"""Rainbow options: payoffs on the ORDER STATISTICS of correlated assets.

The basket model (`models.basket`) prices payoffs on the weighted sum
``B_t``; rainbow contracts instead read the individual terminal prices —
best-of / worst-of calls and puts, Margrabe exchanges, best-of-assets-or-
cash.  Beyond the reference (single asset, `inc/trajectories.cuh`), with
sharp closed-form gates: Margrabe (1978) for the exchange and Stulz
(1982) via the bivariate normal CDF for two-asset min/max contracts
(`oracle.margrabe`, `oracle.stulz_*`).

Device mapping: rainbow payoffs are terminal-only, so each path is ONE exact
correlated GBM draw over the full horizon (the reference's `terminal`
trick, trajectories.cuh:74-75, lifted to d assets): ceil(d/2) threefry
pairs -> d iid normals -> unrolled Cholesky mix -> d exps, all on
(tile_rows, 128) tiles; min/max folds are d-1 vector maximum ops.  Reuses
the basket parameter packing (`_pack_basket` with n_steps=1, so the
packed drifts cover the full T and sqrt_dt = sqrt(T)).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from mc_tpu import rng
from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.engines import STREAM_OUTER
from mc_tpu.models.basket import (BasketDynamics, DEMO_BASKET,
                                  _basket_namespace, _pack_basket,
                                  _unpack_basket)
from mc_tpu.oracle import PriceResult, summarize
from mc_tpu.ops import path_kernels as pk
from mc_tpu.ops._pallas import xla_moment_scan
from mc_tpu.ops.reduce import finish_sum

__all__ = ["price_rainbow", "RAINBOW_PAYOFFS", "BasketDynamics",
           "DEMO_BASKET"]


def _vmax(ss):
    m = ss[0]
    for s in ss[1:]:
        m = jnp.maximum(m, s)
    return m


def _vmin(ss):
    m = ss[0]
    for s in ss[1:]:
        m = jnp.minimum(m, s)
    return m


# name -> (payoff fn over the terminal asset list, min assets required)
RAINBOW_PAYOFFS = {
    "call_on_max": (lambda ss, p: jnp.maximum(_vmax(ss) - p.k, 0.0), 1),
    "call_on_min": (lambda ss, p: jnp.maximum(_vmin(ss) - p.k, 0.0), 1),
    "put_on_max": (lambda ss, p: jnp.maximum(p.k - _vmax(ss), 0.0), 1),
    "put_on_min": (lambda ss, p: jnp.maximum(p.k - _vmin(ss), 0.0), 1),
    "exchange": (lambda ss, p: jnp.maximum(ss[0] - ss[1], 0.0), 2),
    "best_of_cash": (lambda ss, p: jnp.maximum(_vmax(ss), p.k), 1),
}


def _rainbow_leg(pay_fn, d: int, p, draw_pair, antithetic_sign=1.0):
    """One exact terminal draw per path: S_i = s0_i exp(drift_i + y_i)
    with y = sqrt(T) * chol @ z.  ``p`` is the n_steps=1 basket
    namespace, so p.drifts spans the full horizon."""
    sign = jnp.float32(antithetic_sign)
    zs = []
    for q in range((d + 1) // 2):
        z0, z1 = draw_pair(q)
        zs.append(sign * z0)
        zs.append(sign * z1)
    zs = zs[:d]
    ss = []
    for i in range(d):
        y = None
        for k in range(i + 1):
            term = p.chol[i][k] * zs[k]
            y = term if y is None else y + term
        ss.append(p.s0s[i] * jnp.exp(p.drifts[i] + p.sqrt_dt * y))
    return pay_fn(ss, p)


def _rainbow_tile(name, d, antithetic, p, ids, valid, k0, k1,
                  rng_source="threefry13"):
    pay_fn, _ = RAINBOW_PAYOFFS[name]
    shape = ids.shape

    rounds = 13 if rng_source == "threefry13" else 20

    def draw_pair(m):
        c1 = jnp.full(shape, 0, jnp.uint32) + jnp.asarray(m, jnp.uint32)
        return rng.normal_pair(k0, k1, ids, c1, rounds=rounds)

    pay = _rainbow_leg(pay_fn, d, p, draw_pair)
    if antithetic:
        pay = 0.5 * (pay + _rainbow_leg(pay_fn, d, p, draw_pair,
                                        antithetic_sign=-1.0))
    return jnp.where(valid, pay, 0.0)


def _rainbow_partials(name, cfg, d, key, params, path_offset=0,
                      n_valid=None):
    """(sum, sumsq) (8,128) slabs for this shard's global path-id range.

    ``params`` is the packed basket parameter vector (n_steps=1 namespace).
    """
    offset = jnp.asarray(path_offset, jnp.uint32)
    bound = (offset + jnp.uint32(cfg.n_paths) if n_valid is None
             else jnp.asarray(n_valid, jnp.uint32))
    ns = _unpack_basket(params, d)
    k0 = jnp.asarray(key[0], jnp.uint32)
    k1 = jnp.asarray(key[1], jnp.uint32)

    def tile_fn(ids, valid):
        pay = _rainbow_tile(name, d, cfg.antithetic, ns, ids, valid,
                            k0, k1)
        return [pay, pay * pay]

    return xla_moment_scan(tile_fn, cfg.n_paths, cfg.tile_rows, 2,
                           offset=offset, bound=bound)


@functools.partial(
    jax.jit,
    static_argnames=("name", "sim", "d", "antithetic",
                     "tile_rows", "rng_source"))
def _price_rainbow_impl(option, basket, name, sim, d, antithetic,
                        tile_rows, key,
                        rng_source="threefry13"):
    cfg = pk.KernelConfig(n_paths=sim.n_paths, n_steps=1,
                          tile_rows=tile_rows, antithetic=antithetic,
                          rng_source=rng_source)
    params = _pack_basket(_basket_namespace(option, basket, 1), d)
    s, sq = _rainbow_partials(name, cfg, d, key, params)
    r = jnp.float32(option.r)
    t = jnp.float32(option.t)
    return summarize(finish_sum(s), finish_sum(sq),
                     jnp.asarray(sim.n_paths, jnp.float32),
                     jnp.exp(-r * t))


def price_rainbow(option: OptionParams = DEMO_OPTION,
                  basket: BasketDynamics = DEMO_BASKET,
                  sim: SimParams = DEMO_SIM,
                  payoff: str = "call_on_max",
                  *,
                  antithetic: bool = False,
                  tile_rows: int = 128,
                  stream: int = STREAM_OUTER,
                  key=None,
                  rng_source: str = "threefry13") -> PriceResult:
    """Monte Carlo price of a rainbow option on correlated GBM assets.

    ``payoff``: one of `RAINBOW_PAYOFFS` — contracts on the terminal
    order statistics (min/max) of the asset vector, or the pairwise
    exchange max(S1-S2, 0).  `option.k` is the cash strike; weights in
    ``basket`` are ignored (rainbows read the assets, not the sum).
    `sim.n_steps` is ignored: terminal-only payoffs use one exact draw.

    Two-asset gates: `oracle.margrabe`, `oracle.stulz_min_call` /
    `stulz_max_call` / `stulz_min_put` / `stulz_max_put`.
    """
    if payoff not in RAINBOW_PAYOFFS:
        raise KeyError(f"unknown rainbow payoff {payoff!r}; "
                       f"available: {sorted(RAINBOW_PAYOFFS)}")
    b32 = basket.as_f32()
    _, min_d = RAINBOW_PAYOFFS[payoff]
    if b32.d < min_d:
        raise ValueError(f"{payoff!r} needs >= {min_d} assets, "
                         f"basket has {b32.d}")
    if key is None:
        key = jnp.asarray(rng.derive_key(sim.seed, stream, 0xBE0F),
                          jnp.uint32)
    return _price_rainbow_impl(option.as_f32(), b32, payoff,
                               sim.replace(seed=0), b32.d,
                               antithetic, tile_rows, key,
                               rng_source=rng_source)
