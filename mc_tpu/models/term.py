"""Term-structure GBM: per-step deterministic rate and volatility curves.

Beyond the reference (flat r, sigma hard-coded per run, `hello.cu:5-13`):
production desks price off CURVES — a discount curve r(t) and a forward
volatility surface slice sigma(t).  Here both are piecewise-constant per
simulation step:

    d log S = (r_j - q - sigma_j^2/2) dt + sigma_j sqrt(dt) dW,  step j.

Because the curves are deterministic, the terminal distribution is GBM
with the AVERAGED parameters — r_bar = mean(r_j), sigma_bar^2 =
mean(sigma_j^2) — so every European contract has an EXACT closed form
(plain Black-Scholes at (r_bar, sigma_bar)); that identity is the test
gate.  Path-dependent payoffs see the real curve (an Asian under a vol
term structure actually differs from its flat-vol twin).

Device mapping: the per-step drift/vol pairs ship in the same flat f32
vector as the scalar params; the step loop reads ``drift_dt[j]`` /
``vol_sdt[j]`` as dynamic scalar loads — no layout change to the
(tile_rows, 128) tile compute.  Counter layout matches
the GBM euler kernel (one threefry pair per step pair).
"""

from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from mc_tpu import rng
from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.engines import STREAM_OUTER
from mc_tpu.oracle import PriceResult, summarize
from mc_tpu.ops import path_kernels as pk
from mc_tpu.ops._pallas import xla_moment_scan
from mc_tpu.ops.payoffs import get_payoff
from mc_tpu.ops.reduce import finish_sum

__all__ = ["TermStructure", "price_term", "DEMO_TERM"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TermStructure:
    """Per-step curves (traced pytree leaves, static length = n_steps).

    ``rates[j]`` and ``sigmas[j]`` apply over simulation step j.  Build
    from coarser knots with `TermStructure.from_knots`.
    """

    rates: Any    # (n_steps,) short-rate curve
    sigmas: Any   # (n_steps,) instantaneous vol curve

    @property
    def n_steps(self) -> int:
        return int(self.rates.shape[0])

    def as_f32(self) -> "TermStructure":
        return TermStructure(rates=jnp.asarray(self.rates, jnp.float32),
                             sigmas=jnp.asarray(self.sigmas, jnp.float32))

    @staticmethod
    def from_knots(rate_knots, sigma_knots, n_steps: int):
        """Spread K knot values over n_steps as equal piecewise segments."""
        def spread(vals):
            vals = np.asarray(vals, np.float32)
            idx = np.minimum((np.arange(n_steps) * len(vals)) // n_steps,
                             len(vals) - 1)
            return vals[idx]
        return TermStructure(rates=spread(rate_knots),
                             sigmas=spread(sigma_knots))


DEMO_TERM = TermStructure.from_knots([0.10, 0.07, 0.05],
                                     [0.15, 0.22, 0.30], 100)

# Parameter-vector layout: [s0, k, t, barrier, p1, p2, q, dt, inv_n, r_bar, sigma_bar,
#                           drift_dt(n_steps), vol_sdt(n_steps)]
_HDR = 11


def _pack_term(option, term, n_steps):
    s0, t, k, r0, sigma0, barrier, p1, p2, q = (
        jnp.float32(v) for v in option.astuple())
    del r0, sigma0  # the curves REPLACE the option's flat fields
    rs = jnp.asarray(term.rates, jnp.float32)
    sg = jnp.asarray(term.sigmas, jnp.float32)
    n = jnp.float32(n_steps)
    dt = t / n
    r_bar = jnp.mean(rs)
    sigma_bar = jnp.sqrt(jnp.mean(sg * sg))
    head = jnp.stack([s0, k, t, barrier, p1, p2, q, dt, 1.0 / n, r_bar,
                      sigma_bar])
    drift_dt = (rs - q - 0.5 * sg * sg) * dt
    vol_sdt = sg * jnp.sqrt(dt)
    return jnp.concatenate([head, drift_dt, vol_sdt])


def _unpack_term_head(ref):
    names = ("s0", "k", "t", "barrier", "p1", "p2", "q", "dt",
             "inv_n_steps", "r", "sigma")  # r/sigma = averaged (payoffs)
    return SimpleNamespace(**{nm: ref[i] for i, nm in enumerate(names)})


def _term_leg(payoff, n_steps: int, p, s0, draw_pair, drift_at, vol_at,
              antithetic_sign=1.0):
    """Log-Euler leg with per-step curve lookups; one pair per step pair."""
    sign = jnp.float32(antithetic_sign)
    state0 = payoff.init(p, jnp.zeros_like(s0))

    def one_step(carry, j, z):
        w, state = carry
        w = w + (drift_at(j) + vol_at(j) * z)
        s = s0 * jnp.exp(w)  # log-space: one exp rounding per S_t
        return (w, payoff.update(state, s, p)), s

    def pair_body(j, carry):
        z0, z1 = draw_pair(j)
        carry, _ = one_step(carry, 2 * j, sign * z0)
        carry, s = one_step(carry, 2 * j + 1, sign * z1)
        return carry

    zeros = jnp.zeros_like(s0)
    (w, state) = jax.lax.fori_loop(0, n_steps // 2, pair_body,
                                   (zeros, state0))
    return payoff.terminal(state, s0 * jnp.exp(w), p)


def _term_tile(payoff, n_steps, antithetic, p, ids, valid, k0, k1,
               drift_at, vol_at):
    shape = ids.shape

    def draw_pair(m):
        c1 = jnp.full(shape, 0, jnp.uint32) + jnp.asarray(m, jnp.uint32)
        return rng.normal_pair(k0, k1, ids, c1)

    s0 = jnp.full(shape, p.s0, jnp.float32)
    pay = _term_leg(payoff, n_steps, p, s0, draw_pair, drift_at, vol_at)
    if antithetic:
        pay = 0.5 * (pay + _term_leg(payoff, n_steps, p, s0, draw_pair,
                                     drift_at, vol_at,
                                     antithetic_sign=-1.0))
    return jnp.where(valid, pay, 0.0)


def _term_partials(payoff, cfg, key, params, path_offset=0, n_valid=None):
    """(sum, sumsq) (8,128) slabs for this shard's global path-id range."""
    offset = jnp.asarray(path_offset, jnp.uint32)
    bound = (offset + jnp.uint32(cfg.n_paths) if n_valid is None
             else jnp.asarray(n_valid, jnp.uint32))
    p = _unpack_term_head(params)
    n = cfg.n_steps
    k0 = jnp.asarray(key[0], jnp.uint32)
    k1 = jnp.asarray(key[1], jnp.uint32)
    drift_at = lambda j: params[_HDR + j]
    vol_at = lambda j: params[_HDR + n + j]

    def tile_fn(ids, valid):
        pay = _term_tile(payoff, n, cfg.antithetic, p, ids, valid, k0, k1,
                         drift_at, vol_at)
        return [pay, pay * pay]

    return xla_moment_scan(tile_fn, cfg.n_paths, cfg.tile_rows, 2,
                           offset=offset, bound=bound)


@functools.partial(
    jax.jit,
    static_argnames=("payoff", "sim", "antithetic", "tile_rows"))
def _price_term_impl(option, term, payoff, sim, antithetic,
                     tile_rows, key):
    cfg = pk.KernelConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                          tile_rows=tile_rows, antithetic=antithetic)
    params = _pack_term(option, term, sim.n_steps)
    s, sq = _term_partials(payoff, cfg, key, params)
    # curve discount: exp(-sum r_j dt) = exp(-r_bar * T)
    t = jnp.float32(option.t)
    discount = jnp.exp(-params[9] * t)
    return summarize(finish_sum(s), finish_sum(sq),
                     jnp.asarray(sim.n_paths, jnp.float32), discount)


def price_term(option: OptionParams = DEMO_OPTION,
               term: TermStructure = DEMO_TERM,
               sim: SimParams = DEMO_SIM,
               payoff="vanilla_call",
               *,
               antithetic: bool = False,
               tile_rows: int = 128,
               stream: int = STREAM_OUTER,
               key=None) -> PriceResult:
    """Monte Carlo price under per-step rate and volatility CURVES.

    ``term.rates`` / ``term.sigmas`` must have length ``sim.n_steps``
    (use `TermStructure.from_knots` to spread coarse knots); the
    option's flat ``r`` / ``sigma`` fields are ignored.  Payoffs that
    read ``p.r`` / ``p.sigma`` (e.g. the Brownian-bridge barrier
    weights) see the AVERAGED values.

    European gate: the terminal law is exactly GBM at
    (r_bar, sqrt(mean(sigma^2))) — plain `oracle.bs_call` prices it.
    """
    po = get_payoff(payoff)
    po.validate(option, sim.n_steps)
    t32 = term.as_f32()
    if t32.n_steps != sim.n_steps:
        raise ValueError(
            f"term structure has {t32.n_steps} steps, sim has "
            f"{sim.n_steps}; build with TermStructure.from_knots(..., "
            f"n_steps={sim.n_steps})")
    if sim.n_steps % 2:
        raise ValueError("term requires an even n_steps (pair-consuming "
                         "step loop)")
    if key is None:
        key = jnp.asarray(rng.derive_key(sim.seed, stream, 0x7E53),
                          jnp.uint32)
    return _price_term_impl(option.as_f32(), t32, po,
                            sim.replace(seed=0), antithetic,
                            tile_rows, key)
