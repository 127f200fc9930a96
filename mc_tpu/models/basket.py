"""Multi-asset basket model: correlated GBM, payoffs on the basket level.

Beyond the reference (single asset): ``d`` assets follow GBM with a full
correlation structure; every payoff in the registry prices on the basket
value ``B_t = sum_i w_i S_{i,t}`` (so basket calls, basket Asians, basket
barrier/bullet contracts all work unchanged).

Device mapping: the asset dimension is a STATIC python loop over
(tile_rows, 128) tiles — for the d <= ~16 of practical baskets, the
per-step work is d correlated normals (Cholesky mixing unrolled as
scalar-times-tile FMAs), d log-increment adds, and d exps.
Draw layout: step j consumes pairs (j * ceil(d/2) + q), so the stream stays
counter-based and tiling/sharding-invariant.

Correlation enters through the Cholesky factor of the full return
covariance ``diag(sigma) @ corr @ diag(sigma)``, computed at trace time
from traced parameters — re-pricing at new vols/correlations recompiles
nothing.
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
from mc_tpu.ops._pallas import (LANES, SUBLANES, fold_to_sublanes,
                                kahan_xla_update, tile_path_ids,
                                xla_moment_scan)
from mc_tpu.ops.payoffs import get_payoff
from mc_tpu.ops.reduce import finish_sum

__all__ = ["BasketDynamics", "price_basket", "DEMO_BASKET"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BasketDynamics:
    """d-asset basket parameters (traced pytree leaves, shapes static)."""

    s0s: Any       # (d,) initial prices
    sigmas: Any    # (d,) volatilities
    weights: Any   # (d,) basket weights
    corr: Any      # (d, d) correlation matrix (PSD, unit diagonal)

    @property
    def d(self) -> int:
        return int(self.s0s.shape[0])

    def as_f32(self) -> "BasketDynamics":
        return BasketDynamics(
            s0s=jnp.asarray(self.s0s, jnp.float32),
            sigmas=jnp.asarray(self.sigmas, jnp.float32),
            weights=jnp.asarray(self.weights, jnp.float32),
            corr=jnp.asarray(self.corr, jnp.float32),
        )


def _demo_basket(d: int = 4, rho: float = 0.5) -> BasketDynamics:
    corr = np.full((d, d), rho, np.float32)
    np.fill_diagonal(corr, 1.0)
    return BasketDynamics(
        s0s=np.full(d, 100.0, np.float32),
        sigmas=np.linspace(0.15, 0.3, d).astype(np.float32),
        weights=np.full(d, 1.0 / d, np.float32),
        corr=corr,
    )


DEMO_BASKET = _demo_basket()


def _basket_leg(payoff, d: int, n_steps: int, p, draw_pair,
                antithetic_sign=1.0, history=False):
    """Correlated log-Euler leg; basket value drives the payoff.

    ``p`` carries per-asset scalars: p.s0s, p.weights (d-tuples of
    scalars or traced values), p.chol (d x d nested tuple), p.drifts
    (d-tuple of (r - sigma_i^2/2) dt).  ``history=True`` also returns the
    per-step (basket level, payoff state) grids, shaped (n_steps, *tile).
    """
    sign = jnp.float32(antithetic_sign)
    n_pairs_per_step = (d + 1) // 2

    def basket_of(ws):
        b = None
        for i in range(d):
            s_i = p.s0s[i] * jnp.exp(ws[i])
            term = p.weights[i] * s_i
            b = term if b is None else b + term
        return b

    def step(j, ws):
        # draw d iid normals for this step
        zs = []
        for q in range(n_pairs_per_step):
            z0, z1 = draw_pair(j * n_pairs_per_step + q)
            zs.append(sign * z0)
            zs.append(sign * z1)
        zs = zs[:d]
        # Cholesky mix + log-increment per asset (unrolled, static d)
        new_ws = []
        for i in range(d):
            y = None
            for k in range(i + 1):
                term = p.chol[i][k] * zs[k]
                y = term if y is None else y + term
            new_ws.append(ws[i] + p.drifts[i] + p.sqrt_dt * y)
        return tuple(new_ws)

    def body(j, carry):
        ws, state = carry
        ws = step(j, ws)
        b = basket_of(ws)
        state = payoff.update(state, b, p)
        return (ws, state), b

    z_probe, _ = draw_pair(0)  # fixes the tile shape
    zeros = jnp.zeros_like(z_probe)
    ws0 = tuple(zeros for _ in range(d))
    state0 = payoff.init(p, zeros)
    if not history:
        ws, state = jax.lax.fori_loop(
            0, n_steps, lambda j, c: body(j, c)[0], (ws0, state0))
        return payoff.terminal(state, basket_of(ws), p)

    def scan_body(carry, j):
        (ws, state), b = body(j, carry)
        c = state[0] if payoff.n_state else jnp.zeros_like(b)
        return (ws, state), (b, c)

    (ws, state), (b_hist, c_hist) = jax.lax.scan(
        scan_body, (ws0, state0), jnp.arange(n_steps, dtype=jnp.int32))
    return payoff.terminal(state, basket_of(ws), p), b_hist, c_hist


MAX_BASKET_D = 32  # unrolled Cholesky/mixing compile as O(d^2) scalar
                   # ops; past this the compile time dwarfs the kernel


def chol_scalars(cov, d: int):
    """Unrolled scalar Cholesky (Banachiewicz) of a tiny static-d SPD
    matrix -> nested lower-triangular tuples of traced scalars.

    Replaces ``jnp.linalg.cholesky``, a library call outside the fused
    program.  For the d <= ~16 of practical baskets the d^3/6 scalar ops
    fuse into the surrounding program for free.
    """
    if d > MAX_BASKET_D:
        raise ValueError(
            f"basket dimension d={d} exceeds MAX_BASKET_D={MAX_BASKET_D}: "
            "the unrolled Cholesky mixing compiles O(d^2) scalar FMAs per "
            "step, which dominates compile time and VREG pressure past "
            "~32 assets; factor the basket or raise the bound knowingly")
    L = [[None] * (i + 1) for i in range(d)]
    for i in range(d):
        for j in range(i + 1):
            acc = cov[i, j]
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(acc, 1e-30))
            else:
                L[i][j] = acc / L[j][j]
    return tuple(tuple(row) for row in L)


def _basket_namespace(option, basket, n_steps: int):
    """Scalar-ized parameters (python tuples of traced scalars) shared by
    the pricers."""
    d = basket.d
    sig = basket.sigmas
    cov = (sig[:, None] * basket.corr * sig[None, :])
    # tiny relative jitter keeps the Cholesky finite at the degenerate
    # corr=1 boundary (rank-deficient covariance); 1e-6 relative is far
    # below any market calibration precision
    jitter = 1e-6 * jnp.mean(jnp.diag(cov))
    chol_t = chol_scalars(cov + jitter * jnp.eye(basket.d), d)
    t = jnp.float32(option.t)
    r = jnp.float32(option.r)
    dt = t / jnp.float32(n_steps)
    ns = SimpleNamespace(
        s0=jnp.sum(basket.weights * basket.s0s),  # B_0 (payoff-visible)
        k=jnp.float32(option.k), r=r, t=t,
        barrier=jnp.float32(option.barrier),
        p1=jnp.float32(option.p1), p2=jnp.float32(option.p2),
        sigma=jnp.float32(option.sigma),
        dt=dt, inv_n_steps=1.0 / jnp.float32(n_steps),
        sqrt_dt=jnp.sqrt(dt),
        s0s=tuple(basket.s0s[i] for i in range(d)),
        weights=tuple(basket.weights[i] for i in range(d)),
        drifts=tuple((r - jnp.float32(option.q)
                      - 0.5 * sig[i] * sig[i]) * dt for i in range(d)),
        chol=chol_t,
    )
    return ns


def _basket_tile(payoff, d, n_steps, antithetic, p, ids, valid, k0, k1):
    shape = ids.shape

    def draw_pair(m):
        c1 = jnp.full(shape, 0, jnp.uint32) + jnp.asarray(m, jnp.uint32)
        return rng.normal_pair(k0, k1, ids, c1)

    pay = _basket_leg(payoff, d, n_steps, p, draw_pair)
    if antithetic:
        pay = 0.5 * (pay + _basket_leg(payoff, d, n_steps, p, draw_pair,
                                       antithetic_sign=-1.0))
    return jnp.where(valid, pay, 0.0)


# Basket params ship as one flat f32 vector:
# [k, r, t, barrier, p1, p2, dt, inv_n, sqrt_dt, b0,
#  s0s(d), weights(d), drifts(d), chol(lower-tri, d(d+1)/2)]
_HDR = 10


def _pack_basket(ns, d: int):
    tri = [ns.chol[i][k] for i in range(d) for k in range(i + 1)]
    return jnp.stack([ns.k, ns.r, ns.t, ns.barrier, ns.p1, ns.p2, ns.dt,
                      ns.inv_n_steps, ns.sqrt_dt, ns.s0]
                     + list(ns.s0s) + list(ns.weights) + list(ns.drifts)
                     + tri)


def _unpack_basket(ref, d: int):
    names = ("k", "r", "t", "barrier", "p1", "p2", "dt", "inv_n_steps",
             "sqrt_dt", "s0")
    ns = SimpleNamespace(**{nm: ref[i] for i, nm in enumerate(names)})
    o = _HDR
    ns.s0s = tuple(ref[o + i] for i in range(d)); o += d
    ns.weights = tuple(ref[o + i] for i in range(d)); o += d
    ns.drifts = tuple(ref[o + i] for i in range(d)); o += d
    chol = []
    for i in range(d):
        chol.append(tuple(ref[o + k] for k in range(i + 1)))
        o += i + 1
    ns.chol = tuple(chol)
    ns.sigma = ns.k * 0.0  # placeholder (unused by basket payoffs)
    return ns


def basket_trajectories(payoff, cfg: pk.KernelConfig, d: int, key,
                        params):
    """Materialize (basket level, payoff state) grids — step-major
    (n_steps, n_tiles*tile_rows, 128) — plus the terminal payoff moment
    slabs; the LSMC feed for American exercise on a basket."""
    if payoff.n_state > 1:
        raise ValueError("the basket trajectory engine stores one state "
                         "array")
    p = _unpack_basket(params, d)
    k0 = jnp.asarray(key[0], jnp.uint32)
    k1 = jnp.asarray(key[1], jnp.uint32)
    shape = (cfg.tile_rows, LANES)
    flat = tile_path_ids(0, shape)

    def one_tile(carry, i):
        acc, comp = carry
        ids = jnp.uint32(i * cfg.paths_per_tile) + flat

        def draw_pair(m):
            c1 = jnp.full(shape, 0, jnp.uint32) + jnp.asarray(m, jnp.uint32)
            return rng.normal_pair(k0, k1, ids, c1)

        pay, b_hist, c_hist = _basket_leg(payoff, d, cfg.n_steps, p,
                                          draw_pair, history=True)
        pay = jnp.where(ids < jnp.uint32(cfg.n_paths), pay, 0.0)
        for m, v in enumerate([pay, pay * pay]):
            acc, comp = kahan_xla_update(acc, comp, m,
                                         fold_to_sublanes(v, cfg.tile_rows))
        return (acc, comp), (b_hist, c_hist)

    zeros = jnp.zeros((2, SUBLANES, LANES), jnp.float32)
    (acc, _), (b_tiles, c_tiles) = jax.lax.scan(
        one_tile, (zeros, zeros), jnp.arange(cfg.n_tiles, dtype=jnp.uint32))
    rows = cfg.n_tiles * cfg.tile_rows

    def to_grid(x):  # (n_tiles, n_steps, tile_rows, 128) -> step-major
        return jnp.moveaxis(x, 0, 1).reshape(cfg.n_steps, rows, LANES)

    return to_grid(b_tiles), to_grid(c_tiles), acc[0], acc[1]


def _basket_partials(payoff, cfg, d, key, ns, path_offset=0, n_valid=None):
    """(sum, sumsq) (8,128) slabs for this shard's global path-id range."""
    offset = jnp.asarray(path_offset, jnp.uint32)
    bound = (offset + jnp.uint32(cfg.n_paths) if n_valid is None
             else jnp.asarray(n_valid, jnp.uint32))
    k0 = jnp.asarray(key[0], jnp.uint32)
    k1 = jnp.asarray(key[1], jnp.uint32)

    def tile_fn(ids, valid):
        pay = _basket_tile(payoff, d, cfg.n_steps, cfg.antithetic, ns,
                           ids, valid, k0, k1)
        return [pay, pay * pay]

    return xla_moment_scan(tile_fn, cfg.n_paths, cfg.tile_rows, 2,
                           offset=offset, bound=bound)


@functools.partial(
    jax.jit,
    static_argnames=("payoff", "sim", "d", "antithetic",
                     "tile_rows"))
def _price_basket_impl(option, basket, payoff, sim, d, antithetic,
                       tile_rows, key):
    cfg = pk.KernelConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                          tile_rows=tile_rows, antithetic=antithetic)
    ns = _basket_namespace(option, basket, sim.n_steps)
    s, sq = _basket_partials(payoff, cfg, d, key, ns)
    r = jnp.float32(option.r)
    t = jnp.float32(option.t)
    return summarize(finish_sum(s), finish_sum(sq),
                     jnp.asarray(sim.n_paths, jnp.float32),
                     jnp.exp(-r * t))


def price_basket(option: OptionParams = DEMO_OPTION,
                 basket: BasketDynamics = DEMO_BASKET,
                 sim: SimParams = DEMO_SIM,
                 payoff="vanilla_call",
                 *,
                 antithetic: bool = False,
                 tile_rows: int = 128,
                 stream: int = STREAM_OUTER,
                 key=None) -> PriceResult:
    """Monte Carlo price of an option on a correlated multi-asset basket.

    Every registry payoff applies to the basket value B_t (basket call,
    basket Asian, basket knock-out, bullet on the basket, ...).  The
    option-level strike/barrier fields refer to the basket level.
    """
    po = get_payoff(payoff)
    b32 = basket.as_f32()
    if key is None:
        key = jnp.asarray(rng.derive_key(sim.seed, stream, 0xBA5C),
                          jnp.uint32)
    return _price_basket_impl(option.as_f32(), b32, po,
                              sim.replace(seed=0), b32.d,
                              antithetic, tile_rows, key)


# ---------------------------------------------------------------------------
# Basket trajectory materialization: the step-major (B_t, state_t) grids
# that feed LSMC — American/Bermudan exercise on a correlated basket.
# ---------------------------------------------------------------------------


