"""Fused path-simulation kernels for NVIDIA GPUs (Pallas, Triton route).

Re-design of the reference's simulation kernels (``inc/trajectories.cuh``,
SURVEY.md C7/C8):

* reference: one CUDA thread = one path; per-thread curand state pulled to
  registers; Euler loop in registers; shared-memory tree reduce + warp
  shuffle; per-block partials ``g_odata[blockIdx.x]`` finished on the host.
* here: one Triton program = one tile of ``tile_rows x 128`` paths, walked
  in (8, 128) chunks; normals are generated *inside* the kernel from
  counter-based threefry (no RNG state in HBM); the step loop is a
  ``fori_loop`` over values held in registers; each program folds its
  chunks into one (8, 128) slab per moment and writes it to its own row of
  an ``(n_tiles, 8, 128)`` output — the reference's per-block-partials
  mode.  `kahan_tiles` then sums the rows in tile order, which is the XLA
  engine's summation order.  No atomics: their order changes from run to
  run.

One generic kernel serves every payoff in the registry because the payoff's
``init/update/terminal`` are inlined at trace time (the reference needed a
hand-written kernel per payoff).  Variance-reduction hooks (antithetic
pairing, control-variate moment accumulators) are fused into the same pass.

Normal draws are counter-based threefry: draw (path i, step j) = f(key, i,
j), bit-identical for any tiling, sharding or backend.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from mc_tpu import rng
from mc_tpu.ops._pallas import (LANES, SUBLANES, cdiv, fold_to_sublanes,
                                kahan_tiles_kernel, kahan_xla_update,
                                tile_path_ids, triton_call, xla_moment_scan)
from mc_tpu.ops.payoffs import PathPayoff

__all__ = ["KernelConfig", "PARAM_FIELDS", "pack_params", "simulate_partials",
           "simulate_trajectories_kernel", "terminal_pair_partials",
           "check_rng_source"]


# ---------------------------------------------------------------------------
# Parameter packing: the analogue of __constant__ OptionData
# (trajectories.cuh:12) is a small f32 vector each program reads as scalars.
# ---------------------------------------------------------------------------

PARAM_FIELDS = (
    "s0", "k", "r", "sigma", "barrier", "p1", "p2", "t", "q",
    "dt", "drift_dt", "vol_dt", "drift_t", "vol_t", "inv_n_steps",
)


def pack_params(option, n_steps: int) -> jnp.ndarray:
    """Pack OptionParams + derived GBM coefficients into an f32 vector."""
    s0, t, k, r, sigma, barrier, p1, p2, q = (
        jnp.float32(v) for v in option.astuple())
    n = jnp.float32(n_steps)
    dt = t / n
    vals = dict(
        s0=s0, k=k, r=r, sigma=sigma, barrier=barrier, p1=p1, p2=p2, t=t,
        q=q,
        dt=dt,
        drift_dt=(r - q - 0.5 * sigma * sigma) * dt,
        vol_dt=sigma * jnp.sqrt(dt),
        drift_t=(r - q - 0.5 * sigma * sigma) * t,
        vol_t=sigma * jnp.sqrt(t),
        inv_n_steps=1.0 / n,
    )
    return jnp.stack([vals[f] for f in PARAM_FIELDS])


def unpack_params(params_ref) -> SimpleNamespace:
    return SimpleNamespace(
        **{f: params_ref[i] for i, f in enumerate(PARAM_FIELDS)})


# Default tile height per engine.  The kernel walks a tile in (8, 128)
# chunks inside one program, so the tile sets the number of programs and of
# partial slabs: 32 rows (4096 paths) was fastest end to end for the
# 1M-path European and bullet calls on an H100 (CHANGES.md).  The XLA
# engine iterates tiles in a device loop, so it wants fewer, larger tiles.
DEFAULT_TILE_ROWS = {"pallas": 32, "xla": 128}


def default_tile_rows(engine: str) -> int:
    return DEFAULT_TILE_ROWS[engine]


RNG_SOURCES = ("threefry13", "threefry")


def check_rng_source(rng_source: str):
    """Validate a normal-draw stream name."""
    if rng_source not in RNG_SOURCES:
        raise ValueError(f"unknown rng_source {rng_source!r}; use "
                         "'threefry13' or 'threefry' (20 rounds)")


# ---------------------------------------------------------------------------
# Kernel configuration (static)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    n_paths: int
    n_steps: int
    tile_rows: int = 128          # paths per tile = tile_rows * 128
    antithetic: bool = False
    with_cv: bool = False         # emit control-variate moment partials
    rng_source: str = "threefry13"  # "threefry13" | "threefry"(20)
    method: str = "euler"         # "euler" | "terminal"
    start_step: int = 0           # resume support (trajectories.cuh:116-117 Tk)
    # Importance sampling: shift the terminal log-price by `is_shift`
    # standard deviations (of sigma*sqrt(T)); payoffs are re-weighted by
    # the exact likelihood ratio so the estimator stays unbiased.
    is_shift: float = 0.0

    def __post_init__(self):
        if self.tile_rows % 8 or self.tile_rows < 8:
            raise ValueError("tile_rows must be a positive multiple of 8 "
                             f"(the (8, 128) slab); got {self.tile_rows}")
        check_rng_source(self.rng_source)
        if self.method not in ("euler", "terminal"):
            # "terminal_pair" has its own kernel + entry validation in
            # engines.price; reaching here means a sibling entry point
            # (sharded/chunked) would silently run the euler loop
            # instead — fail loudly.
            raise ValueError(
                f"unknown method {self.method!r} for the step-loop "
                "kernels; use 'euler' or 'terminal' "
                "(method='terminal_pair' is only available through "
                "price())")
        if self.is_shift and self.start_step:
            raise ValueError("importance sampling with resume (start_step>0) "
                             "is not supported")

    @property
    def rng_rounds(self) -> int:
        """13-round threefry passes BigCrush (Salmon et al. table 5) at
        ~35% fewer hot-loop ops; 20 is the high-margin default."""
        return 13 if self.rng_source == "threefry13" else 20

    @property
    def paths_per_tile(self) -> int:
        return self.tile_rows * LANES

    @property
    def n_tiles(self) -> int:
        return cdiv(self.n_paths, self.paths_per_tile)


def _tile_normals_threefry(key0, key1, ids, pair_idx,
                           rounds: int = rng.DEFAULT_ROUNDS):
    """Two N(0,1) tiles for counter (path id, pair index) — tiling-invariant.

    Normal draw j of path i is half ``j % 2`` of pair ``j // 2`` — the same
    convention as `rng.normals`, so kernels, XLA engines, and host
    recomputations all see one stream.
    """
    c1 = jnp.full(ids.shape, 0, jnp.uint32) + jnp.asarray(pair_idx, jnp.uint32)
    return rng.normal_pair(key0, key1, ids, c1, rounds=rounds)


def _simulate_leg(payoff: PathPayoff, cfg: KernelConfig, p, s0, draw_pair,
                  state_init=None):
    """Simulate one leg to maturity; returns ``(s_t, state, weight)``.

    ``draw_pair(m) -> (z_2m, z_2m+1)`` tiles; ``s0`` is the initial price
    tile.  The step loop consumes both Box-Muller halves of every threefry
    call (one threefry per TWO steps — the RNG is the hot-loop cost).
    ``weight`` is the importance-sampling likelihood ratio dP/dQ (None when
    cfg.is_shift == 0).
    """
    shift = jnp.float32(cfg.is_shift)
    if cfg.method == "terminal":
        z, _ = draw_pair(0)
        if cfg.is_shift:
            z = z + shift
        s_t = s0 * jnp.exp(p.drift_t + p.vol_t * z)
        if cfg.is_shift:
            # dP/dQ at the sampled point: exp(-shift*eps + shift^2/2).
            return s_t, (), jnp.exp(-shift * z + 0.5 * shift * shift)
        return s_t, (), None

    state0 = payoff.init(p, jnp.zeros_like(s0)) if state_init is None else state_init
    # Per-step drift shift theta = shift/sqrt(n): total terminal log-shift
    # is sigma*sqrt(T)*shift, matching the terminal method.
    theta = shift / jnp.float32(math.sqrt(cfg.n_steps))

    # Log-space accumulation: w_t = sum of log-increments, S_t = S0 e^{w_t}.
    # Each S_t carries exactly ONE exp rounding; the multiplicative form
    # S *= exp(inc) would compound the per-call exp error over the steps.
    w = jnp.zeros_like(s0)
    s, state = s0, state0

    def one_step(w, state, z):
        if cfg.is_shift:
            z = z + theta
        w = w + (p.drift_dt + p.vol_dt * z)
        s = s0 * jnp.exp(w)
        return w, s, payoff.update(state, s, p)

    start, end = cfg.start_step, cfg.n_steps
    if start % 2:  # odd resume point: consume the tail half of its pair
        _, z1 = draw_pair(start // 2)
        w, s, state = one_step(w, state, z1)
        start += 1

    def body(m, carry):
        w, s, state = carry
        z0, z1 = draw_pair(m)
        w, s, state = one_step(w, state, z0)
        w, s, state = one_step(w, state, z1)
        return (w, s, state)

    w, s, state = jax.lax.fori_loop(start // 2, end // 2, body, (w, s, state))
    if end % 2:  # odd step count: epilogue consumes the head half only
        z0, _ = draw_pair(end // 2)
        w, s, state = one_step(w, state, z0)
    if cfg.is_shift:
        # log dP/dQ = -theta * sum(eps_j) + n theta^2 / 2, with the realized
        # shifted increments recovered from the log-price accumulator:
        # sum(eps) * vol_dt = w - n * drift_dt.
        sum_eps = (w - jnp.float32(cfg.n_steps) * p.drift_dt) / p.vol_dt
        weight = jnp.exp(-theta * sum_eps
                         + 0.5 * jnp.float32(cfg.n_steps) * theta * theta)
        return s, state, weight
    return s, state, None


def _payoff_leg(payoff: PathPayoff, cfg: KernelConfig, p, s0, draw_pair,
                state_init=None):
    """Simulate one leg and apply the payoff.

    Returns ``(payoff, S_T-or-weighted-S_T)`` — the terminal price doubles
    as the control variate (E[S_T] = S0 * exp(rT) exactly, since log-Euler
    increments are exact in distribution under GBM).  Under importance
    sampling both outputs carry the likelihood-ratio weight, so every
    downstream moment remains an unbiased P-measure estimator.
    """
    s_t, state, weight = _simulate_leg(payoff, cfg, p, s0, draw_pair,
                                       state_init)
    pay = payoff.terminal(state, s_t, p)
    x = payoff.control(state, s_t, p) if payoff.has_control else s_t
    if weight is not None:
        return pay * weight, x * weight
    return pay, x


def path_moments(payoff: PathPayoff, cfg: KernelConfig, p, k0, k1, ids,
                 valid, s0, state_init=None):
    """Per-path moment tiles ``[pay, pay^2(, x, x^2, pay*x)]`` for a block
    of path ids — the one body the kernel and the XLA engine share."""
    def draw_pair(m):
        return _tile_normals_threefry(k0, k1, ids, m, rounds=cfg.rng_rounds)

    pay, x = _payoff_leg(payoff, cfg, p, s0, draw_pair, state_init)
    if cfg.antithetic:
        draw_neg = lambda m: tuple(-z for z in draw_pair(m))
        pay_neg, x_neg = _payoff_leg(payoff, cfg, p, s0, draw_neg, state_init)
        pay = 0.5 * (pay + pay_neg)
        x = 0.5 * (x + x_neg)
    pay = jnp.where(valid, pay, 0.0)
    vals = [pay, pay * pay]
    if cfg.with_cv:
        # Control variate X = terminal price (pair-mean if antithetic):
        # E[X] = S0 * exp(rT) exactly under the log-Euler scheme.
        x = jnp.where(valid, x, 0.0)
        vals += [x, x * x, pay * x]
    return vals


def _partials_shape(n_out: int, n_tiles: int):
    """Per-tile moment slabs, stacked moment-major for `kahan_tiles_kernel`."""
    return jax.ShapeDtypeStruct((n_out, n_tiles, SUBLANES, LANES),
                                jnp.float32)


def _chunked_tile(n_chunks: int, chunk_fn, n_out: int):
    """Fold a program's (8, 128) chunks in row order: the in-kernel form
    of `fold_to_sublanes`."""
    def body(c, acc):
        return tuple(a + v for a, v in zip(acc, chunk_fn(c)))

    zero = jnp.zeros((SUBLANES, LANES), jnp.float32)
    return jax.lax.fori_loop(0, n_chunks, body, (zero,) * n_out)


def _make_sim_kernel(payoff: PathPayoff, cfg: KernelConfig, with_resume: bool):
    """Build the fused simulate+reduce kernel body."""

    n_out = 5 if cfg.with_cv else 2
    n_chunks = cfg.tile_rows // SUBLANES

    def kernel(*refs):
        key_ref, params_ref, meta_ref = refs[0], refs[1], refs[2]
        idx = 3
        if with_resume:
            s_init_ref = refs[idx]; idx += 1
            state_refs = refs[idx: idx + payoff.n_state]; idx += payoff.n_state
        out_ref = refs[idx]

        p = unpack_params(params_ref)
        i = pl.program_id(0)
        k0, k1 = key_ref[0], key_ref[1]

        def chunk(c):
            row0 = i * cfg.tile_rows + c * SUBLANES
            # Global path id = shard offset + local id: RNG counters stay
            # identical no matter how paths are sharded across devices.
            # The validity mask is against the traced GLOBAL bound, so a
            # shard whose rounded-up range overhangs contributes zeros.
            ids = meta_ref[0] + tile_path_ids(row0)
            valid = ids < meta_ref[1]
            if with_resume:
                rows = pl.ds(row0, SUBLANES)
                s0 = s_init_ref[rows, :]
                state_init = tuple(r[rows, :] for r in state_refs)
            else:
                s0 = jnp.full((SUBLANES, LANES), p.s0, jnp.float32)
                state_init = None
            return path_moments(payoff, cfg, p, k0, k1, ids, valid, s0,
                                state_init)

        for m, v in enumerate(_chunked_tile(n_chunks, chunk, n_out)):
            out_ref[m, i] = v

    return kernel


@functools.partial(
    jax.jit,
    static_argnames=("payoff", "cfg", "interpret"))
def simulate_partials(payoff: PathPayoff, cfg: KernelConfig, key, params,
                      path_offset=0, n_valid=None, s_init=None,
                      state_init=None, interpret: bool = False):
    """Run the fused kernel; returns a tuple of (8, 128) f32 accumulators.

    accumulators = (sum_pay, sum_pay2[, sum_x, sum_x2, sum_pay_x]).

    `path_offset`/`n_valid`: traced global path-id offset of this shard and
    the traced global path-count bound (defaults to offset + cfg.n_paths) —
    together they make the same jitted program serve every shard of a mesh.
    `s_init`/`state_init`: optional per-path resume arrays shaped
    (n_tiles*tile_rows, 128) — the reference's (Sk, Ik, Tk) resume
    arguments (trajectories.cuh:116-117).
    """
    with_resume = s_init is not None
    n_out = 5 if cfg.with_cv else 2
    offset = jnp.asarray(path_offset, jnp.uint32)
    bound = (offset + jnp.uint32(cfg.n_paths) if n_valid is None
             else jnp.asarray(n_valid, jnp.uint32))
    inputs = [jnp.asarray(key, jnp.uint32), params,
              jnp.stack([offset, bound])]
    if with_resume:
        inputs += [s_init, *(state_init or ())]
    parts = triton_call(
        _make_sim_kernel(payoff, cfg, with_resume),
        _partials_shape(n_out, cfg.n_tiles),
        grid=(cfg.n_tiles,), name=f"mc_paths_{cfg.method}",
        interpret=interpret)(*inputs)
    return tuple(kahan_tiles_kernel(parts, interpret))


# ---------------------------------------------------------------------------
# Trajectory materialization (C9): persist (S_t, count_t) at every step.
# ---------------------------------------------------------------------------


def outer_tile_history(payoff: PathPayoff, cfg, p, k0, k1, ids, persist):
    """Simulate an outer trajectory block, calling ``persist(j, s, state)``
    after every step j; returns ``(s_T, state_T)``.  The trajectory
    kernel's step loop; `_history_scan` is its XLA form."""
    shape = ids.shape
    s0 = jnp.full(shape, p.s0, jnp.float32)
    state0 = payoff.init(p, jnp.zeros_like(s0))
    rounds = getattr(cfg, "rng_rounds", rng.DEFAULT_ROUNDS)

    def one_step(w, state, z):
        w = w + (p.drift_dt + p.vol_dt * z)
        s = s0 * jnp.exp(w)  # log-space: one exp rounding per S_t
        return w, s, payoff.update(state, s, p)

    def body(m, carry):
        w, s, state = carry
        z0, z1 = _tile_normals_threefry(k0, k1, ids, m, rounds=rounds)
        w, s, state = one_step(w, state, z0)
        persist(2 * m, s, state)
        w, s, state = one_step(w, state, z1)
        persist(2 * m + 1, s, state)
        return (w, s, state)

    w, s_t, state = jax.lax.fori_loop(0, cfg.n_steps // 2, body,
                                      (jnp.zeros_like(s0), s0, state0))
    if cfg.n_steps % 2:
        z0, _ = _tile_normals_threefry(k0, k1, ids, cfg.n_steps // 2,
                                       rounds=rounds)
        w, s_t, state = one_step(w, state, z0)
        persist(cfg.n_steps - 1, s_t, state)
    return s_t, state


def _make_traj_kernel(payoff: PathPayoff, cfg: KernelConfig):
    if payoff.n_state > 1:
        raise ValueError("the trajectory kernel stores one state array")
    n_chunks = cfg.tile_rows // SUBLANES

    def kernel(key_ref, params_ref, meta_ref, s_out, st_out, parts):
        p = unpack_params(params_ref)
        i = pl.program_id(0)

        def chunk(c):
            row0 = i * cfg.tile_rows + c * SUBLANES
            rows = pl.ds(row0, SUBLANES)
            ids = meta_ref[0] + tile_path_ids(row0)

            def persist(j, s, state):
                # The HBM-streaming analogue of the d_stock_prices /
                # d_sums_i writes (trajectories.cuh:304-305), one step
                # at a time: a block of n_steps rows need not be a
                # power of two.
                s_out[j, rows, :] = s
                st_out[j, rows, :] = (state[0] if payoff.n_state
                                      else jnp.zeros_like(s))

            s_t, state = outer_tile_history(payoff, cfg, p, key_ref[0],
                                            key_ref[1], ids, persist)
            pay = jnp.where(ids < meta_ref[1],
                            payoff.terminal(state, s_t, p), 0.0)
            return [pay, pay * pay]

        for m, v in enumerate(_chunked_tile(n_chunks, chunk, 2)):
            parts[m, i] = v

    return kernel


@functools.partial(jax.jit, static_argnames=("payoff", "cfg", "interpret"))
def simulate_trajectories_kernel(payoff: PathPayoff, cfg: KernelConfig, key,
                                 params, path_offset=0, n_valid=None,
                                 interpret: bool = False):
    """Materialize the full (S, state) grids + payoff partials.

    Returns (s_grid, state_grid, pay_partials, pay_sq_partials) with grids
    shaped (n_steps, n_tiles*tile_rows, 128): step-major so the NMC inner
    stage can tile (step, point-block) slabs straight out of HBM.
    """
    rows = cfg.n_tiles * cfg.tile_rows
    offset = jnp.asarray(path_offset, jnp.uint32)
    bound = (offset + jnp.uint32(cfg.n_paths) if n_valid is None
             else jnp.asarray(n_valid, jnp.uint32))
    grid = jax.ShapeDtypeStruct((cfg.n_steps, rows, LANES), jnp.float32)
    s, st, parts = triton_call(
        _make_traj_kernel(payoff, cfg),
        [grid, grid, _partials_shape(2, cfg.n_tiles)],
        grid=(cfg.n_tiles,), name="mc_trajectories",
        interpret=interpret)(jnp.asarray(key, jnp.uint32), params,
                             jnp.stack([offset, bound]))
    psum, psq = kahan_tiles_kernel(parts, interpret)
    return s, st, psum, psq


def trajectories(payoff: PathPayoff, cfg: KernelConfig, key, params,
                 engine: str, path_offset=0, n_valid=None,
                 interpret: bool = False):
    """(s_grid, state_grid, pay_sum, pay_sumsq) by either engine."""
    if engine == "pallas":
        return simulate_trajectories_kernel(
            payoff, cfg, key, params, path_offset=path_offset,
            n_valid=n_valid, interpret=interpret)
    return xla_trajectories(payoff, cfg, key, params,
                            path_offset=path_offset, n_valid=n_valid)


def xla_trajectories(payoff: PathPayoff, cfg: KernelConfig, key, params,
                     path_offset=0, n_valid=None):
    """XLA engine of `simulate_trajectories_kernel`: same draws, same
    grids, same (8, 128) fold and Kahan order."""
    if payoff.n_state > 1:
        raise ValueError("the trajectory engine stores one state array")
    p = unpack_params(params)
    k0 = jnp.asarray(key[0], jnp.uint32)
    k1 = jnp.asarray(key[1], jnp.uint32)
    offset = jnp.asarray(path_offset, jnp.uint32)
    bound = (offset + jnp.uint32(cfg.n_paths) if n_valid is None
             else jnp.asarray(n_valid, jnp.uint32))
    shape = (cfg.tile_rows, LANES)
    flat = tile_path_ids(0, shape)

    def one_tile(carry, i):
        acc, comp = carry
        ids = offset + jnp.uint32(i * cfg.paths_per_tile) + flat
        (s_t, s_hist, c_hist), state = _history_scan(payoff, cfg, p, k0,
                                                     k1, ids)
        pay = jnp.where(ids < bound, payoff.terminal(state, s_t, p), 0.0)
        for m, v in enumerate([pay, pay * pay]):
            acc, comp = kahan_xla_update(acc, comp, m,
                                         fold_to_sublanes(v, cfg.tile_rows))
        return (acc, comp), (s_hist, c_hist)

    zeros = (jnp.zeros((2, SUBLANES, LANES), jnp.float32)
             + jnp.float32(0) * offset.astype(jnp.float32))
    (acc, _), (s_tiles, c_tiles) = jax.lax.scan(
        one_tile, (zeros, zeros), jnp.arange(cfg.n_tiles, dtype=jnp.uint32))
    rows = cfg.n_tiles * cfg.tile_rows

    def to_grid(x):  # (n_tiles, n_steps, tile_rows, 128) -> step-major
        return jnp.moveaxis(x, 0, 1).reshape(cfg.n_steps, rows, LANES)

    return to_grid(s_tiles), to_grid(c_tiles), acc[0], acc[1]


def _history_scan(payoff, cfg, p, k0, k1, ids):
    """XLA form of `outer_tile_history`: a scan over Box-Muller pairs that
    stacks the per-step (S, state) history.  Returns ``((s_T, s_hist,
    c_hist), state_T)``."""
    shape = ids.shape
    rounds = getattr(cfg, "rng_rounds", rng.DEFAULT_ROUNDS)
    s0 = jnp.full(shape, p.s0, jnp.float32)
    state0 = payoff.init(p, jnp.zeros_like(s0))

    def one_step(w, state, z):
        w = w + (p.drift_dt + p.vol_dt * z)
        s = s0 * jnp.exp(w)  # log-space: one exp rounding per S_t
        return w, s, payoff.update(state, s, p)

    def keep(s, state):
        return state[0] if payoff.n_state else jnp.zeros_like(s)

    def pair_step(carry, m):
        w, s, state = carry
        z0, z1 = _tile_normals_threefry(k0, k1, ids, m, rounds=rounds)
        w, s1, st1 = one_step(w, state, z0)
        w, s2, st2 = one_step(w, st1, z1)
        return (w, s2, st2), (jnp.stack([s1, s2]),
                              jnp.stack([keep(s1, st1), keep(s2, st2)]))

    n_pairs = cfg.n_steps // 2
    (w, s_t, state), (s_hist, c_hist) = jax.lax.scan(
        pair_step, (jnp.zeros_like(s0), s0, state0),
        jnp.arange(n_pairs, dtype=jnp.uint32))
    s_hist = s_hist.reshape(2 * n_pairs, *shape)
    c_hist = c_hist.reshape(2 * n_pairs, *shape)
    if cfg.n_steps % 2:
        z0, _ = _tile_normals_threefry(k0, k1, ids, cfg.n_steps // 2,
                                       rounds=rounds)
        w, s_t, state = one_step(w, state, z0)
        s_hist = jnp.concatenate([s_hist, s_t[None]], axis=0)
        c_hist = jnp.concatenate([c_hist, keep(s_t, state)[None]], axis=0)
    return (s_t, s_hist, c_hist), state


# ---------------------------------------------------------------------------
# Paired terminal kernel: BOTH Box-Muller halves become paths.
#
# The classic terminal kernel (trajectories.cuh:74-75 analogue) burns one
# threefry + one full Box-Muller pair per path and discards z1.  Here
# element e carries paths (2e, 2e+1): one threefry + one Box-Muller pair
# prices TWO exact terminal draws, and the moment accumulators take
# per-path [pay_a + pay_b, pay_a^2 + pay_b^2] so the stderr stays exact.
# Terminal-only payoffs, counter-based RNG, no antithetic/CV/IS (those
# route through the classic kernel).
# ---------------------------------------------------------------------------


def _terminal_pair_vals(payoff, p, ids_e, bound_paths, z0, z1):
    """Per-element [sum, sumsq] of the two terminal-path payoffs."""

    def one(z, pid):
        s_t = p.s0 * jnp.exp(p.drift_t + p.vol_t * z)
        pay = payoff.terminal((), s_t, p)
        return jnp.where(pid < bound_paths, pay, 0.0)

    two = jnp.uint32(2)
    pa = one(z0, two * ids_e)
    pb = one(z1, two * ids_e + jnp.uint32(1))
    return [pa + pb, pa * pa + pb * pb]


def _make_terminal_pair_kernel(payoff: PathPayoff, cfg: KernelConfig):
    n_chunks = cfg.tile_rows // SUBLANES

    def kernel(key_ref, params_ref, meta_ref, parts):
        p = unpack_params(params_ref)
        i = pl.program_id(0)

        def chunk(c):
            ids_e = meta_ref[0] + tile_path_ids(i * cfg.tile_rows
                                                + c * SUBLANES)
            z0, z1 = _tile_normals_threefry(key_ref[0], key_ref[1], ids_e,
                                            0, rounds=cfg.rng_rounds)
            return _terminal_pair_vals(payoff, p, ids_e, meta_ref[1], z0, z1)

        for m, v in enumerate(_chunked_tile(n_chunks, chunk, 2)):
            parts[m, i] = v

    return kernel


@functools.partial(jax.jit, static_argnames=("payoff", "cfg", "engine",
                                             "interpret"))
def terminal_pair_partials(payoff: PathPayoff, cfg: KernelConfig, key,
                           params, n_paths_total: jnp.uint32,
                           engine: str = "xla", interpret: bool = False):
    """(sum, sumsq) (8,128) slabs over ``cfg.n_paths`` ELEMENTS (= two
    terminal paths each); ``n_paths_total`` masks the trailing odd path."""
    if engine not in ("pallas", "xla"):
        raise ValueError(f"unknown engine {engine!r}; use 'pallas' or "
                         "'xla'")
    bound = jnp.asarray(n_paths_total, jnp.uint32)
    if engine == "pallas":
        parts = triton_call(
            _make_terminal_pair_kernel(payoff, cfg),
            _partials_shape(2, cfg.n_tiles),
            grid=(cfg.n_tiles,), name="mc_terminal_pair",
            interpret=interpret)(jnp.asarray(key, jnp.uint32), params,
                                 jnp.stack([jnp.uint32(0), bound]))
        return tuple(kahan_tiles_kernel(parts, interpret))
    p = unpack_params(params)
    k0 = jnp.asarray(key[0], jnp.uint32)
    k1 = jnp.asarray(key[1], jnp.uint32)

    def tile_fn(ids_e, valid):
        del valid  # per-PATH masking happens inside (bound is in paths)
        z0, z1 = _tile_normals_threefry(k0, k1, ids_e, 0,
                                        rounds=cfg.rng_rounds)
        return _terminal_pair_vals(payoff, p, ids_e, bound, z0, z1)

    return xla_moment_scan(tile_fn, cfg.n_paths, cfg.tile_rows, 2)
