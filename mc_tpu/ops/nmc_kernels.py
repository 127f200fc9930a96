"""Nested Monte Carlo kernels (reference ``inc/nmc.cuh``, SURVEY.md C10-C12).

The reference prices the conditional expected payoff at EVERY point
``(outer path i, step t)`` of every outer bullet trajectory by launching
``N_PATHS_INNER`` inner trajectories that resume from the stored state
``(S_t, count_t)``.  Here:

* the outer trajectories are materialized to HBM first
  (`path_kernels.simulate_trajectories_kernel`, the reference's C9 pass,
  ``trajectories.cuh:273-351``);
* the inner kernel (C10) is a parallel ``(n_steps, n_tiles)`` grid: each
  program resumes one (step, path-tile) block of points, walking it in
  (8, 128) chunks.  All lanes of a program share ``remaining_steps``, so
  the inner step loop is uniform — no divergence;
* the reference's task-decomposed load balancing (C12) is left to the GPU's
  block scheduler within a device, and to sharding the outer-path axis over
  the device mesh across devices (parallel/nmc_sharded.py).

Inner RNG: an independent threefry stream (derive_key(seed, STREAM_INNER) —
the reference's seed 1235, ``wrappers.cuh:163``).  The counter for inner
draw pair ``q`` of inner path ``m`` resuming at step ``t`` of outer path
``i`` is ``(i, (t * n_inner + m) * pair_cap + q)`` — unique, static-shaped,
and independent of tiling/sharding.

The kernel and the XLA engine in mc_tpu/nmc.py call the same
`_nmc_point_tile` function, so they draw the same numbers.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from mc_tpu import rng
from mc_tpu.ops._pallas import (LANES, SUBLANES, cdiv, tile_path_ids,
                                triton_call)
from mc_tpu.ops.path_kernels import unpack_params
from mc_tpu.ops.payoffs import PathPayoff

__all__ = ["NMCConfig", "nmc_inner_kernel", "_nmc_point_tile"]


@dataclasses.dataclass(frozen=True)
class NMCConfig:
    n_paths: int              # outer paths
    n_steps: int
    n_inner: int              # inner paths per point (N_PATHS_INNER)
    tile_rows: int = 8
    discount: str = "full"    # "full": e^{-rT} like nmc.cuh:100; "remaining": e^{-r(T-t)}

    def __post_init__(self):
        if self.tile_rows % 8 or self.tile_rows < 8:
            raise ValueError("tile_rows must be a positive multiple of 8")
        # Inner draw counter = ((j+1)*n_inner + m)*pair_cap + q in uint32;
        # it must not wrap or inner streams would silently collide.
        span = self.n_steps * self.n_inner * ((self.n_steps + 1) // 2)
        if span >= 1 << 32:
            raise ValueError(
                "inner RNG counter space exhausted: n_steps * n_inner * "
                f"ceil(n_steps/2) = {span} >= 2^32; reduce n_steps or "
                "n_inner (or split the run across seeds)")

    @property
    def paths_per_tile(self) -> int:
        return self.tile_rows * LANES

    @property
    def n_tiles(self) -> int:
        return cdiv(self.n_paths, self.paths_per_tile)

    @property
    def pair_cap(self) -> int:
        """Counter stride per inner path: max Box-Muller pairs per resume."""
        return (self.n_steps + 1) // 2


def _simulate_resumed(payoff: PathPayoff, p, s_t, state_t, remaining,
                      draw_pair):
    """Run `remaining` (traced) log-Euler steps from (s_t, state_t).

    Two steps per threefry call; the trailing odd step is handled by a
    scalar-predicated select (uniform across the tile, so it costs one
    cheap vector select, not divergence).
    """
    n_pairs = (remaining + 1) // 2

    def body(q, carry):
        w, s, state = carry
        z0, z1 = draw_pair(q)
        w1 = w + (p.drift_dt + p.vol_dt * z0)
        s1 = s_t * jnp.exp(w1)  # log-space: one exp rounding per S
        st1 = payoff.update(state, s1, p)
        w2 = w1 + (p.drift_dt + p.vol_dt * z1)
        s2 = s_t * jnp.exp(w2)
        st2 = payoff.update(st1, s2, p)
        # Drop the second half-step when it overruns `remaining`.
        take2 = (2 * q + 1) < remaining
        w_out = jnp.where(take2, w2, w1)
        s_out = jnp.where(take2, s2, s1)
        st_out = tuple(jnp.where(take2, b, a) for a, b in zip(st1, st2))
        return (w_out, s_out, st_out)

    _, s_f, state_f = jax.lax.fori_loop(
        0, n_pairs, body, (jnp.zeros_like(s_t), s_t, state_t))
    return payoff.terminal(state_f, s_f, p)


def _nmc_point_tile(payoff: PathPayoff, cfg: NMCConfig, p, ki0, ki1, ids,
                    j, s_t, state_t):
    """Inner-MC estimate for one point tile: mean payoff over n_inner paths.

    ``j`` is the (traced) step index of the stored state (state after step
    j+1, as in trajectories.cuh:304-305); remaining = n_steps - j - 1.
    Returns the SUM over inner paths (Kahan-compensated f32); the caller
    divides by n_inner and discounts — exactly the reference's
    ``atomicAdd(sum) -> * exp(-rT)/N_INNER`` finish (nmc.cuh:100-104).
    """
    remaining = jnp.int32(cfg.n_steps) - j - 1
    # uint32 counter arithmetic: the config guard bounds the full span
    # below 2^32, so no silent wrap/stream collision is possible.
    t_base = ((jnp.asarray(j, jnp.uint32) + jnp.uint32(1))
              * jnp.uint32(cfg.n_inner))  # state is after step j+1

    def inner(m, carry):
        acc, comp = carry
        c1_base = ((t_base + jnp.asarray(m, jnp.uint32))
                   * jnp.uint32(cfg.pair_cap))

        def draw_pair(q):
            c1 = jnp.full(ids.shape, 0, jnp.uint32) + c1_base \
                + jnp.asarray(q, jnp.uint32)
            return rng.normal_pair(ki0, ki1, ids, c1)

        pay = _simulate_resumed(payoff, p, s_t, state_t, remaining,
                                draw_pair)
        y = pay - comp
        t = acc + y
        comp = (t - acc) - y
        return (t, comp)

    zero = jnp.zeros_like(s_t)
    acc, _ = jax.lax.fori_loop(0, cfg.n_inner, inner, (zero, zero))
    return acc


def _discount_factor(cfg: NMCConfig, p, j):
    """Per-point discount: reference parity is the full e^{-rT}."""
    if cfg.discount == "full":
        return jnp.exp(-p.r * p.t)
    # e^{-r (T - t_j)} with t_j = (j+1) dt — the financially-standard
    # conditional discount (the reference applies e^{-rT}, nmc.cuh:100).
    t_j = (j.astype(jnp.float32) + 1.0) * p.dt
    return jnp.exp(-p.r * (p.t - t_j))


def _make_inner_kernel(payoff: PathPayoff, cfg: NMCConfig):
    """Inner pass (C10): consume the HBM state grids, one (step, path-tile)
    block per program."""
    n_chunks = cfg.tile_rows // SUBLANES

    def kernel(ki_ref, params_ref, meta_ref, s_ref, c_ref, surf_ref):
        p = unpack_params(params_ref)
        t_idx = pl.program_id(0)
        i = pl.program_id(1)

        def chunk(c, carry):
            row0 = i * cfg.tile_rows + c * SUBLANES
            rows = pl.ds(row0, SUBLANES)
            ids = meta_ref[0] + tile_path_ids(row0)
            s_j = s_ref[t_idx, rows, :]
            st_j = (c_ref[t_idx, rows, :],) if payoff.n_state else ()
            inner_sum = _nmc_point_tile(payoff, cfg, p, ki_ref[0], ki_ref[1],
                                        ids, t_idx, s_j, st_j)
            v = inner_sum * (1.0 / cfg.n_inner) * _discount_factor(
                cfg, p, t_idx)
            surf_ref[t_idx, rows, :] = jnp.where(ids < meta_ref[1], v, 0.0)
            return carry

        jax.lax.fori_loop(0, n_chunks, chunk, 0)

    return kernel


@functools.partial(jax.jit, static_argnames=("payoff", "cfg", "interpret"))
def nmc_inner_kernel(payoff: PathPayoff, cfg: NMCConfig, key_inner, params,
                     s_grid, c_grid, path_offset=0, n_valid=None,
                     interpret: bool = False):
    """Two-stage NMC inner pass over materialized (s, state) HBM grids."""
    rows = cfg.n_tiles * cfg.tile_rows
    offset = jnp.asarray(path_offset, jnp.uint32)
    bound = (offset + jnp.uint32(cfg.n_paths) if n_valid is None
             else jnp.asarray(n_valid, jnp.uint32))
    return triton_call(
        _make_inner_kernel(payoff, cfg),
        jax.ShapeDtypeStruct((cfg.n_steps, rows, LANES), jnp.float32),
        grid=(cfg.n_steps, cfg.n_tiles), name="mc_nmc_inner",
        interpret=interpret)(jnp.asarray(key_inner, jnp.uint32), params,
                             jnp.stack([offset, bound]), s_grid, c_grid)
