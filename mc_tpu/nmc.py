"""Nested Monte Carlo engine: per-point conditional-expectation surfaces.

Public equivalent of the reference's three NMC wrappers
(``wrapper_gpu_bullet_option_nmc_one_point_one_block``,
``..._one_kernel``, ``..._optimal`` — ``inc/wrappers.cuh:128-340``):
for every point (outer path, step) of every outer trajectory, estimate the
conditional expected payoff by ``n_inner`` resumed inner paths, giving the
price surface used for Bermudan/exposure analysis.

* ``engine="pallas"`` (default on a GPU) — the C9 + C10 pipeline: the
  trajectory kernel materializes the outer (S, state) grids in HBM, then
  the inner kernel resumes every (step, path-tile) block in parallel.
* ``engine="xla"`` (default elsewhere) — the same draws through
  `_nmc_point_tile`, one outer tile at a time.

The reference's C12 "optimal" task decomposition balanced inner-path work
across SMs by hand; here the GPU's block scheduler balances the
(n_steps x n_tiles) programs, and the cross-device balance is by sharding
outer paths over the mesh (parallel/nmc_sharded.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import jax
import jax.numpy as jnp

from mc_tpu import rng
from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.engines import STREAM_INNER, STREAM_OUTER, _payoff_namespace
from mc_tpu.oracle import PriceResult, summarize
from mc_tpu.ops import nmc_kernels as nk
from mc_tpu.ops import path_kernels as pk
from mc_tpu.ops._pallas import LANES, resolve_engine, tile_path_ids
from mc_tpu.ops.payoffs import get_payoff
from mc_tpu.ops.reduce import finish_sum
from mc_tpu.xva import ExposureMetrics

__all__ = ["price_nmc", "NMCResult"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NMCResult(ExposureMetrics):
    """Price surface + outer estimate.

    ``surface[j]`` is the discounted inner-MC estimate of the conditional
    expected payoff given the state after step j+1, shaped
    (n_steps, rows, 128) step-major; ``outer`` the plain outer-path price
    (what the reference prints next to the surface mean,
    wrappers.cuh:185-190); ``surface_mean`` the mean over all
    n_paths*n_steps points (the reference's final "option price" output).
    """

    surface: Any
    outer: PriceResult
    surface_mean: Any
    n_points: Any
    t_horizon: Any = 1.0  # option maturity T (years); set by the pricers
    # outer MARKET-spot grid, same (n_steps, rows, 128) layout as the
    # value surface (both engines materialize it anyway)
    spot_surface: Any = None

    def surface_matrix(self):
        """(n_paths, n_steps) view (drops lane padding)."""
        n_steps, rows, lanes = self.surface.shape
        out = jnp.moveaxis(self.surface, 0, -1).reshape(rows * lanes, n_steps)
        return out[: int(self.outer.n_paths)]

    def spot_matrix(self):
        """(n_paths, n_steps) outer spot grid."""
        if self.spot_surface is None:
            raise ValueError(
                "this result carries no outer spot grid; price it with "
                "price_nmc for spot-linked metrics")
        n_steps, rows, lanes = self.spot_surface.shape
        out = jnp.moveaxis(self.spot_surface, 0, -1).reshape(
            rows * lanes, n_steps)
        return out[: int(self.outer.n_paths)]

    def cva_wwr_spot(self, hazard_rate: float, beta: float,
                     recovery: float = 0.4,
                     t_horizon: float | None = None):
        """CVA under SPOT-linked wrong-way risk: the default intensity
        rides each path's UNDERLYING level, lambda_i(t_j) = hazard *
        exp(beta * (S_ij / mean_i S_ij - 1)) (date-centered relative
        deviation, so beta=0 reproduces the flat-hazard `cva` exactly).

        This is the equity-desk WWR model: unlike the exposure-linked
        `cva_wwr` (which always loads the default weight onto high-
        exposure states), the SIGN of the effect flips with the
        position — beta > 0 (default likelier when the market rallies)
        RAISES a long call's CVA but LOWERS a long put's, the right-way
        case the exposure link cannot express.  Requires the outer spot
        grid `price_nmc` materializes."""
        from mc_tpu.xva import _grid_weights
        s = self.spot_matrix()
        v = self.surface_matrix()
        _, _, dt = _grid_weights(
            self.observation_dates(t_horizon, v.shape[1]))
        rel = s / jnp.mean(s, axis=0, keepdims=True) - 1.0
        lam = jnp.float32(hazard_rate) * jnp.exp(jnp.float32(beta) * rel)
        h = lam * dt
        cum = jnp.cumsum(h, axis=1)
        surv_prev = jnp.exp(-(cum - h))
        dpd = surv_prev * (1.0 - jnp.exp(-h))
        pos = jnp.maximum(v, 0.0)
        return (1.0 - jnp.float32(recovery)) * jnp.mean(
            jnp.sum(pos * dpd, axis=1))

    # exposure_profile / cva / dva / fva / ... come from ExposureMetrics
    # (uniform step-grid observation dates: the NMC surface observes at
    # t_j = j*T/n_steps).


def _xla_nmc(payoff, cfg: nk.NMCConfig, key_outer, key_inner, option,
             path_offset=0, n_valid=None):
    """XLA engine: per outer tile, the outer history then the inner sweep
    (same draws as the kernels, same Kahan order for the outer moments).
    Returns ``(surface, spot_grid, outer_sum, outer_sumsq)``."""
    p = _payoff_namespace(option, cfg.n_steps)
    ko0, ko1 = (jnp.asarray(key_outer[i], jnp.uint32) for i in (0, 1))
    ki0, ki1 = (jnp.asarray(key_inner[i], jnp.uint32) for i in (0, 1))
    shape = (cfg.tile_rows, LANES)
    flat = tile_path_ids(0, shape)
    offset = jnp.asarray(path_offset, jnp.uint32)
    bound = (offset + jnp.uint32(cfg.n_paths) if n_valid is None
             else jnp.asarray(n_valid, jnp.uint32))

    def one_tile(carry, i):
        acc, comp = carry
        ids = offset + jnp.uint32(i * cfg.paths_per_tile) + flat
        valid = ids < bound
        (s_t, s_hist, c_hist), state = pk._history_scan(
            payoff, cfg, p, ko0, ko1, ids)
        pay = jnp.where(valid, payoff.terminal(state, s_t, p), 0.0)
        for m, v in enumerate([pay, pay * pay]):
            acc, comp = pk.kahan_xla_update(
                acc, comp, m, pk.fold_to_sublanes(v, cfg.tile_rows))

        # Inner sweep per step.
        def step_fn(j):
            st_j = (c_hist[j],) if payoff.n_state else ()
            inner_sum = nk._nmc_point_tile(
                payoff, cfg, p, ki0, ki1, ids, j.astype(jnp.int32),
                s_hist[j], st_j)
            v = inner_sum * (1.0 / cfg.n_inner) * nk._discount_factor(
                cfg, p, j.astype(jnp.int32))
            return jnp.where(valid, v, 0.0)

        surf = jax.lax.map(step_fn, jnp.arange(cfg.n_steps))
        return (acc, comp), (surf, s_hist)

    zeros = (jnp.zeros((2, pk.SUBLANES, LANES), jnp.float32)
             + jnp.float32(0) * offset.astype(jnp.float32))
    (acc, _), (surfs, spots) = jax.lax.scan(
        one_tile, (zeros, zeros), jnp.arange(cfg.n_tiles, dtype=jnp.uint32))

    def to_grid(x):  # (n_tiles, n_steps, tile_rows, 128) -> step-major
        return jnp.moveaxis(x, 0, 1).reshape(
            cfg.n_steps, cfg.n_tiles * cfg.tile_rows, LANES)

    return to_grid(surfs), to_grid(spots), acc[0], acc[1]


def nmc_partials(payoff, cfg: nk.NMCConfig, engine, interpret, key_outer,
                 key_inner, params, option, path_offset=0, n_valid=None):
    """``(surface, spot_grid, outer_sum, outer_sumsq)`` by either engine."""
    if engine == "xla":
        return _xla_nmc(payoff, cfg, key_outer, key_inner, option,
                        path_offset=path_offset, n_valid=n_valid)
    kcfg = pk.KernelConfig(n_paths=cfg.n_paths, n_steps=cfg.n_steps,
                           tile_rows=cfg.tile_rows)
    s_grid, c_grid, osum, osq = pk.simulate_trajectories_kernel(
        payoff, kcfg, key_outer, params, path_offset=path_offset,
        n_valid=n_valid, interpret=interpret)
    surface = nk.nmc_inner_kernel(
        payoff, cfg, key_inner, params, s_grid, c_grid,
        path_offset=path_offset, n_valid=n_valid, interpret=interpret)
    return surface, s_grid, osum, osq


@functools.partial(
    jax.jit,
    static_argnames=("payoff", "sim", "engine", "tile_rows", "discount",
                     "interpret"))
def _price_nmc_impl(option, payoff, sim, engine, tile_rows, discount,
                    interpret, key_outer, key_inner):
    cfg = nk.NMCConfig(
        n_paths=sim.n_paths, n_steps=sim.n_steps, n_inner=sim.n_paths_inner,
        tile_rows=tile_rows, discount=discount)
    params = pk.pack_params(option, sim.n_steps)
    surface, spot, osum, osq = nmc_partials(
        payoff, cfg, engine, interpret, key_outer, key_inner, params, option)

    r = jnp.asarray(option.r, jnp.float32)
    t = jnp.asarray(option.t, r.dtype)
    outer = summarize(finish_sum(osum), finish_sum(osq),
                      jnp.asarray(sim.n_paths, jnp.float32),
                      jnp.exp(-r * t))
    n_points = sim.n_paths * sim.n_steps
    surface_mean = jnp.sum(surface, dtype=jnp.float32) / n_points
    return NMCResult(surface=surface, outer=outer,
                     surface_mean=surface_mean,
                     n_points=jnp.asarray(n_points, jnp.float32),
                     t_horizon=jnp.asarray(option.t, jnp.float32),
                     spot_surface=spot)


def price_nmc(option: OptionParams = DEMO_OPTION,
              sim: SimParams = DEMO_SIM,
              payoff="bullet_call",
              *,
              engine: Optional[str] = None,
              tile_rows: int = 8,
              discount: str = "full",
              stream_outer: int = STREAM_OUTER,
              stream_inner: int = STREAM_INNER,
              key_outer=None,
              key_inner=None,
              interpret: bool = False) -> NMCResult:
    """Nested Monte Carlo price surface.

    ``sim.n_paths_inner`` inner paths re-price every (path, step) point of
    every outer trajectory.  ``engine`` as in `price`.  A tile of
    ``tile_rows * 128`` outer paths at one step is one kernel program.
    """
    po = get_payoff(payoff)
    engine = resolve_engine(engine, interpret)
    if po.n_state > 1:
        raise ValueError("NMC supports payoffs with at most one state array")
    if key_outer is None:
        key_outer = jnp.asarray(rng.derive_key(sim.seed, stream_outer),
                                jnp.uint32)
    if key_inner is None:
        key_inner = jnp.asarray(rng.derive_key(sim.seed, stream_inner),
                                jnp.uint32)
    return _price_nmc_impl(option.as_f32(), po, sim.replace(seed=0), engine,
                           tile_rows, discount, interpret, key_outer,
                           key_inner)
