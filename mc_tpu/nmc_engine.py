"""Generic nested-Monte-Carlo engine over a model-family protocol.

The reference hand-writes one NMC scheduler per strategy for ONE model
(``/root/reference/inc/nmc.cuh:12-386``, GBM only).  Round 2 of this
framework generalized NMC to four model families — but by cloning the
whole grid-strategy skeleton per family (~300 LoC each).  This module is
the round-3 unification: ONE engine owning everything that is model-
independent, driven by a small per-family physics object:

- `NMCFamily` — the protocol.  A family subclass supplies parameter
  packing, the inner-leg step physics (resume carry + per-substep draw
  scheme + terminal value), its outer scan, and its discount
  conventions.  Instances are frozen/hashable so they ride through
  ``jax.jit`` as static arguments (per-call static specializations like
  Merton's Poisson scan depth live in ``extras``).
- `family_point_tile` — the shared inner-MC driver: the Kahan-compensated
  loop over ``n_inner`` legs with the C10 counter layout
  ``c_base = ((j+1)*n_inner + m) * stride`` (nmc.cuh:53-66 analogue).
- `_xla_nmc_family` — the shared engine: per outer tile, the family's
  outer scan, then the inner sweep over every step.
- `price_nmc_family` — the shared entry point: payoff/state validation,
  even-step and RNG-counter-span guards, per-family key derivation.

Adding family number N+1 is now a dynamics definition: subclass
`NMCFamily`, point it at the model's step function, and register it (see `nmc_cev.py` — under 100 lines).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict

import jax
import jax.numpy as jnp

from mc_tpu import rng
from mc_tpu.config import OptionParams, SimParams
from mc_tpu.nmc import NMCResult
from mc_tpu.oracle import summarize
from mc_tpu.ops import path_kernels as pk
from mc_tpu.ops._pallas import LANES, SUBLANES
from mc_tpu.ops.payoffs import PathPayoff, get_payoff
from mc_tpu.ops.reduce import finish_sum

__all__ = ["NMCFamily", "family_point_tile", "price_nmc_family",
           "price_nmc_family_sharded", "NMC_FAMILIES",
           "NMC_FAMILY_BUILDERS", "register_nmc_family"]

STREAM_OUTER, STREAM_INNER = 0, 1


@dataclasses.dataclass(frozen=True)
class NMCFamily:
    """Per-model-family physics consumed by the generic NMC engine.

    Subclasses override the class attributes and methods; ``extras``
    carries static per-call specializations (they participate in
    equality, so the jit cache keys on them correctly).
    """

    extras: tuple = ()

    # --- identity ------------------------------------------------------
    name = "?"
    tag = 0            # rng.derive_key stream tag (must match price_<m>)
    n_grids = 1        # market-state grids incl. S (heston 2, vasicek 3)
    even_steps = True  # pair-consuming outer loop -> n_steps % 2 == 0

    # --- entry guards --------------------------------------------------
    def span(self, n_steps: int, n_inner: int):
        """(max inner counter, formula description) for the wrap guard."""
        raise NotImplementedError

    # --- parameter packing --------------------------------------------
    def pack(self, option, dyn, n_steps: int):
        raise NotImplementedError

    def unpack(self, params):
        raise NotImplementedError

    def make_ctx(self, params, n_steps: int):
        """Optional per-kernel context built from the packed params
        (e.g. the local-vol surface lookup closure)."""
        return None

    # --- RNG layout ----------------------------------------------------
    def counter_stride(self, n_steps: int) -> int:
        """Counter budget per inner leg (uint32s of threefry pairs)."""
        return n_steps

    # --- physics -------------------------------------------------------
    def leg(self, payoff: PathPayoff, p, ctx, ki0, ki1, ids, c_base, j,
            remaining, grids_j, state_t, n_steps: int):
        """One inner leg resumed from the stored point state ``grids_j``:
        run ``remaining`` substeps and return the terminal payoff value
        (including any pathwise inner discount)."""
        raise NotImplementedError

    # --- discounting ---------------------------------------------------
    def point_scale(self, p, grids_j):
        """Per-point factor applied to the inner mean (reference parity:
        the full e^{-rT}, nmc.cuh:100-104; pathwise families override)."""
        return jnp.exp(-p.r * p.t)

    def outer_discount(self, p):
        """Discount used by the outer-path summarize."""
        return jnp.exp(-p.r * p.t)

    # --- outer grids ---------------------------------------------------
    def trajectories(self, payoff, cfg, key, params):
        """Materialize the outer state grids: returns
        ``(*market_grids, c_grid, outer_sum, outer_sq)`` step-major,
        built with the family's `xla_outer` scan."""
        return xla_family_trajectories(self, payoff, cfg, params, key)

    # --- outer-path physics --------------------------------------------
    # The ENGINE owns the outer loop (a lax.scan over blocks).
    # Families supply one BLOCK transition: ``outer_steps_per_block``
    # substeps advanced per call, matching the family's draw granularity
    # (1 for one-pair-per-step families, 2 for pair-consuming loops).

    outer_steps_per_block = 1

    def outer_init(self, p, ctx, s0, state0):
        """Initial outer carry for one path tile (must include the
        payoff state)."""
        raise NotImplementedError

    def outer_block(self, payoff, p, ctx, ids, ko0, ko1, carry, m):
        """Advance ``outer_steps_per_block`` substeps from block index
        ``m`` (traced uint32; outer draw counters derive from it).
        Returns ``(carry, recs)`` — recs a tuple of per-substep records,
        each record ``(*market_grid_rows, cv)``."""
        raise NotImplementedError

    def outer_pay(self, payoff, p, ctx, carry):
        """Terminal outer payoff value from the final carry (incl. any
        pathwise discount), unmasked."""
        raise NotImplementedError

    def xla_outer(self, payoff, p, ctx, ids, ko0, ko1, s0, state0,
                  n_steps: int):
        """Outer scan for one path tile built on the block hooks:
        returns ``(market_hists, c_hist, pay)`` with hists shaped
        (n_steps, *tile)."""
        spb = self.outer_steps_per_block

        def block(carry, m):
            carry, recs = self.outer_block(payoff, p, ctx, ids, ko0, ko1,
                                           carry, m)
            if spb == 1:
                return carry, recs[0]
            return carry, tuple(jnp.stack(cols) for cols in zip(*recs))

        carry, ys = jax.lax.scan(
            block, self.outer_init(p, ctx, s0, state0),
            jnp.arange(n_steps // spb, dtype=jnp.uint32))
        ys = tuple(y.reshape((n_steps,) + s0.shape) for y in ys)
        return ys[:-1], ys[-1], self.outer_pay(payoff, p, ctx, carry)

    # --- Andersen-Broadie rollout hooks (lsmc.american_bounds) ---------
    # Rollouts are FRESH estimators on their own stream (no bitwise
    # contract with the pricing legs), so every family shares one
    # uniform counter layout: substep u of branch b draws pairs
    # (b*n_steps + u)*rollout_pairs_per_step + q.

    rollout_pairs_per_step = 1

    def rollout_carry(self, p, ctx, grids_j):
        """Rollout state from the stored flat-grid rows at one date."""
        raise NotImplementedError

    def rollout_step(self, p, ctx, carry, d, u):
        """Advance one substep; ``d`` supplies draws (d.pair/d.unit/
        d.normal1), ``u`` is the DATE the step leaves (its move has
        index u+1 — surface families index their curves by it).
        Returns ``(carry, step_df)`` — the one-step discount factor
        (scalar families: e^{-r dt}; pathwise families: e^{-dy})."""
        raise NotImplementedError

    def rollout_spot(self, p, ctx, carry):
        """Payoff-visible price at the current rollout state."""
        raise NotImplementedError

    # Optional MLMC hook.  None -> the generic (z1+z2)/sqrt(2)
    # draws-combining shim couples the coarse leg (exact for plain
    # per-step Gaussian drivers).  Families with non-Gaussian drivers
    # override with signature (p_f, p_c, ctx_c, carry, d1, d2, u) ->
    # (carry, step_df): ONE coarse step consuming BOTH fine substeps'
    # draw objects, coupled at the increment level (see MertonNMC).
    mlmc_coarse_step = None

    def rollout_t0(self, p):
        """Date-0 market state in grid-row layout (the dual's t=0
        transition anchor)."""
        return (p.s0,)

    def ab_grid_df(self, p, gs, t):
        """Discount-to-0 factor of grid row ``t`` on the dual's outer
        set (scalar default e^{-r dt (t+1)}; pathwise families read
        their stored integrated-rate grid)."""
        return jnp.exp(-p.r * p.dt) ** (jnp.float32(t) + 1.0)

    def lsmc_basis_point(self, p, carry, s, degree: int, inv_k):
        """Continuation-basis row at the CURRENT rollout state (default:
        the S/K monomials; stochastic-state families add regressors)."""
        from mc_tpu.lsmc import _basis
        return _basis(s * inv_k, degree)

    # --- LSMC hooks (generic Longstaff-Schwartz client, lsmc.py) -------
    def lsmc_level(self, p, grids_flat):
        """Exercise-level grid the payoff reads during the backward
        induction (default: the first market grid; multi-asset families
        fold their weighted sum / order statistic)."""
        return grids_flat[0]

    def lsmc_design(self, p, grids_flat, degree: int, inv_k):
        """(design_fn(t) | None, n_basis) continuation regressors from
        the family's flattened market grids.  Default: the S/K monomial
        basis (families Markov in S); stochastic-state families augment
        with their extra regressors."""
        return None, degree + 1

    def lsmc_discount(self, p, grids_flat):
        """(disc, disc_fn | None, disc0): per-step discount for the
        backward induction and the date-0 factor applied to the final
        cashflows.  Default: the scalar e^{-r dt}; pathwise-discounting
        families return per-path factors from their grids."""
        d = jnp.exp(-p.r * p.dt)
        return d, None, d


def family_point_tile(fam: NMCFamily, payoff: PathPayoff, n_steps: int,
                      n_inner: int, p, ctx, ki0, ki1, ids, j, grids_j,
                      state_t):
    """Inner-MC payoff SUM over n_inner legs resumed from one
    (path-tile, step j) point; the caller divides and discounts.

    The Kahan-compensated accumulation order is part of the bitwise
    engine-parity contract — do not reorder.
    """
    remaining = jnp.int32(n_steps) - j - 1
    t_base = ((jnp.asarray(j, jnp.uint32) + jnp.uint32(1))
              * jnp.uint32(n_inner))
    stride = jnp.uint32(fam.counter_stride(n_steps))

    def inner(m, carry):
        acc, comp = carry
        c_base = (t_base + jnp.asarray(m, jnp.uint32)) * stride
        pay = fam.leg(payoff, p, ctx, ki0, ki1, ids, c_base, j, remaining,
                      grids_j, state_t, n_steps)
        y = pay - comp
        t = acc + y
        comp = (t - acc) - y
        return (t, comp)

    zeros = jnp.zeros_like(grids_j[0])
    acc, _ = jax.lax.fori_loop(0, n_inner, inner, (zeros, zeros))
    return acc


def xla_family_trajectories(fam, payoff, cfg, params, key_outer,
                            path_offset=0, n_valid=None):
    """Step-major outer state grids + outer moment slabs via the family's
    XLA outer scan (the C9 materialization, trajectories.cuh:273-351
    analogue).  ``path_offset``/``n_valid``: this shard's global path-id
    range (multi-chip sharding keys the streams by GLOBAL id)."""
    p = fam.unpack(params)
    ctx = fam.make_ctx(params, cfg.n_steps)
    n = cfg.n_steps
    ko0, ko1 = (jnp.asarray(key_outer[i], jnp.uint32) for i in (0, 1))
    shape = (cfg.tile_rows, LANES)
    flat = (jax.lax.broadcasted_iota(jnp.uint32, shape, 0) * LANES
            + jax.lax.broadcasted_iota(jnp.uint32, shape, 1))
    per_tile = cfg.tile_rows * LANES
    n_tiles = cfg.n_tiles
    offset = jnp.asarray(path_offset, jnp.uint32)
    bound = (offset + jnp.uint32(cfg.n_paths) if n_valid is None
             else jnp.asarray(n_valid, jnp.uint32))

    def one_tile(carry, i):
        acc, comp = carry
        ids = offset + jnp.uint32(i * per_tile) + flat
        valid = ids < bound
        s0 = jnp.full(shape, p.s0, jnp.float32)
        state0 = payoff.init(p, jnp.zeros_like(s0))
        hists, c_hist, pay = fam.xla_outer(payoff, p, ctx, ids, ko0, ko1,
                                           s0, state0, n)
        pay = jnp.where(valid, pay, 0.0)
        for m, val in enumerate([pay, pay * pay]):
            acc, comp = pk.kahan_xla_update(
                acc, comp, m, pk.fold_to_sublanes(val, cfg.tile_rows))
        return (acc, comp), hists + (c_hist,)

    zeros = jnp.zeros((2, SUBLANES, LANES), jnp.float32)
    (acc, _), stacked = jax.lax.scan(
        one_tile, (zeros, zeros), jnp.arange(n_tiles, dtype=jnp.uint32))

    def to_grid(h):  # (n_tiles, n_steps, tile, LANES) -> step-major
        return jnp.moveaxis(h, 0, 1).reshape(
            n, n_tiles * cfg.tile_rows, LANES)

    grids = tuple(to_grid(h) for h in stacked)
    return (*grids, acc[0], acc[1])


def _xla_nmc_family(fam, payoff, sim, params, key_outer, key_inner,
                    tile_rows, path_offset=0, n_valid=None):
    """The family NMC engine: per outer tile, the outer scan then the
    inner sweep.  Returns ``(surface, spot_grid, outer_sum, outer_sq)``."""
    p = fam.unpack(params)
    ctx = fam.make_ctx(params, sim.n_steps)
    n = sim.n_steps
    ko0, ko1 = (jnp.asarray(key_outer[i], jnp.uint32) for i in (0, 1))
    ki0, ki1 = (jnp.asarray(key_inner[i], jnp.uint32) for i in (0, 1))
    shape = (tile_rows, LANES)
    flat = (jax.lax.broadcasted_iota(jnp.uint32, shape, 0) * LANES
            + jax.lax.broadcasted_iota(jnp.uint32, shape, 1))
    per_tile = tile_rows * LANES
    n_tiles = -(-sim.n_paths // per_tile)
    offset = jnp.asarray(path_offset, jnp.uint32)
    bound = (offset + jnp.uint32(sim.n_paths) if n_valid is None
             else jnp.asarray(n_valid, jnp.uint32))

    def one_tile(carry, i):
        acc, comp = carry
        ids = offset + jnp.uint32(i * per_tile) + flat
        valid = ids < bound
        s0 = jnp.full(shape, p.s0, jnp.float32)
        state0 = payoff.init(p, jnp.zeros_like(s0))
        hists, c_hist, pay = fam.xla_outer(payoff, p, ctx, ids, ko0, ko1,
                                           s0, state0, n)
        pay = jnp.where(valid, pay, 0.0)
        for m, val in enumerate([pay, pay * pay]):
            acc, comp = pk.kahan_xla_update(
                acc, comp, m, pk.fold_to_sublanes(val, tile_rows))

        def step_fn(j):
            st_j = (c_hist[j],) if payoff.n_state else ()
            grids_j = tuple(h[j] for h in hists)
            inner_sum = family_point_tile(
                fam, payoff, n, sim.n_paths_inner, p, ctx, ki0, ki1, ids,
                j.astype(jnp.int32), grids_j, st_j)
            val = (inner_sum * (1.0 / sim.n_paths_inner)
                   * fam.point_scale(p, grids_j))
            return jnp.where(valid, val, 0.0)

        surf = jax.lax.map(step_fn, jnp.arange(n))
        return (acc, comp), (surf, hists[0])

    zeros = jnp.zeros((2, SUBLANES, LANES), jnp.float32)
    (acc, _), (surfs, spots) = jax.lax.scan(
        one_tile, (zeros, zeros), jnp.arange(n_tiles, dtype=jnp.uint32))

    def to_grid(h):  # (n_tiles, n_steps, tile, LANES) -> step-major
        return jnp.moveaxis(h, 0, 1).reshape(n, n_tiles * tile_rows, LANES)

    return to_grid(surfs), to_grid(spots), acc[0], acc[1]


@functools.partial(
    jax.jit, static_argnames=("fam", "payoff", "sim", "tile_rows"))
def _price_nmc_family_impl(fam, option, dyn, payoff, sim, tile_rows,
                           key_outer, key_inner):
    params = fam.pack(option, dyn, sim.n_steps)
    p = fam.unpack(params)
    surface, spot, osum, osq = _xla_nmc_family(
        fam, payoff, sim, params, key_outer, key_inner, tile_rows)
    outer = summarize(finish_sum(osum), finish_sum(osq),
                      jnp.asarray(sim.n_paths, jnp.float32),
                      fam.outer_discount(p))
    n_points = sim.n_paths * sim.n_steps
    surface_mean = jnp.sum(surface, dtype=jnp.float32) / n_points
    return NMCResult(surface=surface, outer=outer,
                     surface_mean=surface_mean,
                     n_points=jnp.asarray(n_points, jnp.float32),
                     t_horizon=jnp.asarray(option.t, jnp.float32),
                     spot_surface=spot)


def _validate_and_keys(fam, sim, payoff, stream_outer, stream_inner):
    """Entry guards + per-family key derivation shared by the
    single-chip and sharded entry points."""
    po = get_payoff(payoff) if isinstance(payoff, str) else payoff
    if po.n_state > 1:
        raise ValueError("NMC supports payoffs with at most one state "
                         "array")
    if fam.even_steps and sim.n_steps % 2:
        raise ValueError(f"{fam.name} requires an even n_steps "
                         "(pair-consuming outer loop)")
    span, desc = fam.span(sim.n_steps, sim.n_paths_inner)
    if span >= 1 << 32:
        raise ValueError(
            f"inner RNG counter space exhausted: {desc} = "
            f"{span} >= 2^32; reduce n_steps or n_paths_inner")
    key_outer = jnp.asarray(
        rng.derive_key(sim.seed, stream_outer, fam.tag), jnp.uint32)
    key_inner = jnp.asarray(
        rng.derive_key(sim.seed, stream_inner, fam.tag), jnp.uint32)
    return po, key_outer, key_inner


def price_nmc_family(fam: NMCFamily,
                     option: OptionParams,
                     dyn,
                     sim: SimParams,
                     payoff="vanilla_call",
                     *,
                     tile_rows: int = 8,
                     stream_outer: int = STREAM_OUTER,
                     stream_inner: int = STREAM_INNER) -> NMCResult:
    """Shared NMC entry point: validation, guards, key derivation."""
    po, key_outer, key_inner = _validate_and_keys(
        fam, sim, payoff, stream_outer, stream_inner)
    return _price_nmc_family_impl(fam, option.as_f32(), dyn, po,
                                  sim.replace(seed=0), tile_rows, key_outer,
                                  key_inner)


# name -> price_nmc_<model> callable; populated by the family modules at
# import (single source for the CLI's `nmc --model` dispatch).
# NMC_FAMILY_BUILDERS: name -> builder(option, dyn, sim) -> (fam, dyn32)
# for the generic sharded/greeks consumers.
NMC_FAMILIES: Dict[str, Callable[..., Any]] = {}
NMC_FAMILY_BUILDERS: Dict[str, Callable[..., Any]] = {}


def register_nmc_family(name: str, price_fn, builder=None) -> None:
    NMC_FAMILIES[name] = price_fn
    if builder is not None:
        NMC_FAMILY_BUILDERS[name] = builder


# name -> defining module, for lazy registration (families register on
# import; consumers that dispatch by NAME call ensure_family first).
FAMILY_MODULES = {"heston": "mc_tpu.nmc_heston",
                  "bates": "mc_tpu.nmc_bates",
                  "merton": "mc_tpu.nmc_merton",
                  "cev": "mc_tpu.nmc_cev",
                  "localvol": "mc_tpu.nmc_localvol",
                  "sabr": "mc_tpu.nmc_sabr",
                  "vasicek": "mc_tpu.nmc_vasicek",
                  "basket": "mc_tpu.nmc_basket",
                  "rainbow": "mc_tpu.nmc_rainbow",
                  "term": "mc_tpu.nmc_term"}


def ensure_family(name: str) -> None:
    """Import the module that registers family ``name`` (idempotent)."""
    import importlib
    if name not in FAMILY_MODULES:
        raise ValueError(f"unknown model family {name!r}; available: "
                         f"{sorted(FAMILY_MODULES)}")
    importlib.import_module(FAMILY_MODULES[name])


# ---------------------------------------------------------------------------
# Multi-device family NMC: outer paths sharded over the mesh.  The engine's
# path-offset plumbing keys every stream by GLOBAL path id, so the result
# is mesh-size invariant and a 1-device mesh is bitwise-identical to the
# single-device engine.  The surface comes back sharded along the path
# axis — the layout a downstream exposure pipeline wants.
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("fam", "payoff", "sim", "mesh", "tile_rows"))
def _nmc_family_sharded_impl(fam, option, dyn, payoff, sim, mesh, tile_rows,
                             key_outer, key_inner):
    from jax.sharding import PartitionSpec as P

    from mc_tpu.parallel.mesh import PATHS_AXIS, shard_bounds

    n_shards = mesh.devices.size
    n_local = shard_bounds(sim.n_paths, n_shards, tile_rows)
    params = fam.pack(option, dyn, sim.n_steps)
    p = fam.unpack(params)
    sim_local = sim.replace(n_paths=n_local)
    n_total = jnp.uint32(sim.n_paths)

    def shard_fn(ko, ki, params, n_total):
        rank = jax.lax.axis_index(PATHS_AXIS).astype(jnp.uint32)
        offset = rank * jnp.uint32(n_local)
        surf, _, osum, osq = _xla_nmc_family(
            fam, payoff, sim_local, params, ko, ki, tile_rows,
            path_offset=offset, n_valid=n_total)
        osum = jax.lax.psum(osum, PATHS_AXIS)
        osq = jax.lax.psum(osq, PATHS_AXIS)
        ssum = jax.lax.psum(jnp.sum(surf, dtype=jnp.float32), PATHS_AXIS)
        return surf, osum, osq, ssum

    surf, osum, osq, ssum = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P(None, PATHS_AXIS, None), P(), P(), P()),
        check_vma=False,
    )(key_outer, key_inner, params, n_total)

    outer = summarize(finish_sum(osum), finish_sum(osq),
                      jnp.asarray(sim.n_paths, jnp.float32),
                      fam.outer_discount(p))
    n_points = sim.n_paths * sim.n_steps
    return NMCResult(surface=surf, outer=outer,
                     surface_mean=ssum / n_points,
                     n_points=jnp.asarray(n_points, jnp.float32),
                     t_horizon=jnp.asarray(option.t, jnp.float32))


def price_nmc_family_sharded(fam: NMCFamily, option, dyn, sim, payoff,
                             *,
                             mesh=None,
                             tile_rows: int = 8,
                             stream_outer: int = STREAM_OUTER,
                             stream_inner: int = STREAM_INNER) -> NMCResult:
    """Family NMC with outer paths sharded across the mesh (validation +
    keys shared with the single-device entry)."""
    from mc_tpu.parallel.mesh import make_mesh

    po, key_outer, key_inner = _validate_and_keys(
        fam, sim, payoff, stream_outer, stream_inner)
    mesh = mesh if mesh is not None else make_mesh()
    return _nmc_family_sharded_impl(fam, option.as_f32(), dyn, po,
                                    sim.replace(seed=0), mesh, tile_rows,
                                    key_outer, key_inner)
