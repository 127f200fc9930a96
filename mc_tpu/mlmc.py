"""Multilevel Monte Carlo for biased discretizations (Giles 2008).

GBM needs no MLMC here (the log-Euler scheme is exact in distribution),
but the Heston full-truncation Euler scheme carries O(dt) weak bias —
exactly the setting multilevel was built for: write

    E[P_L] = E[P_0] + sum_l E[P_l - P_{l-1}]

with level l using ``n0 * 2^l`` integration substeps, and estimate each
correction with COUPLED paths: the coarse path consumes the pairwise sums
of the fine path's Brownian increments (z_c = (z_{2k} + z_{2k+1})/sqrt(2)
for both the variance and the orthogonal factor), so Var[P_l - P_{l-1}]
decays ~ O(dt_l) while a single-level estimator would pay the finest
cost at full variance.  Total cost to RMS accuracy eps drops from
O(eps^-3) to O(eps^-2 log^2 eps).

Level sample counts follow the standard allocation
N_l ~ sqrt(V_l / C_l) * sum(sqrt(V_l C_l)) / eps^2, estimated from pilot
runs.  The estimator runs through the jitted XLA engine (XLA fuses the
per-level coupled step loop, the same step loop the other engines use).
"""

from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace
from typing import Any, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mc_tpu import rng
from mc_tpu.config import DEMO_OPTION, OptionParams
from mc_tpu.models.heston import (DEMO_HESTON, HestonDynamics, _pack_heston,
                                  _unpack_heston, heston_euler_step)
from mc_tpu.ops._pallas import LANES, round_up, xla_moment_scan
from mc_tpu.ops.payoffs import get_payoff
from mc_tpu.ops.reduce import finish_sum

__all__ = ["price_heston_mlmc", "price_mlmc_family", "MLMCResult",
           "heston_level_moments", "family_level_moments",
           "family_level_moments_sharded"]

# Path-dependent payoffs whose functional refines with the grid (each
# level prices a finer discretization of the SAME continuous contract) —
# Giles 2008's Asian/lookback setting.  Step-grid-defined contracts
# (bullet window, discrete knock-out count) are rejected.
_MLMC_PATH_OK = {"asian_call", "lookback_call", "up_out_call",
                 "down_in_call"}


def _coupled_level_tile(payoff, p, ids, valid, k0, k1, n_fine: int,
                        coupled: bool):
    """(P_fine - P_coarse) payoff tile with pairwise-coupled increments.

    Fine path: n_fine substeps.  Coarse path: n_fine/2 substeps driven by
    z_c = (z_{2k} + z_{2k+1}) / sqrt(2) — the same Brownian path seen at
    half resolution.  For level 0 (coupled=False) only the fine path runs;
    an odd n_fine there gets an epilogue substep so e.g. n0=1 integrates
    the full horizon instead of silently taking zero steps.

    Path-dependent payoffs (Asian mean, lookback max — Giles's original
    test cases) are supported: each leg carries its own payoff state,
    updated on ITS OWN grid, and evaluates the level's discretization of
    the continuous functional (per-leg dt / inv_n_steps in the params
    namespace).  Level-DEFINED contracts (the bullet's step-count window)
    are not grid-refinable and are rejected upstream.
    """
    if coupled and n_fine % 2:
        raise ValueError(
            f"coupled MLMC level needs an even substep count, got {n_fine}")
    if n_fine < 1:
        raise ValueError(f"n_fine must be >= 1, got {n_fine}")
    shape = ids.shape
    dt_f = p.t / jnp.float32(n_fine)
    sq_f = jnp.sqrt(dt_f)
    dt_c = dt_f * 2.0
    sq_c = jnp.sqrt(dt_c)
    inv_sqrt2 = jnp.float32(0.7071067811865476)
    track_state = payoff.n_state > 0
    pf = SimpleNamespace(**{**p.__dict__, "dt": dt_f,
                            "inv_n_steps": 1.0 / n_fine})
    pc = SimpleNamespace(**{**p.__dict__, "dt": dt_c,
                            "inv_n_steps": 2.0 / max(n_fine, 2)})

    def draw(j):
        c1 = jnp.full(shape, 0, jnp.uint32) + jnp.asarray(j, jnp.uint32)
        return rng.normal_pair(k0, k1, ids, c1)

    zero = jnp.zeros(shape, jnp.float32)
    v0 = jnp.full(shape, p.v0, jnp.float32)
    st_f0 = payoff.init(pf, zero)
    st_c0 = payoff.init(pc, zero)

    def fine_sub(wf, vf, st_f, z_v, z_p):
        wf, vf = heston_euler_step(p, wf, vf, z_v, z_p, dt_f, sq_f)
        if track_state:
            st_f = payoff.update(st_f, p.s0 * jnp.exp(wf), pf)
        return wf, vf, st_f

    def body(k, carry):
        wf, vf, wc, vc, st_f, st_c = carry
        z_v0, z_p0 = draw(2 * k)
        z_v1, z_p1 = draw(2 * k + 1)
        wf, vf, st_f = fine_sub(wf, vf, st_f, z_v0, z_p0)
        wf, vf, st_f = fine_sub(wf, vf, st_f, z_v1, z_p1)
        if coupled:
            zc_v = (z_v0 + z_v1) * inv_sqrt2
            zc_p = (z_p0 + z_p1) * inv_sqrt2
            wc, vc = heston_euler_step(p, wc, vc, zc_v, zc_p, dt_c, sq_c)
            if track_state:
                st_c = payoff.update(st_c, p.s0 * jnp.exp(wc), pc)
        return (wf, vf, wc, vc, st_f, st_c)

    wf, vf, wc, vc, st_f, st_c = jax.lax.fori_loop(
        0, n_fine // 2, body, (zero, v0, zero, v0, st_f0, st_c0))
    if n_fine % 2:
        # uncoupled odd tail: the pair loop covered draws 0..n_fine-2
        z_v, z_p = draw(n_fine - 1)
        wf, vf, st_f = fine_sub(wf, vf, st_f, z_v, z_p)
    s_f = p.s0 * jnp.exp(wf)
    pay = payoff.terminal(st_f, s_f, pf)
    if coupled:
        s_c = p.s0 * jnp.exp(wc)
        pay = pay - payoff.terminal(st_c, s_c, pc)
    return jnp.where(valid, pay, 0.0)


@functools.partial(
    jax.jit,
    static_argnames=("payoff", "n_paths", "n_fine", "coupled", "tile_rows"))
def heston_level_moments(option, heston, payoff, n_paths, n_fine, coupled,
                         tile_rows, key, path_offset=0):
    """(sum Y, sum Y^2) of the level-l correction over paths
    [path_offset, path_offset + n_paths)."""
    p = _unpack_heston(_pack_heston_ns(option, heston))
    k0 = jnp.asarray(key[0], jnp.uint32)
    k1 = jnp.asarray(key[1], jnp.uint32)
    offset = jnp.asarray(path_offset, jnp.uint32)

    def tile_fn(ids, valid):
        pay = _coupled_level_tile(payoff, p, ids, valid, k0, k1, n_fine,
                                  coupled)
        return [pay, pay * pay]

    s, sq = xla_moment_scan(tile_fn, n_paths, tile_rows, 2, offset=offset,
                            bound=offset + jnp.uint32(n_paths))
    return finish_sum(s), finish_sum(sq)


def _pack_heston_ns(option, heston):
    # reuse the heston param vector (n_steps irrelevant for the namespace
    # fields the coupled stepper uses; dt/sqrt_dt recomputed per level)
    return _pack_heston(option, heston, 1)


def _mlmc_schedule(level_sums, fines, n_pilot, eps, n_per_level,
                   tile_rows):
    """Giles's pilot/allocate/top-up schedule, estimator-agnostic.

    ``level_sums(l, n, path_offset)`` returns (sum Y, sum Y^2, n) of the
    level-l correction over n paths at the given global path offset.
    Pilot sums are KEPT and merged; top-up paths continue the SAME
    stream at a shifted offset (disjoint counter range).  Returns
    (means, varis, ns) per level.
    """
    n_levels = len(fines)
    n_pilot = round_up(max(n_pilot, 1024), tile_rows * LANES)
    pilot = [level_sums(l, n_pilot) for l in range(n_levels)]
    v_l = np.array([max(sq / n - (s / n) ** 2, 0.0)
                    for s, sq, n in pilot])
    c_l = np.array([fines[l] for l in range(n_levels)], float)

    if n_per_level is None:
        if eps is None:
            eps = 2e-3
        lam = np.sum(np.sqrt(v_l * c_l)) / (eps * eps / 2.0)
        n_l = np.maximum(np.ceil(lam * np.sqrt(v_l / c_l)), n_pilot)
    else:
        n_l = np.asarray(n_per_level, float)

    means, varis, ns = [], [], []
    for l in range(n_levels):
        s0_, sq0, n0_ = pilot[l]
        s1, sq1, n1 = level_sums(l, int(n_l[l]) - n0_, path_offset=n0_)
        s, sq, n = s0_ + s1, sq0 + sq1, n0_ + n1
        mean = s / n
        means.append(mean)
        varis.append(max(sq / n - mean * mean, 0.0))
        ns.append(n)
    return means, varis, ns


@dataclasses.dataclass(frozen=True)
class MLMCResult:
    price: Any
    stderr: Any
    levels: tuple            # n_fine per level
    n_per_level: tuple
    level_means: tuple
    level_vars: tuple

    def variance_decay_rate(self) -> float:
        """Fitted beta in Var[Y_l] ~ 2^{-beta l} over the coupled levels."""
        v = np.asarray(self.level_vars[1:], np.float64)
        ell = np.arange(1, len(self.level_vars))
        mask = v > 0
        if mask.sum() < 2:
            return float("nan")
        slope = np.polyfit(ell[mask], np.log2(v[mask]), 1)[0]
        return float(-slope)


def price_heston_mlmc(option: OptionParams = DEMO_OPTION,
                      heston: HestonDynamics = DEMO_HESTON,
                      payoff="vanilla_call",
                      *,
                      n0: int = 4,
                      n_levels: int = 5,
                      n_pilot: int = 20_000,
                      eps: Optional[float] = None,
                      n_per_level: Optional[Sequence[int]] = None,
                      tile_rows: int = 64,
                      seed: int = 1234) -> MLMCResult:
    """Multilevel Heston price to target RMS accuracy ``eps``.

    Level l integrates with ``n0 * 2^l`` substeps; pilot runs estimate
    (V_l, C_l) and the standard allocation sizes N_l (overridable with
    ``n_per_level``).  Each level uses an independent threefry stream.
    """
    po = get_payoff(payoff)
    if not (po.terminal_only or po.name in _MLMC_PATH_OK):
        raise ValueError(
            f"MLMC supports terminal payoffs and the grid-refinable "
            f"path functionals {sorted(_MLMC_PATH_OK)}; {po.name!r} is "
            "defined by the step grid itself (e.g. a step-count window) "
            "so the levels would price different contracts")
    if n0 < 1:
        raise ValueError(f"n0 must be >= 1, got {n0}")
    opt32 = option.as_f32()
    hes32 = heston.as_f32()
    fines = tuple(n0 * (1 << l) for l in range(n_levels))
    keys = [jnp.asarray(rng.derive_key(seed, 0x4D4C, l), jnp.uint32)
            for l in range(n_levels)]

    def level_sums(l, n, path_offset=0):
        """(sum, sumsq, n) over n paths starting at path_offset."""
        n = round_up(max(n, 0), tile_rows * LANES)
        if n == 0:
            return 0.0, 0.0, 0
        s, sq = heston_level_moments(opt32, hes32, po, n, fines[l], l > 0,
                                     tile_rows, keys[l],
                                     jnp.uint32(path_offset))
        return float(s), float(sq), n

    means, varis, ns = _mlmc_schedule(level_sums, fines, n_pilot, eps,
                                      n_per_level, tile_rows)
    disc = float(np.exp(-float(opt32.r) * float(opt32.t)))
    price = disc * sum(means)
    stderr = disc * float(np.sqrt(sum(v / n for v, n in zip(varis, ns))))
    return MLMCResult(price=price, stderr=stderr, levels=fines,
                      n_per_level=tuple(ns), level_means=tuple(means),
                      level_vars=tuple(varis))


# ---------------------------------------------------------------------------
# Generic multilevel over the NMCFamily rollout hooks: MLMC for ANY
# Gaussian-driven family is just its dynamics definition (the same
# protocol the NMC/LSMC/AB engines consume — nmc_engine.NMCFamily).
#
# Level l packs the family's params at n0*2^l substeps (dt, sqrt_dt etc.
# are baked in by `fam.pack`, so each leg steps its OWN grid with the
# family's exact scheme), and the coarse leg consumes the pairwise sums
# z_c = (z_{2k} + z_{2k+1})/sqrt(2) of the fine leg's draws through a
# draws-combining shim.  Unbiasedness needs NO coupling-quality
# assumption: the coarse leg at level l is driven by iid standard
# normals, so its law equals the fine leg of level l-1 and the telescope
# is exact; coupling quality only affects the variance-decay rate
# (measured, `MLMCResult.variance_decay_rate`).
#
# Discounting rides the rollout: per-step factors from `rollout_step`
# accumulate multiplicatively per leg, so stochastic-rate families
# (vasicek) discount pathwise-exactly and constant-rate families
# reproduce e^{-rT} up to fp.  Prices are therefore already discounted
# (unlike `price_heston_mlmc`'s host-side discount).
# ---------------------------------------------------------------------------

# Families whose drivers are not plain per-step Gaussians, or whose
# dynamics OBJECT is defined on the simulation grid itself (refining the
# grid would change the specified model, not just its discretization).
_MLMC_EXCLUDED = {
    "localvol": "the sigma(x, t) surface is specified per sim step; "
                "refining the grid changes the model itself",
    "term": "per-step rate/vol curves are specified on the sim grid",
    "rainbow": "order-statistic payoffs live outside the scalar payoff "
               "registry the level estimator prices",
}


# Families whose builders derive a STATIC Poisson scan depth (fam.kmax)
# from sim.n_steps.  Their builder must see the COARSEST grid n0 — the
# per-step jump intensity lam*T/n0 is the largest any MLMC leg sees, and
# a deeper scan is correct (identical counts) everywhere.  Keying bates
# off fines[-1] truncated the coarse legs' jump-count distribution
# (kmax=4 used vs 7 required at lam=0.3, n0=4, 5 levels), biasing the
# telescope — round-4 advisor finding.
_KMAX_FAMILIES = ("merton", "bates")


def _family_builder_steps(model: str, n0: int, fines) -> int:
    """Step count handed to the family builder (>= 2 for scheme setup)."""
    return max(n0 if model in _KMAX_FAMILIES else fines[-1], 2)


def _mk_rollout_draws(k0, k1, ids, pps, u):
    """Per-step draws at counter base u*pps — the lsmc rollout
    convention (lsmc.py mk_draw) minus the branch axis."""
    shape = ids.shape
    base = jnp.asarray(u, jnp.uint32) * jnp.uint32(pps)

    def pair(q):
        c1 = jnp.full(shape, 0, jnp.uint32) + base + jnp.uint32(q)
        return rng.normal_pair(k0, k1, ids, c1)

    def unit(q):
        # uniforms have no sum-coupling; families that consume them
        # (merton) override fam.mlmc_coarse_step and combine at the
        # increment level instead — fine legs draw these directly
        c1 = jnp.full(shape, 0, jnp.uint32) + base + jnp.uint32(q)
        b0, _ = rng.threefry2x32(k0, k1, ids, c1,
                                 rounds=rng.DEFAULT_ROUNDS)
        return rng.bits_to_unit(b0)

    def normal1(q):
        c1 = jnp.full(shape, 0, jnp.uint32) + base + jnp.uint32(q)
        b0, _ = rng.threefry2x32(k0, k1, ids, c1,
                                 rounds=rng.DEFAULT_ROUNDS)
        return rng.inv_normal_cdf(rng.bits_to_unit(b0))

    return SimpleNamespace(pair=pair, unit=unit, normal1=normal1)


def _combine_draws(d1, d2):
    """The coarse leg's Brownian increments: (z1 + z2)/sqrt(2) of the
    two fine sub-steps' draws — iid standard normals again, so the
    coarse leg's law is exactly level l-1's fine leg.  (The fine values
    are recomputed inside the closures; XLA CSE merges them with the
    fine leg's identical threefry calls.)"""
    inv_sqrt2 = jnp.float32(0.7071067811865476)

    def pair(q):
        a0, a1 = d1.pair(q)
        b0, b1 = d2.pair(q)
        return (a0 + b0) * inv_sqrt2, (a1 + b1) * inv_sqrt2

    def unit(q):
        raise NotImplementedError("no uniform sum-coupling")

    def normal1(q):
        return (d1.normal1(q) + d2.normal1(q)) * inv_sqrt2

    return SimpleNamespace(pair=pair, unit=unit, normal1=normal1)


def _family_coupled_tile(fam, payoff, p_f, ctx_f, p_c, ctx_c, ids, valid,
                         k0, k1, n_fine: int, coupled: bool):
    """(P_fine - P_coarse) tile through the family rollout hooks.

    Each leg: carry = fam.rollout_carry at t=0, stepped with
    fam.rollout_step on ITS OWN packed grid (p_f at n_fine substeps,
    p_c at n_fine/2), per-step discount factors accumulated
    multiplicatively, payoff state (if any) updated on the leg's spot
    after every step.
    """
    if coupled and n_fine % 2:
        raise ValueError(
            f"coupled MLMC level needs an even substep count, got {n_fine}")
    if n_fine < 1:
        raise ValueError(f"n_fine must be >= 1, got {n_fine}")
    shape = ids.shape
    pps = fam.rollout_pairs_per_step
    track = payoff.n_state > 0
    zero = jnp.zeros(shape, jnp.float32)
    one = jnp.ones(shape, jnp.float32)

    def bcast(vals):
        return tuple(zero + jnp.asarray(v, jnp.float32) for v in vals)

    def leg_init(p, ctx):
        carry = fam.rollout_carry(p, ctx, bcast(fam.rollout_t0(p)))
        return carry, one, payoff.init(p, zero)

    def leg_step(p, ctx, carry, df, st, d, u):
        carry, sdf = fam.rollout_step(p, ctx, carry, d, u)
        df = df * sdf
        if track:
            st = payoff.update(st, fam.rollout_spot(p, ctx, carry), p)
        return carry, df, st

    def leg_pay(p, ctx, carry, df, st):
        return payoff.terminal(st, fam.rollout_spot(p, ctx, carry), p) * df

    carry_f, df_f, st_f = leg_init(p_f, ctx_f)

    if not coupled:
        def body(u, c):
            carry, df, st = c
            d = _mk_rollout_draws(k0, k1, ids, pps, u)
            return leg_step(p_f, ctx_f, carry, df, st, d, u)

        carry_f, df_f, st_f = jax.lax.fori_loop(
            0, n_fine, body, (carry_f, df_f, st_f))
        return jnp.where(valid, leg_pay(p_f, ctx_f, carry_f, df_f, st_f),
                         0.0)

    carry_c, df_c, st_c = leg_init(p_c, ctx_c)

    def body(kk, c):
        carry_f, df_f, st_f, carry_c, df_c, st_c = c
        d1 = _mk_rollout_draws(k0, k1, ids, pps, 2 * kk)
        d2 = _mk_rollout_draws(k0, k1, ids, pps, 2 * kk + 1)
        carry_f, df_f, st_f = leg_step(p_f, ctx_f, carry_f, df_f, st_f,
                                       d1, 2 * kk)
        carry_f, df_f, st_f = leg_step(p_f, ctx_f, carry_f, df_f, st_f,
                                       d2, 2 * kk + 1)
        if fam.mlmc_coarse_step is None:
            carry_c, df_c, st_c = leg_step(p_c, ctx_c, carry_c, df_c,
                                           st_c, _combine_draws(d1, d2),
                                           kk)
        else:
            # increment-level coupling (non-Gaussian drivers): one
            # coarse step consuming BOTH fine draw objects
            carry_c, sdf = fam.mlmc_coarse_step(p_f, p_c, ctx_c,
                                                carry_c, d1, d2, kk)
            df_c = df_c * sdf
            if track:
                st_c = payoff.update(
                    st_c, fam.rollout_spot(p_c, ctx_c, carry_c), p_c)
        return (carry_f, df_f, st_f, carry_c, df_c, st_c)

    carry_f, df_f, st_f, carry_c, df_c, st_c = jax.lax.fori_loop(
        0, n_fine // 2, body,
        (carry_f, df_f, st_f, carry_c, df_c, st_c))
    pay = (leg_pay(p_f, ctx_f, carry_f, df_f, st_f)
           - leg_pay(p_c, ctx_c, carry_c, df_c, st_c))
    return jnp.where(valid, pay, 0.0)


def _family_level_slabs(fam, params_f, params_c, payoff, n_local, n_fine,
                        coupled, tile_rows, key, offset, bound):
    """(8,128) Kahan slabs of (Y, Y^2) over local path range
    [offset, offset + n_local) masked against the global ``bound`` —
    the per-chip piece both the single-chip and sharded moments share."""
    p_f = fam.unpack(params_f)
    ctx_f = fam.make_ctx(params_f, n_fine)
    p_c = fam.unpack(params_c)
    ctx_c = fam.make_ctx(params_c, max(n_fine // 2, 1))
    k0 = jnp.asarray(key[0], jnp.uint32)
    k1 = jnp.asarray(key[1], jnp.uint32)

    def tile_fn(ids, valid):
        pay = _family_coupled_tile(fam, payoff, p_f, ctx_f, p_c, ctx_c,
                                   ids, valid, k0, k1, n_fine, coupled)
        return [pay, pay * pay]

    return xla_moment_scan(tile_fn, n_local, tile_rows, 2, offset=offset,
                           bound=bound)


@functools.partial(
    jax.jit,
    static_argnames=("fam", "payoff", "n_paths", "n_fine", "coupled",
                     "tile_rows"))
def family_level_moments(fam, params_f, params_c, payoff, n_paths,
                         n_fine, coupled, tile_rows, key, path_offset=0):
    """(sum Y, sum Y^2) of the level correction for any NMCFamily."""
    offset = jnp.asarray(path_offset, jnp.uint32)
    s, sq = _family_level_slabs(fam, params_f, params_c, payoff, n_paths,
                                n_fine, coupled, tile_rows, key, offset,
                                offset + jnp.uint32(n_paths))
    return finish_sum(s), finish_sum(sq)


@functools.partial(
    jax.jit,
    static_argnames=("fam", "payoff", "n_paths", "n_fine", "coupled",
                     "tile_rows", "mesh"))
def family_level_moments_sharded(fam, params_f, params_c, payoff,
                                 n_paths, n_fine, coupled, tile_rows,
                                 mesh, key, path_offset=0):
    """Level moments with the path range split over the mesh: each chip
    scans its slice of GLOBAL path ids (streams key by path id, so the
    simulated set is mesh-size invariant), slabs meet in one psum."""
    from jax.sharding import PartitionSpec as P

    from mc_tpu.parallel.mesh import PATHS_AXIS, shard_bounds

    n_shards = mesh.devices.size
    n_local = shard_bounds(n_paths, n_shards, tile_rows)
    offset = jnp.asarray(path_offset, jnp.uint32)
    bound = offset + jnp.uint32(n_paths)

    def shard_fn(params_f, params_c, key, offset, bound):
        rank = jax.lax.axis_index(PATHS_AXIS).astype(jnp.uint32)
        local_off = offset + rank * jnp.uint32(n_local)
        s, sq = _family_level_slabs(fam, params_f, params_c, payoff,
                                    n_local, n_fine, coupled, tile_rows,
                                    key, local_off, bound)
        return (jax.lax.psum(s, PATHS_AXIS),
                jax.lax.psum(sq, PATHS_AXIS))

    s, sq = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=P(), check_vma=False,
    )(params_f, params_c, key, offset, bound)
    return finish_sum(s), finish_sum(sq)


def price_mlmc_family(model: str,
                      option: OptionParams = DEMO_OPTION,
                      dyn=None,
                      payoff="vanilla_call",
                      *,
                      n0: int = 4,
                      n_levels: int = 5,
                      n_pilot: int = 20_000,
                      eps: Optional[float] = None,
                      n_per_level: Optional[Sequence[int]] = None,
                      tile_rows: int = 64,
                      mesh=None,
                      seed: int = 1234) -> MLMCResult:
    """Multilevel price under any supported model family.

    ``model`` names an `nmc_engine` family ("heston", "cev", "sabr",
    "vasicek", "basket" — Gaussian-driven, coupled by the (z1+z2)/sqrt2
    draws shim — or "merton", coupled at the increment level via
    `MertonNMC.mlmc_coarse_step`: the coarse compound-jump increment is
    the SUM of the two fine ones, exact in law); ``dyn`` its dynamics
    (family demo default).
    Levels, allocation, and result semantics match `price_heston_mlmc`,
    except the price is discounted THROUGH the rollout (pathwise-exact
    for vasicek's stochastic rates).  Exact-in-law schemes (vasicek's
    exact OU triple; basket's log-Euler) have mean-zero corrections for
    terminal payoffs — MLMC is only *useful* there for grid-refinable
    path functionals, but stays correct.
    """
    from mc_tpu.config import SimParams
    from mc_tpu.nmc_engine import (FAMILY_MODULES, NMC_FAMILY_BUILDERS,
                                   ensure_family)

    if model in _MLMC_EXCLUDED:
        raise ValueError(
            f"MLMC does not support the {model!r} family: "
            f"{_MLMC_EXCLUDED[model]}")
    if model not in FAMILY_MODULES:
        raise ValueError(
            f"unknown model family {model!r}; available: "
            f"{sorted(set(FAMILY_MODULES) - set(_MLMC_EXCLUDED))}")
    ensure_family(model)
    po = get_payoff(payoff)
    if not (po.terminal_only or po.name in _MLMC_PATH_OK):
        raise ValueError(
            f"MLMC supports terminal payoffs and the grid-refinable "
            f"path functionals {sorted(_MLMC_PATH_OK)}; {po.name!r} is "
            "defined by the step grid itself")
    if n0 < 1:
        raise ValueError(f"n0 must be >= 1, got {n0}")
    opt32 = option.as_f32()
    fines = tuple(n0 * (1 << l) for l in range(n_levels))
    builder_steps = _family_builder_steps(model, n0, fines)
    fam, dyn32 = NMC_FAMILY_BUILDERS[model](
        opt32, dyn, SimParams(n_paths=tile_rows * LANES,
                              n_steps=builder_steps))
    packs_f = [fam.pack(opt32, dyn32, nf) for nf in fines]
    packs_c = [fam.pack(opt32, dyn32, max(nf // 2, 1)) for nf in fines]
    keys = [jnp.asarray(rng.derive_key(seed, 0x4D4D, l), jnp.uint32)
            for l in range(n_levels)]

    def level_sums(l, n, path_offset=0):
        n = round_up(max(n, 0), tile_rows * LANES)
        if n == 0:
            return 0.0, 0.0, 0
        if mesh is None:
            s, sq = family_level_moments(fam, packs_f[l], packs_c[l], po,
                                         n, fines[l], l > 0, tile_rows,
                                         keys[l], jnp.uint32(path_offset))
        else:
            # every level's path range sharded over the mesh; streams
            # key by GLOBAL path id, so the simulated set (and hence
            # the estimate up to summation order) is mesh-invariant
            s, sq = family_level_moments_sharded(
                fam, packs_f[l], packs_c[l], po, n, fines[l], l > 0,
                tile_rows, mesh, keys[l], jnp.uint32(path_offset))
        return float(s), float(sq), n

    means, varis, ns = _mlmc_schedule(level_sums, fines, n_pilot, eps,
                                      n_per_level, tile_rows)
    price = float(sum(means))
    stderr = float(np.sqrt(sum(v / n for v, n in zip(varis, ns))))
    return MLMCResult(price=price, stderr=stderr, levels=fines,
                      n_per_level=tuple(ns), level_means=tuple(means),
                      level_vars=tuple(varis))
