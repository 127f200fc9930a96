"""Nested Monte Carlo under a local-volatility surface.

Extends the flagship NMC capability (the reference's ``inc/nmc.cuh``
re-pricing of every (path, step) point, SURVEY.md C10-C12) to the
smile: conditional values — and hence exposure profiles — under a
sigma(S, t) surface instead of flat vol.

Inner legs resume from the stored (S_j, payoff-state) point; because the
surface is a function of ABSOLUTE log-moneyness log(S/S0) and calendar
step, the inner path's moneyness starts at log(S_j/S0) and each inner
substep u evaluates the surface at step index j+1+u — the same clamped-
ramp lookup as the outer kernel.

The engine is the generic `nmc_engine`; this module supplies the
local-vol physics (surface lookup context + both-normals substep pairs).

Martingale gate: with full e^{-rT} discounting the conditional value of
a NON-NEGATIVE payoff is a martingale, so a vanilla call's expected-
exposure profile must be FLAT at the time-0 price at EVERY step — the
smile moves the PFE quantiles, never the EE mean.

Inner-draw convention: point (i, j), inner path m consumes threefry
pairs ``((j+1)*n_inner + m)*pair_cap + q`` on the inner key,
pair_cap = ceil(n_steps/2), two substeps per pair with the trailing odd
substep dropped by a uniform predicated select (the
`nmc_kernels._simulate_resumed` scheme — both normals used).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from mc_tpu import rng
from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.models.localvol import (DEMO_LOCALVOL, LocalVolSurface,
                                    _make_sigma_at, _pack_localvol,
                                    _unpack_localvol_head,
                                    validate_surface)
from mc_tpu.nmc import NMCResult
from mc_tpu.nmc_engine import (NMCFamily, price_nmc_family,
                               register_nmc_family)

__all__ = ["price_nmc_localvol"]

STREAM_OUTER, STREAM_INNER = 0, 1


class LocalVolNMC(NMCFamily):
    """Local-vol physics for the generic NMC engine: market grid (S,);
    ``extras = (n_knots,)`` — the static surface knot count."""

    name = "localvol"
    tag = 0x10CA
    n_grids = 1
    even_steps = True

    @property
    def n_knots(self):
        return self.extras[0]

    def span(self, n_steps, n_inner):
        return ((n_steps + 1) * n_inner * ((n_steps + 1) // 2),
                "(n_steps+1)*n_inner*ceil(n_steps/2)")

    def counter_stride(self, n_steps):
        return (n_steps + 1) // 2  # pair_cap: one pair per two substeps

    def pack(self, option, dyn, n_steps):
        return _pack_localvol(option, dyn, n_steps)

    def unpack(self, params):
        return _unpack_localvol_head(params)

    def make_ctx(self, params, n_steps):
        return _make_sigma_at(params, n_steps, self.n_knots)

    def leg(self, payoff, p, ctx, ki0, ki1, ids, c_base, j, remaining,
            grids_j, state_t, n_steps):
        (s_t,) = grids_j
        sigma_at = ctx
        base_drift = (p.r - p.q) * p.dt
        sdt = jnp.sqrt(p.dt)
        w0 = jnp.log(s_t / p.s0)  # absolute log-moneyness at the point
        last = jnp.int32(n_steps - 1)

        def substep(w, state, z, u):
            # clamp the (masked-out) overrun substep's surface index
            sg = sigma_at(w, jnp.minimum(u, last))
            w = w + (base_drift - 0.5 * sg * sg * p.dt) + sg * sdt * z
            return w, payoff.update(state, p.s0 * jnp.exp(w), p)

        def body(q, carry2):
            w, state = carry2
            c1 = (jnp.full(ids.shape, 0, jnp.uint32) + c_base
                  + jnp.asarray(q, jnp.uint32))
            z0, z1 = rng.normal_pair(ki0, ki1, ids, c1)
            u1 = j + 1 + 2 * q
            w1, st1 = substep(w, state, z0, u1)
            w2, st2 = substep(w1, st1, z1, u1 + 1)
            take2 = (2 * q + 1) < remaining
            w = jnp.where(take2, w2, w1)
            state = tuple(jnp.where(take2, b, a)
                          for a, b in zip(st1, st2))
            return (w, state)

        n_pairs = (remaining + 1) // 2
        w, state = jax.lax.fori_loop(0, n_pairs, body, (w0, state_t))
        return payoff.terminal(state, p.s0 * jnp.exp(w), p)

    def rollout_carry(self, p, ctx, grids_j):
        return (jnp.log(grids_j[0] / p.s0),)  # absolute log-moneyness

    def rollout_step(self, p, ctx, carry, d, u):
        z0 = d.normal1(0)
        (w,) = carry
        sigma_at = ctx
        # rollout from grid row u: the next move's surface index is u+1
        sg = sigma_at(w, jnp.minimum(u + 1, jnp.int32(self._n_steps_of(p))))
        w = (w + ((p.r - p.q) * p.dt - 0.5 * sg * sg * p.dt)
             + sg * jnp.sqrt(p.dt) * z0)
        return (w,), jnp.exp(-p.r * p.dt)

    @staticmethod
    def _n_steps_of(p):
        # surface rows run 0..n_steps-1; inv_n_steps packs 1/n
        return jnp.round(1.0 / p.inv_n_steps).astype(jnp.int32) - 1

    def rollout_spot(self, p, ctx, carry):
        return p.s0 * jnp.exp(carry[0])

    outer_steps_per_block = 2

    def outer_init(self, p, ctx, s0, state0):
        # s rides the carry: outer_pay must consume the SAME rounded
        # spot the step persisted (see nmc_merton.MertonNMC.outer_init)
        return (jnp.zeros_like(s0), s0, state0)

    def outer_block(self, payoff, p, ctx, ids, ko0, ko1, carry, m):
        # mirrors _localvol_leg's pair loop: pair m -> steps 2m, 2m+1
        sigma_at = ctx
        base_drift = (p.r - p.q) * p.dt
        sdt = jnp.sqrt(p.dt)
        w, s, state = carry
        c1 = jnp.full(ids.shape, 0, jnp.uint32) + m
        z0, z1 = rng.normal_pair(ko0, ko1, ids, c1)
        recs = []
        for step_idx, z in ((2 * m, z0), (2 * m + 1, z1)):
            sg = sigma_at(w, step_idx)
            w = w + (base_drift - 0.5 * sg * sg * p.dt) + sg * sdt * z
            s = p.s0 * jnp.exp(w)
            state = payoff.update(state, s, p)
            cv = state[0] if payoff.n_state else jnp.zeros_like(s)
            recs.append((s, cv))
        return (w, s, state), tuple(recs)

    def outer_pay(self, payoff, p, ctx, carry):
        _, s, state = carry
        return payoff.terminal(state, s, p)


def price_nmc_localvol(option: OptionParams = DEMO_OPTION,
                       surf: LocalVolSurface = None,
                       sim: SimParams = DEMO_SIM,
                       payoff="vanilla_call",
                       *,
                       tile_rows: int = 8,
                       stream_outer: int = STREAM_OUTER,
                       stream_inner: int = STREAM_INNER) -> NMCResult:
    """Nested MC price surface under a local-volatility smile.

    Every (path, step) point is re-priced by ``sim.n_paths_inner`` inner
    legs resumed from the stored (S_t, payoff state), stepping on the
    SAME sigma(S, t) surface — exposure profiles
    (``result.exposure_profile()``) and CVA under the smile.
    """
    if surf is None:
        surf = (DEMO_LOCALVOL if sim.n_steps == 100
                else LocalVolSurface.demo(sim.n_steps))
    s32 = validate_surface(surf, sim.n_steps)
    return price_nmc_family(LocalVolNMC(extras=(s32.n_knots,)), option,
                            s32, sim, payoff, tile_rows=tile_rows,
                            stream_outer=stream_outer,
                            stream_inner=stream_inner)


def _localvol_builder(option, dyn, sim):
    if dyn is None:
        dyn = (DEMO_LOCALVOL if sim.n_steps == 100
               else LocalVolSurface.demo(sim.n_steps))
    s32 = validate_surface(dyn, sim.n_steps)
    return LocalVolNMC(extras=(s32.n_knots,)), s32


register_nmc_family("localvol", price_nmc_localvol, _localvol_builder)
