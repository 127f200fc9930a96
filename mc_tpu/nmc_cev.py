"""Nested Monte Carlo under CEV local volatility — the round-3 proof that
a new family's NMC is just a dynamics definition on the generic engine
(`nmc_engine`): no kernels, no duals, no scaffolding.

Inner legs resume from the stored S_t and step the level-space Euler
scheme of `models/cev._cev_leg` (absorbing zero boundary); the outer
stream matches `price_cev`'s pair convention.  Inner-draw convention:
point (i, j), inner path m consumes threefry pairs
``((j+1)*n_inner + m)*pair_cap + q``, pair_cap = ceil(n_steps/2), two
substeps per pair with the trailing odd substep dropped by a predicated
select (the localvol-NMC scheme).

Martingale gate (tests): with full e^{-rT} discounting the conditional
value of a vanilla call is a martingale, so its expected-exposure profile
is FLAT at the time-0 CEV price (Schroder-oracle-checked) at every step.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from mc_tpu import rng
from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.models.cev import (DEMO_CEV, CEVDynamics, _pack_cev,
                               _unpack_cev)
from mc_tpu.nmc import NMCResult
from mc_tpu.nmc_engine import (NMCFamily, price_nmc_family,
                               register_nmc_family)

__all__ = ["price_nmc_cev"]


class CEVNMC(NMCFamily):
    """CEV physics for the generic NMC engine: market grid (S,)."""

    name = "CEV"
    tag = 0xCE4
    n_grids = 1
    even_steps = True

    def span(self, n_steps, n_inner):
        return ((n_steps + 1) * n_inner * ((n_steps + 1) // 2),
                "(n_steps+1)*n_inner*ceil(n_steps/2)")

    def counter_stride(self, n_steps):
        return (n_steps + 1) // 2  # one pair per two substeps

    def pack(self, option, dyn, n_steps):
        return _pack_cev(option, dyn, n_steps)

    def unpack(self, params):
        return _unpack_cev(params)

    @staticmethod
    def _substep(payoff, p, s, state, z):
        # level-space Euler with absorbing zero boundary (_cev_leg:95-107)
        alive = s > 0.0
        s_safe = jnp.maximum(s, 1e-12)
        diff = p.sigma_lv * jnp.exp(p.beta * jnp.log(s_safe))
        s_new = s + p.growth_dt * s + diff * p.sqrt_dt * z
        s = jnp.where(alive, jnp.maximum(s_new, 0.0), 0.0)
        return s, payoff.update(state, s, p)

    def leg(self, payoff, p, ctx, ki0, ki1, ids, c_base, j, remaining,
            grids_j, state_t, n_steps):
        (s_t,) = grids_j

        def body(q, carry2):
            s, state = carry2
            c1 = (jnp.full(ids.shape, 0, jnp.uint32) + c_base
                  + jnp.asarray(q, jnp.uint32))
            z0, z1 = rng.normal_pair(ki0, ki1, ids, c1)
            s1, st1 = self._substep(payoff, p, s, state, z0)
            s2, st2 = self._substep(payoff, p, s1, st1, z1)
            take2 = (2 * q + 1) < remaining
            s = jnp.where(take2, s2, s1)
            state = tuple(jnp.where(take2, b, a)
                          for a, b in zip(st1, st2))
            return (s, state)

        n_pairs = (remaining + 1) // 2
        s, state = jax.lax.fori_loop(0, n_pairs, body, (s_t, state_t))
        return payoff.terminal(state, s, p)

    def rollout_carry(self, p, ctx, grids_j):
        return (grids_j[0],)

    def rollout_step(self, p, ctx, carry, d, u):
        z0 = d.normal1(0)
        s = carry[0]
        alive = s > 0.0
        s_safe = jnp.maximum(s, 1e-12)
        diff = p.sigma_lv * jnp.exp(p.beta * jnp.log(s_safe))
        s_new = s + p.growth_dt * s + diff * p.sqrt_dt * z0
        return ((jnp.where(alive, jnp.maximum(s_new, 0.0), 0.0),),
                jnp.exp(-p.r * p.dt))

    def rollout_spot(self, p, ctx, carry):
        return carry[0]

    outer_steps_per_block = 2

    def outer_init(self, p, ctx, s0, state0):
        return (s0, state0)

    def outer_block(self, payoff, p, ctx, ids, ko0, ko1, carry, m):
        s, state = carry
        c1 = jnp.full(ids.shape, 0, jnp.uint32) + m
        z0, z1 = rng.normal_pair(ko0, ko1, ids, c1)
        recs = []
        for z in (z0, z1):
            s, state = self._substep(payoff, p, s, state, z)
            cv = state[0] if payoff.n_state else jnp.zeros_like(s)
            recs.append((s, cv))
        return (s, state), tuple(recs)

    def outer_pay(self, payoff, p, ctx, carry):
        s, state = carry
        return payoff.terminal(state, s, p)


def price_nmc_cev(option: OptionParams = DEMO_OPTION,
                  dyn: CEVDynamics = DEMO_CEV,
                  sim: SimParams = DEMO_SIM,
                  payoff="vanilla_call",
                  *,
                  tile_rows: int = 8,
                  stream_outer: int = 0,
                  stream_inner: int = 1) -> NMCResult:
    """Nested MC price surface under CEV local volatility: exposure
    profiles (``result.exposure_profile()``) and CVA under the
    parametric skew."""
    return price_nmc_family(CEVNMC(), option, dyn.as_f32(), sim, payoff,
                            tile_rows=tile_rows,
                            stream_outer=stream_outer,
                            stream_inner=stream_inner)


register_nmc_family(
    "cev", price_nmc_cev,
    lambda option, dyn, sim: (CEVNMC(),
                              (DEMO_CEV if dyn is None
                               else dyn).as_f32()))
