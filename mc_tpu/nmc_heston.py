"""Nested Monte Carlo under Heston stochastic volatility.

Extends the flagship NMC capability (the reference's ``inc/nmc.cuh``
re-pricing of every (path, step) point, SURVEY.md C10-C12) from GBM to the
Heston model family: the conditional re-pricing resumes from the FULL
stored market state ``(S_t, v_t, payoff_state_t)`` — the variance is part
of the state, so exposure profiles under stochastic volatility (XVA's
standard setting) come out of the same surface machinery.

The engine (grid materialization, inner Pallas kernel, bitwise XLA dual,
guards) is the generic `nmc_engine`; this module supplies only the Heston
physics: full-truncation Euler inner legs resumed from (S_t, v_t).

Inner-draw convention: point (path i, step j), inner path m, substep u
consumes threefry pair ``(i, ((j+1)*n_inner + m)*n_steps + u)`` — one
Box-Muller pair per substep (Heston needs two correlated normals per
step, z_v and z_perp).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from mc_tpu import rng
from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.models.heston import (DEMO_HESTON, HestonDynamics, _pack_heston,
                                  _unpack_heston, heston_euler_step)
from mc_tpu.nmc import NMCResult
from mc_tpu.nmc_engine import (NMCFamily, price_nmc_family,
                               register_nmc_family)

__all__ = ["price_nmc_heston"]

STREAM_OUTER, STREAM_INNER = 0, 1


class HestonNMC(NMCFamily):
    """Heston physics for the generic NMC engine: market grids (S, v)."""

    name = "heston"
    tag = 0x4E57
    n_grids = 2
    even_steps = False

    def span(self, n_steps, n_inner):
        return n_steps * n_inner * n_steps, "n_steps^2 * n_inner"

    def pack(self, option, dyn, n_steps):
        return _pack_heston(option, dyn, n_steps)

    def unpack(self, params):
        return _unpack_heston(params)

    def leg(self, payoff, p, ctx, ki0, ki1, ids, c_base, j, remaining,
            grids_j, state_t, n_steps):
        s_t, v_t = grids_j

        def step(u, carry2):
            w, v, state = carry2
            c1 = (jnp.full(ids.shape, 0, jnp.uint32) + c_base
                  + jnp.asarray(u, jnp.uint32))
            z_v, z_p = rng.normal_pair(ki0, ki1, ids, c1)
            w, v = heston_euler_step(p, w, v, z_v, z_p, p.dt, p.sqrt_dt)
            state = payoff.update(state, s_t * jnp.exp(w), p)
            return (w, v, state)

        w, v, state = jax.lax.fori_loop(
            0, remaining, step, (jnp.zeros_like(s_t), v_t, state_t))
        return payoff.terminal(state, s_t * jnp.exp(w), p)

    def rollout_carry(self, p, ctx, grids_j):
        s_t, v_t = grids_j
        return (s_t, jnp.zeros_like(s_t), v_t)

    def rollout_step(self, p, ctx, carry, d, u):
        s_t, w, v = carry
        z_v, z_p = d.pair(0)
        w, v = heston_euler_step(p, w, v, z_v, z_p, p.dt, p.sqrt_dt)
        return (s_t, w, v), jnp.exp(-p.r * p.dt)

    def rollout_spot(self, p, ctx, carry):
        return carry[0] * jnp.exp(carry[1])

    def rollout_t0(self, p):
        return (p.s0, p.v0)

    def lsmc_basis_point(self, p, carry, s, degree, inv_k):
        from mc_tpu.lsmc import _basis_sv
        return _basis_sv(s * inv_k, carry[2], degree)

    def lsmc_design(self, p, grids_flat, degree, inv_k):
        # stochastic-vol LSMC: continuation regressed on (S, v)
        from mc_tpu.lsmc import _basis_sv
        s, v = grids_flat[0], grids_flat[1]
        return (lambda t: _basis_sv(s[t] * inv_k, v[t], degree),
                degree + 4)

    outer_steps_per_block = 1

    def outer_init(self, p, ctx, s0, state0):
        # s rides the carry: outer_pay must consume the SAME rounded
        # spot the step persisted (see nmc_merton.MertonNMC.outer_init)
        return (jnp.zeros_like(s0), jnp.full_like(s0, p.v0), s0, state0)

    def outer_block(self, payoff, p, ctx, ids, ko0, ko1, carry, m):
        w, v, s, state = carry
        c1 = jnp.full(ids.shape, 0, jnp.uint32) + m
        z_v, z_p = rng.normal_pair(ko0, ko1, ids, c1)
        w, v = heston_euler_step(p, w, v, z_v, z_p, p.dt, p.sqrt_dt)
        s = p.s0 * jnp.exp(w)
        state = payoff.update(state, s, p)
        cv = state[0] if payoff.n_state else jnp.zeros_like(s)
        return (w, v, s, state), ((s, v, cv),)

    def outer_pay(self, payoff, p, ctx, carry):
        _, _, s, state = carry
        return payoff.terminal(state, s, p)


def price_nmc_heston(option: OptionParams = DEMO_OPTION,
                     heston: HestonDynamics = DEMO_HESTON,
                     sim: SimParams = DEMO_SIM,
                     payoff="vanilla_call",
                     *,
                     tile_rows: int = 8,
                     stream_outer: int = STREAM_OUTER,
                     stream_inner: int = STREAM_INNER) -> NMCResult:
    """Nested MC price surface under Heston stochastic volatility.

    Every (path, step) point of the outer trajectories is re-priced by
    ``sim.n_paths_inner`` inner legs resumed from the stored market state
    (S_t, v_t) AND payoff state — exposure profiles
    (``result.exposure_profile()``) under stochastic vol for XVA.
    """
    return price_nmc_family(HestonNMC(), option, heston.as_f32(), sim,
                            payoff, tile_rows=tile_rows,
                            stream_outer=stream_outer,
                            stream_inner=stream_inner)


register_nmc_family(
    "heston", price_nmc_heston,
    lambda option, dyn, sim: (HestonNMC(),
                              (DEMO_HESTON if dyn is None
                               else dyn).as_f32()))
