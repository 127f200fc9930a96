"""Nested Monte Carlo under SABR — exposure on the smile model desks
actually calibrate to.  A dynamics definition on the generic engine
(`nmc_engine`): market grids (F, sigma); inner legs resume from the full
stored two-factor state and re-run `models/sabr.sabr_step`.

Payoffs are evaluated on the FORWARD path and discounted at e^{-rT}
(the `price_sabr` convention).  F is a martingale under the forward
measure, so the fully-discounted conditional value of a call is a
martingale: EE gated flat at the time-0 SABR price (Hagan/MC cross).

Inner-draw convention: point (i, j), inner path m, substep u consumes
threefry pair ``((j+1)*n_inner + m)*n_steps + u`` — one pair (z_vol,
z_perp) per substep, matching `price_sabr`'s outer layout.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from mc_tpu import rng
from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.models.sabr import (DEMO_SABR, SABRDynamics, _pack_sabr,
                                _unpack_sabr, sabr_step)
from mc_tpu.nmc import NMCResult
from mc_tpu.nmc_engine import (NMCFamily, price_nmc_family,
                               register_nmc_family)

__all__ = ["price_nmc_sabr"]


class SABRNMC(NMCFamily):
    """SABR physics for the generic NMC engine: market grids (F, sig)."""

    name = "SABR"
    tag = 0x5AB4
    n_grids = 2
    even_steps = False

    def span(self, n_steps, n_inner):
        return n_steps * n_inner * n_steps, "n_steps^2 * n_inner"

    def pack(self, option, dyn, n_steps):
        return _pack_sabr(option, dyn, n_steps)

    def unpack(self, params):
        return _unpack_sabr(params)

    def leg(self, payoff, p, ctx, ki0, ki1, ids, c_base, j, remaining,
            grids_j, state_t, n_steps):
        f_t, sig_t = grids_j

        def step(u, carry2):
            logf, sig, state = carry2
            c1 = (jnp.full(ids.shape, 0, jnp.uint32) + c_base
                  + jnp.asarray(u, jnp.uint32))
            z_vol, z_perp = rng.normal_pair(ki0, ki1, ids, c1)
            logf, sig = sabr_step(p, logf, sig, z_vol, z_perp)
            state = payoff.update(state, jnp.exp(logf), p)
            return (logf, sig, state)

        logf, sig, state = jax.lax.fori_loop(
            0, remaining, step, (jnp.log(f_t), sig_t, state_t))
        return payoff.terminal(state, jnp.exp(logf), p)

    def rollout_carry(self, p, ctx, grids_j):
        f_t, sig_t = grids_j
        return (jnp.log(f_t), sig_t)

    def rollout_step(self, p, ctx, carry, d, u):
        z_vol, z_perp = d.pair(0)
        logf, sig = sabr_step(p, carry[0], carry[1], z_vol, z_perp)
        return (logf, sig), jnp.exp(-p.r * p.dt)

    def rollout_spot(self, p, ctx, carry):
        return jnp.exp(carry[0])

    def rollout_t0(self, p):
        return (p.f0, p.alpha)

    outer_steps_per_block = 1

    def outer_init(self, p, ctx, s0, state0):
        # the SABR path lives on the FORWARD, not the spot the engine's
        # s0 carries — start from p.f0 (price_sabr convention)
        f0 = jnp.full_like(s0, 1.0) * p.f0
        # f rides the carry: outer_pay must consume the SAME rounded
        # forward the step persisted (see nmc_merton.MertonNMC)
        return (jnp.log(f0), jnp.zeros_like(f0) + p.alpha, f0, state0)

    def outer_block(self, payoff, p, ctx, ids, ko0, ko1, carry, m):
        logf, sig, f, state = carry
        c1 = jnp.full(ids.shape, 0, jnp.uint32) + m
        z_vol, z_perp = rng.normal_pair(ko0, ko1, ids, c1)
        logf, sig = sabr_step(p, logf, sig, z_vol, z_perp)
        f = jnp.exp(logf)
        state = payoff.update(state, f, p)
        cv = state[0] if payoff.n_state else jnp.zeros_like(f)
        return (logf, sig, f, state), ((f, sig, cv),)

    def outer_pay(self, payoff, p, ctx, carry):
        _, _, f, state = carry
        return payoff.terminal(state, f, p)


def price_nmc_sabr(option: OptionParams = DEMO_OPTION,
                   dyn: SABRDynamics = DEMO_SABR,
                   sim: SimParams = DEMO_SIM,
                   payoff="vanilla_call",
                   *,
                   tile_rows: int = 8,
                   stream_outer: int = 0,
                   stream_inner: int = 1) -> NMCResult:
    """Nested MC price surface under SABR: exposure profiles
    (``result.exposure_profile()``) and CVA under the smile model's own
    dynamics, inner legs resumed from the stored (F_t, sigma_t)."""
    return price_nmc_family(SABRNMC(), option, dyn.as_f32(), sim, payoff,
                            tile_rows=tile_rows,
                            stream_outer=stream_outer,
                            stream_inner=stream_inner)


register_nmc_family(
    "sabr", price_nmc_sabr,
    lambda option, dyn, sim: (SABRNMC(),
                              (DEMO_SABR if dyn is None
                               else dyn).as_f32()))
