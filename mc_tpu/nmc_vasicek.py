"""Nested Monte Carlo under Black-Scholes–Vasicek stochastic rates.

Extends the flagship NMC capability (the reference's ``inc/nmc.cuh``
re-pricing of every (path, step) point, SURVEY.md C10-C12) to STOCHASTIC
DISCOUNTING — the setting where nested simulation is the production tool
(XVA desks discount exposures along the simulated rate path, not by a
scalar e^{-rT}).

The conditional value at point (path i, step j) is discounted to TIME 0
pathwise:

    V*_ij = exp(-y_j) * (1/M) sum_m  payoff_m * exp(-(y_T^m - y_j)),

where y = int_0^t r du accumulates along the OUTER path up to t_j (stored
in the trajectory grid) and each INNER leg m resumes from the stored
market state (S_j, x_j = r_j - b, payoff state) and accumulates its own
remaining discount.  Martingale consequence used as the test gate: for a
`zcb` payoff the expected exposure profile is FLAT at the closed-form
P(0,T) for EVERY j.

The engine is the generic `nmc_engine`; this module supplies the Vasicek
physics (exact OU triple inner legs + pathwise discounting, grids
(S, x, y)).

Inner-draw convention: point (i, j), inner path m, substep u consumes
threefry pairs ``2*(((j+1)*n_inner + m)*n_steps + u) + {0,1}`` on the
inner key — two pairs per substep (the exact scheme needs three normals;
the fourth is discarded).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from mc_tpu import rng
from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.models.vasicek import (DEMO_VASICEK, VasicekDynamics,
                                   _pack_vasicek, _unpack_vasicek,
                                   vasicek_step)
from mc_tpu.nmc import NMCResult
from mc_tpu.nmc_engine import (NMCFamily, price_nmc_family,
                               register_nmc_family)

__all__ = ["price_nmc_vasicek"]

STREAM_OUTER, STREAM_INNER = 0, 1


class VasicekNMC(NMCFamily):
    """Vasicek physics for the generic NMC engine: grids (S, x, y) with
    pathwise discounting (point scale e^{-y_j}, outer discount 1)."""

    name = "vasicek"
    tag = 0x7A51
    n_grids = 3
    even_steps = True

    def span(self, n_steps, n_inner):
        return (2 * (n_steps + 1) * n_inner * n_steps,
                "2*(n_steps+1)*n_inner*n_steps")

    def pack(self, option, dyn, n_steps):
        return _pack_vasicek(option, dyn, n_steps)

    def unpack(self, params):
        return _unpack_vasicek(params)

    def point_scale(self, p, grids_j):
        return jnp.exp(-grids_j[2])  # e^{-y_j}: outer pathwise discount

    def outer_discount(self, p):
        return jnp.float32(1.0)  # outer payoffs already discounted

    def leg(self, payoff, p, ctx, ki0, ki1, ids, c_base, j, remaining,
            grids_j, state_t, n_steps):
        s_t, x_t = grids_j[0], grids_j[1]

        def step(u, carry2):
            wxy, state = carry2
            cu = jnp.uint32(2) * (c_base + jnp.asarray(u, jnp.uint32))
            c1a = jnp.full(ids.shape, 0, jnp.uint32) + cu
            za, zb = rng.normal_pair(ki0, ki1, ids, c1a)
            zc, _ = rng.normal_pair(ki0, ki1, ids, c1a + jnp.uint32(1))
            wxy, s = vasicek_step(p, wxy, za, zb, zc, s_t)
            return (wxy, payoff.update(state, s, p))

        zeros = jnp.zeros_like(s_t)
        (w, _, yd), state = jax.lax.fori_loop(
            0, remaining, step, ((zeros, x_t, zeros), state_t))
        return payoff.terminal(state, s_t * jnp.exp(w), p) * jnp.exp(-yd)

    # --- AB dual hooks: pathwise discounting rides the rollout carry ---
    rollout_pairs_per_step = 2  # the exact OU triple needs 3 normals

    def rollout_carry(self, p, ctx, grids_j):
        s_t, x_t = grids_j[0], grids_j[1]
        zeros = jnp.zeros_like(s_t)
        return (s_t, (zeros, x_t, zeros))  # (anchor, (w, x, y_rel))

    def rollout_step(self, p, ctx, carry, d, u):
        s_t, wxy = carry
        y_old = wxy[2]
        za, zb = d.pair(0)
        zc, _ = d.pair(1)
        wxy, _s = vasicek_step(p, wxy, za, zb, zc, s_t)
        return (s_t, wxy), jnp.exp(-(wxy[2] - y_old))

    def rollout_spot(self, p, ctx, carry):
        return carry[0] * jnp.exp(carry[1][0])

    def rollout_t0(self, p):
        return (p.s0, p.x0, jnp.float32(0.0))

    def ab_grid_df(self, p, gs, t):
        return jnp.exp(-gs[2][t])  # stored integrated rate

    def lsmc_basis_point(self, p, carry, s, degree, inv_k):
        from mc_tpu.lsmc import _basis_sr
        return _basis_sr(s * inv_k, carry[1][1], degree)

    def lsmc_design(self, p, grids_flat, degree, inv_k):
        # stochastic-rate LSMC: continuation regressed on (S, r)
        from mc_tpu.lsmc import _basis_sr
        s, x = grids_flat[0], grids_flat[1]
        return (lambda t: _basis_sr(s[t] * inv_k, x[t], degree),
                degree + 4)

    def lsmc_discount(self, p, grids_flat):
        # STOCHASTIC per-path discounting: date t+1 -> t along the
        # stored integrated-rate grid; cashflows to date 0 via e^{-y_0}.
        y = grids_flat[2]
        return (None, lambda t: jnp.exp(-(y[t + 1] - y[t])),
                jnp.exp(-y[0]))

    outer_steps_per_block = 2

    def outer_init(self, p, ctx, s0, state0):
        # s rides the carry: outer_pay must consume the SAME rounded
        # spot the step persisted (see nmc_merton.MertonNMC.outer_init)
        zeros = jnp.zeros_like(s0)
        return ((zeros, jnp.full_like(s0, p.x0), zeros), s0, state0)

    def outer_block(self, payoff, p, ctx, ids, ko0, ko1, carry, m):
        # mirrors _vasicek_leg's pair loop: pairs (3m, 3m+1, 3m+2)
        wxy, s, state = carry

        def draw(c):
            c1 = jnp.full(ids.shape, 0, jnp.uint32) + c
            return rng.normal_pair(ko0, ko1, ids, c1)

        z0, z1 = draw(3 * m)
        z2, z3 = draw(3 * m + 1)
        z4, z5 = draw(3 * m + 2)
        s0 = jnp.full(ids.shape, p.s0, jnp.float32)
        recs = []
        for za, zb, zc in ((z0, z1, z2), (z3, z4, z5)):
            wxy, s = vasicek_step(p, wxy, za, zb, zc, s0)
            state = payoff.update(state, s, p)
            cv = state[0] if payoff.n_state else jnp.zeros_like(s)
            recs.append((s, wxy[1], wxy[2], cv))
        return (wxy, s, state), tuple(recs)

    def outer_pay(self, payoff, p, ctx, carry):
        (_, _, y), s, state = carry
        return payoff.terminal(state, s, p) * jnp.exp(-y)


def price_nmc_vasicek(option: OptionParams = DEMO_OPTION,
                      dyn: VasicekDynamics = DEMO_VASICEK,
                      sim: SimParams = DEMO_SIM,
                      payoff="vanilla_call",
                      *,
                      tile_rows: int = 8,
                      stream_outer: int = STREAM_OUTER,
                      stream_inner: int = STREAM_INNER) -> NMCResult:
    """Nested MC price surface under stochastic (Vasicek) rates.

    Every (path, step) point is re-priced by ``sim.n_paths_inner`` exact
    inner legs resumed from the stored (S_t, r_t) market state, with the
    discounting done PATHWISE along both the outer and inner rate paths —
    exposure profiles (``result.exposure_profile()``) and CVA
    (``result.cva(...)``) under the rates that actually discount them.
    """
    return price_nmc_family(VasicekNMC(), option, dyn.as_f32(), sim,
                            payoff, tile_rows=tile_rows,
                            stream_outer=stream_outer,
                            stream_inner=stream_inner)


register_nmc_family(
    "vasicek", price_nmc_vasicek,
    lambda option, dyn, sim: (VasicekNMC(),
                              (DEMO_VASICEK if dyn is None
                               else dyn).as_f32()))
