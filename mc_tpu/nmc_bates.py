"""Nested Monte Carlo under Bates SVJ (Heston + compound-Poisson jumps).

Extends the flagship NMC capability (the reference's ``inc/nmc.cuh``
re-pricing of every (path, step) point, SURVEY.md C10-C12) to the Bates
model family: conditional re-pricing resumes from the stored market state
``(S_t, v_t, payoff_state_t)`` — jumps are i.i.d. across steps, so (S, v)
remains the whole market state exactly as under Heston.  Exposure/CVA
under CRASH RISK *and* STOCHASTIC VOL together: the jump tail fattens PFE
beyond the matched-vol Heston profile (asserted in tests/test_nmc_bates).

The engine is the generic `nmc_engine`; this module supplies only the
Bates physics by composing the two single-definition substeps —
`heston.heston_euler_step` for the diffusion and `merton._jump_increment`
/ `_poisson_inv_cdf` for the jumps (compensator pre-folded into the
packed ``growth`` by `bates._pack_bates`).

Inner-draw convention: point (path i, step j), inner path m, substep u
consumes counters ``c_base + 3u`` (diffusion Box-Muller pair), ``+3u+1``
(jump-size normal) and ``+3u+2`` (Poisson uniform) with
``c_base = ((j+1) * n_inner + m) * 3 * n_steps`` — the same 3-counter
step layout as the standalone `price_bates` Euler leg.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from mc_tpu import rng
from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.models.bates import (DEMO_BATES, BatesDynamics, _pack_bates,
                                 _unpack_bates)
from mc_tpu.models.heston import heston_euler_step
from mc_tpu.models.merton import (_jump_increment, _poisson_inv_cdf,
                                  poisson_kmax)
from mc_tpu.nmc import NMCResult
from mc_tpu.nmc_engine import (NMCFamily, price_nmc_family,
                               register_nmc_family)

__all__ = ["price_nmc_bates"]

STREAM_OUTER, STREAM_INNER = 0, 1


class BatesNMC(NMCFamily):
    """Bates physics for the generic NMC engine: market grids (S, v);
    ``extras = (kmax,)`` — the static Poisson scan depth."""

    name = "bates"
    tag = 0xBA7E
    n_grids = 2
    even_steps = False

    @property
    def kmax(self):
        return self.extras[0]

    def span(self, n_steps, n_inner):
        # c_base uses j+1 (max n_steps) at stride 3*n_steps per leg.
        return (3 * (n_steps + 1) * n_inner * n_steps,
                "3*(n_steps+1)*n_inner*n_steps")

    def counter_stride(self, n_steps):
        return 3 * n_steps

    def pack(self, option, dyn, n_steps):
        return _pack_bates(option, dyn, n_steps)

    def unpack(self, params):
        return _unpack_bates(params)

    def leg(self, payoff, p, ctx, ki0, ki1, ids, c_base, j, remaining,
            grids_j, state_t, n_steps):
        s_t, v_t = grids_j
        kmax = self.kmax

        def step(u, carry2):
            w, v, state = carry2
            cu = c_base + jnp.uint32(3) * jnp.asarray(u, jnp.uint32)
            c1 = jnp.full(ids.shape, 0, jnp.uint32) + cu
            z_v, z_p = rng.normal_pair(ki0, ki1, ids, c1)
            e, _ = rng.normal_pair(ki0, ki1, ids, c1 + jnp.uint32(1))
            b0, _ = rng.threefry2x32(ki0, ki1, ids, c1 + jnp.uint32(2),
                                     rounds=rng.DEFAULT_ROUNDS)
            uu = rng.bits_to_unit(b0)
            w, v = heston_euler_step(p, w, v, z_v, z_p, p.dt, p.sqrt_dt)
            nj = _poisson_inv_cdf(uu, p.lam_dt, kmax)
            w = w + _jump_increment(p, nj, e)
            state = payoff.update(state, s_t * jnp.exp(w), p)
            return (w, v, state)

        w, v, state = jax.lax.fori_loop(
            0, remaining, step, (jnp.zeros_like(s_t), v_t, state_t))
        return payoff.terminal(state, s_t * jnp.exp(w), p)

    # --- Andersen-Broadie / LSMC rollout hooks --------------------------

    rollout_pairs_per_step = 3  # (z_v,z_perp) pair + jump normal + uniform

    def rollout_carry(self, p, ctx, grids_j):
        s_t, v_t = grids_j
        return (s_t, jnp.zeros_like(s_t), v_t)

    def rollout_step(self, p, ctx, carry, d, u):
        s_t, w, v = carry
        z_v, z_p = d.pair(0)
        e, _ = d.pair(1)
        w, v = heston_euler_step(p, w, v, z_v, z_p, p.dt, p.sqrt_dt)
        nj = _poisson_inv_cdf(d.unit(2), p.lam_dt, self.kmax)
        w = w + _jump_increment(p, nj, e)
        return (s_t, w, v), jnp.exp(-p.r * p.dt)

    def rollout_spot(self, p, ctx, carry):
        return carry[0] * jnp.exp(carry[1])

    def rollout_t0(self, p):
        return (p.s0, p.v0)

    def mlmc_coarse_step(self, p_f, p_c, ctx_c, carry, d1, d2, u):
        """MLMC coupling: Brownian parts sum-couple through the standard
        (z1+z2)/sqrt(2) (both the spot and variance drivers), the jump
        part couples at the INCREMENT level exactly as MertonNMC — the
        sum of the two fine compound increments IS the coarse compound
        in law (N1+N2 ~ Poisson(lam*2dt); sqrt(n1)e1+sqrt(n2)e2 ~
        sqrt(n1+n2)N(0,1) given the counts), so the coarse leg's law
        equals level l-1's fine leg and the telescope stays exact."""
        inv_sqrt2 = jnp.float32(0.7071067811865476)
        s_t, w, v = carry
        z1v, z1p = d1.pair(0)
        z2v, z2p = d2.pair(0)
        e1, _ = d1.pair(1)
        e2, _ = d2.pair(1)
        zc_v = (z1v + z2v) * inv_sqrt2
        zc_p = (z1p + z2p) * inv_sqrt2
        w, v = heston_euler_step(p_c, w, v, zc_v, zc_p, p_c.dt,
                                 p_c.sqrt_dt)
        n1 = _poisson_inv_cdf(d1.unit(2), p_f.lam_dt, self.kmax)
        n2 = _poisson_inv_cdf(d2.unit(2), p_f.lam_dt, self.kmax)
        w = (w + _jump_increment(p_f, n1, e1)
             + _jump_increment(p_f, n2, e2))
        return (s_t, w, v), jnp.exp(-p_c.r * p_c.dt)

    def lsmc_basis_point(self, p, carry, s, degree, inv_k):
        from mc_tpu.lsmc import _basis_sv
        return _basis_sv(s * inv_k, carry[2], degree)

    def lsmc_design(self, p, grids_flat, degree, inv_k):
        # stochastic-vol LSMC: continuation regressed on (S, v) — jumps
        # add no extra state (i.i.d. across steps)
        from mc_tpu.lsmc import _basis_sv
        s, v = grids_flat[0], grids_flat[1]
        return (lambda t: _basis_sv(s[t] * inv_k, v[t], degree),
                degree + 4)

    # --- outer-path physics ---------------------------------------------

    outer_steps_per_block = 1

    def outer_init(self, p, ctx, s0, state0):
        # s rides the carry: outer_pay must consume the SAME rounded
        # spot the step persisted (see nmc_merton.MertonNMC.outer_init)
        return (jnp.zeros_like(s0), jnp.full_like(s0, p.v0), s0, state0)

    def outer_block(self, payoff, p, ctx, ids, ko0, ko1, carry, m):
        w, v, s, state = carry
        base = jnp.uint32(3) * m
        c1 = jnp.full(ids.shape, 0, jnp.uint32) + base
        z_v, z_p = rng.normal_pair(ko0, ko1, ids, c1)
        e, _ = rng.normal_pair(ko0, ko1, ids, c1 + jnp.uint32(1))
        b0, _ = rng.threefry2x32(ko0, ko1, ids, c1 + jnp.uint32(2),
                                 rounds=rng.DEFAULT_ROUNDS)
        uu = rng.bits_to_unit(b0)
        w, v = heston_euler_step(p, w, v, z_v, z_p, p.dt, p.sqrt_dt)
        nj = _poisson_inv_cdf(uu, p.lam_dt, self.kmax)
        w = w + _jump_increment(p, nj, e)
        s = p.s0 * jnp.exp(w)
        state = payoff.update(state, s, p)
        cv = state[0] if payoff.n_state else jnp.zeros_like(s)
        return (w, v, s, state), ((s, v, cv),)

    def outer_pay(self, payoff, p, ctx, carry):
        _, _, s, state = carry
        return payoff.terminal(state, s, p)


def price_nmc_bates(option: OptionParams = DEMO_OPTION,
                    dyn: BatesDynamics = DEMO_BATES,
                    sim: SimParams = DEMO_SIM,
                    payoff="vanilla_call",
                    *,
                    tile_rows: int = 8,
                    stream_outer: int = STREAM_OUTER,
                    stream_inner: int = STREAM_INNER) -> NMCResult:
    """Nested MC price surface under Bates SVJ dynamics.

    Every (path, step) point is re-priced by ``sim.n_paths_inner`` inner
    SVJ legs resumed from the stored (S_t, v_t, payoff state): exposure
    profiles and CVA under joint stochastic-vol + crash risk.
    """
    kmax = poisson_kmax(float(dyn.lam) * float(option.t) / sim.n_steps)
    return price_nmc_family(BatesNMC(extras=(kmax,)), option,
                            dyn.as_f32(), sim, payoff, tile_rows=tile_rows,
                            stream_outer=stream_outer,
                            stream_inner=stream_inner)


def _bates_builder(option, dyn, sim):
    dyn = DEMO_BATES if dyn is None else dyn
    kmax = poisson_kmax(float(dyn.lam) * float(option.t) / sim.n_steps)
    return BatesNMC(extras=(kmax,)), dyn.as_f32()


register_nmc_family("bates", price_nmc_bates, _bates_builder)
