"""Nested Monte Carlo under Merton jump-diffusion.

Extends the flagship NMC capability (the reference's ``inc/nmc.cuh``
re-pricing of every (path, step) point, SURVEY.md C10-C12) to the jump
model family: conditional re-pricing resumes from the stored
``(S_t, payoff_state_t)`` (the compound-Poisson increments are i.i.d., so
S is the whole market state) with jump-diffusion inner legs.  Exposure
profiles and CVA under CRASH RISK: jumps fatten the exposure tail, so
PFE/CVA under Merton exceed their diffusion-model counterparts at matched
vol — the standard XVA argument for jump models.

The engine is the generic `nmc_engine`; this module supplies the Merton
physics (exact-in-law compound-Poisson inner legs; the Poisson
inverse-CDF scan depth ``kmax`` rides in the family's static extras).

Inner-draw convention: point (path i, step j), inner path m, substep u
consumes counters ``c_base + 2u`` (Box-Muller pair -> diffusion normal z,
jump-size normal e) and ``c_base + 2u + 1`` (raw bits -> Poisson uniform)
with ``c_base = ((j+1) * n_inner + m) * 2 * n_steps``.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from mc_tpu import rng
from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.models.merton import (DEMO_MERTON, MertonDynamics,
                                  _jump_increment, _pack_merton,
                                  _poisson_inv_cdf, _unpack_merton,
                                  poisson_kmax)
from mc_tpu.nmc import NMCResult
from mc_tpu.nmc_engine import (NMCFamily, price_nmc_family,
                               register_nmc_family)

__all__ = ["price_nmc_merton"]

STREAM_OUTER, STREAM_INNER = 0, 1


class MertonNMC(NMCFamily):
    """Merton physics for the generic NMC engine: market grid (S,);
    ``extras = (kmax,)`` — the static Poisson scan depth."""

    name = "Merton"
    tag = 0x3E44
    n_grids = 1
    even_steps = True

    @property
    def kmax(self):
        return self.extras[0]

    def span(self, n_steps, n_inner):
        # t_base uses j+1 (max n_steps), so the counter layout spans
        # 2*(n_steps+1)*n_inner per step-row.
        return (2 * (n_steps + 1) * n_inner * n_steps,
                "2*(n_steps+1)*n_inner*n_steps")

    def counter_stride(self, n_steps):
        return 2 * n_steps

    def pack(self, option, dyn, n_steps):
        return _pack_merton(option, dyn, n_steps)

    def unpack(self, params):
        return _unpack_merton(params)

    def leg(self, payoff, p, ctx, ki0, ki1, ids, c_base, j, remaining,
            grids_j, state_t, n_steps):
        (s_t,) = grids_j
        kmax = self.kmax

        def step(u, carry2):
            w, state = carry2
            cu = c_base + jnp.uint32(2) * jnp.asarray(u, jnp.uint32)
            c1 = jnp.full(ids.shape, 0, jnp.uint32) + cu
            z, e = rng.normal_pair(ki0, ki1, ids, c1)
            b0, _ = rng.threefry2x32(ki0, ki1, ids,
                                     c1 + jnp.uint32(1),
                                     rounds=rng.DEFAULT_ROUNDS)
            uu = rng.bits_to_unit(b0)
            nj = _poisson_inv_cdf(uu, p.lam_dt, kmax)
            w = w + p.drift_dt + p.vol_dt * z + _jump_increment(p, nj, e)
            state = payoff.update(state, s_t * jnp.exp(w), p)
            return (w, state)

        w, state = jax.lax.fori_loop(0, remaining, step,
                                     (jnp.zeros_like(s_t), state_t))
        return payoff.terminal(state, s_t * jnp.exp(w), p)

    rollout_pairs_per_step = 2  # (z, e) pair + Poisson uniform

    def rollout_carry(self, p, ctx, grids_j):
        (s_t,) = grids_j
        return (s_t, jnp.zeros_like(s_t))

    def rollout_step(self, p, ctx, carry, d, u):
        s_t, w = carry
        z, e = d.pair(0)
        nj = _poisson_inv_cdf(d.unit(1), p.lam_dt, self.kmax)
        w = w + p.drift_dt + p.vol_dt * z + _jump_increment(p, nj, e)
        return (s_t, w), jnp.exp(-p.r * p.dt)

    def rollout_spot(self, p, ctx, carry):
        return carry[0] * jnp.exp(carry[1])

    def mlmc_coarse_step(self, p_f, p_c, ctx_c, carry, d1, d2, u):
        """MLMC coupling at the INCREMENT level: the coarse 2dt step
        consumes the two fine substeps' draws exactly.

        The Brownian part sum-couples as usual (vol_c*(z1+z2)/sqrt2 ==
        vol_f*(z1+z2)); the jump part simply SUMS the two fine compound
        increments — a sum of independent compound-Poisson-normal
        increments IS the coarse compound (N_1+N_2 ~ Poisson(lam*2dt),
        and sqrt(n1)e1 + sqrt(n2)e2 ~ sqrt(n1+n2)N(0,1) given the
        counts), so the coarse leg's law equals level l-1's fine leg
        and the telescope stays exact.  The uniform draws never need a
        sum-coupling (the reason the draws-combining shim can't serve
        this family): counts are recovered per FINE substep at the fine
        intensity and combined downstream of the inverse CDF."""
        s_t, w = carry
        z1, e1 = d1.pair(0)
        z2, e2 = d2.pair(0)
        n1 = _poisson_inv_cdf(d1.unit(1), p_f.lam_dt, self.kmax)
        n2 = _poisson_inv_cdf(d2.unit(1), p_f.lam_dt, self.kmax)
        zc = (z1 + z2) * jnp.float32(0.7071067811865476)
        w = (w + p_c.drift_dt + p_c.vol_dt * zc
             + _jump_increment(p_f, n1, e1) + _jump_increment(p_f, n2, e2))
        return (s_t, w), jnp.exp(-p_c.r * p_c.dt)

    outer_steps_per_block = 2

    def outer_init(self, p, ctx, s0, state0):
        # s rides the carry so outer_pay consumes the SAME rounded value
        # the step persisted (recomputing s0*exp(w) at pay time lets XLA
        # contract the multiply into the payoff's subtract — 1-ulp drift
        # vs the trajectory kernels)
        return (jnp.zeros_like(s0), s0, state0)

    def outer_block(self, payoff, p, ctx, ids, ko0, ko1, carry, m):
        from mc_tpu.models.merton import _merton_draw3
        kmax = self.kmax
        w, s, state = carry
        z0, z1, e0, e1, u0, u1 = _merton_draw3(ko0, ko1, ids, m)
        recs = []
        for z, e, u in ((z0, e0, u0), (z1, e1, u1)):
            nj = _poisson_inv_cdf(u, p.lam_dt, kmax)
            w = w + p.drift_dt + p.vol_dt * z + _jump_increment(p, nj, e)
            s = p.s0 * jnp.exp(w)
            state = payoff.update(state, s, p)
            cv = state[0] if payoff.n_state else jnp.zeros_like(s)
            recs.append((s, cv))
        return (w, s, state), tuple(recs)

    def outer_pay(self, payoff, p, ctx, carry):
        _, s, state = carry
        return payoff.terminal(state, s, p)


def price_nmc_merton(option: OptionParams = DEMO_OPTION,
                     dyn: MertonDynamics = DEMO_MERTON,
                     sim: SimParams = DEMO_SIM,
                     payoff="vanilla_call",
                     *,
                     tile_rows: int = 8,
                     stream_outer: int = STREAM_OUTER,
                     stream_inner: int = STREAM_INNER) -> NMCResult:
    """Nested MC price surface under Merton jump-diffusion.

    Every (path, step) point is re-priced by ``sim.n_paths_inner`` inner
    jump-diffusion legs resumed from the stored (S_t, payoff state):
    exposure profiles (``result.exposure_profile()``) and CVA
    (``result.cva(...)``) under crash risk.
    """
    kmax = poisson_kmax(float(dyn.lam) * float(option.t) / sim.n_steps)
    return price_nmc_family(MertonNMC(extras=(kmax,)), option,
                            dyn.as_f32(), sim, payoff, tile_rows=tile_rows,
                            stream_outer=stream_outer,
                            stream_inner=stream_inner)


def _merton_builder(option, dyn, sim):
    dyn = DEMO_MERTON if dyn is None else dyn
    kmax = poisson_kmax(float(dyn.lam) * float(option.t) / sim.n_steps)
    return MertonNMC(extras=(kmax,)), dyn.as_f32()


register_nmc_family("merton", price_nmc_merton, _merton_builder)
