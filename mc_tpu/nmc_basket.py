"""Multi-asset nested Monte Carlo: exposure under a correlated basket.

Extends the flagship NMC capability (``/root/reference/inc/nmc.cuh``,
single-asset GBM) to d correlated assets on the generic `nmc_engine`:
inner legs resume from the FULL stored d-asset state (S_1..S_d at the
point) and re-run the correlated log-Euler scheme of
`models/basket._basket_leg` — the conditional value of a basket position
depends on every asset level, not just the basket level, so the engine's
market grids are the d per-asset price grids.

Margrabe exposure falls out for free: a 2-asset book with weights
(+1, -1) and strike 0 makes the basket level S1 - S2, so ``vanilla_call``
IS the exchange option — its EE profile is gated flat at the Margrabe
(1978) closed form (martingale property under full e^{-rT} discounting).

Stream conventions (matching `price_basket`): outer step j consumes
threefry pairs ``j*ceil(d/2) + q``; inner leg m at point (i, j) consumes
pairs ``c_base + u*ceil(d/2) + q`` with ``c_base = ((j+1)*n_inner + m) *
n_steps*ceil(d/2)``.  At d=1 this is `price_basket`'s one-pair-per-step
layout (only z0 used), NOT the GBM kernels' both-normals layout — so the
d=1 check against GBM NMC is distributional (gated in tests), while the
within-family pallas/XLA parity is bitwise as everywhere else.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from mc_tpu import rng
from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.models.basket import (DEMO_BASKET, BasketDynamics,
                                  _basket_namespace, _pack_basket,
                                  _unpack_basket)
from mc_tpu.nmc import NMCResult
from mc_tpu.nmc_engine import (NMCFamily, price_nmc_family,
                               register_nmc_family)

__all__ = ["price_nmc_basket"]


class BasketNMC(NMCFamily):
    """d-asset correlated-GBM physics for the generic NMC engine:
    market grids (S_1, ..., S_d); ``extras = (d,)``."""

    name = "basket"
    tag = 0xBA5C
    even_steps = False

    @property
    def d(self):
        return self.extras[0]

    @property
    def n_grids(self):
        return self.extras[0]

    def span(self, n_steps, n_inner):
        npps = (self.d + 1) // 2
        return ((n_steps + 1) * n_inner * n_steps * npps,
                "(n_steps+1)*n_inner*n_steps*ceil(d/2)")

    def counter_stride(self, n_steps):
        return n_steps * ((self.d + 1) // 2)

    def pack(self, option, dyn, n_steps):
        return _pack_basket(_basket_namespace(option, dyn, n_steps),
                            self.d)

    def unpack(self, params):
        return _unpack_basket(params, self.d)

    @staticmethod
    def _basket_of(p, d, ws):
        b = None
        for i in range(d):
            term = p.weights[i] * (p.s0s[i] * jnp.exp(ws[i]))
            b = term if b is None else b + term
        return b

    def _mix_step(self, p, ws, zs):
        """Cholesky mix + per-asset log increment (_basket_leg:109-117)."""
        d = self.d
        new_ws = []
        for i in range(d):
            y = None
            for k in range(i + 1):
                term = p.chol[i][k] * zs[k]
                y = term if y is None else y + term
            new_ws.append(ws[i] + p.drifts[i] + p.sqrt_dt * y)
        return tuple(new_ws)

    def leg(self, payoff, p, ctx, ki0, ki1, ids, c_base, j, remaining,
            grids_j, state_t, n_steps):
        d = self.d
        npps = (d + 1) // 2
        # resume: per-asset log-moneyness from the stored price levels
        ws0 = tuple(jnp.log(grids_j[i] / p.s0s[i]) for i in range(d))

        def step(u, carry2):
            ws, state = carry2
            zs = []
            for q in range(npps):
                cc = (c_base
                      + jnp.asarray(u, jnp.uint32) * jnp.uint32(npps)
                      + jnp.uint32(q))
                c1 = jnp.full(ids.shape, 0, jnp.uint32) + cc
                z0, z1 = rng.normal_pair(ki0, ki1, ids, c1)
                zs += [z0, z1]
            ws = self._mix_step(p, ws, zs[:d])
            b = self._basket_of(p, d, ws)
            return (ws, payoff.update(state, b, p))

        ws, state = jax.lax.fori_loop(0, remaining, step, (ws0, state_t))
        return payoff.terminal(state, self._basket_of(p, d, ws), p)

    # --- LSMC hooks: per-asset cross basis ----------------------------
    # The continuation value of a multi-asset contract depends on every
    # asset level, not just the folded payoff level, so the regression
    # runs on per-asset moneyness monomials plus the pairwise cross
    # terms (Longstaff-Schwarz 2001 Sec. 8's basis for two-asset max
    # options, generalized): 1, x_i^k (k <= degree), x_i x_j (i < j)
    # with x_i = S_i/s0_i - 1 centered for f32 conditioning like
    # lsmc._basis.

    def lsmc_level(self, p, grids_flat):
        lvl = None
        for i in range(self.d):
            term = p.weights[i] * grids_flat[i]
            lvl = term if lvl is None else lvl + term
        return lvl

    def lsmc_design(self, p, grids_flat, degree, inv_k):
        d = self.d
        lvl = self.lsmc_level(p, grids_flat)

        def design(t):
            xs = [grids_flat[i][t] / p.s0s[i] - 1.0 for i in range(d)]
            # level moneyness monomials FIRST: deep in the money the
            # continuation is ~linear in the payoff level (cont ≈ lvl -
            # K e^{-r tau}), and for order-statistic levels (RainbowNMC)
            # the max/min fold is not a polynomial in the x_i — without
            # these columns the fit under-predicts deep-ITM continuation
            # and spuriously exercises the most valuable paths (~2% low
            # bias measured on the two-asset call-on-max)
            m = lvl[t] * inv_k - 1.0
            cols = [jnp.ones_like(m)]
            pw = m
            for _ in range(degree):
                cols.append(pw)
                pw = pw * m
            for x in xs:
                pw = x
                for _ in range(degree):
                    cols.append(pw)
                    pw = pw * x
            for i in range(d):
                for j in range(i + 1, d):
                    cols.append(xs[i] * xs[j])
            return jnp.stack(cols, axis=-1)

        return design, 1 + (d + 1) * degree + d * (d - 1) // 2

    # --- Andersen-Broadie rollout hooks -------------------------------
    # Rollout state = the d per-asset log-moneyness values; each substep
    # draws ceil(d/2) pairs and applies the same Cholesky mix the
    # pricing legs run.  The continuation basis at a rollout state must
    # reproduce lsmc_design's column layout exactly (the dual re-reads
    # the FITTED betas).

    @property
    def rollout_pairs_per_step(self):
        return (self.d + 1) // 2

    def rollout_carry(self, p, ctx, grids_j):
        return tuple(jnp.log(grids_j[i] / p.s0s[i])
                     for i in range(self.d))

    def rollout_step(self, p, ctx, carry, d, u):
        zs = []
        for q in range((self.d + 1) // 2):
            z0, z1 = d.pair(q)
            zs += [z0, z1]
        return (self._mix_step(p, carry, zs[:self.d]),
                jnp.exp(-p.r * p.dt))

    def rollout_spot(self, p, ctx, carry):
        return self._basket_of(p, self.d, carry)

    def rollout_t0(self, p):
        return tuple(p.s0s[i] for i in range(self.d))

    def lsmc_basis_point(self, p, carry, s, degree, inv_k):
        d = self.d
        xs = [jnp.exp(carry[i]) - 1.0 for i in range(d)]
        m = s * inv_k - 1.0
        cols = [jnp.ones_like(m)]
        pw = m
        for _ in range(degree):
            cols.append(pw)
            pw = pw * m
        for x in xs:
            pw = x
            for _ in range(degree):
                cols.append(pw)
                pw = pw * x
        for i in range(d):
            for j in range(i + 1, d):
                cols.append(xs[i] * xs[j])
        return jnp.stack(cols, axis=-1)

    outer_steps_per_block = 1

    def outer_init(self, p, ctx, s0, state0):
        # the basket level b rides the carry: outer_pay must consume the
        # SAME rounded value the step fed payoff.update (see
        # nmc_merton.MertonNMC.outer_init)
        zeros = jnp.zeros_like(s0)
        b0 = self._basket_of(p, self.d, tuple(zeros for _ in range(self.d)))
        return (tuple(zeros for _ in range(self.d)), b0, state0)

    def outer_block(self, payoff, p, ctx, ids, ko0, ko1, carry, m):
        d = self.d
        npps = (d + 1) // 2
        ws, _, state = carry
        zs = []
        for q in range(npps):
            c1 = (jnp.full(ids.shape, 0, jnp.uint32)
                  + m * jnp.uint32(npps) + jnp.uint32(q))
            z0, z1 = rng.normal_pair(ko0, ko1, ids, c1)
            zs += [z0, z1]
        ws = self._mix_step(p, ws, zs[:d])
        b = self._basket_of(p, d, ws)
        state = payoff.update(state, b, p)
        cv = state[0] if payoff.n_state else jnp.zeros_like(b)
        s_levels = tuple(p.s0s[i] * jnp.exp(ws[i]) for i in range(d))
        return (ws, b, state), (s_levels + (cv,),)

    def outer_pay(self, payoff, p, ctx, carry):
        _, b, state = carry
        return payoff.terminal(state, b, p)


def price_nmc_basket(option: OptionParams = DEMO_OPTION,
                     basket: BasketDynamics = DEMO_BASKET,
                     sim: SimParams = DEMO_SIM,
                     payoff="vanilla_call",
                     *,
                     tile_rows: int = 8,
                     stream_outer: int = 0,
                     stream_inner: int = 1) -> NMCResult:
    """Nested MC price surface on a correlated d-asset basket.

    Every (path, step) point is re-priced by ``sim.n_paths_inner`` inner
    legs resumed from the stored d-asset state (S_1..S_d, payoff state):
    exposure profiles and CVA of basket positions under correlation.
    Weights may be signed — weights (1, -1) with k=0 gives Margrabe
    exchange exposure (gated vs the closed form).
    """
    b32 = basket.as_f32()
    return price_nmc_family(BasketNMC(extras=(b32.d,)), option, b32, sim,
                            payoff, tile_rows=tile_rows,
                            stream_outer=stream_outer,
                            stream_inner=stream_inner)


def _basket_builder(option, dyn, sim):
    b32 = (DEMO_BASKET if dyn is None else dyn).as_f32()
    return BasketNMC(extras=(b32.d,)), b32


register_nmc_family("basket", price_nmc_basket, _basket_builder)
