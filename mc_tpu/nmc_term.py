"""Nested Monte Carlo under term structures — deterministic r(t)/sigma(t)
curves (models/term.py) on the generic engine: exposure profiles whose
underlying diffuses with the CALENDAR-dated vol and drifts with the
forward curve, completing the NMC matrix across every step-loop family.

A dynamics definition only: the curves ride the packed parameter vector
(drift/vol per step after the scalar head), the inner legs index them by
ABSOLUTE move index j+1+u (the localvol convention), and discounting is
the curve-average e^{-r_bar T} (exact for the averaged curve, the
`price_term` convention — so the fully-discounted conditional value of a
call is a martingale and EE is gated flat at the time-0 term price).

Inner-draw convention: point (i, j), inner path m consumes threefry
pairs ``((j+1)*n_inner + m)*pair_cap + q``, pair_cap = ceil(n_steps/2),
two substeps per pair with the trailing odd substep dropped by a
predicated select.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from mc_tpu import rng
from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.models.term import (_HDR, TermStructure, _pack_term,
                                _unpack_term_head)
from mc_tpu.nmc import NMCResult
from mc_tpu.nmc_engine import (NMCFamily, price_nmc_family,
                               register_nmc_family)

__all__ = ["price_nmc_term"]


class TermNMC(NMCFamily):
    """Term-structure physics for the generic NMC engine: market grid
    (S,); ``extras = (n_steps,)`` (the curve length, for ctx)."""

    name = "term"
    tag = 0x7E53
    n_grids = 1
    even_steps = True

    def span(self, n_steps, n_inner):
        return ((n_steps + 1) * n_inner * ((n_steps + 1) // 2),
                "(n_steps+1)*n_inner*ceil(n_steps/2)")

    def counter_stride(self, n_steps):
        return (n_steps + 1) // 2  # one pair per two substeps

    def pack(self, option, dyn, n_steps):
        return _pack_term(option, dyn, n_steps)

    def unpack(self, params):
        return _unpack_term_head(params)

    def make_ctx(self, params, n_steps):
        drift_at = lambda j: params[_HDR + j]
        vol_at = lambda j: params[_HDR + n_steps + j]
        return (drift_at, vol_at)

    def leg(self, payoff, p, ctx, ki0, ki1, ids, c_base, j, remaining,
            grids_j, state_t, n_steps):
        (s_t,) = grids_j
        drift_at, vol_at = ctx
        w0 = jnp.log(s_t / p.s0)
        last = jnp.int32(n_steps - 1)

        def substep(w, state, z, u):
            uu = jnp.minimum(u, last)  # overrun substep clamped (masked)
            w = w + (drift_at(uu) + vol_at(uu) * z)
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

    outer_steps_per_block = 2

    def outer_init(self, p, ctx, s0, state0):
        # s rides the carry: outer_pay must consume the SAME rounded
        # spot the step persisted (see nmc_merton.MertonNMC.outer_init)
        return (jnp.zeros_like(s0), s0, state0)

    def outer_block(self, payoff, p, ctx, ids, ko0, ko1, carry, m):
        # mirrors _term_leg's pair loop: pair m -> moves 2m, 2m+1
        drift_at, vol_at = ctx
        w, s, state = carry
        c1 = jnp.full(ids.shape, 0, jnp.uint32) + m
        z0, z1 = rng.normal_pair(ko0, ko1, ids, c1)
        recs = []
        for move, z in ((2 * m, z0), (2 * m + 1, z1)):
            w = w + (drift_at(move) + vol_at(move) * z)
            s = p.s0 * jnp.exp(w)
            state = payoff.update(state, s, p)
            cv = state[0] if payoff.n_state else jnp.zeros_like(s)
            recs.append((s, cv))
        return (w, s, state), tuple(recs)

    def outer_pay(self, payoff, p, ctx, carry):
        _, s, state = carry
        return payoff.terminal(state, s, p)


def price_nmc_term(option: OptionParams = DEMO_OPTION,
                   dyn: TermStructure = None,
                   sim: SimParams = DEMO_SIM,
                   payoff="vanilla_call",
                   *,
                   tile_rows: int = 8,
                   stream_outer: int = 0,
                   stream_inner: int = 1) -> NMCResult:
    """Nested MC price surface under deterministic r(t)/sigma(t) curves:
    exposure profiles whose scenarios respect the term structure."""
    if dyn is None:
        dyn = TermStructure.from_knots([0.10, 0.07, 0.05],
                                       [0.15, 0.22, 0.30], sim.n_steps)
    if dyn.rates.shape[0] != sim.n_steps:
        raise ValueError(f"term structure has {dyn.rates.shape[0]} steps, "
                         f"sim has {sim.n_steps}")
    return price_nmc_family(TermNMC(), option, dyn.as_f32(), sim, payoff,
                            tile_rows=tile_rows,
                            stream_outer=stream_outer,
                            stream_inner=stream_inner)


def _term_builder(option, dyn, sim):
    if dyn is None:
        dyn = TermStructure.from_knots([0.10, 0.07, 0.05],
                                       [0.15, 0.22, 0.30], sim.n_steps)
    if dyn.rates.shape[0] != sim.n_steps:
        raise ValueError(f"term structure has {dyn.rates.shape[0]} steps, "
                         f"sim has {sim.n_steps}")
    return TermNMC(), dyn.as_f32()


register_nmc_family("term", price_nmc_term, _term_builder)
