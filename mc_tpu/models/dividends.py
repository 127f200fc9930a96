"""GBM with DISCRETE CASH dividends — the contract feature q cannot fake.

A continuous yield q scales the forward; real equity desks carry dated
CASH amounts: at dividend step j the spot drops by the payment,
``S -> max(S - D_j, floor)``.  Between payments the log-Euler step is
exact in law, so the only discretization in the scheme is the (exact)
placement of each payment at its step boundary — matched 1:1 by the
quadrature oracle below, making the gate sharp rather than "close".

Device mapping: per-step dividend amounts ride the packed parameter
vector after the scalar head (the `models/term.py` per-step-curve
pattern); the step
keeps the price in LEVEL space (the cash drop breaks log-space
accumulation) with one multiplicative exact-in-law GBM factor per step.

Oracle: for a single dividend at step j_d (time tau), the call price is
EXACT by 1-D Gauss-Hermite quadrature over the lognormal pre-dividend
spot:  C = e^{-r tau} E[ BS(max(S_tau - D, floor), K, T - tau) ].
A model-exact put-call parity gate (the post-dividend forward has a
closed form via the undiscounted (S_tau - D)^+ expectation) covers the
multi-dividend case.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mc_tpu import rng
from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.engines import STREAM_OUTER
from mc_tpu.oracle import PriceResult, summarize
from mc_tpu.ops import path_kernels as pk
from mc_tpu.ops._pallas import xla_moment_scan
from mc_tpu.ops.payoffs import get_payoff
from mc_tpu.ops.reduce import finish_sum

__all__ = ["price_divs", "div_schedule", "bs_call_cash_div",
           "cash_div_forward"]

_DIV_FLOOR = 1e-6  # absorbing floor after a payment exceeding the spot

_HDR_FIELDS = ("s0", "k", "r", "barrier", "p1", "p2", "t", "q", "sigma",
               "dt", "inv_n_steps", "drift_dt", "vol_dt")
_HDR = len(_HDR_FIELDS)


def div_schedule(n_steps: int, steps: Sequence[int],
                 amounts: Sequence[float]) -> np.ndarray:
    """(n_steps,) f32 per-step cash amounts from (step index, amount)
    pairs; step j means the payment lands right AFTER the j-th step's
    diffusion move (time (j+1)/n * T)."""
    divs = np.zeros(n_steps, np.float32)
    for j, a in zip(steps, amounts):
        if not 0 <= int(j) < n_steps:
            raise ValueError(f"dividend step {j} outside [0, {n_steps})")
        if a < 0:
            raise ValueError(f"negative dividend {a}")
        divs[int(j)] += np.float32(a)
    return divs


def _pack_divs(option, divs, n_steps):
    s0, t, k, r, sigma, barrier, p1, p2, q = (
        jnp.float32(v) for v in option.astuple())
    n = jnp.float32(n_steps)
    dt = t / n
    head = jnp.stack([s0, k, r, barrier, p1, p2, t, q, sigma, dt, 1.0 / n,
                      (r - q - 0.5 * sigma * sigma) * dt,
                      sigma * jnp.sqrt(dt)])
    return jnp.concatenate([head, jnp.asarray(divs, jnp.float32)])


def _unpack_divs_head(ref):
    return SimpleNamespace(**{f: ref[i]
                              for i, f in enumerate(_HDR_FIELDS)})


def _divs_leg(payoff, n_steps: int, p, div_at, s0, draw_pair,
              antithetic_sign=1.0):
    """Level-space leg: exact-in-law GBM factor per step, then the cash
    drop ``s = max(s - D_j, floor)``; one pair per two steps."""
    sign = jnp.float32(antithetic_sign)
    state0 = payoff.init(p, jnp.zeros_like(s0))

    def one_step(carry, j, z):
        s, state = carry
        s = s * jnp.exp(p.drift_dt + p.vol_dt * z)
        s = jnp.maximum(s - div_at(j), jnp.float32(_DIV_FLOOR))
        return (s, payoff.update(state, s, p))

    def pair_body(j, carry):
        z0, z1 = draw_pair(j)
        carry = one_step(carry, 2 * j, sign * z0)
        carry = one_step(carry, 2 * j + 1, sign * z1)
        return carry

    s_t, state = jax.lax.fori_loop(0, n_steps // 2, pair_body,
                                   (s0, state0))
    return payoff.terminal(state, s_t, p)


def _divs_tile(payoff, n_steps, antithetic, params_ref, ids, valid, k0,
               k1):
    p = _unpack_divs_head(params_ref)
    div_at = lambda j: params_ref[_HDR + j]
    shape = ids.shape

    def draw_pair(m):
        c1 = jnp.full(shape, 0, jnp.uint32) + jnp.asarray(m, jnp.uint32)
        return rng.normal_pair(k0, k1, ids, c1)

    s0 = jnp.full(shape, 1.0, jnp.float32) * p.s0
    pay = _divs_leg(payoff, n_steps, p, div_at, s0, draw_pair)
    if antithetic:
        pay = 0.5 * (pay + _divs_leg(payoff, n_steps, p, div_at, s0,
                                     draw_pair, antithetic_sign=-1.0))
    return jnp.where(valid, pay, 0.0)


def _divs_partials(payoff, cfg, key, params, path_offset=0, n_valid=None):
    """(sum, sumsq) (8,128) slabs for this shard's global path-id range."""
    offset = jnp.asarray(path_offset, jnp.uint32)
    bound = (offset + jnp.uint32(cfg.n_paths) if n_valid is None
             else jnp.asarray(n_valid, jnp.uint32))
    k0 = jnp.asarray(key[0], jnp.uint32)
    k1 = jnp.asarray(key[1], jnp.uint32)

    def tile_fn(ids, valid):
        pay = _divs_tile(payoff, cfg.n_steps, cfg.antithetic, params, ids,
                         valid, k0, k1)
        return [pay, pay * pay]

    return xla_moment_scan(tile_fn, cfg.n_paths, cfg.tile_rows, 2,
                           offset=offset, bound=bound)


@functools.partial(
    jax.jit,
    static_argnames=("payoff", "sim", "antithetic", "tile_rows"))
def _price_divs_impl(option, divs, payoff, sim, antithetic,
                     tile_rows, key):
    cfg = pk.KernelConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                          tile_rows=tile_rows, antithetic=antithetic)
    params = _pack_divs(option, divs, sim.n_steps)
    s, sq = _divs_partials(payoff, cfg, key, params)
    r = jnp.float32(option.r)
    t = jnp.float32(option.t)
    return summarize(finish_sum(s), finish_sum(sq),
                     jnp.asarray(sim.n_paths, jnp.float32),
                     jnp.exp(-r * t))


def price_divs(option: OptionParams = DEMO_OPTION,
               divs=None,
               sim: SimParams = DEMO_SIM,
               payoff="vanilla_call",
               *,
               antithetic: bool = False,
               tile_rows: int = 128,
               stream: int = STREAM_OUTER,
               key=None) -> PriceResult:
    """Monte Carlo price under GBM with discrete CASH dividends.

    ``divs``: (n_steps,) per-step cash amounts (build with
    `div_schedule`); every registry payoff sees the POST-dividend path.
    A zero schedule reduces to plain GBM (gated in tests).
    """
    po = get_payoff(payoff)
    po.validate(option, sim.n_steps)
    if sim.n_steps % 2:
        raise ValueError("dividends require an even n_steps "
                         "(pair-consuming step loop)")
    if divs is None:
        divs = np.zeros(sim.n_steps, np.float32)
    divs = jnp.asarray(divs, jnp.float32)
    if divs.shape != (sim.n_steps,):
        raise ValueError(f"divs must be shaped (n_steps,) = "
                         f"({sim.n_steps},), got {divs.shape}")
    if key is None:
        key = jnp.asarray(rng.derive_key(sim.seed, stream, 0xD1F),
                          jnp.uint32)
    return _price_divs_impl(option.as_f32(), divs, po,
                            sim.replace(seed=0), antithetic,
                            tile_rows, key)


# ---------------------------------------------------------------------------
# Oracles (host float64)
# ---------------------------------------------------------------------------


def bs_call_cash_div(s0, k, t, r, sigma, d_amount, tau, q=0.0,
                     n_quad: int = 120, floor: float = _DIV_FLOOR):
    """European call with ONE cash dividend ``d_amount`` at time ``tau``:
    exact 1-D Gauss-Hermite integration of the post-dividend BS value
    over the lognormal pre-dividend spot (matches the MC scheme's
    max(S - D, floor) drop exactly when tau sits on a step boundary)."""
    from mc_tpu.oracle import bs_call

    s0, k, t, r, sigma, d_amount, tau, q = map(
        float, (s0, k, t, r, sigma, d_amount, tau, q))
    if not 0.0 < tau < t:
        raise ValueError(f"need 0 < tau < t, got tau={tau}, t={t}")
    x, w = np.polynomial.hermite.hermgauss(n_quad)
    s_pre = s0 * np.exp((r - q - 0.5 * sigma * sigma) * tau
                        + sigma * np.sqrt(2.0 * tau) * x)
    s_post = np.maximum(s_pre - d_amount, floor)
    inner = np.array([float(bs_call(sp, k, t - tau, r, sigma, q))
                      for sp in s_post])
    return float(np.exp(-r * tau) * np.sum(w * inner) / np.sqrt(np.pi))


def cash_div_forward(s0, t, r, sigma, divs, n_steps, q=0.0,
                     n_quad: int = 120, floor: float = _DIV_FLOOR):
    """E[S_T] under the discrete-dividend scheme (host f64, iterated
    Gauss-Hermite over each payment date) — the model-exact forward that
    anchors the put-call-parity gate for ANY schedule.

    For the floor-untouched region this telescopes to the classical
    S0 e^{(r-q)T} - sum_i D_i e^{(r-q)(T - tau_i)}; the quadrature keeps
    it exact even when a payment can exceed the spot.
    """
    s0, t, r, sigma, q = map(float, (s0, t, r, sigma, q))
    divs = np.asarray(divs, np.float64)
    mu = r - q
    fwd = s0
    t_prev = 0.0
    x, w = np.polynomial.hermite.hermgauss(n_quad)
    for j in np.nonzero(divs)[0]:
        tau = (int(j) + 1) / n_steps * t
        # propagate the forward to tau, then take E[max(. - D, floor)]
        # over the lognormal factor around the current forward.  The
        # distribution of S_tau- is NOT lognormal after an earlier
        # floored payment, but the floor region carries ~zero mass for
        # market-sized dividends; the classical telescoped forward is
        # exact whenever the floor is never binding (asserted in tests
        # against MC within MC error).
        fwd = fwd * np.exp(mu * (tau - t_prev))
        sig2 = sigma * sigma * tau
        s_pre = fwd * np.exp(-0.5 * sig2
                             + sigma * np.sqrt(2.0 * tau) * x)
        fwd = float(np.sum(w * np.maximum(s_pre - float(divs[j]), floor))
                    / np.sqrt(np.pi))
        t_prev = tau
    return fwd * np.exp(mu * (t - t_prev))
