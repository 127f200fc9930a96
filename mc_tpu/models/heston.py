"""Heston stochastic-volatility model family.

Beyond the reference (GBM only): the square-root variance process

    dS = r S dt + sqrt(v) S dW_s
    dv = kappa (theta - v) dt + xi sqrt(v) dW_v,   d<W_s, W_v> = rho dt

discretized with the full-truncation Euler scheme (Lord et al. 2010) —
the standard robust choice: v may go negative in the discretization but
only v+ = max(v, 0) enters the diffusion terms, keeping the scheme
unbiased-in-the-limit without reflection artifacts.

Kernel mapping: each step consumes exactly one threefry Box-Muller pair
(z_v, z_perp) — counter (path id, step) — and correlates them in-register
(z_s = rho z_v + sqrt(1-rho^2) z_perp).  The price accumulates in log
space like the GBM kernels (one exp rounding per S_t).  The payoff
registry plugs in unchanged: payoffs only see (state, S, params).

`heston_call_cf` is the semi-analytic oracle (Heston 1993 characteristic
function in the stable "little trap" formulation of Albrecher et al.),
integrated on the host in float64 — the model family's Black-Scholes
equivalent for tolerance tests.
"""

from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace
from typing import Any

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

__all__ = ["HestonDynamics", "price_heston", "heston_call_cf",
           "heston_euler_step", "heston_qe_step", "qe_consts",
           "DEMO_HESTON"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HestonDynamics:
    """Variance-process parameters (traced pytree leaves)."""

    v0: Any = 0.04       # initial variance (sigma0^2)
    kappa: Any = 2.0     # mean-reversion speed
    theta: Any = 0.04    # long-run variance
    xi: Any = 0.3        # vol-of-vol
    rho: Any = -0.7      # spot/vol correlation

    def astuple(self):
        return (self.v0, self.kappa, self.theta, self.xi, self.rho)

    def as_f32(self) -> "HestonDynamics":
        return HestonDynamics(*(jnp.float32(x) for x in self.astuple()))


DEMO_HESTON = HestonDynamics()

_HESTON_FIELDS = ("s0", "k", "r", "barrier", "p1", "p2", "t", "dt",
                  "inv_n_steps", "v0", "kappa", "theta", "xi", "rho",
                  "rho_perp", "sqrt_dt", "growth")


def _pack_heston(option, heston, n_steps):
    s0, t, k, r, _, barrier, p1, p2, q = (jnp.float32(v)
                                          for v in option.astuple())
    v0, kappa, theta, xi, rho = (jnp.float32(v) for v in heston.astuple())
    n = jnp.float32(n_steps)
    dt = t / n
    vals = dict(s0=s0, k=k, r=r, barrier=barrier, p1=p1, p2=p2, t=t, dt=dt,
                inv_n_steps=1.0 / n, v0=v0, kappa=kappa, theta=theta, xi=xi,
                rho=rho, rho_perp=jnp.sqrt(1.0 - rho * rho),
                sqrt_dt=jnp.sqrt(dt), growth=r - q)
    return jnp.stack([vals[f] for f in _HESTON_FIELDS])


def _unpack_heston(ref):
    return SimpleNamespace(**{f: ref[i] for i, f in
                              enumerate(_HESTON_FIELDS)})


def heston_euler_step(p, w, v, z_v, z_perp, dt, sqrt_dt):
    """One full-truncation Euler substep (log-space price accumulator).

    THE single definition of the scheme — the pricing leg and the MLMC
    coupled levels both call it, so the discretization can never drift
    between them.
    """
    z_s = p.rho * z_v + p.rho_perp * z_perp
    v_plus = jnp.maximum(v, 0.0)
    # double-where sqrt: the primal is bit-identical to sqrt(v_plus)
    # (same input when v > 0, literal 0.0 otherwise) but the JVP at a
    # truncated point is 0 instead of inf*0 = NaN — cva_greeks
    # forward-diffs through this step
    sq = jnp.where(v > 0.0, jnp.sqrt(jnp.where(v > 0.0, v, 1.0)),
                   0.0) * sqrt_dt
    w = w + ((p.growth - 0.5 * v_plus) * dt + sq * z_s)
    v = v + p.kappa * (p.theta - v_plus) * dt + p.xi * sq * z_v
    return w, v


# ---------------------------------------------------------------------------
# Andersen (2008) quadratic-exponential scheme — the production-desk
# discretization.  Weak error is orders of magnitude below full-truncation
# Euler at coarse step counts (the QE tests gate this against the CF
# oracle at n_steps=8 where Euler is visibly biased), and the variance
# stays >= 0 by construction.  Branch-free device mapping: both the
# quadratic (psi <= 1.5) and exponential (psi > 1.5) samplers evaluate on
# every lane with domain-safe arguments and a `where` select — no
# data-dependent control flow, so the step fuses into one vector pass.
# ---------------------------------------------------------------------------

_PSI_C = 1.5          # Andersen's switching threshold
_U_MAX = 0.99999994   # largest f32 < 1: keeps log1p(-u) finite


def qe_consts(p):
    """Per-step constants of the QE scheme (Andersen 2008, eqs. 27-34).

    Central discretization gamma1 = gamma2 = 1/2.  All values derive
    from the packed params, so they trace once per compile and live in
    registers inside the step loop.
    """
    gamma = jnp.float32(0.5)
    emkdt = jnp.exp(-p.kappa * p.dt)
    one_m = 1.0 - emkdt
    # conditional-moment coefficients: m = theta + (v - theta) e^{-k dt},
    # s2 = v * c1 + c2
    c1 = p.xi * p.xi * emkdt * one_m / p.kappa
    c2 = p.theta * p.xi * p.xi * one_m * one_m / (2.0 * p.kappa)
    kr = p.kappa * p.rho / p.xi - 0.5
    k0 = -p.rho * p.kappa * p.theta * p.dt / p.xi
    k1 = gamma * p.dt * kr - p.rho / p.xi
    k2 = gamma * p.dt * kr + p.rho / p.xi
    k3 = gamma * p.dt * (1.0 - p.rho * p.rho)
    k4 = k3
    # martingale-correction exponent A = K2 + K4/2 (Prop. 5.1); with
    # rho <= 0 it is < 0 and both branch constraints hold automatically.
    a_mc = k2 + 0.5 * k4
    return SimpleNamespace(emkdt=emkdt, c1=c1, c2=c2, k0=k0, k1=k1,
                           k2=k2, k3=k3, k4=k4, a_mc=a_mc,
                           growth_dt=p.growth * p.dt)


def heston_qe_step(p, qc, w, v, z_v, z_s, u, martingale_correction=True):
    """One Andersen QE step: (w, v) -> (w', v'), v' >= 0 always.

    THE single definition of the scheme — pricing leg, Pallas kernel and
    XLA dual all call it.  `z_v` drives the quadratic sampler, `u` the
    exponential sampler, `z_s` the spot; `qc` = `qe_consts(p)`.

    With `martingale_correction` (default) K0 is replaced per-branch by
    Andersen's K0* (Prop. 5.1) so that E[S_{t+dt} | F_t] = S_t e^{g dt}
    holds EXACTLY per step — the discounted spot is a true martingale at
    any step count (gated by `test_qe_martingale_exact`).  Where the
    rho > 0 validity constraint (A < 1/(2a), A < beta) fails, the lane
    falls back to the plain K0.
    """
    m = p.theta + (v - p.theta) * qc.emkdt
    s2 = v * qc.c1 + qc.c2
    psi = s2 / (m * m)

    # quadratic branch: v' = a (b + Z)^2 (evaluated domain-safe everywhere)
    two_over = 2.0 / jnp.maximum(psi, jnp.float32(1e-12))
    b2 = jnp.maximum(two_over - 1.0, 0.0)
    b2 = b2 + jnp.sqrt(two_over * b2)
    a = m / (1.0 + b2)
    bz = jnp.sqrt(b2) + z_v
    v_quad = a * bz * bz

    # exponential branch: mass p_at0 at zero + exponential tail
    p_at0 = (psi - 1.0) / (psi + 1.0)
    beta = (1.0 - p_at0) / jnp.maximum(m, jnp.float32(1e-30))
    u_c = jnp.minimum(u, jnp.float32(_U_MAX))
    v_exp = jnp.where(
        u_c <= p_at0, 0.0,
        (jnp.log1p(-p_at0) - jnp.log1p(-u_c)) / beta)

    quad = psi <= jnp.float32(_PSI_C)
    v_next = jnp.where(quad, v_quad, v_exp)

    if martingale_correction:
        # K0* = -ln M - (K1 + K3/2) v  with  M = E[e^{A v'} | v]
        aa = qc.a_mc
        two_a_a = 2.0 * aa * a
        ok_q = two_a_a < jnp.float32(1.0 - 1e-6)
        safe = jnp.where(ok_q, 1.0 - two_a_a, 1.0)
        # k0_eff replaces (K0 + K1 v), so the corrected form is
        # K0* + K1 v = -ln M - (K1 + K3/2) v + K1 v = -ln M - (K3/2) v
        k0_q = (-aa * b2 * a / safe + 0.5 * jnp.log(safe)
                - 0.5 * qc.k3 * v)
        ok_e = aa < beta * jnp.float32(1.0 - 1e-6)
        marg = jnp.where(ok_e,
                         p_at0 + beta * (1.0 - p_at0)
                         / jnp.maximum(beta - aa, jnp.float32(1e-30)),
                         1.0)
        k0_e = -jnp.log(marg) - 0.5 * qc.k3 * v
        k0_plain = qc.k0 + qc.k1 * v
        k0_eff = jnp.where(quad,
                           jnp.where(ok_q, k0_q, k0_plain),
                           jnp.where(ok_e, k0_e, k0_plain))
    else:
        k0_eff = qc.k0 + qc.k1 * v

    var_s = jnp.maximum(qc.k3 * v + qc.k4 * v_next, 0.0)
    w = (w + qc.growth_dt + k0_eff + qc.k2 * v_next
         + jnp.sqrt(var_s) * z_s)
    return w, v_next


def _heston_qe_leg(payoff, n_steps: int, p, s0, draw_pair, draw_unit,
                   antithetic_sign=1.0):
    """QE leg: one Box-Muller pair (z_v, z_s) + one uniform per step.

    Counter layout: step j consumes threefry counters (id, 2j) for the
    normal pair and (id, 2j+1) for the uniform — disjoint from the Euler
    leg's (id, j) layout, so the two schemes never share draws.
    Antithetic flips (z_v, z_s) -> (-z_v, -z_s) and u -> 1-u (quantile
    reflection in both samplers).
    """
    sign = jnp.float32(antithetic_sign)
    anti = antithetic_sign < 0
    qc = qe_consts(p)
    state0 = payoff.init(p, jnp.zeros_like(s0))

    def body(j, carry):
        w, v, s, state = carry
        z_v, z_s = draw_pair(2 * j)
        u = draw_unit(2 * j + 1)
        if anti:
            u = 1.0 - u
        w, v = heston_qe_step(p, qc, w, v, sign * z_v, sign * z_s, u)
        s = s0 * jnp.exp(w)
        return (w, v, s, payoff.update(state, s, p))

    w0 = jnp.zeros_like(s0)
    v_init = jnp.full_like(s0, p.v0)
    _, _, s_t, state = jax.lax.fori_loop(
        0, n_steps, body, (w0, v_init, s0, state0))
    return payoff.terminal(state, s_t, p)


def _heston_leg(payoff, n_steps: int, p, s0, draw_pair, antithetic_sign=1.0):
    """Full-truncation Euler leg; one Box-Muller pair per step."""
    sign = jnp.float32(antithetic_sign)
    state0 = payoff.init(p, jnp.zeros_like(s0))

    def body(j, carry):
        w, v, s, state = carry
        z_v, z_perp = draw_pair(j)
        w, v = heston_euler_step(p, w, v, sign * z_v, sign * z_perp,
                                 p.dt, p.sqrt_dt)
        s = s0 * jnp.exp(w)  # log-space: one exp rounding per S_t
        return (w, v, s, payoff.update(state, s, p))

    w0 = jnp.zeros_like(s0)
    v_init = jnp.full_like(s0, p.v0)
    _, _, s_t, state = jax.lax.fori_loop(
        0, n_steps, body, (w0, v_init, s0, state0))
    return payoff.terminal(state, s_t, p)


def _heston_tile(payoff, n_steps, tile_rows, antithetic, p, ids, valid,
                 k0, k1, scheme="euler", rng_source="threefry13"):
    shape = ids.shape
    rounds = 13 if rng_source == "threefry13" else 20

    def draw_pair(j):
        c1 = jnp.full(shape, 0, jnp.uint32) + jnp.asarray(j, jnp.uint32)
        return rng.normal_pair(k0, k1, ids, c1, rounds=rounds)

    def draw_unit(j):
        c1 = jnp.full(shape, 0, jnp.uint32) + jnp.asarray(j, jnp.uint32)
        b0, _ = rng.threefry2x32(k0, k1, ids, c1, rounds=rounds)
        return rng.bits_to_unit(b0)

    s0 = jnp.full(shape, p.s0, jnp.float32)
    if scheme == "qe":
        leg = functools.partial(_heston_qe_leg, payoff, n_steps, p, s0,
                                draw_pair, draw_unit)
    else:
        leg = functools.partial(_heston_leg, payoff, n_steps, p, s0,
                                draw_pair)
    pay = leg()
    if antithetic:
        pay = 0.5 * (pay + leg(antithetic_sign=-1.0))
    return jnp.where(valid, pay, 0.0)


def _heston_partials(payoff, cfg, key, params, path_offset, n_valid,
                     scheme="euler"):
    p = _unpack_heston(params)
    k0 = jnp.asarray(key[0], jnp.uint32)
    k1 = jnp.asarray(key[1], jnp.uint32)

    def tile_fn(ids, valid):
        pay = _heston_tile(payoff, cfg.n_steps, cfg.tile_rows,
                           cfg.antithetic, p, ids, valid, k0, k1,
                           scheme=scheme, rng_source=cfg.rng_source)
        return [pay, pay * pay]

    return xla_moment_scan(tile_fn, cfg.n_paths, cfg.tile_rows, 2,
                           offset=path_offset, bound=n_valid)


@functools.partial(
    jax.jit,
    static_argnames=("payoff", "sim", "antithetic", "tile_rows", "scheme",
                     "rng_source"))
def _price_heston_impl(option, heston, payoff, sim, antithetic, tile_rows,
                       key, scheme="euler", rng_source="threefry13"):
    cfg = pk.KernelConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                          tile_rows=tile_rows, antithetic=antithetic,
                          rng_source=rng_source)
    params = _pack_heston(option, heston, sim.n_steps)
    s, sq = _heston_partials(payoff, cfg, key, params, 0, None,
                             scheme=scheme)
    r = jnp.asarray(option.r, jnp.float32)
    t = jnp.asarray(option.t, jnp.float32)
    return summarize(finish_sum(s), finish_sum(sq),
                     jnp.asarray(sim.n_paths, jnp.float32),
                     jnp.exp(-r * t))


def price_heston(option: OptionParams = DEMO_OPTION,
                 heston: HestonDynamics = DEMO_HESTON,
                 sim: SimParams = DEMO_SIM,
                 payoff="vanilla_call",
                 *,
                 scheme: str = "euler",
                 antithetic: bool = False,
                 tile_rows: int = 128,
                 stream: int = STREAM_OUTER,
                 key=None,
                 rng_source: str = "threefry13") -> PriceResult:
    """Monte Carlo price under Heston stochastic volatility.

    Every payoff in the registry works (they see only (state, S, params)).
    Counter layout: one threefry pair per (path, step) — independent of the
    GBM stream convention, so Heston and GBM runs at the same seed do not
    share draws.
    """
    po = get_payoff(payoff)
    if po.terminal_only and po.name.startswith("vanilla"):
        pass  # vanilla under Heston still needs the full step loop
    if key is None:
        key = jnp.asarray(rng.derive_key(sim.seed, stream, 0x4E57),
                          jnp.uint32)
    if scheme not in ("euler", "qe"):
        raise ValueError(f"unknown scheme {scheme!r} (euler | qe)")
    pk.check_rng_source(rng_source)
    return _price_heston_impl(option.as_f32(), heston.as_f32(), po,
                              sim.replace(seed=0), antithetic, tile_rows,
                              key, scheme=scheme, rng_source=rng_source)


def heston_call_cf(s0, k, t, r, v0, kappa, theta, xi, rho, q=0.0,
                   n_quad: int = 2048, u_max: float = 200.0) -> float:
    """Semi-analytic Heston European call (host, float64).

    Characteristic-function pricing in the numerically stable 'little
    Heston trap' form (Albrecher et al. 2007), integrated with the
    trapezoid rule — the oracle for the Heston MC tests.
    """
    s0, k, t, r, q = map(float, (s0, k, t, r, q))
    v0, kappa, theta, xi, rho = map(float, (v0, kappa, theta, xi, rho))

    def cf(u):
        # phi(u) = E[exp(i u ln S_T)]
        iu = 1j * u
        d = np.sqrt((rho * xi * iu - kappa) ** 2 + xi * xi * (iu + u * u))
        g2 = (kappa - rho * xi * iu - d) / (kappa - rho * xi * iu + d)
        exp_dt = np.exp(-d * t)
        c = (kappa * theta / xi ** 2) * (
            (kappa - rho * xi * iu - d) * t
            - 2.0 * np.log((1.0 - g2 * exp_dt) / (1.0 - g2)))
        dd = ((kappa - rho * xi * iu - d) / xi ** 2
              * (1.0 - exp_dt) / (1.0 - g2 * exp_dt))
        return np.exp(iu * (np.log(s0) + (r - q) * t) + c + dd * v0)

    # P1, P2 via the standard Gil-Pelaez inversions.
    u = np.linspace(1e-8, u_max, n_quad)
    lnk = np.log(k)
    phi_u = cf(u)
    phi_u_minus_i = cf(u - 1j)
    denom = cf(-1j)  # = E[S_T] = s0 e^{rT}
    int1 = np.real(np.exp(-1j * u * lnk) * phi_u_minus_i / (1j * u * denom))
    int2 = np.real(np.exp(-1j * u * lnk) * phi_u / (1j * u))
    p1 = 0.5 + np.trapezoid(int1, u) / np.pi
    p2 = 0.5 + np.trapezoid(int2, u) / np.pi
    # e^{-qT} on the P1 leg: price = e^{-rT}(E[S_T] P1 - K P2) and
    # E[S_T] = s0 e^{(r-q)T}.  (Regression-gated at q != 0 against the
    # xi -> 0 Black-Scholes limit in tests/test_heston.py.)
    return s0 * np.exp(-q * t) * p1 - k * np.exp(-r * t) * p2
