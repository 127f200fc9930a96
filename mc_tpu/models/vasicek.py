"""Hybrid Black-Scholes–Vasicek: equity under STOCHASTIC short rates.

Beyond the reference (constant r, scalar discount e^{-rT},
`inc/wrappers.cuh:51`): the short rate follows the Vasicek/Hull-White OU
process and every payoff is discounted PATHWISE by exp(-int_0^T r_u du):

    dr = a (b - r) dt + sigma_r dW_r
    dS/S = (r_t - q) dt + sigma_s dW_s,      d<W_s, W_r> = rho dt

EXACT-IN-LAW stepping (no discretization bias at ANY step count): per
step the triple (eps, eta, u) = (OU shock, integrated-rate shock, equity
diffusion) is jointly Gaussian with known covariance from the OU kernels

    Var(eps)     = sigma_r^2 C2
    Cov(eps,eta) = (sigma_r^2/a)(B - C2)
    Var(eta)     = (sigma_r^2/a^2)(dt - 2B + C2)
    Cov(eps,u)   = rho sigma_s sigma_r B
    Cov(eta,u)   = rho sigma_s (sigma_r/a)(dt - B)
    Var(u)       = sigma_s^2 dt,

B = (1-e^{-a dt})/a, C2 = (1-e^{-2a dt})/(2a); the 3x3 Cholesky is
computed once at trace time and shipped in the parameter vector.  State per path is
(x = r - b, y = int r du, w = log S/S0): exact updates

    y += b dt + x B + eta;  w += (same) - (q + sigma_s^2/2) dt + u;
    x  = x e^{-a dt} + eps.

Device mapping: 3 normals/step => the step loop consumes PAIRS two steps at
a time (3 threefry pairs per step pair, like the Merton/CEV kernels), so
n_steps must be even.  Registry payoffs plug in unchanged on the S path;
the `zcb` payoff (pays 1) prices the discount bond itself.

Oracles: `oracle.vasicek_zcb` (affine closed form) and `oracle.bsv_call`
(Merton 1973 — Black formula under the T-forward measure).
"""

from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace
from typing import Any

import jax
import jax.numpy as jnp

from mc_tpu import rng
from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.engines import STREAM_OUTER
from mc_tpu.oracle import PriceResult, summarize
from mc_tpu.ops import path_kernels as pk
from mc_tpu.ops._pallas import xla_moment_scan
from mc_tpu.ops.payoffs import get_payoff
from mc_tpu.ops.reduce import finish_sum

__all__ = ["VasicekDynamics", "price_vasicek", "DEMO_VASICEK"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class VasicekDynamics:
    """Short-rate parameters (traced pytree leaves).  The INITIAL rate r0
    is `option.r` — the option record's rate field becomes the rate
    process's starting point."""

    a: Any = 0.3         # mean-reversion speed
    b: Any = 0.05        # long-run rate level
    sigma_r: Any = 0.015  # absolute rate volatility
    rho: Any = -0.3      # equity/rate correlation

    def astuple(self):
        return (self.a, self.b, self.sigma_r, self.rho)

    def as_f32(self) -> "VasicekDynamics":
        return VasicekDynamics(*(jnp.float32(x) for x in self.astuple()))


DEMO_VASICEK = VasicekDynamics()

_VAS_FIELDS = ("s0", "k", "r", "barrier", "p1", "p2", "t", "dt",
               "inv_n_steps", "sqrt_dt", "sigma", "x0", "bdt", "e1",
               "big_b", "drift_adj", "l11", "l21", "l22", "l31", "l32",
               "l33")


def ou_gap(x):
    """G(x) = x - 2 tanh(x/2): the exact-OU conditional-variance factor.

    Var[eta | eps] over one step is (sigma_r^2 / a^3) * G(a*dt), and the
    eps-orthogonal (eta, u) covariance is rho*sigma_s*sigma_r/a^2 * G —
    the SAME function (g == h algebraically; both reduce to
    x - 2 tanh(x/2)).  G ~ x^3/12 vanishes three orders faster than the
    covariance entries it is assembled from, so the textbook
    c11 - c10^2/c00 form loses ~x^-2 relative digits in f32 —
    catastrophic at per-step x = a*dt (measured: the discriminant went
    NEGATIVE on an accelerator backend at n_steps=16, the 1e-30 floor made
    l22 ~ 1e-15, and the l32 division exploded the kernel to NaN on
    every engine).  Stable split: Maclaurin through x^9 below 0.5
    (truncation < 5e-7 rel), the closed tanh form above (cancellation
    amplification x/G < 50 at the crossover).
    """
    x2 = x * x
    series = x * x2 * (1.0 / 12.0 + x2 * (
        -1.0 / 120.0 + x2 * (17.0 / 20160.0 + x2 * (-31.0 / 362880.0))))
    direct = x - 2.0 * jnp.tanh(0.5 * x)
    return jnp.where(x < 0.5, series, direct)


def ou_chol2(a, sigma_r, dt):
    """(e1, big_b, l11, l21, l22): exact-OU step decay, B(dt), and the
    Cholesky of the exact (eps, eta) = (OU increment, integrated-OU
    increment) covariance — every entry in cancellation-free closed
    form:

        B - c2 = v^2 / (2a)            (v = 1 - e^{-a dt}, exact algebra)
        Var[eta | eps] = sigma_r^2 G(a dt) / a^3   (`ou_gap`)

    Shared by `_pack_vasicek` and the swaption/hullwhite expiry draw
    (`swaption._exact_xy_coeffs` delegates here).
    """
    x = a * dt
    u = jnp.exp(-x)
    v = -jnp.expm1(-x)
    c2 = -jnp.expm1(-2.0 * x) / (2.0 * a)
    sqrt_c2 = jnp.sqrt(c2)
    big_b = v / a
    l11 = sigma_r * sqrt_c2
    l21 = sigma_r * v * v / (2.0 * a * a * sqrt_c2)
    l22 = (sigma_r / a) * jnp.sqrt(ou_gap(x) / a)
    return u, big_b, l11, l21, l22


def _pack_vasicek(option, dyn, n_steps):
    s0, t, k, r0, sigma_s, barrier, p1, p2, q = (
        jnp.float32(v) for v in option.astuple())
    a, b, sigma_r, rho = (jnp.float32(v) for v in dyn.astuple())
    n = jnp.float32(n_steps)
    dt = t / n
    # Cholesky of the exact (eps, eta, u) covariance (module docstring)
    # in closed cancellation-free form — the spot row simplifies all the
    # way down: l31^2 + l32^2 == rho^2 sigma_s^2 dt exactly, so
    # l33 = sigma_s sqrt(dt) sqrt(1 - rho^2) (rank-2 at rho = +-1 is
    # exact, no jitter needed).  Unrolled scalars fuse into the program;
    # jnp.linalg.cholesky is a library call outside it (see
    # basket.chol_scalars).
    e1, big_b, l11, l21, l22 = ou_chol2(a, sigma_r, dt)
    x = a * dt
    gx = ou_gap(x)
    c2 = -jnp.expm1(-2.0 * x) / (2.0 * a)
    v = -jnp.expm1(-x)
    l31 = rho * sigma_s * v / (a * jnp.sqrt(c2))
    l32 = rho * sigma_s * jnp.sqrt(gx / a)
    l33 = (sigma_s * jnp.sqrt(dt)
           * jnp.sqrt(jnp.maximum(1.0 - rho * rho, 0.0)))
    vals = dict(s0=s0, k=k, r=r0, barrier=barrier, p1=p1, p2=p2, t=t,
                dt=dt, inv_n_steps=1.0 / n, sqrt_dt=jnp.sqrt(dt),
                sigma=sigma_s, x0=r0 - b, bdt=b * dt, e1=e1, big_b=big_b,
                drift_adj=(q + 0.5 * sigma_s * sigma_s) * dt,
                l11=l11, l21=l21, l22=l22, l31=l31, l32=l32, l33=l33)
    return jnp.stack([vals[f] for f in _VAS_FIELDS])


def _unpack_vasicek(ref):
    return SimpleNamespace(**{f: ref[i] for i, f in enumerate(_VAS_FIELDS)})


def vasicek_step(p, carry, za, zb, zc, s0):
    """One exact substep from three iid normals — THE single definition
    of the scheme (pricing leg, trajectory kernel, and the NMC inner
    legs all call it)."""
    w, x, y = carry
    eps = p.l11 * za
    eta = p.l21 * za + p.l22 * zb
    u = p.l31 * za + p.l32 * zb + p.l33 * zc
    dy = p.bdt + x * p.big_b + eta
    w = w + dy - p.drift_adj + u
    y = y + dy
    x = x * p.e1 + eps
    s = s0 * jnp.exp(w)  # log-space: one exp rounding per S_t
    return (w, x, y), s


def _vasicek_leg(payoff, n_steps: int, p, s0, draw_pair,
                 antithetic_sign=1.0):
    """Exact Gaussian leg; 3 pairs per TWO steps (even n_steps)."""
    sign = jnp.float32(antithetic_sign)
    state0 = payoff.init(p, jnp.zeros_like(s0))

    def one_step(carry, za, zb, zc):
        wxy, state = carry
        wxy, s = vasicek_step(p, wxy, za, zb, zc, s0)
        return (wxy, payoff.update(state, s, p)), s

    def pair_body(j, carry3):
        carry, _ = carry3
        z0, z1 = draw_pair(3 * j)
        z2, z3 = draw_pair(3 * j + 1)
        z4, z5 = draw_pair(3 * j + 2)
        carry, s = one_step(carry, sign * z0, sign * z1, sign * z2)
        carry, s = one_step(carry, sign * z3, sign * z4, sign * z5)
        return carry, s

    zeros = jnp.zeros_like(s0)
    x0 = jnp.full_like(s0, p.x0)
    # s_t rides the loop carry: the terminal pay must consume the SAME
    # rounded s the last step fed payoff.update (recomputing s0*exp(w)
    # here lets XLA contract the multiply into the payoff's subtract —
    # 1-ulp drift vs the carried value)
    (((_, _, y), state), s_t) = jax.lax.fori_loop(
        0, n_steps // 2, pair_body, (((zeros, x0, zeros), state0), s0))
    # pathwise stochastic discount replaces the reference's scalar
    # e^{-rT} finish (wrappers.cuh:51)
    return payoff.terminal(state, s_t, p) * jnp.exp(-y)


def _vasicek_tile(payoff, n_steps, antithetic, p, ids, valid, k0, k1,
                  rng_source="threefry13"):
    shape = ids.shape

    rounds = 13 if rng_source == "threefry13" else 20

    def draw_pair(m):
        c1 = jnp.full(shape, 0, jnp.uint32) + jnp.asarray(m, jnp.uint32)
        return rng.normal_pair(k0, k1, ids, c1, rounds=rounds)

    s0 = jnp.full(shape, p.s0, jnp.float32)
    pay = _vasicek_leg(payoff, n_steps, p, s0, draw_pair)
    if antithetic:
        pay = 0.5 * (pay + _vasicek_leg(payoff, n_steps, p, s0, draw_pair,
                                        antithetic_sign=-1.0))
    return jnp.where(valid, pay, 0.0)


def _vasicek_partials(payoff, cfg, key, params, path_offset=0,
                      n_valid=None):
    """(sum, sumsq) (8,128) slabs of PATHWISE-DISCOUNTED payoffs."""
    offset = jnp.asarray(path_offset, jnp.uint32)
    bound = (offset + jnp.uint32(cfg.n_paths) if n_valid is None
             else jnp.asarray(n_valid, jnp.uint32))
    p = _unpack_vasicek(params)
    k0 = jnp.asarray(key[0], jnp.uint32)
    k1 = jnp.asarray(key[1], jnp.uint32)

    def tile_fn(ids, valid):
        pay = _vasicek_tile(payoff, cfg.n_steps, cfg.antithetic, p, ids,
                            valid, k0, k1)
        return [pay, pay * pay]

    return xla_moment_scan(tile_fn, cfg.n_paths, cfg.tile_rows, 2,
                           offset=offset, bound=bound)


@functools.partial(
    jax.jit,
    static_argnames=("payoff", "sim", "antithetic", "tile_rows",
                     "rng_source"))
def _price_vasicek_impl(option, dyn, payoff, sim, antithetic,
                        tile_rows, key,
                        rng_source="threefry13"):
    cfg = pk.KernelConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                          tile_rows=tile_rows, antithetic=antithetic,
                          rng_source=rng_source)
    params = _pack_vasicek(option, dyn, sim.n_steps)
    s, sq = _vasicek_partials(payoff, cfg, key, params)
    # discount already applied pathwise inside the leg
    return summarize(finish_sum(s), finish_sum(sq),
                     jnp.asarray(sim.n_paths, jnp.float32),
                     jnp.float32(1.0))


def price_vasicek(option: OptionParams = DEMO_OPTION,
                  dyn: VasicekDynamics = DEMO_VASICEK,
                  sim: SimParams = DEMO_SIM,
                  payoff="vanilla_call",
                  *,
                  antithetic: bool = False,
                  tile_rows: int = 128,
                  stream: int = STREAM_OUTER,
                  key=None,
                  rng_source: str = "threefry13") -> PriceResult:
    """Monte Carlo price under Black-Scholes–Vasicek stochastic rates.

    `option.r` is the INITIAL short rate r0; every registry payoff works
    and is discounted pathwise by exp(-int r dt).  `payoff="zcb"` prices
    the zero-coupon bond itself (gate: `oracle.vasicek_zcb`); vanilla
    calls gate against `oracle.bsv_call` (Merton 1973).  The scheme is
    exact in law — n_steps only controls payoff monitoring dates, not
    discretization bias.
    """
    po = get_payoff(payoff)
    po.validate(option, sim.n_steps)
    if sim.n_steps % 2:
        raise ValueError("vasicek requires an even n_steps "
                         "(pair-consuming step loop)")
    if key is None:
        key = jnp.asarray(rng.derive_key(sim.seed, stream, 0x7A51),
                          jnp.uint32)
    return _price_vasicek_impl(option.as_f32(), dyn.as_f32(), po,
                               sim.replace(seed=0), antithetic,
                               tile_rows, key,
                               rng_source=rng_source)


# ---------------------------------------------------------------------------
# Trajectory materialization: step-major (S, x = r-b, y = int r, state)
# grids — the full market state the NMC exposure engine resumes from
# (the Vasicek analogue of the C9 state-grid kernel,
# trajectories.cuh:273-351, whose state is the rate path as well).
# ---------------------------------------------------------------------------


