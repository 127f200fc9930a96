"""Bates (1996) stochastic-volatility jump-diffusion model family.

Beyond the reference (GBM only, `/root/reference/inc/trajectories.cuh`):
the SVJ dynamics that desks actually calibrate to equity smiles —
Heston variance plus Merton-style lognormal jumps in the spot:

    dS/S = (r - q - lam*kbar) dt + sqrt(v) dW_s + (e^Y - 1) dN
    dv   = kappa (theta - v) dt + xi sqrt(v) dW_v,  d<W_s,W_v> = rho dt
    N ~ Poisson(lam),  Y ~ N(mu_j, sigma_j^2),  kbar = E[e^Y] - 1.

The model COMPOSES the two existing machineries rather than duplicating
them: the diffusion substep is literally `heston.heston_euler_step` /
`heston.heston_qe_step` (the single definitions of those schemes), and
the jump substep is literally `merton._poisson_inv_cdf` +
`merton._jump_increment` — the compensator moves into the packed
`growth` field, so the Heston steps need no change at all.  Jumps are
exact in law per step (compound-Poisson log increment), so the only
discretization error is the Heston substep's own.

Device mapping: per step the Euler leg consumes three threefry counters
(diffusion Box-Muller pair, jump-size normal, Poisson uniform) and the
QE leg four (QE normal pair, QE uniform, jump normal, Poisson uniform)
— all derived from the (path id, step) counter, so the kernel stays
stateless/tiling-invariant like every other family.  The Poisson
inverse CDF is a branch-free fori_loop of static depth `kmax` (host
pre-computed, tail < 1e-12), so the whole step fuses into one vector pass.

`bates_call_cf` is the semi-analytic oracle: the Bates characteristic
function FACTORIZES as (Heston CF) x (compensated compound-Poisson CF),
so the same stable little-trap Gil-Pelaez inversion used for Heston
applies with one extra exponential factor.  Exact limits gate the
composition: lam=0 reproduces `heston_call_cf` and xi=0, v0=theta
reproduces `merton_call_closed_form` (tests/test_bates.py).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from types import SimpleNamespace
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from mc_tpu import rng
from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.engines import STREAM_OUTER
from mc_tpu.models.heston import (heston_call_cf, heston_euler_step,
                                  heston_qe_step, qe_consts)
from mc_tpu.models.merton import (_jump_increment, _poisson_inv_cdf,
                                  poisson_kmax)
from mc_tpu.oracle import PriceResult, summarize
from mc_tpu.ops import path_kernels as pk
from mc_tpu.ops._pallas import xla_moment_scan
from mc_tpu.ops.payoffs import get_payoff
from mc_tpu.ops.reduce import finish_sum

__all__ = ["BatesDynamics", "price_bates", "bates_call_cf", "DEMO_BATES"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BatesDynamics:
    """Heston variance params + Merton jump params (traced leaves)."""

    v0: Any = 0.04       # initial variance
    kappa: Any = 2.0     # variance mean-reversion speed
    theta: Any = 0.04    # long-run variance
    xi: Any = 0.3        # vol-of-vol
    rho: Any = -0.7      # spot/vol correlation
    lam: Any = 0.3       # jump intensity (per year)
    mu_j: Any = -0.10    # mean log jump size
    sigma_j: Any = 0.15  # std of log jump size

    def astuple(self):
        return (self.v0, self.kappa, self.theta, self.xi, self.rho,
                self.lam, self.mu_j, self.sigma_j)

    def as_f32(self) -> "BatesDynamics":
        return BatesDynamics(*(jnp.float32(x) for x in self.astuple()))

    def kbar(self) -> float:
        """E[e^Y] - 1 — the jump drift compensator."""
        return math.exp(float(self.mu_j)
                        + 0.5 * float(self.sigma_j) ** 2) - 1.0


DEMO_BATES = BatesDynamics()

# Superset of heston's _HESTON_FIELDS: heston_euler_step / qe_consts /
# heston_qe_step read growth/dt/sqrt_dt/kappa/theta/xi/rho/rho_perp by
# name, and the jump substep reads lam_dt/mu_j/sigma_j — one packed
# vector serves both substeps.
_BATES_FIELDS = ("s0", "k", "r", "barrier", "p1", "p2", "t", "dt",
                 "inv_n_steps", "v0", "kappa", "theta", "xi", "rho",
                 "rho_perp", "sqrt_dt", "growth", "lam_dt", "mu_j",
                 "sigma_j")


def _pack_bates(option, dyn, n_steps):
    s0, t, k, r, _, barrier, p1, p2, q = (jnp.float32(v)
                                          for v in option.astuple())
    v0, kappa, theta, xi, rho, lam, mu_j, sigma_j = (
        jnp.float32(v) for v in dyn.astuple())
    kbar = jnp.exp(mu_j + 0.5 * sigma_j * sigma_j) - 1.0
    n = jnp.float32(n_steps)
    dt = t / n
    vals = dict(
        s0=s0, k=k, r=r, barrier=barrier, p1=p1, p2=p2, t=t, dt=dt,
        inv_n_steps=1.0 / n, v0=v0, kappa=kappa, theta=theta, xi=xi,
        rho=rho, rho_perp=jnp.sqrt(1.0 - rho * rho),
        sqrt_dt=jnp.sqrt(dt),
        # Compensated growth: the Heston substeps see r - q - lam*kbar,
        # so E[S_t] = S0 e^{(r-q)t} holds exactly (martingale test).
        growth=r - q - lam * kbar,
        lam_dt=lam * dt, mu_j=mu_j, sigma_j=sigma_j)
    return jnp.stack([vals[f] for f in _BATES_FIELDS])


def _unpack_bates(ref):
    return SimpleNamespace(**{f: ref[i]
                              for i, f in enumerate(_BATES_FIELDS)})


def _bates_euler_leg(payoff, n_steps: int, kmax: int, p, s0, draw_pair,
                     draw_unit, antithetic_sign=1.0):
    """Full-truncation Euler diffusion + exact-in-law jump per step.

    Counter layout: step j consumes counters 3j (diffusion pair
    (z_v, z_perp)), 3j+1 (jump-size normal e) and 3j+2 (Poisson uniform
    u) — disjoint from the pure-Heston (id, j) and pure-Merton 3m
    layouts only through the derive_key stream, which is Bates-specific.
    """
    sign = jnp.float32(antithetic_sign)
    anti = antithetic_sign < 0
    state0 = payoff.init(p, jnp.zeros_like(s0))

    def body(j, carry):
        w, v, s, state = carry
        z_v, z_perp = draw_pair(3 * j)
        e, _ = draw_pair(3 * j + 1)
        u = draw_unit(3 * j + 2)
        if anti:
            u = 1.0 - u
        w, v = heston_euler_step(p, w, v, sign * z_v, sign * z_perp,
                                 p.dt, p.sqrt_dt)
        nj = _poisson_inv_cdf(u, p.lam_dt, kmax)
        w = w + _jump_increment(p, nj, sign * e)
        s = s0 * jnp.exp(w)
        return (w, v, s, payoff.update(state, s, p))

    w0 = jnp.zeros_like(s0)
    v_init = jnp.full_like(s0, p.v0)
    _, _, s_t, state = jax.lax.fori_loop(
        0, n_steps, body, (w0, v_init, s0, state0))
    return payoff.terminal(state, s_t, p)


def _bates_qe_leg(payoff, n_steps: int, kmax: int, p, s0, draw_pair,
                  draw_unit, antithetic_sign=1.0):
    """Andersen QE diffusion + exact-in-law jump per step.

    The QE martingale correction makes the DIFFUSION factor a per-step
    martingale at growth rate p.growth = r - q - lam*kbar; the jump
    factor has expectation e^{lam*kbar*dt} per step, so their product
    restores E[S_{t+dt}|F_t] = S_t e^{(r-q)dt} exactly.

    Counter layout: step j consumes 4j (QE pair (z_v, z_s)), 4j+1 (QE
    branch uniform), 4j+2 (jump normal), 4j+3 (Poisson uniform).
    """
    sign = jnp.float32(antithetic_sign)
    anti = antithetic_sign < 0
    qc = qe_consts(p)
    state0 = payoff.init(p, jnp.zeros_like(s0))

    def body(j, carry):
        w, v, s, state = carry
        z_v, z_s = draw_pair(4 * j)
        u_v = draw_unit(4 * j + 1)
        e, _ = draw_pair(4 * j + 2)
        u_n = draw_unit(4 * j + 3)
        if anti:
            u_v = 1.0 - u_v
            u_n = 1.0 - u_n
        w, v = heston_qe_step(p, qc, w, v, sign * z_v, sign * z_s, u_v)
        nj = _poisson_inv_cdf(u_n, p.lam_dt, kmax)
        w = w + _jump_increment(p, nj, sign * e)
        s = s0 * jnp.exp(w)
        return (w, v, s, payoff.update(state, s, p))

    w0 = jnp.zeros_like(s0)
    v_init = jnp.full_like(s0, p.v0)
    _, _, s_t, state = jax.lax.fori_loop(
        0, n_steps, body, (w0, v_init, s0, state0))
    return payoff.terminal(state, s_t, p)


def _bates_tile(payoff, n_steps, kmax, antithetic, p, ids, valid,
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
    leg = _bates_qe_leg if scheme == "qe" else _bates_euler_leg
    leg = functools.partial(leg, payoff, n_steps, kmax, p, s0,
                            draw_pair, draw_unit)
    pay = leg()
    if antithetic:
        pay = 0.5 * (pay + leg(antithetic_sign=-1.0))
    return jnp.where(valid, pay, 0.0)


def _bates_partials(payoff, cfg, kmax, key, params, path_offset=0,
                    n_valid=None,
                    scheme="euler"):
    """(sum, sumsq) (8,128) slabs for this shard's global path-id range."""
    offset = jnp.asarray(path_offset, jnp.uint32)
    bound = (offset + jnp.uint32(cfg.n_paths) if n_valid is None
             else jnp.asarray(n_valid, jnp.uint32))
    p = _unpack_bates(params)
    k0 = jnp.asarray(key[0], jnp.uint32)
    k1 = jnp.asarray(key[1], jnp.uint32)

    def tile_fn(ids, valid):
        pay = _bates_tile(payoff, cfg.n_steps, kmax, cfg.antithetic, p,
                          ids, valid, k0, k1, scheme=scheme)
        return [pay, pay * pay]

    return xla_moment_scan(tile_fn, cfg.n_paths, cfg.tile_rows, 2,
                           offset=offset, bound=bound)


@functools.partial(
    jax.jit,
    static_argnames=("payoff", "sim", "kmax", "antithetic",
                     "tile_rows", "scheme", "rng_source"))
def _price_bates_impl(option, dyn, payoff, sim, kmax, antithetic,
                      tile_rows, key, scheme="euler",
                      rng_source="threefry13"):
    cfg = pk.KernelConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                          tile_rows=tile_rows, antithetic=antithetic,
                          rng_source=rng_source)
    params = _pack_bates(option, dyn, sim.n_steps)
    s, sq = _bates_partials(payoff, cfg, kmax, key, params,
                            scheme=scheme)
    r = jnp.asarray(option.r, jnp.float32)
    t = jnp.asarray(option.t, jnp.float32)
    return summarize(finish_sum(s), finish_sum(sq),
                     jnp.asarray(sim.n_paths, jnp.float32),
                     jnp.exp(-r * t))


def price_bates(option: OptionParams = DEMO_OPTION,
                dyn: BatesDynamics = DEMO_BATES,
                sim: SimParams = DEMO_SIM,
                payoff="vanilla_call",
                *,
                scheme: str = "euler",
                antithetic: bool = False,
                tile_rows: int = 128,
                stream: int = STREAM_OUTER,
                key=None,
                rng_source: str = "threefry13") -> PriceResult:
    """Monte Carlo price under Bates SVJ dynamics.

    Every payoff in the registry works (they see only (state, S,
    params)).  `scheme` picks the diffusion substep: "euler"
    (full-truncation) or "qe" (Andersen 2008 with exact per-step
    martingale correction); the jump substep is exact in law either
    way.  The Poisson scan depth is pre-computed on the host from
    lam*dt (tail < 1e-12), so intensity is a static rebuild trigger
    like Merton's.
    """
    po = get_payoff(payoff)
    if key is None:
        key = jnp.asarray(rng.derive_key(sim.seed, stream, 0xBA7E),
                          jnp.uint32)
    if scheme not in ("euler", "qe"):
        raise ValueError(f"unknown scheme {scheme!r} (euler | qe)")
    kmax = poisson_kmax(float(dyn.lam) * float(option.t) / sim.n_steps)
    return _price_bates_impl(option.as_f32(), dyn.as_f32(), po,
                             sim.replace(seed=0), kmax,
                             antithetic, tile_rows, key,
                             scheme=scheme, rng_source=rng_source)


def bates_call_cf(s0, k, t, r, v0, kappa, theta, xi, rho, lam, mu_j,
                  sigma_j, q=0.0, n_quad: int = 2048,
                  u_max: float = 200.0) -> float:
    """Semi-analytic Bates European call (host, float64).

    The Bates CF factorizes: phi_B(u) = phi_H(u) * phi_J(u) with the
    Heston factor in the stable little-trap form (same as
    `heston_call_cf`) and the compensated compound-Poisson factor

        phi_J(u) = exp(lam t (e^{i u mu_j - u^2 sigma_j^2 / 2} - 1)
                       - i u lam t kbar),   kbar = e^{mu_j+sigma_j^2/2}-1,

    so phi_B(-i) = s0 e^{(r-q)t} still (the jump factor is exactly 1
    there) and the same Gil-Pelaez inversion applies unchanged.  The
    model's analytic oracle; lam=0 reproduces `heston_call_cf` exactly
    and xi=0, v0=theta reproduces `merton_call_closed_form`.
    """
    s0, k, t, r, q = map(float, (s0, k, t, r, q))
    v0, kappa, theta, xi, rho = map(float, (v0, kappa, theta, xi, rho))
    lam, mu_j, sigma_j = map(float, (lam, mu_j, sigma_j))
    kbar = math.exp(mu_j + 0.5 * sigma_j * sigma_j) - 1.0

    def cf(u):
        iu = 1j * u
        d = np.sqrt((rho * xi * iu - kappa) ** 2 + xi * xi * (iu + u * u))
        g2 = (kappa - rho * xi * iu - d) / (kappa - rho * xi * iu + d)
        exp_dt = np.exp(-d * t)
        c = (kappa * theta / xi ** 2) * (
            (kappa - rho * xi * iu - d) * t
            - 2.0 * np.log((1.0 - g2 * exp_dt) / (1.0 - g2)))
        dd = ((kappa - rho * xi * iu - d) / xi ** 2
              * (1.0 - exp_dt) / (1.0 - g2 * exp_dt))
        jump = lam * t * (np.exp(iu * mu_j - 0.5 * u * u * sigma_j ** 2)
                          - 1.0) - iu * lam * t * kbar
        return np.exp(iu * (np.log(s0) + (r - q) * t) + c + dd * v0
                      + jump)

    u = np.linspace(1e-8, u_max, n_quad)
    lnk = np.log(k)
    phi_u = cf(u)
    phi_u_minus_i = cf(u - 1j)
    denom = cf(np.array(-1j))  # = E[S_T] = s0 e^{(r-q)T}
    int1 = np.real(np.exp(-1j * u * lnk) * phi_u_minus_i / (1j * u * denom))
    int2 = np.real(np.exp(-1j * u * lnk) * phi_u / (1j * u))
    p1 = 0.5 + np.trapezoid(int1, u) / np.pi
    p2 = 0.5 + np.trapezoid(int2, u) / np.pi
    return float(s0 * math.exp(-q * t) * p1
                 - k * math.exp(-r * t) * p2)
