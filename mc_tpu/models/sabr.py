"""SABR stochastic-volatility model family.

    dF     = sigma F^beta dW_1,      F_0 = forward = S0 e^{(r-q)T}
    dsigma = nu sigma dW_2,          <dW_1, dW_2> = rho dt

The market-standard smile model for rates/FX desks (Hagan et al. 2002,
"Managing Smile Risk").  Fifth dynamics family — two correlated factors
like Heston, but with a lognormal (not square-root) vol process and a CEV
backbone, and a different oracle style: Hagan's asymptotic IMPLIED-VOL
expansion rather than an exact transform.  Tests invert MC prices back to
implied vols (`oracle.bs_implied_vol`) and compare smiles.

Device mapping: same fused tile pattern as Heston (two normals per step from
one threefry call).  The vol factor is exact in distribution
(sigma_{t+1} = sigma_t exp(nu sqrt(dt) z - nu^2 dt / 2)); the forward
steps in LOG space with the local lognormal vol sigma_t F_t^{beta-1}
(exact for beta = 1, positivity-preserving for beta < 1 — the P(F hits 0)
mass is negligible for the equity/rates configs this targets, unlike the
absorbing level-space CEV scheme in models/cev.py).
"""

from __future__ import annotations

import dataclasses
import functools
import math
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

__all__ = ["SABRDynamics", "price_sabr", "sabr_implied_vol",
           "sabr_call_hagan", "DEMO_SABR"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SABRDynamics:
    """SABR parameters (traced leaves).

    alpha: initial vol of the forward (lognormal scale at beta=1)
    beta:  CEV backbone exponent in [0, 1]
    nu:    vol-of-vol
    rho:   forward-vol correlation
    """

    alpha: Any = 0.2
    beta: Any = 1.0
    nu: Any = 0.4
    rho: Any = -0.4

    def as_f32(self) -> "SABRDynamics":
        return SABRDynamics(*(jnp.float32(v) for v in
                              (self.alpha, self.beta, self.nu, self.rho)))


DEMO_SABR = SABRDynamics()

_SABR_FIELDS = ("s0", "k", "r", "barrier", "p1", "p2", "t", "q",
                "dt", "inv_n_steps", "sqrt_dt", "f0",
                "alpha", "beta", "nu", "rho", "rho_perp")


def _pack_sabr(option, dyn, n_steps):
    s0, t, k, r, _, barrier, p1, p2, q = (jnp.float32(v)
                                          for v in option.astuple())
    n = jnp.float32(n_steps)
    dt = t / n
    rho = jnp.float32(dyn.rho)
    vals = dict(
        s0=s0, k=k, r=r, barrier=barrier, p1=p1, p2=p2, t=t, q=q,
        dt=dt, inv_n_steps=1.0 / n, sqrt_dt=jnp.sqrt(dt),
        f0=s0 * jnp.exp((r - q) * t),  # the forward the smile lives on
        alpha=jnp.float32(dyn.alpha), beta=jnp.float32(dyn.beta),
        nu=jnp.float32(dyn.nu), rho=rho,
        rho_perp=jnp.sqrt(jnp.maximum(1.0 - rho * rho, 0.0)))
    return jnp.stack([vals[f] for f in _SABR_FIELDS])


def _unpack_sabr(ref):
    return SimpleNamespace(**{f: ref[i] for i, f in enumerate(_SABR_FIELDS)})


def sabr_step(p, logf, sig, z_vol, z_perp):
    """One SABR substep: log-forward + exact lognormal vol factor —
    THE single scheme definition (pricing leg and NMC legs share it)."""
    z_f = p.rho * z_vol + p.rho_perp * z_perp
    # local lognormal vol of F: sigma * F^(beta-1)
    vol_loc = sig * jnp.exp((p.beta - 1.0) * logf)
    logf = logf + vol_loc * p.sqrt_dt * z_f \
        - 0.5 * vol_loc * vol_loc * p.dt
    # exact vol-factor update (GBM with zero drift)
    sig = sig * jnp.exp(p.nu * p.sqrt_dt * z_vol
                        - 0.5 * p.nu * p.nu * p.dt)
    return logf, sig


def _sabr_leg(payoff, n_steps: int, p, f0, draw_pair, antithetic_sign=1.0):
    """Log-space forward + exact lognormal vol factor.

    One threefry call per step supplies (z_vol, z_perp); the forward shock
    is z_f = rho z_vol + sqrt(1-rho^2) z_perp (exact correlation).
    """
    sign = jnp.float32(antithetic_sign)
    state0 = payoff.init(p, jnp.zeros_like(f0))

    def body(m, carry):
        logf, sig, state = carry
        z_vol, z_perp = draw_pair(m)
        logf, sig = sabr_step(p, logf, sig, sign * z_vol, sign * z_perp)
        f = jnp.exp(logf)
        return (logf, sig, payoff.update(state, f, p))

    logf0 = jnp.log(f0)
    sig0 = jnp.zeros_like(f0) + p.alpha
    logf, sig, state = jax.lax.fori_loop(0, n_steps, body,
                                         (logf0, sig0, state0))
    return payoff.terminal(state, jnp.exp(logf), p)


def _sabr_tile(payoff, n_steps, antithetic, p, ids, valid, k0, k1,
               rng_source="threefry13"):
    shape = ids.shape

    rounds = 13 if rng_source == "threefry13" else 20

    def draw_pair(m):
        c1 = jnp.full(shape, 0, jnp.uint32) + jnp.asarray(m, jnp.uint32)
        return rng.normal_pair(k0, k1, ids, c1, rounds=rounds)

    f0 = jnp.full(shape, 1.0, jnp.float32) * p.f0
    pay = _sabr_leg(payoff, n_steps, p, f0, draw_pair)
    if antithetic:
        pay = 0.5 * (pay + _sabr_leg(payoff, n_steps, p, f0, draw_pair,
                                     antithetic_sign=-1.0))
    return jnp.where(valid, pay, 0.0)


def _sabr_partials(payoff, cfg, key, params, path_offset=0, n_valid=None):
    """(sum, sumsq) (8,128) slabs for this shard's global path-id range."""
    offset = jnp.asarray(path_offset, jnp.uint32)
    bound = (offset + jnp.uint32(cfg.n_paths) if n_valid is None
             else jnp.asarray(n_valid, jnp.uint32))
    p = _unpack_sabr(params)
    k0 = jnp.asarray(key[0], jnp.uint32)
    k1 = jnp.asarray(key[1], jnp.uint32)

    def tile_fn(ids, valid):
        pay = _sabr_tile(payoff, cfg.n_steps, cfg.antithetic, p, ids,
                         valid, k0, k1)
        return [pay, pay * pay]

    return xla_moment_scan(tile_fn, cfg.n_paths, cfg.tile_rows, 2,
                           offset=offset, bound=bound)


@functools.partial(
    jax.jit,
    static_argnames=("payoff", "sim", "antithetic", "tile_rows",
                     "rng_source"))
def _price_sabr_impl(option, dyn, payoff, sim, antithetic,
                     tile_rows, key, rng_source="threefry13"):
    cfg = pk.KernelConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                          tile_rows=tile_rows, antithetic=antithetic,
                          rng_source=rng_source)
    params = _pack_sabr(option, dyn, sim.n_steps)
    s, sq = _sabr_partials(payoff, cfg, key, params)
    r = jnp.float32(option.r)
    t = jnp.float32(option.t)
    return summarize(finish_sum(s), finish_sum(sq),
                     jnp.asarray(sim.n_paths, jnp.float32),
                     jnp.exp(-r * t))


def price_sabr(option: OptionParams = DEMO_OPTION,
               dyn: SABRDynamics = DEMO_SABR,
               sim: SimParams = DEMO_SIM,
               payoff="vanilla_call",
               *,
               antithetic: bool = False,
               tile_rows: int = 128,
               stream: int = STREAM_OUTER,
               key=None,
               rng_source: str = "threefry13") -> PriceResult:
    """Monte Carlo price under SABR (payoffs evaluated on the FORWARD
    path; European payoffs discounted at e^{-rT})."""
    po = get_payoff(payoff)
    po.validate(option, sim.n_steps)
    if key is None:
        key = jnp.asarray(rng.derive_key(sim.seed, stream, 0x5AB4),
                          jnp.uint32)
    return _price_sabr_impl(option.as_f32(), dyn.as_f32(), po,
                            sim.replace(seed=0), antithetic,
                            tile_rows, key,
                            rng_source=rng_source)


def sabr_implied_vol(f, k, t, alpha, beta, nu, rho) -> float:
    """Hagan et al. (2002) lognormal implied-vol expansion, host f64.

    The industry-standard asymptotic approximation — accurate to O(T) for
    moderate vol-of-vol; the model's oracle (tests allow its documented
    ~1% bias on top of MC noise).
    """
    f, k, t, alpha, beta, nu, rho = map(
        float, (f, k, t, alpha, beta, nu, rho))
    omb = 1.0 - beta
    lfk = math.log(f / k)
    fkb = (f * k) ** (omb / 2.0)
    # correction factor common to ATM and smile branches
    corr = (1.0 + (omb ** 2 / 24.0 * alpha ** 2 / fkb ** 2
                   + rho * beta * nu * alpha / (4.0 * fkb)
                   + (2.0 - 3.0 * rho ** 2) / 24.0 * nu ** 2) * t)
    denom = fkb * (1.0 + omb ** 2 / 24.0 * lfk ** 2
                   + omb ** 4 / 1920.0 * lfk ** 4)
    if abs(lfk) < 1e-10:
        return alpha / denom * corr
    z = nu / alpha * fkb * lfk
    xz = math.log((math.sqrt(1.0 - 2.0 * rho * z + z * z) + z - rho)
                  / (1.0 - rho))
    return alpha / denom * (z / xz) * corr


def sabr_call_hagan(s0, k, t, r, alpha, beta, nu, rho, q=0.0) -> float:
    """European call under SABR: Hagan implied vol into Black-Scholes."""
    from mc_tpu.oracle import _call_segment_f64
    s0, k, t, r, q = map(float, (s0, k, t, r, q))
    f = s0 * math.exp((r - q) * t)
    iv = sabr_implied_vol(f, k, t, alpha, beta, nu, rho)
    # Black-76 on the forward == BS with q folded into the forward:
    # e^{-rT} E[(F_T - K)+] with lognormal F_T of vol iv.
    return _call_segment_f64(f, k, t, 0.0, iv, 0.0, k, None) * math.exp(-r * t)
