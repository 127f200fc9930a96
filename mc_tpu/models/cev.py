"""CEV local-volatility model family.

Constant elasticity of variance:  dS = (r - q) S dt + sigma_lv S^beta dW —
the canonical parametric local-vol dynamics (beta = 1 recovers GBM;
beta < 1 produces the equity skew).  Third dynamics family after GBM and
Heston, demonstrating the framework's model extensibility with a rigorous
oracle: the European call under CEV has a closed form in the noncentral
chi-squared distribution (Schroder 1989), evaluated on the host with
scipy.

Device mapping: same fused tile pattern as GBM, but the diffusion coefficient
depends on the state, so the price steps in LEVEL space (S_{t+1} =
S_t + (r-q) S_t dt + sigma_lv S_t^beta sqrt(dt) z) with an absorbing floor
at zero (the CEV boundary behaviour for beta < 1).  S^beta computes as
exp(beta*log(S)).
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

__all__ = ["CEVDynamics", "price_cev", "cev_call_closed_form", "DEMO_CEV"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CEVDynamics:
    """CEV parameters (traced leaves).

    sigma_lv is the level-vol coefficient: local vol at spot S is
    sigma_lv * S^(beta-1).  Parameterize via at-the-money vol:
    sigma_lv = sigma_atm * S0^(1-beta) keeps the ATM vol comparable
    across betas.
    """

    sigma_lv: Any = 0.2 * 100.0 ** 0.5   # sigma_atm=0.2, beta=0.5, S0=100
    beta: Any = 0.5

    def as_f32(self) -> "CEVDynamics":
        return CEVDynamics(sigma_lv=jnp.float32(self.sigma_lv),
                           beta=jnp.float32(self.beta))

    @staticmethod
    def from_atm_vol(sigma_atm: float, beta: float,
                     s0: float = 100.0) -> "CEVDynamics":
        return CEVDynamics(sigma_lv=sigma_atm * s0 ** (1.0 - beta),
                           beta=beta)


DEMO_CEV = CEVDynamics()

_CEV_FIELDS = ("s0", "k", "r", "barrier", "p1", "p2", "t", "dt",
               "inv_n_steps", "sqrt_dt", "growth_dt", "sigma_lv", "beta")


def _pack_cev(option, cev, n_steps):
    s0, t, k, r, _, barrier, p1, p2, q = (jnp.float32(v)
                                          for v in option.astuple())
    n = jnp.float32(n_steps)
    dt = t / n
    vals = dict(s0=s0, k=k, r=r, barrier=barrier, p1=p1, p2=p2, t=t, dt=dt,
                inv_n_steps=1.0 / n, sqrt_dt=jnp.sqrt(dt),
                growth_dt=(r - q) * dt,
                sigma_lv=jnp.float32(cev.sigma_lv),
                beta=jnp.float32(cev.beta))
    return jnp.stack([vals[f] for f in _CEV_FIELDS])


def _unpack_cev(ref):
    return SimpleNamespace(**{f: ref[i] for i, f in enumerate(_CEV_FIELDS)})


def _cev_leg(payoff, n_steps: int, p, s0, draw_pair, antithetic_sign=1.0):
    """Level-space Euler leg with an absorbing zero boundary."""
    sign = jnp.float32(antithetic_sign)
    state0 = payoff.init(p, jnp.zeros_like(s0))

    def body(m, carry):
        s, state = carry
        z0, z1 = draw_pair(m)
        for z in (sign * z0, sign * z1):
            # local vol sigma_lv * S^beta; S^beta via exp(beta log S) with
            # the absorbed region masked (S=0 stays 0)
            alive = s > 0.0
            s_safe = jnp.maximum(s, 1e-12)
            diff = p.sigma_lv * jnp.exp(p.beta * jnp.log(s_safe))
            s_new = s + p.growth_dt * s + diff * p.sqrt_dt * z
            s = jnp.where(alive, jnp.maximum(s_new, 0.0), 0.0)
            state = payoff.update(state, s, p)
        return (s, state)

    assert n_steps % 2 == 0, "CEV leg consumes full Box-Muller pairs"
    s_t, state = jax.lax.fori_loop(0, n_steps // 2, body, (s0, state0))
    return payoff.terminal(state, s_t, p)


def _cev_tile(payoff, n_steps, antithetic, p, ids, valid, k0, k1):
    shape = ids.shape

    def draw_pair(m):
        c1 = jnp.full(shape, 0, jnp.uint32) + jnp.asarray(m, jnp.uint32)
        return rng.normal_pair(k0, k1, ids, c1)

    s0 = jnp.full(shape, p.s0, jnp.float32)
    pay = _cev_leg(payoff, n_steps, p, s0, draw_pair)
    if antithetic:
        pay = 0.5 * (pay + _cev_leg(payoff, n_steps, p, s0, draw_pair,
                                    antithetic_sign=-1.0))
    return jnp.where(valid, pay, 0.0)


def _cev_partials(payoff, cfg, key, params, path_offset=0, n_valid=None):
    """(sum, sumsq) (8,128) slabs for this shard's global path-id range."""
    offset = jnp.asarray(path_offset, jnp.uint32)
    bound = (offset + jnp.uint32(cfg.n_paths) if n_valid is None
             else jnp.asarray(n_valid, jnp.uint32))
    p = _unpack_cev(params)
    k0 = jnp.asarray(key[0], jnp.uint32)
    k1 = jnp.asarray(key[1], jnp.uint32)

    def tile_fn(ids, valid):
        pay = _cev_tile(payoff, cfg.n_steps, cfg.antithetic, p, ids,
                        valid, k0, k1)
        return [pay, pay * pay]

    return xla_moment_scan(tile_fn, cfg.n_paths, cfg.tile_rows, 2,
                           offset=offset, bound=bound)


@functools.partial(
    jax.jit,
    static_argnames=("payoff", "sim", "antithetic", "tile_rows"))
def _price_cev_impl(option, cev, payoff, sim, antithetic, tile_rows,
                    key):
    cfg = pk.KernelConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                          tile_rows=tile_rows, antithetic=antithetic)
    params = _pack_cev(option, cev, sim.n_steps)
    s, sq = _cev_partials(payoff, cfg, key, params)
    r = jnp.float32(option.r)
    t = jnp.float32(option.t)
    return summarize(finish_sum(s), finish_sum(sq),
                     jnp.asarray(sim.n_paths, jnp.float32),
                     jnp.exp(-r * t))


def price_cev(option: OptionParams = DEMO_OPTION,
              cev: CEVDynamics = DEMO_CEV,
              sim: SimParams = DEMO_SIM,
              payoff="vanilla_call",
              *,
              antithetic: bool = False,
              tile_rows: int = 128,
              stream: int = STREAM_OUTER,
              key=None) -> PriceResult:
    """Monte Carlo price under CEV local volatility."""
    po = get_payoff(payoff)
    if sim.n_steps % 2:
        raise ValueError("CEV requires an even n_steps (pair-consuming "
                         "step loop)")
    if key is None:
        key = jnp.asarray(rng.derive_key(sim.seed, stream, 0xCE4), jnp.uint32)
    return _price_cev_impl(option.as_f32(), cev.as_f32(), po,
                           sim.replace(seed=0), antithetic,
                           tile_rows, key)


def cev_call_closed_form(s0, k, t, r, sigma_lv, beta, q=0.0) -> float:
    """European call under CEV via the noncentral chi-squared closed form
    (Schroder 1989), host-side scipy — the model's analytic oracle.

    Valid for 0 < beta < 1 (absorbing boundary at zero).
    """
    from scipy.stats import ncx2

    s0, k, t, r, sigma_lv, beta, q = map(
        float, (s0, k, t, r, sigma_lv, beta, q))
    if not 0.0 < beta < 1.0:
        raise ValueError("closed form implemented for 0 < beta < 1")
    mu = r - q
    # Hull's parameterization (verified: exact GBM limit as beta -> 1)
    if abs(mu) > 1e-12:
        nu = (sigma_lv ** 2 / (2.0 * mu * (beta - 1.0))
              * (np.exp(2.0 * mu * (beta - 1.0) * t) - 1.0))
    else:
        nu = sigma_lv ** 2 * t
    a = ((k * np.exp(-mu * t)) ** (2.0 * (1.0 - beta))
         / ((1.0 - beta) ** 2 * nu))
    b = 1.0 / (1.0 - beta)
    c = s0 ** (2.0 * (1.0 - beta)) / ((1.0 - beta) ** 2 * nu)
    call = (s0 * np.exp(-q * t) * (1.0 - ncx2.cdf(a, b + 2.0, c))
            - k * np.exp(-r * t) * ncx2.cdf(c, b, a))
    return float(call)
