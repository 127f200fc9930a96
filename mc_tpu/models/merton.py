"""Merton jump-diffusion model family.

Risk-neutral dynamics with compound-Poisson log-normal jumps (Merton 1976):

    dS/S = (r - q - lam*kappa) dt + sigma dW + (e^Y - 1) dN,
    N ~ Poisson(lam),  Y ~ N(mu_j, sigma_j^2),
    kappa = E[e^Y] - 1 = exp(mu_j + sigma_j^2/2) - 1.

Fourth dynamics family after GBM, Heston and CEV — adds discontinuous
paths, the canonical fix for GBM's inability to produce short-dated smile.
The European call has a rapidly converging series oracle (each jump count
conditions to a Black-Scholes world), used by the tests the same way the
reference validates its GBM pricer against the closed form
(``/root/reference/hello.cu:43-45``).

Device mapping.  The per-step log-increment is *exact in distribution*:

    dlog S = (r - q - lam*kappa - sigma^2/2) dt + sigma sqrt(dt) z
             + N mu_j + sigma_j sqrt(N) e,      N ~ Poisson(lam dt)

because the sum of N iid N(mu_j, sigma_j^2) jumps given N is
N(N mu_j, N sigma_j^2) — one extra normal ``e`` replaces the whole jump
sum, so the kernel stays a branch-free fused tile loop.  The Poisson count
is drawn by a branch-free inverse-CDF scan of static depth ``kmax``
(chosen on the host so the truncated tail < 1e-12).  RNG budget: three
threefry calls per Box-Muller step pair — diffusion normals, jump-size
normals, Poisson uniforms — vs one for GBM.
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

__all__ = ["MertonDynamics", "price_merton", "merton_call_closed_form",
           "DEMO_MERTON"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MertonDynamics:
    """Jump parameters (traced leaves).

    lam:     jump intensity (expected jumps per year)
    mu_j:    mean of the log jump size Y
    sigma_j: std of the log jump size Y
    """

    lam: Any = 0.3
    mu_j: Any = -0.10
    sigma_j: Any = 0.15

    def as_f32(self) -> "MertonDynamics":
        return MertonDynamics(lam=jnp.float32(self.lam),
                              mu_j=jnp.float32(self.mu_j),
                              sigma_j=jnp.float32(self.sigma_j))

    def kappa(self) -> float:
        """E[e^Y] - 1 — the drift compensator."""
        return math.exp(float(self.mu_j)
                        + 0.5 * float(self.sigma_j) ** 2) - 1.0


DEMO_MERTON = MertonDynamics()

_MERTON_FIELDS = ("s0", "k", "r", "barrier", "p1", "p2", "t", "q", "sigma",
                  "dt", "inv_n_steps", "drift_dt", "vol_dt", "drift_t",
                  "vol_t", "lam_dt", "lam_t", "mu_j", "sigma_j")


def _pack_merton(option, dyn, n_steps):
    s0, t, k, r, sigma, barrier, p1, p2, q = (
        jnp.float32(v) for v in option.astuple())
    lam = jnp.float32(dyn.lam)
    mu_j = jnp.float32(dyn.mu_j)
    sigma_j = jnp.float32(dyn.sigma_j)
    kappa = jnp.exp(mu_j + 0.5 * sigma_j * sigma_j) - 1.0
    n = jnp.float32(n_steps)
    dt = t / n
    # Compensated drift: the jump expectation is subtracted so that
    # E[S_t] = S0 e^{(r-q)t} exactly (martingale test in tests/test_merton).
    mu = r - q - lam * kappa - 0.5 * sigma * sigma
    vals = dict(
        s0=s0, k=k, r=r, barrier=barrier, p1=p1, p2=p2, t=t, q=q,
        sigma=sigma, dt=dt, inv_n_steps=1.0 / n,
        drift_dt=mu * dt, vol_dt=sigma * jnp.sqrt(dt),
        drift_t=mu * t, vol_t=sigma * jnp.sqrt(t),
        lam_dt=lam * dt, lam_t=lam * t, mu_j=mu_j, sigma_j=sigma_j)
    return jnp.stack([vals[f] for f in _MERTON_FIELDS])


def _unpack_merton(ref):
    return SimpleNamespace(**{f: ref[i]
                              for i, f in enumerate(_MERTON_FIELDS)})


def poisson_kmax(lam: float, tail: float = 1e-12) -> int:
    """Smallest k with P(Poisson(lam) > k) < tail (static scan depth)."""
    lam = float(lam)
    if lam <= 0.0:
        return 1
    pmf = math.exp(-lam)
    cdf = pmf
    k = 0
    while cdf < 1.0 - tail and k < 256:
        k += 1
        pmf *= lam / k
        cdf += pmf
    if cdf < 1.0 - tail:
        raise ValueError(
            f"Poisson scan depth would exceed 256 at intensity lam={lam} "
            f"(truncated tail {1.0 - cdf:.3e} > {tail:.0e} design target); "
            "reduce lam*dt by using more steps or a lower jump intensity")
    return max(k, 1)


def _poisson_inv_cdf(u, lam, kmax: int):
    """Branch-free Poisson inverse CDF: N = #{k in 0..kmax-1 : u >= F(k)}.

    Returns the count as f32 (it feeds straight into the compound-jump
    mean/variance).  ``kmax`` is static; the tail beyond it is clipped,
    chosen < 1e-12 by `poisson_kmax` on the host.
    """
    pmf0 = jnp.exp(-lam) * jnp.ones_like(u)

    def body(k, carry):
        pmf, cdf, n = carry
        n = n + jnp.where(u >= cdf, jnp.float32(1.0), jnp.float32(0.0))
        pmf = pmf * lam / jnp.asarray(k, jnp.float32)
        cdf = cdf + pmf
        return (pmf, cdf, n)

    _, _, n = jax.lax.fori_loop(1, kmax + 1, body,
                                (pmf0, pmf0, jnp.zeros_like(u)))
    return n


def _jump_increment(p, n, e):
    """Compound-jump log increment given count ``n`` and one N(0,1) ``e``."""
    return n * p.mu_j + p.sigma_j * jnp.sqrt(n) * e


def _merton_draw3(k0, k1, ids, m, rounds=rng.DEFAULT_ROUNDS):
    """Draws for the step pair (2m, 2m+1): three threefry calls.

    Counter layout: c1 = 3m (diffusion normals), 3m+1 (jump-size normals),
    3m+2 (Poisson uniforms) — disjoint for any step count, tiling-invariant.
    """
    base = jnp.asarray(3 * m, jnp.uint32)
    zero = jnp.full(ids.shape, 0, jnp.uint32)
    z0, z1 = rng.normal_pair(k0, k1, ids, zero + base,
                             rounds=rounds)
    e0, e1 = rng.normal_pair(k0, k1, ids, zero + base + jnp.uint32(1),
                             rounds=rounds)
    b0, b1 = rng.threefry2x32(k0, k1, ids, zero + base + jnp.uint32(2),
                              rounds=rounds)
    u0 = rng.bits_to_unit(b0)
    u1 = rng.bits_to_unit(b1)
    return z0, z1, e0, e1, u0, u1


def _merton_leg(payoff, n_steps: int, kmax: int, p, s0, draw3,
                antithetic_sign=1.0):
    """Log-space Euler leg; each step's log-increment is exact in law."""
    sign = jnp.float32(antithetic_sign)
    anti = antithetic_sign < 0
    state0 = payoff.init(p, jnp.zeros_like(s0))

    def one_step(w, state, z, e, u):
        n = _poisson_inv_cdf(u, p.lam_dt, kmax)
        w = w + p.drift_dt + p.vol_dt * z + _jump_increment(p, n, e)
        s = s0 * jnp.exp(w)
        return w, s, payoff.update(state, s, p)

    def body(m, carry):
        w, s, state = carry
        z0, z1, e0, e1, u0, u1 = draw3(m)
        if anti:
            # Antithetic coupling: reflect every underlying uniform —
            # normals negate, Poisson uniforms map u -> 1-u.
            u0, u1 = 1.0 - u0, 1.0 - u1
        w, s, state = one_step(w, state, sign * z0, sign * e0, u0)
        w, s, state = one_step(w, state, sign * z1, sign * e1, u1)
        return (w, s, state)

    assert n_steps % 2 == 0, "Merton leg consumes full Box-Muller pairs"
    zero = jnp.zeros_like(s0)
    w, s_t, state = jax.lax.fori_loop(0, n_steps // 2, body,
                                      (zero, s0, state0))
    return payoff.terminal(state, s_t, p)


def _merton_terminal(payoff, kmax: int, p, s0, draw3, antithetic_sign=1.0):
    """Exact one-shot terminal draw: N ~ Poisson(lam*T) conditions the
    horizon to a single Gaussian (the series oracle's decomposition)."""
    sign = jnp.float32(antithetic_sign)
    z, e, _, _, u, _ = draw3(0)
    if antithetic_sign < 0:
        u = 1.0 - u
    n = _poisson_inv_cdf(u, p.lam_t, kmax)
    s_t = s0 * jnp.exp(p.drift_t + p.vol_t * (sign * z)
                       + _jump_increment(p, n, sign * e))
    return payoff.terminal((), s_t, p)


def _merton_tile(payoff, method: str, n_steps: int, kmax: int, antithetic,
                 p, ids, valid, k0, k1, rng_source="threefry13"):
    rounds = 13 if rng_source == "threefry13" else 20
    draw3 = lambda m: _merton_draw3(k0, k1, ids, m, rounds)
    s0 = jnp.full(ids.shape, p.s0, jnp.float32)
    if method == "terminal":
        pay = _merton_terminal(payoff, kmax, p, s0, draw3)
        if antithetic:
            pay = 0.5 * (pay + _merton_terminal(payoff, kmax, p, s0, draw3,
                                                antithetic_sign=-1.0))
    else:
        pay = _merton_leg(payoff, n_steps, kmax, p, s0, draw3)
        if antithetic:
            pay = 0.5 * (pay + _merton_leg(payoff, n_steps, kmax, p, s0,
                                           draw3, antithetic_sign=-1.0))
    return jnp.where(valid, pay, 0.0)


def _merton_partials(payoff, cfg, kmax, key, params, path_offset=0,
                     n_valid=None):
    """(sum, sumsq) (8,128) slabs for this shard's global path-id range."""
    offset = jnp.asarray(path_offset, jnp.uint32)
    bound = (offset + jnp.uint32(cfg.n_paths) if n_valid is None
             else jnp.asarray(n_valid, jnp.uint32))
    p = _unpack_merton(params)
    k0 = jnp.asarray(key[0], jnp.uint32)
    k1 = jnp.asarray(key[1], jnp.uint32)

    def tile_fn(ids, valid):
        pay = _merton_tile(payoff, cfg.method, cfg.n_steps, kmax,
                           cfg.antithetic, p, ids, valid, k0, k1)
        return [pay, pay * pay]

    return xla_moment_scan(tile_fn, cfg.n_paths, cfg.tile_rows, 2,
                           offset=offset, bound=bound)


@functools.partial(
    jax.jit,
    static_argnames=("payoff", "sim", "method", "kmax",
                     "antithetic", "tile_rows", "rng_source"))
def _price_merton_impl(option, dyn, payoff, sim, method, kmax,
                       antithetic, tile_rows, key,
                       rng_source="threefry13"):
    cfg = pk.KernelConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                          tile_rows=tile_rows, antithetic=antithetic,
                          method=method, rng_source=rng_source)
    params = _pack_merton(option, dyn, sim.n_steps)
    s, sq = _merton_partials(payoff, cfg, kmax, key, params)
    r = jnp.float32(option.r)
    t = jnp.float32(option.t)
    return summarize(finish_sum(s), finish_sum(sq),
                     jnp.asarray(sim.n_paths, jnp.float32),
                     jnp.exp(-r * t))


def price_merton(option: OptionParams = DEMO_OPTION,
                 dyn: MertonDynamics = DEMO_MERTON,
                 sim: SimParams = DEMO_SIM,
                 payoff="vanilla_call",
                 *,
                 method: str = "euler",
                 antithetic: bool = False,
                 tile_rows: int = 128,
                 stream: int = STREAM_OUTER,
                 key=None,
                 rng_source: str = "threefry13") -> PriceResult:
    """Monte Carlo price under Merton jump-diffusion.

    ``method="terminal"`` draws S_T exactly in one shot (terminal-only
    payoffs); ``method="euler"`` steps the exact-in-law log increment so
    path-dependent payoffs see the jumps at step resolution.
    """
    po = get_payoff(payoff)
    po.validate(option, sim.n_steps)
    if method == "terminal" and not po.terminal_only:
        raise ValueError(f"payoff {po.name!r} is path-dependent; "
                         "method='terminal' would ignore its path state")
    if method not in ("terminal", "euler"):
        raise ValueError(f"unknown method {method!r}")
    if method == "euler" and sim.n_steps % 2:
        raise ValueError("Merton requires an even n_steps (pair-consuming "
                         "step loop)")
    # Static Poisson scan depth from the CONCRETE intensity (lam must not
    # be a tracer here — it sizes the kernel's unrolled inverse-CDF scan).
    lam_scale = (float(option.t) if method == "terminal"
                 else float(option.t) / sim.n_steps)
    kmax = poisson_kmax(float(dyn.lam) * lam_scale)
    if key is None:
        key = jnp.asarray(rng.derive_key(sim.seed, stream, 0x3E44),
                          jnp.uint32)
    return _price_merton_impl(option.as_f32(), dyn.as_f32(), po,
                              sim.replace(seed=0), method, kmax,
                              antithetic, tile_rows, key,
                              rng_source=rng_source)


def merton_call_closed_form(s0, k, t, r, sigma, lam, mu_j, sigma_j,
                            q=0.0, tol: float = 1e-14) -> float:
    """European call under Merton jump-diffusion (Merton 1976 series).

    Conditioning on the jump count n, S_T is lognormal, so the price is a
    Poisson(lam') mixture of Black-Scholes prices with
        lam'    = lam (1 + kappa)
        sigma_n = sqrt(sigma^2 + n sigma_j^2 / t)
        r_n     = r - lam kappa + n (mu_j + sigma_j^2/2) / t.
    Host-side f64; the model's analytic oracle.
    """
    s0, k, t, r, sigma, lam, mu_j, sigma_j, q = map(
        float, (s0, k, t, r, sigma, lam, mu_j, sigma_j, q))

    def bs(s0_, r_, sig_):
        if sig_ * math.sqrt(t) < 1e-12:
            return max(s0_ * math.exp((r_ - q) * t) - k, 0.0) \
                * math.exp(-r_ * t)
        d1 = (math.log(s0_ / k) + (r_ - q + 0.5 * sig_ * sig_) * t) \
            / (sig_ * math.sqrt(t))
        d2 = d1 - sig_ * math.sqrt(t)
        nd = lambda x: 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))
        return (s0_ * math.exp(-q * t) * nd(d1)
                - k * math.exp(-r_ * t) * nd(d2))

    kappa = math.exp(mu_j + 0.5 * sigma_j * sigma_j) - 1.0
    lam_p = lam * (1.0 + kappa)
    if lam_p * t < 1e-15:
        return bs(s0, r, sigma)
    w = math.exp(-lam_p * t)  # Poisson(lam' t) pmf at n=0
    total = 0.0
    n = 0
    while True:
        sigma_n = math.sqrt(sigma * sigma + n * sigma_j * sigma_j / t)
        r_n = r - lam * kappa + n * (mu_j + 0.5 * sigma_j * sigma_j) / t
        total += w * bs(s0, r_n, sigma_n)
        n += 1
        w *= lam_p * t / n
        if n > lam_p * t and w < tol:
            break
        if n > 512:
            break
    return float(total)
