"""Local volatility (Dupire-style): sigma = sigma(S, t) on a knot grid.

Beyond the reference (flat sigma) and the parametric CEV family: the
practitioner's local-vol model prices with an ARBITRARY surface
sigma(S, t), here piecewise-linear in log-moneyness x = log(S/S0) over K
knots, per simulation step:

    d log S = (r - q - sigma(x, t_j)^2 / 2) dt + sigma(x, t_j) sqrt(dt) dW.

Device mapping — gather-free interpolation: a piecewise-linear function
with flat extrapolation is a sum of clamped ramps,

    sigma(x) = v_0 + sum_k m_k * clamp(x - x_k, 0, x_{k+1} - x_k),

so the per-step lookup is K-1 FMA+clamp VECTOR ops on the (tile_rows,
128) tiles — no dynamic gather (which has no fast vector path).
Knots are shared across steps; the per-step left value v_0 and
segment slopes m_k are read from the flat params vector by dynamic
scalar index, like the term-structure kernel.

Gates: a flat surface is EXACT log-Euler GBM (plain BS); an S-independent
surface matches the averaged-parameter BS; and the CEV-shaped surface
sigma(S) = sigma0 (S/S0)^(beta-1) reproduces the CEV noncentral-chi^2
closed form (`oracle` via models.cev) — a cross-model consistency check
through a completely different discretization.
"""

from __future__ import annotations

import dataclasses
import functools

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from mc_tpu import rng
from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.engines import STREAM_OUTER
from mc_tpu.models.term import _unpack_term_head
from mc_tpu.oracle import PriceResult, summarize
from mc_tpu.ops import path_kernels as pk
from mc_tpu.ops._pallas import xla_moment_scan
from mc_tpu.ops.payoffs import get_payoff
from mc_tpu.ops.reduce import finish_sum

__all__ = ["LocalVolSurface", "price_localvol", "DEMO_LOCALVOL"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LocalVolSurface:
    """sigma(log-moneyness, step) on a (n_steps, K) knot grid.

    ``x_knots``: (K,) log-moneyness knots (ascending);
    ``vols``: (n_steps, K) positive vols at the knots.  Between knots
    the vol is linear in x; beyond the ends it is flat.
    """

    x_knots: Any
    vols: Any

    @property
    def n_steps(self) -> int:
        return int(self.vols.shape[0])

    @property
    def n_knots(self) -> int:
        return int(self.x_knots.shape[0])

    def as_f32(self) -> "LocalVolSurface":
        return LocalVolSurface(
            x_knots=jnp.asarray(self.x_knots, jnp.float32),
            vols=jnp.asarray(self.vols, jnp.float32))

    @staticmethod
    def from_function(fn, n_steps: int, x_lo=-1.0, x_hi=1.0,
                      n_knots: int = 9):
        """Sample ``fn(x, t_frac) -> sigma`` on the knot grid
        (t_frac = (j + 1) / n_steps, the step's END time fraction)."""
        xs = np.linspace(x_lo, x_hi, n_knots).astype(np.float32)
        vols = np.stack([
            np.asarray([fn(float(x), (j + 1.0) / n_steps) for x in xs],
                       np.float32)
            for j in range(n_steps)])
        return LocalVolSurface(x_knots=xs, vols=vols)

    @staticmethod
    def flat(sigma: float, n_steps: int, n_knots: int = 9):
        return LocalVolSurface.from_function(
            lambda x, t: sigma, n_steps, n_knots=n_knots)

    @staticmethod
    def demo(n_steps: int = 100):
        """The demo surface (a mild smile deepening with time) at any
        step count — the ONE definition the single-chip default, the
        sharded default, the LSMC default, tests and bench all share
        (their 1-device bitwise-parity checks require identical
        values)."""
        return LocalVolSurface.from_function(
            lambda x, t: 0.2 + 0.1 * x * x + 0.05 * t, n_steps)


DEMO_LOCALVOL = LocalVolSurface.demo(100)


def validate_surface(surf: LocalVolSurface, n_steps: int) -> LocalVolSurface:
    """Shared entry-point validation (price / NMC / LSMC): step count,
    knot count, and strictly-ascending knots (dx <= 0 would produce
    infinite slopes and silent NaN prices).  Returns surf.as_f32()."""
    s32 = surf.as_f32()
    if s32.n_steps != n_steps:
        raise ValueError(
            f"surface has {s32.n_steps} steps, sim has {n_steps}; "
            f"build with LocalVolSurface.from_function(..., "
            f"n_steps={n_steps})")
    if s32.n_knots < 2:
        raise ValueError("need at least 2 knots")
    try:  # concrete knots: catch non-ascending grids
        xs = np.asarray(surf.x_knots, np.float64)
        if not np.all(np.diff(xs) > 0.0):
            raise ValueError(
                f"x_knots must be strictly ascending, got {xs.tolist()}")
    except TypeError:
        pass  # traced knots — cannot check at entry
    return s32

# Parameter-vector layout:
# [s0, k, t, barrier, p1, p2, q, dt, inv_n, r, sigma_ref,
#  x_knots(K), dx(K-1), v0(n_steps), slopes(n_steps*(K-1))]
_HDR = 11


def _pack_localvol(option, surf, n_steps):
    s0, t, k, r, sigma0, barrier, p1, p2, q = (
        jnp.float32(v) for v in option.astuple())
    xs = jnp.asarray(surf.x_knots, jnp.float32)
    vols = jnp.asarray(surf.vols, jnp.float32)
    n = jnp.float32(n_steps)
    dt = t / n
    dx = xs[1:] - xs[:-1]
    slopes = (vols[:, 1:] - vols[:, :-1]) / dx[None, :]
    # sigma_ref: time-rms of the TRUE at-the-money vol (the surface
    # interpolated at x = 0, correct for asymmetric knot grids) —
    # payoffs that read p.sigma (e.g. bridge-barrier weights) see this
    atm = vols[:, 0] + jnp.sum(
        slopes * jnp.clip(0.0 - xs[:-1], 0.0, dx)[None, :], axis=1)
    sigma_ref = jnp.sqrt(jnp.mean(atm * atm))
    head = jnp.stack([s0, k, t, barrier, p1, p2, q, dt, 1.0 / n, r,
                      sigma_ref])
    return jnp.concatenate([head, xs, dx, vols[:, 0],
                            slopes.reshape(-1)])


# identical head layout as the term-structure kernel — ONE definition
_unpack_localvol_head = _unpack_term_head


def _make_sigma_at(params, n_steps: int, n_knots: int):
    """sigma(w_tile, j) from the packed vector — K-1 clamped-ramp FMAs."""
    km1 = n_knots - 1
    o_x = _HDR
    o_dx = o_x + n_knots
    o_v0 = o_dx + km1
    o_m = o_v0 + n_steps

    def sigma_at(w, j):
        s = params[o_v0 + j]
        for kk in range(km1):
            m = params[o_m + j * km1 + kk]
            s = s + m * jnp.clip(w - params[o_x + kk], 0.0,
                                 params[o_dx + kk])
        return jnp.maximum(s, 1e-4)

    return sigma_at


def _localvol_leg(payoff, n_steps: int, p, s0, draw_pair, sigma_at,
                  antithetic_sign=1.0):
    """Log-Euler leg with the local-vol lookup; one pair per step pair."""
    sign = jnp.float32(antithetic_sign)
    state0 = payoff.init(p, jnp.zeros_like(s0))
    base_drift = (p.r - p.q) * p.dt
    sdt = jnp.sqrt(p.dt)

    def one_step(carry, j, z):
        w, state = carry
        sg = sigma_at(w, j)
        w = w + (base_drift - 0.5 * sg * sg * p.dt) + sg * sdt * z
        s = s0 * jnp.exp(w)  # log-space: one exp rounding per S_t
        carry = (w, payoff.update(state, s, p))
        return carry, s

    def pair_body(j, carry3):
        carry, _ = carry3
        z0, z1 = draw_pair(j)
        carry, _ = one_step(carry, 2 * j, sign * z0)
        carry, s = one_step(carry, 2 * j + 1, sign * z1)
        return carry, s

    # the terminal pay consumes the SAME rounded s the last step fed
    # payoff.update (recomputing s0*exp(w) here lets XLA contract the
    # multiply into the payoff's subtract — 1-ulp drift vs the carried
    # value, which would break the bitwise NMC/pricer stream agreement)
    zeros = jnp.zeros_like(s0)
    (_, state), s_t = jax.lax.fori_loop(
        0, n_steps // 2, pair_body, ((zeros, state0), s0))
    return payoff.terminal(state, s_t, p)


def _localvol_tile(payoff, n_steps, antithetic, p, ids, valid, k0, k1,
                   sigma_at, rng_source="threefry13"):
    shape = ids.shape

    rounds = 13 if rng_source == "threefry13" else 20

    def draw_pair(m):
        c1 = jnp.full(shape, 0, jnp.uint32) + jnp.asarray(m, jnp.uint32)
        return rng.normal_pair(k0, k1, ids, c1, rounds=rounds)

    s0 = jnp.full(shape, p.s0, jnp.float32)
    pay = _localvol_leg(payoff, n_steps, p, s0, draw_pair, sigma_at)
    if antithetic:
        pay = 0.5 * (pay + _localvol_leg(payoff, n_steps, p, s0,
                                         draw_pair, sigma_at,
                                         antithetic_sign=-1.0))
    return jnp.where(valid, pay, 0.0)


def _localvol_partials(payoff, cfg, n_knots, key, params, path_offset=0,
                       n_valid=None):
    """(sum, sumsq) (8,128) slabs for this shard's global path-id range."""
    offset = jnp.asarray(path_offset, jnp.uint32)
    bound = (offset + jnp.uint32(cfg.n_paths) if n_valid is None
             else jnp.asarray(n_valid, jnp.uint32))
    p = _unpack_localvol_head(params)
    k0 = jnp.asarray(key[0], jnp.uint32)
    k1 = jnp.asarray(key[1], jnp.uint32)
    sigma_at = _make_sigma_at(params, cfg.n_steps, n_knots)

    def tile_fn(ids, valid):
        pay = _localvol_tile(payoff, cfg.n_steps, cfg.antithetic, p, ids,
                             valid, k0, k1, sigma_at)
        return [pay, pay * pay]

    return xla_moment_scan(tile_fn, cfg.n_paths, cfg.tile_rows, 2,
                           offset=offset, bound=bound)


@functools.partial(
    jax.jit,
    static_argnames=("payoff", "sim", "n_knots", "antithetic",
                     "tile_rows", "rng_source"))
def _price_localvol_impl(option, surf, payoff, sim, n_knots,
                         antithetic, tile_rows, key,
                         rng_source="threefry13"):
    cfg = pk.KernelConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                          tile_rows=tile_rows, antithetic=antithetic,
                          rng_source=rng_source)
    params = _pack_localvol(option, surf, sim.n_steps)
    s, sq = _localvol_partials(payoff, cfg, n_knots, key, params)
    r = jnp.float32(option.r)
    t = jnp.float32(option.t)
    return summarize(finish_sum(s), finish_sum(sq),
                     jnp.asarray(sim.n_paths, jnp.float32),
                     jnp.exp(-r * t))


def price_localvol(option: OptionParams = DEMO_OPTION,
                   surf: LocalVolSurface = DEMO_LOCALVOL,
                   sim: SimParams = DEMO_SIM,
                   payoff="vanilla_call",
                   *,
                   antithetic: bool = False,
                   tile_rows: int = 128,
                   stream: int = STREAM_OUTER,
                   key=None,
                   rng_source: str = "threefry13") -> PriceResult:
    """Monte Carlo price under a local-volatility surface sigma(S, t).

    ``surf.vols`` must have ``sim.n_steps`` rows (build with
    `LocalVolSurface.from_function`); every registry payoff works.  The
    discretization is log-Euler (weak order 1 in dt) — unlike the GBM /
    term-structure kernels it is NOT exact in law unless the surface is
    S-independent.
    """
    po = get_payoff(payoff)
    po.validate(option, sim.n_steps)
    s32 = validate_surface(surf, sim.n_steps)
    if sim.n_steps % 2:
        raise ValueError("localvol requires an even n_steps "
                         "(pair-consuming step loop)")
    if key is None:
        key = jnp.asarray(rng.derive_key(sim.seed, stream, 0x10CA),
                          jnp.uint32)
    return _price_localvol_impl(option.as_f32(), s32, po,
                                sim.replace(seed=0), s32.n_knots,
                                antithetic, tile_rows, key,
                                rng_source=rng_source)


# ---------------------------------------------------------------------------
# Trajectory materialization: step-major (S, state) grids feeding LSMC —
# American exercise under a local-vol surface (the localvol analogue of
# the C9 state-grid kernel, trajectories.cuh:273-351).
# ---------------------------------------------------------------------------


