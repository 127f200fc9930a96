"""Greeks: sensitivities of the Monte Carlo price to market parameters.

Not present in the reference (it prices only), but a required capability of
any production pricing framework and a showcase of the functional design:
because the whole pricing engine is a pure jitted function of the traced
``OptionParams`` pytree, **pathwise Greeks are one `jax.grad`** — the
cost of all first-order Greeks together is one extra backward pass, with
the same counter-based draws (no RNG state to replay).

* ``method="pathwise"`` — exact pathwise differentiation (delta, vega,
  rho, theta, dual-delta in one pass).  Valid for (a.e.) continuous
  payoffs: vanilla, Asian, lookback.  Discontinuous payoffs (bullet
  window, barriers) have zero-a.e. pathwise derivatives — rejected.
* ``method="fd"`` — central finite differences with common random numbers
  (same threefry key on both sides, so the difference variance collapses).
  Works for every payoff; also provides gamma.
* ``method="lrm"`` — likelihood-ratio (score-function) estimator:
  differentiates the path DENSITY instead of the payoff, so it is
  unbiased for any payoff including the discontinuous ones pathwise
  rejects (bullet window ``trajectories.cuh:149-153``, barriers).
  delta / vega / rho / epsilon / gamma (second-order score); the scores
  are simple polynomials of the standard normals the engines already draw
  (Glasserman ch. 7.3).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Sequence

import jax
import jax.numpy as jnp

from mc_tpu import rng
from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.engines import STREAM_OUTER, _price_impl
from mc_tpu.ops._pallas import resolve_engine
from mc_tpu.ops.payoffs import get_payoff

__all__ = ["greeks", "heston_greeks", "merton_greeks", "sabr_greeks",
           "vasicek_greeks", "rainbow_greeks", "basket_greeks",
           "GREEK_FIELDS", "HESTON_GREEK_FIELDS",
           "MERTON_GREEK_FIELDS", "SABR_GREEK_FIELDS",
           "VASICEK_GREEK_FIELDS"]

# greek name -> (OptionParams field, sign)
GREEK_FIELDS = {
    "delta": ("s0", 1.0),
    "vega": ("sigma", 1.0),
    "rho": ("r", 1.0),
    "theta": ("t", -1.0),     # market convention: -dP/dT
    "dual_delta": ("k", 1.0),
    "epsilon": ("q", 1.0),    # dividend-yield sensitivity dP/dq
}

# Payoffs whose pathwise derivative is valid (a.e.-differentiable payoff).
_PATHWISE_OK = {"vanilla_call", "vanilla_put", "asian_call",
                "lookback_call", "best_of_cash"}

# Greeks the likelihood-ratio estimator supports: parameters that enter the
# path DENSITY.  (K and T do not: dual_delta/theta have no LRM form here.)
# gamma uses the second-order score — the only UNBIASED gamma for
# discontinuous payoffs (pathwise is a.e. zero, FD is biased).
_LRM_OK = {"delta", "vega", "rho", "epsilon", "gamma"}


def _price_fn(payoff, sim, method, engine, antithetic, tile_rows, key,
              interpret=False):
    def f(option: OptionParams):
        return _price_impl(option, payoff, sim, method, engine, antithetic,
                           False, tile_rows, "threefry13", interpret, key,
                           jnp.uint32(0), None).price
    return f


@functools.partial(
    jax.jit, static_argnames=("payoff", "sim", "sim_method", "tile_rows"))
def _lrm_moments(option, payoff, sim, sim_method, tile_rows, key):
    """LRM estimator moments on the SAME threefry stream as the engines.

    Simulates the identical log-Euler leg as ``pk._simulate_leg`` (draw j
    of path i = half j%2 of threefry pair (i, j//2)) while additionally
    accumulating the score ingredients (z_1, sum z_j, sum z_j^2).  Scores
    (Glasserman 7.3, log-Euler GBM with drift mu = r - q - sigma^2/2):

      d log p / d s0    = z_1 / (s0 sigma sqrt(dt))
      d log p / d sigma = sum_j [(z_j^2 - 1)/sigma - z_j sqrt(dt)]
      d log p / d r     = sqrt(dt) sum_j z_j / sigma   (discount adds -T)
      d log p / d q     = -sqrt(dt) sum_j z_j / sigma

    Returns {greek: (sum, sumsq)} (8,128) slabs plus the plain payoff
    moments (so the implied price is bit-identical to price(engine='xla')).
    """
    from mc_tpu.engines import _payoff_namespace
    from mc_tpu.ops._pallas import xla_moment_scan

    p = _payoff_namespace(option, sim.n_steps)
    k0 = jnp.asarray(key[0], jnp.uint32)
    k1 = jnp.asarray(key[1], jnp.uint32)
    n_steps = sim.n_steps

    def tile_fn(ids, valid):
        shape = ids.shape

        def draw_pair(m):
            c1 = jnp.full(shape, 0, jnp.uint32) + jnp.asarray(m, jnp.uint32)
            return rng.normal_pair(k0, k1, ids, c1)

        zero = jnp.zeros(shape, jnp.float32)
        if sim_method == "terminal":
            z, _ = draw_pair(0)
            s_t = p.s0 * jnp.exp(p.drift_t + p.vol_t * z)
            pay = payoff.terminal((), s_t, p)
            z1, sum_z, sum_z2 = z, z, z * z
            n_z, sq_dt, vol_unit = 1.0, jnp.sqrt(p.t), p.vol_t
        else:
            state0 = payoff.init(p, zero)

            def half_step(w, state, z):
                w = w + (p.drift_dt + p.vol_dt * z)
                s = p.s0 * jnp.exp(w)
                return w, payoff.update(state, s, p)

            def body(m, carry):
                w, state, z1, sz, sz2 = carry
                za, zb = draw_pair(m)
                w, state = half_step(w, state, za)
                w, state = half_step(w, state, zb)
                z1 = jnp.where(m == 0, za, z1)
                return (w, state, z1, sz + za + zb,
                        sz2 + za * za + zb * zb)

            w, state, z1, sum_z, sum_z2 = jax.lax.fori_loop(
                0, n_steps // 2, body, (zero, state0, zero, zero, zero))
            if n_steps % 2:
                za, _ = draw_pair(n_steps // 2)
                w, state = half_step(w, state, za)
                sum_z = sum_z + za
                sum_z2 = sum_z2 + za * za
                if n_steps == 1:
                    z1 = za
            s_t = p.s0 * jnp.exp(w)
            pay = payoff.terminal(state, s_t, p)
            n_z, sq_dt, vol_unit = float(n_steps), jnp.sqrt(p.dt), p.vol_dt

        sc_delta = z1 / (p.s0 * vol_unit)
        sc_vega = (sum_z2 - n_z) / p.sigma - sq_dt * sum_z
        sc_r = sq_dt * sum_z / p.sigma
        # Second-order score (Glasserman 7.3): the density depends on s0
        # only through the FIRST increment, so
        #   W = d2 log p/ds0^2 + (d log p/ds0)^2
        #     = ((z1^2 - 1)/vol_unit^2 - z1/vol_unit) / s0^2.
        # Variance grows like 1/vol_unit^2 = 1/(sigma^2 dt) — fine at the
        # terminal method, noisy for very fine grids (documented).
        sc_gamma = ((z1 * z1 - 1.0) / (vol_unit * vol_unit)
                    - z1 / vol_unit) / (p.s0 * p.s0)
        vals = [pay,
                pay * sc_delta,
                pay * sc_vega,
                pay * (sc_r - p.t),   # d(e^{-rT})/dr folds in the -T
                pay * (-sc_r),
                pay * sc_gamma]
        out = []
        for v in vals:
            v = jnp.where(valid, v, 0.0)
            out += [v, v * v]
        return out

    slabs = xla_moment_scan(tile_fn, sim.n_paths, tile_rows, 12)
    r = jnp.asarray(option.r, jnp.float32)
    t = jnp.asarray(option.t, jnp.float32)
    disc = jnp.exp(-r * t)
    n = jnp.asarray(sim.n_paths, jnp.float32)
    from mc_tpu.oracle import summarize
    from mc_tpu.ops.reduce import finish_sum
    names = ("price", "delta", "vega", "rho", "epsilon", "gamma")
    return {name: summarize(finish_sum(slabs[2 * i]),
                            finish_sum(slabs[2 * i + 1]), n, disc)
            for i, name in enumerate(names)}


def greeks(option: OptionParams = DEMO_OPTION,
           sim: SimParams = DEMO_SIM,
           payoff="vanilla_call",
           *,
           method: str = "pathwise",
           which: Sequence[str] = ("delta", "vega", "rho", "theta"),
           sim_method: Optional[str] = None,
           engine: Optional[str] = None,
           antithetic: bool = False,
           tile_rows: int = 128,
           rel_bump: float = 1e-3,
           stream: int = STREAM_OUTER,
           key=None,
           interpret: bool = False) -> Dict[str, Any]:
    """Monte Carlo Greeks.  Returns {greek: value} (plus 'gamma' for fd).

    ``engine`` prices as in `price` (the Triton kernel on a GPU, XLA
    elsewhere); gradients through the kernel use the XLA engine as the
    backward pass (`engines._pallas_partials_diff`), which computes the
    same function of the same stream, so they are the production
    price's gradients.
    """
    po = get_payoff(payoff)
    engine = resolve_engine(engine, interpret)
    if sim_method is None:
        sim_method = "terminal" if po.terminal_only else "euler"
    if key is None:
        key = jnp.asarray(rng.derive_key(sim.seed, stream), jnp.uint32)
    bad = set(which) - set(GREEK_FIELDS) - {"gamma"}
    if bad:
        raise ValueError(f"unknown greeks {sorted(bad)}; "
                         f"available: {sorted(GREEK_FIELDS)} + ['gamma']")
    if method == "pathwise" and po.name not in _PATHWISE_OK:
        raise ValueError(
            f"payoff {po.name!r} has a discontinuous payoff; pathwise "
            "derivatives are invalid — use method='lrm' (unbiased "
            "score-function weights) or method='fd' (common random "
            "numbers make the central difference low-variance)")

    opt32 = option.as_f32()

    if method == "lrm":
        bad_lrm = set(which) - _LRM_OK
        if bad_lrm:
            raise ValueError(
                f"LRM supports {sorted(_LRM_OK)} (density parameters "
                f"only); requested {sorted(bad_lrm)} — use method='fd'")
        if antithetic:
            raise ValueError("antithetic pairing is not supported for "
                             "method='lrm' (the scores are odd in z)")
        res = _lrm_moments(opt32, po, sim.replace(seed=0), sim_method,
                           tile_rows, key)
        out = {}
        for g in which:
            out[g] = res[g].price
            out[f"{g}_stderr"] = res[g].stderr
        # implied price on the same stream: bit-identical to
        # price(engine="xla") at equal tile_rows — the stream-consistency
        # invariant tests pin.
        out["price"] = res["price"].price
        out["price_stderr"] = res["price"].stderr
        return out
    f = _price_fn(po, sim.replace(seed=0), sim_method, engine, antithetic,
                  tile_rows, key, interpret)

    if method == "pathwise":
        grads = jax.grad(f)(opt32)
        out = {g: getattr(grads, fld) * jnp.float32(sgn)
               for g, (fld, sgn) in GREEK_FIELDS.items() if g in which}
        if "gamma" in which:
            # d2P/dS0^2 pathwise is a.e. zero for kinked payoffs; use a
            # CRN central difference of the pathwise delta instead.
            h = jnp.float32(rel_bump) * opt32.s0
            d_up = jax.grad(f)(dataclasses.replace(opt32, s0=opt32.s0 + h)).s0
            d_dn = jax.grad(f)(dataclasses.replace(opt32, s0=opt32.s0 - h)).s0
            out["gamma"] = (d_up - d_dn) / (2.0 * h)
        return out

    if method != "fd":
        raise ValueError(f"unknown method {method!r}")

    out = {}
    for g in which:
        if g == "gamma":
            h = jnp.float32(rel_bump) * opt32.s0
            up = f(dataclasses.replace(opt32, s0=opt32.s0 + h))
            mid = f(opt32)
            dn = f(dataclasses.replace(opt32, s0=opt32.s0 - h))
            out["gamma"] = (up - 2.0 * mid + dn) / (h * h)
            continue
        fld, sgn = GREEK_FIELDS[g]
        base = getattr(opt32, fld)
        h = jnp.float32(rel_bump) * jnp.maximum(jnp.abs(base), 1e-2)
        up = f(dataclasses.replace(opt32, **{fld: base + h}))
        dn = f(dataclasses.replace(opt32, **{fld: base - h}))
        out[g] = jnp.float32(sgn) * (up - dn) / (2.0 * h)
    return out


def _fd_model_greeks(f, option, dyn, fields, which, rel_bump):
    """CRN central differences over (option, dynamics) fields.

    ``f(option, dyn) -> price`` must consume a FIXED key so both sides of
    each bump ride the same draws (the variance-collapsing trick every
    model-family greek here uses).
    """
    bad = set(which) - set(fields)
    if bad:
        raise ValueError(f"unknown greeks {sorted(bad)}; "
                         f"available: {sorted(fields)}")
    out = {}
    for g in which:
        tree, fld, sgn = fields[g]
        base_obj = option if tree == "option" else dyn
        base = getattr(base_obj, fld)
        h = jnp.float32(rel_bump) * jnp.maximum(jnp.abs(base), 1e-2)
        up_obj = dataclasses.replace(base_obj, **{fld: base + h})
        dn_obj = dataclasses.replace(base_obj, **{fld: base - h})
        if tree == "option":
            up, dn = f(up_obj, dyn), f(dn_obj, dyn)
        else:
            up, dn = f(option, up_obj), f(option, dn_obj)
        out[g] = jnp.float32(sgn) * (up - dn) / (2.0 * h)
    return out


MERTON_GREEK_FIELDS = {
    "delta": ("option", "s0", 1.0),
    "vega": ("option", "sigma", 1.0),       # diffusion-vol sensitivity
    "rho": ("option", "r", 1.0),
    "theta": ("option", "t", -1.0),
    "dual_delta": ("option", "k", 1.0),
    "lam_sens": ("dyn", "lam", 1.0),        # dP/d(jump intensity)
    "mu_j_sens": ("dyn", "mu_j", 1.0),      # dP/d(mean log jump)
    "sigma_j_sens": ("dyn", "sigma_j", 1.0),  # dP/d(jump-size vol)
}


def merton_greeks(option=None, merton=None,
                  sim: SimParams = DEMO_SIM,
                  payoff="vanilla_call",
                  *,
                  which: Sequence[str] = ("delta", "vega", "lam_sens"),
                  antithetic: bool = False,
                  tile_rows: int = 128,
                  rel_bump: float = 1e-3,
                  stream: int = STREAM_OUTER) -> Dict[str, Any]:
    """Merton-model sensitivities by CRN central differences — market
    greeks plus the jump-parameter sensitivities calibration needs.
    (Pathwise gradients through the branch-free Poisson inverse-CDF scan
    are a.e. zero in the count, so FD+CRN is the robust choice.)"""
    from mc_tpu.config import DEMO_OPTION
    from mc_tpu.models.merton import DEMO_MERTON, price_merton

    option = (DEMO_OPTION if option is None else option).as_f32()
    merton = (DEMO_MERTON if merton is None else merton).as_f32()
    key = jnp.asarray(rng.derive_key(sim.seed, stream, 0x3E44), jnp.uint32)

    def f(opt, dyn):
        return price_merton(opt, dyn, sim, payoff, method="euler",
                            antithetic=antithetic,
                            tile_rows=tile_rows, key=key).price

    return _fd_model_greeks(f, option, merton, MERTON_GREEK_FIELDS, which,
                            rel_bump)


SABR_GREEK_FIELDS = {
    "delta": ("option", "s0", 1.0),
    "rho": ("option", "r", 1.0),
    "theta": ("option", "t", -1.0),
    "dual_delta": ("option", "k", 1.0),
    "alpha_sens": ("dyn", "alpha", 1.0),    # dP/d(initial forward vol)
    "beta_sens": ("dyn", "beta", 1.0),      # dP/d(backbone exponent)
    "nu_sens": ("dyn", "nu", 1.0),          # dP/d(vol-of-vol)
    "rho_fv_sens": ("dyn", "rho", 1.0),     # dP/d(forward-vol corr)
}


def sabr_greeks(option=None, sabr=None,
                sim: SimParams = DEMO_SIM,
                payoff="vanilla_call",
                *,
                which: Sequence[str] = ("delta", "alpha_sens", "nu_sens"),
                antithetic: bool = False,
                tile_rows: int = 128,
                rel_bump: float = 1e-3,
                stream: int = STREAM_OUTER) -> Dict[str, Any]:
    """SABR-model sensitivities by CRN central differences — the smile
    calibration set (alpha, beta, nu, rho) plus spot/rate/maturity."""
    from mc_tpu.config import DEMO_OPTION
    from mc_tpu.models.sabr import DEMO_SABR, price_sabr

    option = (DEMO_OPTION if option is None else option).as_f32()
    sabr = (DEMO_SABR if sabr is None else sabr).as_f32()
    key = jnp.asarray(rng.derive_key(sim.seed, stream, 0x5AB4), jnp.uint32)

    def f(opt, dyn):
        return price_sabr(opt, dyn, sim, payoff,
                          antithetic=antithetic, tile_rows=tile_rows,
                          key=key).price

    return _fd_model_greeks(f, option, sabr, SABR_GREEK_FIELDS, which,
                            rel_bump)


HESTON_GREEK_FIELDS = {
    # greek -> (which pytree, field, sign)
    "delta": ("option", "s0", 1.0),
    "rho": ("option", "r", 1.0),
    "theta": ("option", "t", -1.0),
    "dual_delta": ("option", "k", 1.0),
    "vega_v0": ("heston", "v0", 1.0),        # dP/d(initial variance)
    "vega_theta": ("heston", "theta", 1.0),  # dP/d(long-run variance)
    "vega_xi": ("heston", "xi", 1.0),        # dP/d(vol-of-vol)
    "vega_kappa": ("heston", "kappa", 1.0),
    "vega_rho": ("heston", "rho", 1.0),      # dP/d(spot-vol correlation)
}


def heston_greeks(option=None, heston=None,
                  sim: SimParams = DEMO_SIM,
                  payoff="vanilla_call",
                  *,
                  which: Sequence[str] = ("delta", "vega_v0", "rho"),
                  antithetic: bool = False,
                  tile_rows: int = 128,
                  rel_bump: float = 1e-3,
                  scheme: str = "euler",
                  stream: int = STREAM_OUTER) -> Dict[str, Any]:
    """Heston-model sensitivities by common-random-number central
    differences (the full-truncation scheme's sqrt(v+) makes pathwise
    gradients NaN-prone at the v=0 boundary, so FD+CRN is the robust
    default; CRN collapses the difference variance the same way it does
    for GBM).  Supports the spot/rate/maturity/strike greeks plus the
    model-parameter sensitivities calibration needs (v0, theta, xi,
    kappa, rho)."""
    from mc_tpu.models.heston import DEMO_HESTON, _price_heston_impl
    from mc_tpu.config import DEMO_OPTION
    from mc_tpu.ops.payoffs import get_payoff

    option = (DEMO_OPTION if option is None else option).as_f32()
    heston = (DEMO_HESTON if heston is None else heston).as_f32()
    po = get_payoff(payoff)
    key = jnp.asarray(rng.derive_key(sim.seed, stream, 0x4E57), jnp.uint32)
    bad = set(which) - set(HESTON_GREEK_FIELDS)
    if bad:
        raise ValueError(f"unknown heston greeks {sorted(bad)}; "
                         f"available: {sorted(HESTON_GREEK_FIELDS)}")

    def f(opt, hes):
        return _price_heston_impl(opt, hes, po, sim.replace(seed=0),
                                  antithetic, tile_rows, key,
                                  scheme=scheme).price

    out = {}
    for g in which:
        tree, fld, sgn = HESTON_GREEK_FIELDS[g]
        base_obj = option if tree == "option" else heston
        base = getattr(base_obj, fld)
        h = jnp.float32(rel_bump) * jnp.maximum(jnp.abs(base), 1e-2)
        up_obj = dataclasses.replace(base_obj, **{fld: base + h})
        dn_obj = dataclasses.replace(base_obj, **{fld: base - h})
        if tree == "option":
            up, dn = f(up_obj, heston), f(dn_obj, heston)
        else:
            up, dn = f(option, up_obj), f(option, dn_obj)
        out[g] = jnp.float32(sgn) * (up - dn) / (2.0 * h)
    return out


VASICEK_GREEK_FIELDS = {
    "delta": ("option", "s0", 1.0),
    "vega": ("option", "sigma", 1.0),      # equity diffusion vol
    "theta": ("option", "t", -1.0),
    "dual_delta": ("option", "k", 1.0),
    "rho0": ("option", "r", 1.0),          # dP/d(initial short rate)
    "a_sens": ("dyn", "a", 1.0),           # dP/d(mean-reversion speed)
    "b_sens": ("dyn", "b", 1.0),           # dP/d(long-run rate level)
    "sigma_r_sens": ("dyn", "sigma_r", 1.0),
    "rho_sr_sens": ("dyn", "rho", 1.0),    # dP/d(equity/rate corr)
}


def vasicek_greeks(option=None, dyn=None,
                   sim: SimParams = DEMO_SIM,
                   payoff="vanilla_call",
                   *,
                   which: Sequence[str] = ("delta", "rho0",
                                           "sigma_r_sens"),
                   antithetic: bool = False,
                   tile_rows: int = 128,
                   rel_bump: float = 1e-3,
                   stream: int = STREAM_OUTER) -> Dict[str, Any]:
    """Stochastic-rate sensitivities by CRN central differences.

    ``rho0`` is the true rate greek under stochastic rates: the
    sensitivity to the INITIAL short rate (the constant-rate rho's
    analogue); the curve-shape exposures (a, b, sigma_r, equity/rate
    correlation) are what a rates-hybrid desk hedges.  Every greek is
    checkable against finite differences of `oracle.bsv_call`
    (tests/test_model_greeks.py).
    """
    from mc_tpu.config import DEMO_OPTION
    from mc_tpu.models.vasicek import DEMO_VASICEK, price_vasicek

    option = (DEMO_OPTION if option is None else option).as_f32()
    dyn = (DEMO_VASICEK if dyn is None else dyn).as_f32()
    key = jnp.asarray(rng.derive_key(sim.seed, stream, 0x7A51),
                      jnp.uint32)

    def f(opt, d):
        return price_vasicek(opt, d, sim, payoff,
                             antithetic=antithetic, tile_rows=tile_rows,
                             key=key).price

    return _fd_model_greeks(f, option, dyn, VASICEK_GREEK_FIELDS, which,
                            rel_bump)


# ---------------------------------------------------------------------------
# Multi-asset greeks: ONE reverse-mode pass through the XLA dual gives
# the per-asset delta VECTOR, per-asset vega VECTOR, and the full
# correlation-sensitivity (cega) MATRIX at once — the d-dimensional
# generalization the scalar CRN-FD model greeks can't express without
# 2(d^2+2d) re-simulations.  Order-statistic payoffs (max/min) are a.e.
# differentiable, so the pathwise estimator is unbiased; the XLA dual is
# bitwise-equal to the Pallas engine, so these ARE the production
# engine's sensitivities.  Two-asset gates: CRN-FD of oracle.stulz_* /
# margrabe (tests/test_rainbow_greeks.py).
# ---------------------------------------------------------------------------


def _multiasset_greeks(price_fn, basket, which):
    allowed = ("delta", "vega", "cega")
    bad = set(which) - set(allowed)
    if bad:
        raise ValueError(f"unknown greeks {sorted(bad)}; "
                         f"available: {list(allowed)}")

    def f(s0s, sigmas, corr):
        b = dataclasses.replace(basket, s0s=s0s, sigmas=sigmas,
                                corr=corr)
        return price_fn(b)

    g_s0, g_sig, g_corr = jax.grad(f, argnums=(0, 1, 2))(
        basket.s0s, basket.sigmas, basket.corr)
    out = {}
    if "delta" in which:
        out["delta"] = g_s0
    if "vega" in which:
        out["vega"] = g_sig
    if "cega" in which:
        # corr enters symmetrically (rho_ij and rho_ji are the same
        # market parameter): fold the cotangent of the strictly-upper
        # and strictly-lower triangles together, zero the diagonal
        c = g_corr + jnp.transpose(g_corr)
        out["cega"] = c - jnp.diag(jnp.diag(c))
    return out


def rainbow_greeks(option=None, basket=None,
                   sim: SimParams = DEMO_SIM,
                   payoff: str = "call_on_max",
                   *,
                   which: Sequence[str] = ("delta", "vega", "cega"),
                   antithetic: bool = False,
                   tile_rows: int = 128,
                   stream: int = STREAM_OUTER) -> Dict[str, Any]:
    """Per-asset sensitivities of a rainbow contract.

    Returns {"delta": (d,), "vega": (d,), "cega": (d, d)} — pathwise
    gradients through the exact terminal draw (one backward pass).  The
    cega matrix is symmetric with zero diagonal (rho_ii = 1 is not a
    parameter).
    """
    from mc_tpu.config import DEMO_OPTION
    from mc_tpu.models.basket import DEMO_BASKET
    from mc_tpu.models.rainbow import price_rainbow

    option = (DEMO_OPTION if option is None else option).as_f32()
    basket = (DEMO_BASKET if basket is None else basket).as_f32()
    key = jnp.asarray(rng.derive_key(sim.seed, stream, 0xBE0F),
                      jnp.uint32)

    def price_fn(b):
        return price_rainbow(option, b, sim, payoff,
                             antithetic=antithetic, tile_rows=tile_rows,
                             key=key).price

    return _multiasset_greeks(price_fn, basket, which)


def basket_greeks(option=None, basket=None,
                  sim: SimParams = DEMO_SIM,
                  payoff: str = "vanilla_call",
                  *,
                  which: Sequence[str] = ("delta", "vega", "cega"),
                  antithetic: bool = False,
                  tile_rows: int = 128,
                  stream: int = STREAM_OUTER) -> Dict[str, Any]:
    """Per-asset sensitivities of a payoff on the weighted basket level
    (same contract as `price_basket`), by one reverse-mode pass through
    the step-loop XLA dual.  Gate: with d=1 and weight 1 the delta/vega
    collapse to the single-asset pathwise `greeks()`."""
    from mc_tpu.config import DEMO_OPTION
    from mc_tpu.models.basket import DEMO_BASKET, price_basket

    option = (DEMO_OPTION if option is None else option).as_f32()
    basket = (DEMO_BASKET if basket is None else basket).as_f32()
    po = get_payoff(payoff)
    if po.name not in _PATHWISE_OK:
        raise ValueError(
            f"pathwise multi-asset greeks need an a.e.-differentiable "
            f"payoff ({sorted(_PATHWISE_OK)}); {po.name!r} has "
            "zero-a.e. pathwise derivatives")
    key = jnp.asarray(rng.derive_key(sim.seed, stream, 0xBA5C),
                      jnp.uint32)

    def price_fn(b):
        return price_basket(option, b, sim, payoff,
                            antithetic=antithetic, tile_rows=tile_rows,
                            key=key).price

    return _multiasset_greeks(price_fn, basket, which)


# ---------------------------------------------------------------------------
# XVA sensitivities: differentiate CVA through the ENTIRE nested
# pipeline — outer trajectories, inner conditional re-pricing, exposure
# positive part, and the default-leg integral — in one reverse-mode
# pass over the XLA NMC dual (bitwise-equal to the Pallas engine).
# The desk quantity: how the CVA reserve moves with the market.
# ---------------------------------------------------------------------------

CVA_GREEK_FIELDS = ("delta", "vega", "rho", "dual_delta")


def cva_greeks(option=None,
               sim: Optional[SimParams] = None,
               payoff="vanilla_call",
               *,
               hazard_rate: float,
               recovery: float = 0.4,
               which: Sequence[str] = ("delta", "vega"),
               model: Optional[str] = None,
               dyn=None,
               tile_rows: Optional[int] = None,
               stream_outer: int = STREAM_OUTER) -> Dict[str, Any]:
    """d(CVA)/d(market) by pathwise AD through the nested MC.

    The exposure max(V, 0) and the payoff kinks are a.e. differentiable,
    so the estimator is unbiased for continuous payoffs; keys are
    derived from ``sim.seed`` so a CRN finite-difference over the SAME
    pipeline reproduces these numbers (gated in tests/test_xva.py).

    ``model=`` runs the nested pipeline under any registered NMC family
    ("heston"/"merton"/"cev"/"sabr"/"vasicek"/"localvol"/"term") with
    its ``dyn`` dynamics.  ``which`` then accepts, besides the canonical
    option greeks (delta→s0, rho→r, dual_delta→k), any SCALAR dynamics
    field by name — e.g. ``("delta", "v0", "xi")`` under Heston, or
    ``("delta", "lam")`` under Merton (d(CVA)/d(jump intensity), the
    credit desk's jump-risk number).  A name shadowed by a canonical
    greek is reachable with the ``dyn.`` prefix (``"dyn.rho"`` is the
    Heston correlation; bare ``"rho"`` stays the rate greek).  "vega"
    is GBM-only — under a family the vol is a dynamics field, and the
    error lists the available ones.
    """
    from mc_tpu.config import DEMO_OPTION
    from mc_tpu.nmc import DEMO_SIM as NMC_DEMO_SIM
    from mc_tpu.nmc import price_nmc

    option = (DEMO_OPTION if option is None else option).as_f32()
    sim = NMC_DEMO_SIM if sim is None else sim
    opt_fields = {"delta": "s0", "vega": "sigma", "rho": "r",
                  "dual_delta": "k"}

    fam = dyn32 = None
    if model is not None:
        from mc_tpu.nmc_engine import (NMC_FAMILY_BUILDERS, ensure_family,
                                       price_nmc_family)
        ensure_family(model)
        fam, dyn32 = NMC_FAMILY_BUILDERS[model](option, dyn, sim)
        dyn_fields = [f.name for f in dataclasses.fields(dyn32)
                      if jnp.ndim(getattr(dyn32, f.name)) == 0]

    # resolve each requested greek to ("option"|"dyn", field)
    targets = []
    for g in which:
        if g in opt_fields and not (model is not None and g == "vega"):
            targets.append(("option", opt_fields[g]))
            continue
        if model is None:
            raise ValueError(f"unknown greeks {sorted(set(which) - set(CVA_GREEK_FIELDS))}; "
                             f"available: {list(CVA_GREEK_FIELDS)}")
        name = g[4:] if g.startswith("dyn.") else g
        if name == "vega":
            raise ValueError(
                f"'vega' is the GBM sigma greek; under model={model!r} "
                f"use a dynamics field instead: {dyn_fields}")
        if name not in dyn_fields:
            vec = [f.name for f in dataclasses.fields(dyn32)
                   if f.name not in dyn_fields]
            hint = (f" (vector fields {vec} need the per-asset "
                    "rainbow_greeks/basket_greeks)" if vec else "")
            raise ValueError(
                f"unknown greek {g!r}; option greeks "
                f"{sorted(k for k in opt_fields if k != 'vega')} or "
                f"{model} dynamics fields {dyn_fields}{hint}")
        targets.append(("dyn", name))

    def f(*vals):
        okw, dkw = {}, {}
        for (kind, field), v in zip(targets, vals):
            (okw if kind == "option" else dkw)[field] = v
        opt = dataclasses.replace(option, **okw)
        if model is None:
            # forward-mode AD runs through the XLA engine: a Triton
            # kernel has no JVP rule
            res = price_nmc(opt, sim, payoff, engine="xla",
                            tile_rows=8 if tile_rows is None else tile_rows,
                            stream_outer=stream_outer)
        else:
            d = dataclasses.replace(dyn32, **dkw) if dkw else dyn32
            res = price_nmc_family(fam, opt, d, sim, payoff,
                                   tile_rows=(8 if tile_rows is None
                                              else tile_rows),
                                   stream_outer=stream_outer)
        return res.cva(hazard_rate, recovery,
                       t_horizon=jnp.float32(option.t))

    # FORWARD-mode: the inner re-pricing legs run fori_loops with
    # data-dependent trip counts (remaining = n_steps - j - 1), which
    # reverse-mode cannot transpose; JVPs flow through them fine, and
    # with a handful of scalar parameters forward mode costs one extra
    # pass per greek — cheaper than materializing the nested tape anyway.
    vals = [jnp.float32(getattr(option if kind == "option" else dyn32,
                                field)) for kind, field in targets]
    out = {}
    for i, g in enumerate(which):
        tangents = [jnp.float32(1.0 if j == i else 0.0)
                    for j in range(len(vals))]
        _, dot = jax.jvp(f, vals, tangents)
        out[g] = dot
    return out
