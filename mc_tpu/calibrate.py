"""Smile calibration: fit SABR parameters to an implied-vol curve, jitted.

The production loop this closes: simulate (or observe) option prices →
invert to Black-Scholes implied vols (`oracle.bs_implied_vol`, on-device)
→ fit the smile model (here: Hagan's SABR expansion, differentiable jnp)
→ feed the fitted dynamics back into the MC engines (`models.sabr`).

The fit is damped Gauss-Newton (Levenberg-Marquardt) on the residuals
r_i = hagan_iv(k_i; theta) - iv_i with theta = (alpha, nu, rho)
reparameterized unconstrained (log for the positive parameters, atanh for
the correlation), Jacobians by `jax.jacfwd`, a fixed trip count, and no
data-dependent Python control flow — the whole calibration jits to one
XLA program and vmaps across smiles.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["hagan_iv", "calibrate_sabr", "SABRFit",
           "calibrate_heston", "HestonFit",
           "calibrate_localvol",
           "calibrate_hullwhite", "HullWhiteFit",
           "calibrate_g2", "G2Fit"]


def hagan_iv(f, k, t, alpha, beta, nu, rho):
    """Hagan et al. (2002) lognormal implied vol — differentiable jnp.

    Matches `models.sabr.sabr_implied_vol` (host f64) to f32 precision;
    the ATM singularity of z/x(z) is replaced by its series
    1 - rho z/2 + (2 - 3 rho^2) z^2 / 12 on a branch-free `where`.
    """
    f, k, t, alpha, beta, nu, rho = map(
        lambda v: jnp.asarray(v, jnp.float32), (f, k, t, alpha, beta, nu,
                                                rho))
    omb = 1.0 - beta
    lfk = jnp.log(f / k)
    fkb = (f * k) ** (omb / 2.0)
    corr = 1.0 + (omb ** 2 / 24.0 * alpha ** 2 / (fkb * fkb)
                  + rho * beta * nu * alpha / (4.0 * fkb)
                  + (2.0 - 3.0 * rho * rho) / 24.0 * nu * nu) * t
    denom = fkb * (1.0 + omb ** 2 / 24.0 * lfk ** 2
                   + omb ** 4 / 1920.0 * lfk ** 4)
    z = nu / alpha * fkb * lfk
    # x(z) is computed on a safe argument; the |z|->0 limit switches to
    # the series (also keeps the jacfwd derivative finite at ATM).
    small = jnp.abs(z) < 1e-4
    z_safe = jnp.where(small, 1.0, z)
    xz = jnp.log((jnp.sqrt(1.0 - 2.0 * rho * z_safe + z_safe * z_safe)
                  + z_safe - rho) / (1.0 - rho))
    ratio_series = 1.0 - 0.5 * rho * z + (2.0 - 3.0 * rho * rho) / 12.0 * z * z
    ratio = jnp.where(small, ratio_series, z_safe / xz)
    return alpha / denom * ratio * corr


class SABRFit(NamedTuple):
    alpha: jnp.ndarray
    nu: jnp.ndarray
    rho: jnp.ndarray
    rmse: jnp.ndarray          # root-mean-square IV residual at the fit
    n_iter: int


def _theta_to_params(theta):
    return (jnp.exp(theta[0]), jnp.exp(theta[1]),
            jnp.float32(0.999) * jnp.tanh(theta[2]))


@functools.partial(jax.jit, static_argnames=("beta", "n_iter"))
def calibrate_sabr(f, t, strikes, target_ivs, *, beta: float = 1.0,
                   init=(0.2, 0.4, -0.3), n_iter: int = 40,
                   lm_damping: float = 1e-3) -> SABRFit:
    """Fit (alpha, nu, rho) of a beta-pinned SABR smile to implied vols.

    ``strikes``/``target_ivs``: (M,) arrays (M >= 3).  ``beta`` is pinned
    (market convention: chosen a priori, the remaining three parameters
    are identified by the smile level/slope/curvature).  Returns the
    fitted parameters and the IV-space RMSE.

    Damped Gauss-Newton with Levenberg-Marquardt regularization; the
    unconstrained parameterization (log alpha, log nu, atanh-scaled rho)
    keeps every iterate feasible without clipping, so the fixed-trip loop
    is branch-free and the whole fit is one jitted XLA program (vmap it
    for surface-wide calibration across maturities).
    """
    f = jnp.float32(f)
    t = jnp.float32(t)
    strikes = jnp.asarray(strikes, jnp.float32)
    target = jnp.asarray(target_ivs, jnp.float32)
    a0, n0, r0 = (jnp.float32(v) for v in init)
    theta0 = jnp.stack([jnp.log(a0), jnp.log(n0),
                        jnp.arctanh(r0 / jnp.float32(0.999))])

    def residuals(theta):
        alpha, nu, rho = _theta_to_params(theta)
        return hagan_iv(f, strikes, t, alpha, beta, nu, rho) - target

    lam = jnp.float32(lm_damping)
    eye = jnp.eye(3, dtype=jnp.float32)

    def body(_, carry):
        theta, lam = carry
        r = residuals(theta)
        jac = jax.jacfwd(residuals)(theta)          # (M, 3)
        # full float32 products: a GPU would otherwise run them in TF32
        hi = jax.lax.Precision.HIGHEST
        g = jnp.matmul(jac.T, r, precision=hi)
        h = jnp.matmul(jac.T, jac, precision=hi)
        step = jnp.linalg.solve(h + lam * eye, g)
        theta_new = theta - step
        better = jnp.sum(residuals(theta_new) ** 2) < jnp.sum(r * r)
        # classic LM damping schedule, branch-free
        lam = jnp.where(better, lam * 0.5, lam * 4.0)
        lam = jnp.clip(lam, 1e-8, 1e4)
        theta = jnp.where(better, theta_new, theta)
        return (theta, lam)

    theta, _ = jax.lax.fori_loop(0, n_iter, body, (theta0, lam))
    alpha, nu, rho = _theta_to_params(theta)
    rmse = jnp.sqrt(jnp.mean(residuals(theta) ** 2))
    return SABRFit(alpha=alpha, nu=nu, rho=rho, rmse=rmse, n_iter=n_iter)


# ---------------------------------------------------------------------------
# Heston calibration: fit (v0, kappa, theta, xi, rho) to an implied-vol
# surface through the semi-analytic CF oracle.  Host-side float64 (market-
# data prep, runs once per surface); the fitted dynamics feed the MC/NMC/
# LSMC engines, which is where the device cycles go.
# ---------------------------------------------------------------------------


class HestonFit(NamedTuple):
    v0: float
    kappa: float
    theta: float
    xi: float
    rho: float
    rmse: float               # IV-space RMSE at the fit
    n_iter: int


def _bs_iv_host(price, s0, k, t, r, q=0.0, n_iter=40):
    """Host f64 Black-Scholes implied vol (safeguarded Newton,
    erf-based — hot inside the calibration loop, so no scipy)."""
    import math

    price, s0, k, t, r, q = map(float, (price, s0, k, t, r, q))
    disc_s = s0 * math.exp(-q * t)
    disc_k = k * math.exp(-r * t)
    if not max(disc_s - disc_k, 0.0) <= price < disc_s:
        return float("nan")
    sqrt_t = math.sqrt(t)
    lnsk = math.log(s0 / k)
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    inv_sqrt2pi = 1.0 / math.sqrt(2.0 * math.pi)

    def cnd(x):
        return 0.5 * (1.0 + math.erf(x * inv_sqrt2))

    lo, hi = 1e-6, 5.0
    sig = 0.25
    for _ in range(n_iter):
        sq = sig * sqrt_t
        d1 = (lnsk + (r - q + 0.5 * sig * sig) * t) / sq
        diff = disc_s * cnd(d1) - disc_k * cnd(d1 - sq) - price
        if diff > 0:
            hi = sig
        else:
            lo = sig
        vega = disc_s * inv_sqrt2pi * math.exp(-0.5 * d1 * d1) * sqrt_t
        cand = sig - diff / max(vega, 1e-12)
        sig = cand if lo < cand < hi else 0.5 * (lo + hi)
    return sig


def _heston_theta_to_params(th):
    import numpy as np
    return (np.exp(th[0]), np.exp(th[1]), np.exp(th[2]), np.exp(th[3]),
            0.999 * np.tanh(th[4]))


def calibrate_heston(strikes, mats, target_ivs, *, s0=100.0, r=0.1,
                     q=0.0, init=(0.04, 2.0, 0.04, 0.3, -0.5),
                     n_iter: int = 30, n_quad: int = 512) -> HestonFit:
    """Fit Heston (v0, kappa, theta, xi, rho) to an implied-vol surface.

    ``strikes``: (M,), ``mats``: (J,) maturities, ``target_ivs``: (J, M)
    Black-Scholes implied vols.  Multiple maturities identify the
    mean-reversion split (kappa/theta vs v0) that a single smile cannot.
    Levenberg-Marquardt on IV-space residuals with an unconstrained
    reparameterization (log for the positive parameters, scaled tanh for
    rho) so every iterate is feasible; Jacobians by central differences
    on the CF oracle (host f64 — this runs once per surface).

    Round-trip gate (tests): IVs generated from known dynamics are
    recovered to <1e-3 IV RMSE and the refit prices an exotic within
    tolerance of the true-dynamics price.
    """
    import numpy as np

    from mc_tpu.models.heston import heston_call_cf

    strikes = np.asarray(strikes, np.float64)
    mats = np.atleast_1d(np.asarray(mats, np.float64))
    target = np.asarray(target_ivs, np.float64).reshape(len(mats),
                                                        len(strikes))

    def model_ivs(th):
        v0, kappa, theta, xi, rho = _heston_theta_to_params(th)
        out = np.empty_like(target)
        for j, t in enumerate(mats):
            for i, k in enumerate(strikes):
                px = heston_call_cf(s0, k, t, r, v0, kappa, theta, xi,
                                    rho, q=q, n_quad=n_quad)
                iv = _bs_iv_host(px, s0, k, t, r, q)
                if np.isnan(iv):
                    # out of the no-arb band: saturate at the vol-space
                    # boundary the violation points at, so LM keeps a
                    # monotone gradient back toward validity instead of
                    # a flat (or rewarded) NaN region
                    iv = 5.0 if px >= s0 * np.exp(-q * t) else 1e-6
                out[j, i] = iv
        return out

    def residuals(th):
        res = (model_ivs(th) - target).ravel()
        # NaN model IVs mean the trial parameters priced outside the
        # no-arbitrage band: PENALIZE (1.0 = a 100-vol-pt error) instead
        # of ignoring, so LM steps into invalid regions are rejected
        # rather than rewarded for removing points from the objective.
        return np.nan_to_num(res, nan=1.0)

    th = np.array([np.log(init[0]), np.log(init[1]), np.log(init[2]),
                   np.log(init[3]), np.arctanh(init[4] / 0.999)])
    lam = 1e-3
    r_cur = residuals(th)
    for _ in range(n_iter):
        jac = np.empty((r_cur.size, 5))
        for m in range(5):
            h = 1e-4
            tp, tm = th.copy(), th.copy()
            tp[m] += h
            tm[m] -= h
            jac[:, m] = (residuals(tp) - residuals(tm)) / (2 * h)
        g = jac.T @ r_cur
        hmat = jac.T @ jac
        try:
            step = np.linalg.solve(hmat + lam * np.eye(5), g)
        except np.linalg.LinAlgError:
            lam *= 4.0
            continue
        th_new = th - step
        r_new = residuals(th_new)
        if np.sum(r_new ** 2) < np.sum(r_cur ** 2):
            th, r_cur, lam = th_new, r_new, max(lam * 0.5, 1e-8)
        else:
            lam = min(lam * 4.0, 1e4)
    v0, kappa, theta, xi, rho = _heston_theta_to_params(th)
    rmse = float(np.sqrt(np.mean(r_cur ** 2)))
    return HestonFit(v0=float(v0), kappa=float(kappa), theta=float(theta),
                     xi=float(xi), rho=float(rho), rmse=rmse,
                     n_iter=n_iter)


# ---------------------------------------------------------------------------
# Local-volatility calibration: Dupire's formula in total-variance form
# (Gatheral) on a smooth fit of the implied-vol surface -> the sigma(x, t)
# knot grid that models/localvol prices from.  Closes the market-data ->
# surface -> exotic/XVA loop for the non-parametric family.
# ---------------------------------------------------------------------------


def calibrate_localvol(strikes, mats, target_ivs, *, s0=100.0, r=0.1,
                       q=0.0, n_steps: int = 100, n_knots: int = 9,
                       x_lo: float = -1.0, x_hi: float = 1.0,
                       smile_degree: int = 2, min_vol: float = 0.01,
                       max_vol: float = 2.0):
    """Extract a local-vol surface from implied vols via Dupire.

    ``strikes`` (M,), ``mats`` (J,) ascending maturities, ``target_ivs``
    (J, M).  Per maturity the total variance w = iv^2 T is fitted as a
    degree-``smile_degree`` polynomial in forward log-moneyness
    y = log(K/F_T) (host f64 least squares); between maturities w is
    linear in T (flat-extrapolated outside).  The local variance at
    (y, t) is Gatheral's total-variance Dupire ratio

        sigma_loc^2 = dw/dT / (1 - y/w dw/dy
                      + 1/4 (-1/4 - 1/w + y^2/w^2) (dw/dy)^2
                      + 1/2 d2w/dy2),

    evaluated at every (x knot, step-end time) of the returned
    `LocalVolSurface` (x = log(S/S0) absolute log-moneyness, the
    surface's native coordinate; y = x - (r-q) t).  Results are clipped
    to [min_vol, max_vol] — Dupire ratios go degenerate where the input
    surface is extrapolated far off-grid.

    Round-trip gate (tests): a flat IV surface returns the flat local
    vol exactly; re-pricing vanillas under the fitted surface recovers
    the input smile within MC + fit tolerance.
    """
    import numpy as np

    from mc_tpu.models.localvol import LocalVolSurface

    strikes = np.asarray(strikes, np.float64)
    mats = np.atleast_1d(np.asarray(mats, np.float64))
    ivs = np.asarray(target_ivs, np.float64).reshape(len(mats),
                                                     len(strikes))
    if np.any(np.diff(mats) <= 0):
        raise ValueError("mats must be strictly ascending")
    t_max = mats[-1]

    # per-maturity polynomial fit of w(y) = iv^2 T
    coefs = []
    for j, t in enumerate(mats):
        f_t = s0 * np.exp((r - q) * t)
        y = np.log(strikes / f_t)
        w = ivs[j] ** 2 * t
        deg = min(smile_degree, len(strikes) - 1)
        coefs.append(np.polyfit(y, w, deg))

    def w_slice(j, y):
        c = coefs[j]
        return (np.polyval(c, y), np.polyval(np.polyder(c), y),
                np.polyval(np.polyder(c, 2), y))

    def w_at(t, y):
        """(w, dw/dy, d2w/dy2, dw/dT) linear-in-T between slices."""
        if t <= mats[0]:
            w0, wy, wyy = w_slice(0, y)
            # short end: scale total variance linearly from 0 at t=0
            frac = t / mats[0]
            return (w0 * frac, wy * frac, wyy * frac, w0 / mats[0])
        j = int(np.searchsorted(mats, t, side="left"))
        j = min(max(j, 1), len(mats) - 1)
        t0, t1 = mats[j - 1], mats[j]
        a = (t - t0) / (t1 - t0)
        wa, wya, wyya = w_slice(j - 1, y)
        wb, wyb, wyyb = w_slice(j, y)
        return ((1 - a) * wa + a * wb, (1 - a) * wya + a * wyb,
                (1 - a) * wyya + a * wyyb, (wb - wa) / (t1 - t0))

    xs = np.linspace(x_lo, x_hi, n_knots)
    vols = np.empty((n_steps, n_knots))
    for step in range(n_steps):
        t = (step + 1) / n_steps * t_max
        for i, x in enumerate(xs):
            y = x - (r - q) * t   # x = log(S/S0) -> y = log(S/F_t)
            w, wy, wyy, wt = w_at(t, y)
            w = max(w, 1e-8)
            denom = (1.0 - y / w * wy
                     + 0.25 * (-0.25 - 1.0 / w + y * y / (w * w)) * wy * wy
                     + 0.5 * wyy)
            var = wt / max(denom, 1e-8)
            vols[step, i] = np.sqrt(min(max(var, min_vol ** 2),
                                        max_vol ** 2))
    return LocalVolSurface(x_knots=xs.astype(np.float32),
                           vols=vols.astype(np.float32))


# ---------------------------------------------------------------------------
# Hull-White calibration: fit (a, sigma_r) to European swaption quotes
# priced off the SAME input discount curve (oracle.hw_swaption, the
# curve-consistent Jamshidian closed form).  Closes the market-data loop
# for the rates family: curve knots -> DiscountCurve, swaption quotes ->
# (a, sigma_r) -> Bermudans / exposure / XVA off the fitted model.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HullWhiteFit:
    a: float
    sigma_r: float
    rmse: float       # price-space RMSE over the quote set
    n_iter: int


def calibrate_hullwhite(curve, quotes, *, init=(0.1, 0.005),
                        n_iter: int = 60) -> HullWhiteFit:
    """Fit Hull-White (a, sigma_r) to European swaption prices.

    ``curve``: a `models.hullwhite.DiscountCurve` (the model reprices it
    exactly by construction, so only the two vol parameters remain);
    ``quotes``: sequence of (expiry, tenor, n_payments, k_rate, price).
    A TERM STRUCTURE of expiries identifies the (a, sigma_r) split —
    mean reversion flattens long-expiry vols, sigma scales all of them;
    a single expiry leaves a ridge (fit still converges on it, but the
    round-trip gate in tests uses 3 expiries).  Levenberg-Marquardt on
    log-parameters (host float64, runs once per quote set).
    """
    import numpy as np

    from mc_tpu.oracle import hw_swaption

    qs = [(float(t0), float(tau), int(n), float(k), float(px))
          for (t0, tau, n, k, px) in quotes]
    if not qs:
        raise ValueError("need at least one swaption quote")

    def residuals(th):
        a, sig = np.exp(th)
        out = np.empty(len(qs))
        for i, (t0, tau, n, k, px) in enumerate(qs):
            out[i] = hw_swaption(a, sig, curve.df, t0, tau, n, k) - px
        return out

    th = np.array([np.log(init[0]), np.log(init[1])])
    lam = 1e-3
    r_cur = residuals(th)
    for _ in range(n_iter):
        jac = np.empty((r_cur.size, 2))
        for m in range(2):
            h = 1e-5
            tp, tm = th.copy(), th.copy()
            tp[m] += h
            tm[m] -= h
            jac[:, m] = (residuals(tp) - residuals(tm)) / (2 * h)
        g = jac.T @ r_cur
        hmat = jac.T @ jac
        try:
            step = np.linalg.solve(hmat + lam * np.eye(2), g)
        except np.linalg.LinAlgError:
            lam *= 4.0
            continue
        th_new = th - step
        r_new = residuals(th_new)
        if np.sum(r_new ** 2) < np.sum(r_cur ** 2):
            th, r_cur, lam = th_new, r_new, max(lam * 0.5, 1e-8)
        else:
            lam = min(lam * 4.0, 1e4)
        if np.sum(r_cur ** 2) < 1e-22:  # converged to the quote set
            break
    a, sig = np.exp(th)
    return HullWhiteFit(a=float(a), sigma_r=float(sig),
                        rmse=float(np.sqrt(np.mean(r_cur ** 2))),
                        n_iter=n_iter)


@dataclasses.dataclass(frozen=True)
class G2Fit:
    a: float
    sigma: float
    b_mr: float
    eta: float
    rho: float
    rmse: float
    n_iter: int


def calibrate_g2(curve, quotes, *,
                 init=(0.3, 0.008, 0.1, 0.005, -0.3),
                 n_iter: int = 80) -> G2Fit:
    """Fit G2++ (a, sigma, b_mr, eta, rho) to European swaption prices.

    Same LM construction as `calibrate_hullwhite` on the
    `oracle.g2_swaption` semi-closed form; positives go through log,
    rho through a scaled arctanh.  Five parameters need a RICH quote
    set — expiries x tenors (the co-terminal triangle desks quote)
    separate the two mean reversions; the round-trip gate uses a 3x3
    grid of (expiry, tenor) pairs at two strikes.
    """
    import numpy as np

    from mc_tpu.oracle import g2_swaption

    qs = [(float(t0), float(tau), int(n), float(k), float(px))
          for (t0, tau, n, k, px) in quotes]
    if len(qs) < 5:
        raise ValueError("need at least 5 swaption quotes for a "
                         "5-parameter fit")

    def unpack(th):
        a, s, b, e = np.exp(th[:4])
        rho = 0.999 * np.tanh(th[4])
        return a, s, b, e, rho

    def residuals(th):
        a, s, b, e, rho = unpack(th)
        out = np.empty(len(qs))
        for i, (t0, tau, n, k, px) in enumerate(qs):
            out[i] = g2_swaption(a, s, b, e, rho, curve.df, t0, tau, n,
                                 k, n_quad=801) - px
        return out

    th = np.array([np.log(init[0]), np.log(init[1]), np.log(init[2]),
                   np.log(init[3]), np.arctanh(init[4] / 0.999)])
    lam = 1e-3
    r_cur = residuals(th)
    for _ in range(n_iter):
        jac = np.empty((r_cur.size, 5))
        for m in range(5):
            h = 1e-5
            tp, tm = th.copy(), th.copy()
            tp[m] += h
            tm[m] -= h
            jac[:, m] = (residuals(tp) - residuals(tm)) / (2 * h)
        g = jac.T @ r_cur
        hmat = jac.T @ jac
        try:
            step = np.linalg.solve(hmat + lam * np.eye(5), g)
        except np.linalg.LinAlgError:
            lam *= 4.0
            continue
        th_new = th - step
        r_new = residuals(th_new)
        if np.sum(r_new ** 2) < np.sum(r_cur ** 2):
            th, r_cur, lam = th_new, r_new, max(lam * 0.5, 1e-8)
        else:
            lam = min(lam * 4.0, 1e4)
        if np.mean(r_cur ** 2) < 1e-16:  # rmse < 1e-8: repriced
            break
    a, s, b, e, rho = unpack(th)
    return G2Fit(a=float(a), sigma=float(s), b_mr=float(b),
                 eta=float(e), rho=float(rho),
                 rmse=float(np.sqrt(np.mean(r_cur ** 2))),
                 n_iter=n_iter)
