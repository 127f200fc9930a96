"""Black-Scholes analytic oracle + Monte Carlo error statistics.

JAX equivalent of ``inc/BlackandScholes.hpp``.  The reference uses the
Abramowitz-Stegun 5-coefficient polynomial CND approximation
(``BlackandScholes.hpp:8-30``) as its ground truth; here the primary oracle
uses the exact normal CDF (`jax.scipy.stats.norm.cdf`), and the A&S
polynomial is kept as a secondary implementation for parity checks against
the reference's printed values.

Also provides the MC standard-error statistics the reference never computed
(SURVEY.md section 5): the framework's acceptance criterion is
``|price - BS| <= 3 * stderr``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import jax
import jax.numpy as jnp
from jax.scipy.stats import norm

__all__ = [
    "bs_call",
    "bs_digital_call",
    "bs_digital_put",
    "bs_put",
    "bs_delta_call",
    "bs_up_out_call",
    "bs_down_out_call",
    "bs_vega",
    "bs_gamma",
    "bs_implied_vol",
    "cnd_as",
    "bs_call_as",
    "bvn_cdf",
    "margrabe",
    "gk_call",
    "gk_put",
    "quanto_call",
    "quanto_put",
    "compo_call",
    "compo_put",
    "flexo_call",
    "flexo_put",
    "stulz_min_call",
    "stulz_max_call",
    "stulz_min_put",
    "stulz_max_put",
    "vasicek_zcb",
    "vasicek_zbp",
    "vasicek_swaption",
    "bsv_call",
    "bs_forward_start_call",
    "bs_cliquet",
    "PriceResult",
]


def bs_call(s0, k, t, r, sigma, q=0.0):
    """European call, exact closed form with continuous dividend yield
    (cf. BlackandScholes.hpp:34-43, which has q=0)."""
    s0, k, t, r, sigma, q = map(jnp.asarray, (s0, k, t, r, sigma, q))
    sqrt_t = jnp.sqrt(t)
    d1 = (jnp.log(s0 / k) + (r - q + 0.5 * sigma * sigma) * t) / (sigma * sqrt_t)
    d2 = d1 - sigma * sqrt_t
    return (s0 * jnp.exp(-q * t) * norm.cdf(d1)
            - k * jnp.exp(-r * t) * norm.cdf(d2))


def bs_put(s0, k, t, r, sigma, q=0.0):
    """European put via put-call parity."""
    call = bs_call(s0, k, t, r, sigma, q)
    return (call - s0 * jnp.exp(-jnp.asarray(q) * t)
            + k * jnp.exp(-jnp.asarray(r) * t))


def bs_digital_call(s0, k, t, r, sigma, q=0.0):
    """Cash-or-nothing digital call: e^{-rT} N(d2)."""
    s0, k, t, r, sigma, q = map(jnp.float32, (s0, k, t, r, sigma, q))
    st = sigma * jnp.sqrt(t)
    d2 = (jnp.log(s0 / k) + (r - q - 0.5 * sigma * sigma) * t) / st
    return jnp.exp(-r * t) * norm.cdf(d2)


def bs_digital_put(s0, k, t, r, sigma, q=0.0):
    """Cash-or-nothing digital put: e^{-rT} N(-d2) (digital parity:
    call + put = e^{-rT})."""
    s0, k, t, r, sigma, q = map(jnp.float32, (s0, k, t, r, sigma, q))
    st = sigma * jnp.sqrt(t)
    d2 = (jnp.log(s0 / k) + (r - q - 0.5 * sigma * sigma) * t) / st
    return jnp.exp(-r * t) * norm.cdf(-d2)


def bs_delta_call(s0, k, t, r, sigma, q=0.0):
    """BS call delta e^{-qT} N(d1) — the control-variate coefficient."""
    s0, k, t, r, sigma, q = map(jnp.asarray, (s0, k, t, r, sigma, q))
    sqrt_t = jnp.sqrt(t)
    d1 = (jnp.log(s0 / k) + (r - q + 0.5 * sigma * sigma) * t) / (sigma * sqrt_t)
    return jnp.exp(-q * t) * norm.cdf(d1)


def cnd_as(x):
    """Abramowitz-Stegun polynomial CND, max abs error ~7.5e-8.

    Same 5-term approximation as the reference (BlackandScholes.hpp:8-30),
    re-expressed branch-free with `jnp.where` (the reference's sign branch
    becomes a mask, the idiomatic vector form).
    """
    x = jnp.asarray(x, jnp.float32)
    p = jnp.float32(0.2316419)
    b = (0.31938153, -0.356563782, 1.781477937, -1.821255978, 1.330274429)
    one_over_sqrt2pi = jnp.float32(0.39894228)
    ax = jnp.abs(x)
    tt = 1.0 / (1.0 + p * ax)
    poly = tt * (b[0] + tt * (b[1] + tt * (b[2] + tt * (b[3] + tt * b[4]))))
    upper_tail = one_over_sqrt2pi * jnp.exp(-0.5 * ax * ax) * poly
    return jnp.where(x >= 0, 1.0 - upper_tail, upper_tail)


def bs_call_as(s0, k, t, r, sigma):
    """BS call using the A&S CND — bitwise-comparable to the reference oracle."""
    s0, k, t, r, sigma = (jnp.asarray(v, jnp.float32) for v in (s0, k, t, r, sigma))
    sqrt_t = jnp.sqrt(t)
    d1 = (jnp.log(s0 / k) + (r + 0.5 * sigma * sigma) * t) / (sigma * sqrt_t)
    d2 = d1 - sigma * sqrt_t
    return s0 * cnd_as(d1) - k * jnp.exp(-r * t) * cnd_as(d2)


# ---------------------------------------------------------------------------
# Continuously monitored barrier closed forms (reflection principle) — the
# oracles for the Brownian-bridge-corrected barrier payoffs.  Host-side f64.
# ---------------------------------------------------------------------------


def _call_segment_f64(x, k, t, r, sigma, q, lo, hi):
    """e^{-rT} E_x[(S_T - k) 1{lo < S_T < hi}] under GBM, host f64.

    Direct truncated-lognormal expectation — numerically stable where the
    'call-spread + digital' decomposition catastrophically cancels (the
    reflection argument can sit orders of magnitude past the barrier).
    ``hi=None`` means +infinity.
    """
    st = sigma * math.sqrt(t)
    nd = lambda v: 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))

    def d1(y):
        return (math.log(x / y) + (r - q + 0.5 * sigma * sigma) * t) / st

    n1_lo, n2_lo = nd(d1(lo)), nd(d1(lo) - st)
    n1_hi = nd(d1(hi)) if hi is not None else 0.0
    n2_hi = nd(d1(hi) - st) if hi is not None else 0.0
    return (x * math.exp(-q * t) * (n1_lo - n1_hi)
            - k * math.exp(-r * t) * (n2_lo - n2_hi))


def bs_up_out_call(s0, k, t, r, sigma, b, q=0.0) -> float:
    """Up-and-out call with a CONTINUOUSLY monitored barrier b (> s0, > k).

    Reflection principle for drifted Brownian motion: with
    mu = r - q - sigma^2/2,

        P_{s0}(S_T in dz, max S > b) = (b/s0)^{2mu/sigma^2}
                                       P_{b^2/s0}(S_T in dz)    (z < b)

    so  C_uo = seg(s0) - (b/s0)^{2mu/sigma^2} seg(b^2/s0)  with
    seg(x) = e^{-rT} E_x[(S_T-K) 1{K < S_T < b}]  (equivalent to the
    Rubinstein-Reiner form).  Host-side f64; the oracle for the
    `up_out_call_bb` payoff.
    """
    s0, k, t, r, sigma, b, q = map(float, (s0, k, t, r, sigma, b, q))
    if s0 >= b or k >= b:
        return 0.0
    mu = r - q - 0.5 * sigma * sigma
    refl = (b / s0) ** (2.0 * mu / (sigma * sigma))
    return (_call_segment_f64(s0, k, t, r, sigma, q, k, b)
            - refl * _call_segment_f64(b * b / s0, k, t, r, sigma, q, k, b))


def bs_down_out_call(s0, k, t, r, sigma, b, q=0.0) -> float:
    """Down-and-out call, CONTINUOUSLY monitored barrier b (< s0).

    Same reflection identity with the crossing measured downward; the
    surviving payoff region is S_T > max(k, b):
        C_do = seg(s0) - (b/s0)^{2mu/sigma^2} seg(b^2/s0),
        seg(x) = e^{-rT} E_x[(S_T-K) 1{S_T > max(k, b)}].
    Host-side f64; the oracle for `down_out_call_bb`.
    """
    s0, k, t, r, sigma, b, q = map(float, (s0, k, t, r, sigma, b, q))
    if s0 <= b:
        return 0.0
    mu = r - q - 0.5 * sigma * sigma
    refl = (b / s0) ** (2.0 * mu / (sigma * sigma))
    lo = max(k, b)
    return (_call_segment_f64(s0, k, t, r, sigma, q, lo, None)
            - refl * _call_segment_f64(b * b / s0, k, t, r, sigma, q,
                                       lo, None))


# ---------------------------------------------------------------------------
# Two-asset rainbow closed forms (Margrabe 1978, Stulz 1982) — the oracles
# for the `models.rainbow` payoffs.  Host-side f64, built on the bivariate
# normal CDF (Genz's BVND quadrature, accurate to ~1e-15).
# ---------------------------------------------------------------------------

# Gauss-Legendre half-rule (weights, nodes on [0,1] mapped from [-1,1]).
_GL_RULES = {
    6: ((0.1713244923791704, 0.3607615730481386, 0.4679139345726910),
        (0.9324695142031521, 0.6612093864662645, 0.2386191860831969)),
    12: ((0.04717533638651183, 0.1069393259953184, 0.1600783285433462,
          0.2031674267230659, 0.2334925365383548, 0.2491470458134028),
         (0.9815606342467192, 0.9041172563704749, 0.7699026741943047,
          0.5873179542866175, 0.3678314989981802, 0.1252334085114689)),
    20: ((0.01761400713915212, 0.04060142980038694, 0.06267204833410906,
          0.08327674157670475, 0.1019301198172404, 0.1181945319615184,
          0.1316886384491766, 0.1420961093183821, 0.1491729864726037,
          0.1527533871307259),
         (0.9931285991850949, 0.9639719272779138, 0.9122344282513259,
          0.8391169718222188, 0.7463319064601508, 0.6360536807265150,
          0.5108670019508271, 0.3737060887154196, 0.2277858511416451,
          0.07652652113349733)),
}


def _phid(z: float) -> float:
    return 0.5 * math.erfc(-z / math.sqrt(2.0))


def _bvnu(dh: float, dk: float, r: float) -> float:
    """Upper-tail P(X > dh, Y > dk), standard bivariate normal, corr r.

    Genz (2004) BVND: for |r| < 0.925 a Gauss-Legendre quadrature of
    Drezner-Wesolowsky's single integral over arcsin(r); near |r|=1 the
    Owen-like expansion in sqrt(1-r^2) with a quadrature remainder.
    """
    twopi = 2.0 * math.pi
    if abs(r) < 0.3:
        w, xgl = _GL_RULES[6]
    elif abs(r) < 0.75:
        w, xgl = _GL_RULES[12]
    else:
        w, xgl = _GL_RULES[20]
    h, k = dh, dk
    hk = h * k
    bvn = 0.0
    if abs(r) < 0.925:
        hs = (h * h + k * k) / 2.0
        asr = math.asin(r)
        for wi, xi in zip(w, xgl):
            for sn in (math.sin(asr * (1.0 - xi) / 2.0),
                       math.sin(asr * (1.0 + xi) / 2.0)):
                bvn += wi * math.exp((sn * hk - hs) / (1.0 - sn * sn))
        return bvn * asr / (2.0 * twopi) + _phid(-h) * _phid(-k)
    if r < 0.0:
        k = -k
        hk = -hk
    if abs(r) < 1.0:
        a_s = (1.0 - r) * (1.0 + r)
        a = math.sqrt(a_s)
        bs = (h - k) ** 2
        c = (4.0 - hk) / 8.0
        d = (12.0 - hk) / 16.0
        asr = -(bs / a_s + hk) / 2.0
        if asr > -100.0:
            bvn = (a * math.exp(asr)
                   * (1.0 - c * (bs - a_s) * (1.0 - d * bs / 5.0) / 3.0
                      + c * d * a_s * a_s / 5.0))
        if -hk < 100.0:
            b = math.sqrt(bs)
            sp = math.sqrt(twopi) * _phid(-b / a)
            bvn -= (math.exp(-hk / 2.0) * sp * b
                    * (1.0 - c * bs * (1.0 - d * bs / 5.0) / 3.0))
        a = a / 2.0
        for wi, xi in zip(w, xgl):
            for xs in ((a * (1.0 - xi)) ** 2, (a * (1.0 + xi)) ** 2):
                rs = math.sqrt(1.0 - xs)
                asr = -(bs / xs + hk) / 2.0
                if asr > -100.0:
                    sp = 1.0 + c * xs * (1.0 + d * xs)
                    ep = math.exp(-hk * (1.0 - rs)
                                  / (2.0 * (1.0 + rs))) / rs
                    bvn += a * wi * math.exp(asr) * (ep - sp)
        bvn = -bvn / twopi
    if r > 0.0:
        return bvn + _phid(-max(h, k))
    bvn = -bvn
    if k > h:
        bvn += _phid(k) - _phid(h)
    return bvn


def bvn_cdf(x, y, rho) -> float:
    """P(X <= x, Y <= y) for a standard bivariate normal with corr rho."""
    return _bvnu(-float(x), -float(y), float(rho))


def margrabe(s1, s2, t, sigma1, sigma2, rho, q1=0.0, q2=0.0) -> float:
    """Margrabe (1978) exchange option: e^{-rT} E[max(S1_T - S2_T, 0)].

    Rate-free: the option to exchange asset 2 for asset 1 prices with
    sigma^2 = sigma1^2 + sigma2^2 - 2 rho sigma1 sigma2 and no r.
    """
    s1, s2, t, sigma1, sigma2, rho, q1, q2 = map(
        float, (s1, s2, t, sigma1, sigma2, rho, q1, q2))
    sig = math.sqrt(sigma1 * sigma1 + sigma2 * sigma2
                    - 2.0 * rho * sigma1 * sigma2)
    st = sig * math.sqrt(t)
    d1 = (math.log(s1 / s2) + (q2 - q1 + 0.5 * sig * sig) * t) / st
    d2 = d1 - st
    return (s1 * math.exp(-q1 * t) * _phid(d1)
            - s2 * math.exp(-q2 * t) * _phid(d2))


def stulz_min_call(s1, s2, k, t, r, sigma1, sigma2, rho,
                   q1=0.0, q2=0.0) -> float:
    """Stulz (1982) call on the MINIMUM of two assets:
    e^{-rT} E[max(min(S1_T, S2_T) - K, 0)], K > 0."""
    s1, s2, k, t, r, sigma1, sigma2, rho, q1, q2 = map(
        float, (s1, s2, k, t, r, sigma1, sigma2, rho, q1, q2))
    sig = math.sqrt(sigma1 * sigma1 + sigma2 * sigma2
                    - 2.0 * rho * sigma1 * sigma2)
    st = sig * math.sqrt(t)
    rt = math.sqrt(t)
    d = (math.log(s1 / s2) + (q2 - q1 + 0.5 * sig * sig) * t) / st
    y1 = (math.log(s1 / k) + (r - q1 + 0.5 * sigma1 * sigma1) * t) \
        / (sigma1 * rt)
    y2 = (math.log(s2 / k) + (r - q2 + 0.5 * sigma2 * sigma2) * t) \
        / (sigma2 * rt)
    rho1 = (sigma1 - rho * sigma2) / sig
    rho2 = (sigma2 - rho * sigma1) / sig
    return (s1 * math.exp(-q1 * t) * bvn_cdf(y1, -d, -rho1)
            + s2 * math.exp(-q2 * t) * bvn_cdf(y2, d - st, -rho2)
            - k * math.exp(-r * t) * bvn_cdf(y1 - sigma1 * rt,
                                             y2 - sigma2 * rt, rho))


def stulz_max_call(s1, s2, k, t, r, sigma1, sigma2, rho,
                   q1=0.0, q2=0.0) -> float:
    """Call on the MAXIMUM of two assets, via the multiset identity
    max(M-K,0) + max(m-K,0) = max(S1-K,0) + max(S2-K,0)."""
    c1 = float(bs_call(s1, k, t, r, sigma1, q1))
    c2 = float(bs_call(s2, k, t, r, sigma2, q2))
    return c1 + c2 - stulz_min_call(s1, s2, k, t, r, sigma1, sigma2, rho,
                                    q1, q2)


def _min_forward(s1, s2, t, sigma1, sigma2, rho, q1, q2) -> float:
    """e^{-rT} E[min(S1_T, S2_T)] = S1 e^{-q1 T} - Margrabe(S1 -> S2)."""
    return (float(s1) * math.exp(-float(q1) * float(t))
            - margrabe(s1, s2, t, sigma1, sigma2, rho, q1, q2))


def stulz_min_put(s1, s2, k, t, r, sigma1, sigma2, rho,
                  q1=0.0, q2=0.0) -> float:
    """Put on the minimum via parity:
    p_min(K) = K e^{-rT} - c_min(0) + c_min(K)."""
    return (float(k) * math.exp(-float(r) * float(t))
            - _min_forward(s1, s2, t, sigma1, sigma2, rho, q1, q2)
            + stulz_min_call(s1, s2, k, t, r, sigma1, sigma2, rho, q1, q2))


def stulz_max_put(s1, s2, k, t, r, sigma1, sigma2, rho,
                  q1=0.0, q2=0.0) -> float:
    """Put on the maximum via parity with
    c_max(0) = S1 e^{-q1 T} + S2 e^{-q2 T} - c_min(0)."""
    fwd_max = (float(s1) * math.exp(-float(q1) * float(t))
               + float(s2) * math.exp(-float(q2) * float(t))
               - _min_forward(s1, s2, t, sigma1, sigma2, rho, q1, q2))
    return (float(k) * math.exp(-float(r) * float(t)) - fwd_max
            + stulz_max_call(s1, s2, k, t, r, sigma1, sigma2, rho, q1, q2))


# ---------------------------------------------------------------------------
# Cross-currency closed forms (GBM) — oracles for the `models/fx`
# contract registry.  Host-side f64.  ``x0`` is the FX spot in DOMESTIC
# units per foreign unit, ``r`` the domestic rate, ``r_f`` the foreign
# rate, ``q`` the asset's dividend yield, ``rho`` the asset/FX
# log-return correlation.
# ---------------------------------------------------------------------------


def _bs64(call: bool, s0, k, t, r, sigma, q) -> float:
    """Black-Scholes in pure host f64 (math + _phid)."""
    s0, k, t, r, sigma, q = map(float, (s0, k, t, r, sigma, q))
    st = sigma * math.sqrt(t)
    d1 = (math.log(s0 / k) + (r - q + 0.5 * sigma * sigma) * t) / st
    d2 = d1 - st
    c = (s0 * math.exp(-q * t) * _phid(d1)
         - k * math.exp(-r * t) * _phid(d2))
    if call:
        return c
    return c - s0 * math.exp(-q * t) + k * math.exp(-r * t)


def gk_call(x0, kx, t, r, r_f, sigma_x, call: bool = True) -> float:
    """Garman-Kohlhagen FX option: Black-Scholes with q = r_f."""
    return _bs64(call, x0, kx, t, r, sigma_x, r_f)


def gk_put(x0, kx, t, r, r_f, sigma_x) -> float:
    return gk_call(x0, kx, t, r, r_f, sigma_x, call=False)


def quanto_call(s0, k, t, r, r_f, sigma_s, sigma_x, rho, q=0.0,
                x_bar=1.0, call: bool = True) -> float:
    """Quanto option x_bar * max(+-(S_T - K), 0) paid in domestic
    currency: Black-Scholes at the domestic rate with the effective
    dividend yield q_eff = r - r_f + q + rho sigma_s sigma_x (the
    quanto forward is S0 e^{(r_f - q - rho sigma_s sigma_x) T})."""
    q_eff = (float(r) - float(r_f) + float(q)
             + float(rho) * float(sigma_s) * float(sigma_x))
    return float(x_bar) * _bs64(call, s0, k, t, r, sigma_s, q_eff)


def quanto_put(s0, k, t, r, r_f, sigma_s, sigma_x, rho, q=0.0,
               x_bar=1.0) -> float:
    return quanto_call(s0, k, t, r, r_f, sigma_s, sigma_x, rho, q,
                       x_bar, call=False)


def compo_call(s0, x0, k, t, r, sigma_s, sigma_x, rho, q=0.0,
               call: bool = True) -> float:
    """Composite option on the domestic asset value S_T X_T with a
    domestic strike: S X is a domestic tradable paying q, GBM with
    vol sqrt(sigma_s^2 + sigma_x^2 + 2 rho sigma_s sigma_x)."""
    sigma_s, sigma_x, rho = map(float, (sigma_s, sigma_x, rho))
    sigma_c = math.sqrt(sigma_s * sigma_s + sigma_x * sigma_x
                        + 2.0 * rho * sigma_s * sigma_x)
    return _bs64(call, float(s0) * float(x0), k, t, r, sigma_c, q)


def compo_put(s0, x0, k, t, r, sigma_s, sigma_x, rho, q=0.0) -> float:
    return compo_call(s0, x0, k, t, r, sigma_s, sigma_x, rho, q,
                      call=False)


def flexo_call(s0, x0, k, t, r_f, sigma_s, q=0.0,
               call: bool = True) -> float:
    """Foreign vanilla converted at the realized FX rate,
    e^{-r T} E[X_T max(+-(S_T - K), 0)]: change of numeraire to the
    foreign measure gives x0 times the FOREIGN-rate Black-Scholes (the
    domestic rate drops out entirely)."""
    return float(x0) * _bs64(call, s0, k, t, r_f, sigma_s, q)


def flexo_put(s0, x0, k, t, r_f, sigma_s, q=0.0) -> float:
    return flexo_call(s0, x0, k, t, r_f, sigma_s, q, call=False)


# ---------------------------------------------------------------------------
# Forward-start / cliquet closed forms (GBM) — oracles for the
# `forward_start_call` and `cliquet` payoffs.  Host-side f64.
# ---------------------------------------------------------------------------


def bs_forward_start_call(s0, k_ratio, t1, t, r, sigma, q=0.0) -> float:
    """Rubinstein (1991) forward-start call:
    e^{-rT} E[max(S_T - k S_{t1}, 0)] = S0 e^{-q t1} * BS(1, k, T-t1).

    Homogeneity: at t1 the contract is a vanilla call on S/S_{t1} struck
    at the ratio k, so its t1-value is S_{t1} times a constant.
    """
    s0, k_ratio, t1, t, r, sigma, q = map(
        float, (s0, k_ratio, t1, t, r, sigma, q))
    tau = t - t1
    if tau <= 0.0:
        raise ValueError("need t1 < t")
    st = sigma * math.sqrt(tau)
    d1 = (math.log(1.0 / k_ratio) + (r - q + 0.5 * sigma * sigma) * tau) \
        / st
    d2 = d1 - st
    unit = (math.exp(-q * tau) * _phid(d1)
            - k_ratio * math.exp(-r * tau) * _phid(d2))
    return s0 * math.exp(-q * t1) * unit


def bs_cliquet(n_periods, dt_period, floor, cap, t, r, sigma,
               q=0.0) -> float:
    """Ratchet cliquet fair value under GBM:
    e^{-rT} * n * E[clamp(R - 1, floor, cap)] with iid period returns
    R = S_e/S_s lognormal over dt_period.

    E[clamp(R-1, f, c)] = f + E[(R-(1+f))+] - E[(R-(1+c))+], each term a
    Black (undiscounted) call on the unit forward.
    """
    n_periods = int(n_periods)
    dt_period, floor, cap, t, r, sigma, q = map(
        float, (dt_period, floor, cap, t, r, sigma, q))

    def fwd_call(strike):
        if strike <= 0.0:
            return math.exp((r - q) * dt_period) - strike
        st = sigma * math.sqrt(dt_period)
        d1 = (math.log(1.0 / strike)
              + (r - q + 0.5 * sigma * sigma) * dt_period) / st
        d2 = d1 - st
        return (math.exp((r - q) * dt_period) * _phid(d1)
                - strike * _phid(d2))

    e_clamp = floor + fwd_call(1.0 + floor) - (
        fwd_call(1.0 + cap) if math.isfinite(cap) else 0.0)
    return math.exp(-r * t) * n_periods * e_clamp


# ---------------------------------------------------------------------------
# Vasicek stochastic-rate closed forms — the oracles for `models.vasicek`
# (hybrid Black-Scholes–Vasicek with pathwise stochastic discounting).
# Host-side f64.
# ---------------------------------------------------------------------------


def vasicek_zcb(r0, a, b, sigma_r, t) -> float:
    """Zero-coupon bond P(0,T) = E[exp(-int_0^T r_u du)] under
    dr = a (b - r) dt + sigma_r dW (affine closed form)."""
    r0, a, b, sigma_r, t = map(float, (r0, a, b, sigma_r, t))
    bt = -math.expm1(-a * t) / a
    loga = ((b - sigma_r * sigma_r / (2.0 * a * a)) * (bt - t)
            - sigma_r * sigma_r * bt * bt / (4.0 * a))
    return math.exp(loga - bt * r0)


def bsv_call(s0, k, t, r0, sigma_s, a, b, sigma_r, rho, q=0.0) -> float:
    """European equity call under Black-Scholes–Vasicek (Merton 1973).

    Under the T-forward measure the forward F = S e^{-qT}/P(0,T) is
    lognormal with integrated variance
        Sigma^2 = sigma_s^2 T + (sigma_r^2/a^2)(T - 2B + C2)
                  + 2 rho sigma_s (sigma_r/a)(T - B),
    B = (1-e^{-aT})/a, C2 = (1-e^{-2aT})/(2a); the price is the Black
    formula  S0 e^{-qT} N(d1) - K P(0,T) N(d2).
    """
    s0, k, t, r0, sigma_s, a, b, sigma_r, rho, q = map(
        float, (s0, k, t, r0, sigma_s, a, b, sigma_r, rho, q))
    p0t = vasicek_zcb(r0, a, b, sigma_r, t)
    bt = -math.expm1(-a * t) / a
    c2 = -math.expm1(-2.0 * a * t) / (2.0 * a)
    var = (sigma_s * sigma_s * t
           + (sigma_r * sigma_r / (a * a)) * (t - 2.0 * bt + c2)
           + 2.0 * rho * sigma_s * (sigma_r / a) * (t - bt))
    sig = math.sqrt(var)
    d1 = (math.log(s0 * math.exp(-q * t) / (k * p0t)) + 0.5 * var) / sig
    d2 = d1 - sig
    return s0 * math.exp(-q * t) * _phid(d1) - k * p0t * _phid(d2)


def bs_vega(s0, k, t, r, sigma, q=0.0):
    """dC/dsigma = s0 e^{-qT} phi(d1) sqrt(T)."""
    s0, k, t, r, sigma, q = map(jnp.asarray, (s0, k, t, r, sigma, q))
    sqrt_t = jnp.sqrt(t)
    d1 = (jnp.log(s0 / k) + (r - q + 0.5 * sigma * sigma) * t) \
        / (sigma * sqrt_t)
    return s0 * jnp.exp(-q * t) * norm.pdf(d1) * sqrt_t


def bs_gamma(s0, k, t, r, sigma, q=0.0):
    """d2C/dS0^2 = e^{-qT} phi(d1) / (s0 sigma sqrt(T))."""
    s0, k, t, r, sigma, q = map(jnp.asarray, (s0, k, t, r, sigma, q))
    sqrt_t = jnp.sqrt(t)
    d1 = (jnp.log(s0 / k) + (r - q + 0.5 * sigma * sigma) * t) \
        / (sigma * sqrt_t)
    return jnp.exp(-q * t) * norm.pdf(d1) / (s0 * sigma * sqrt_t)


@functools.partial(jax.jit, static_argnames=("n_iter",))
def bs_implied_vol(price, s0, k, t, r, q=0.0, n_iter: int = 24):
    """Black-Scholes implied volatility of a call, fully vectorized + jitted.

    Bisection-safeguarded Newton: the bracket [lo, hi] shrinks
    monotonically (vega > 0 makes the call price strictly increasing in
    sigma), Newton steps are taken whenever they land strictly inside it,
    bisection otherwise — globally convergent, fixed trip count, no
    data-dependent control flow (jit friendly).  Prices outside the
    static no-arbitrage band (forward intrinsic, spot) return NaN.
    Inverts MC prices back to vol surfaces without leaving the device.
    """
    price, s0, k, t, r, q = map(
        lambda v: jnp.asarray(v, jnp.float32), (price, s0, k, t, r, q))
    lb = jnp.maximum(s0 * jnp.exp(-q * t) - k * jnp.exp(-r * t), 0.0)
    ub = s0 * jnp.exp(-q * t)
    valid = jnp.logical_and(price > lb, price < ub)

    lo = jnp.full_like(price, 1e-4)
    hi = jnp.full_like(price, 5.0)
    # Brenner-Subrahmanyam ATM start: sigma ~ sqrt(2 pi / T) * C / S0
    sigma0 = jnp.clip(jnp.sqrt(2.0 * jnp.pi / t) * price / s0, 1e-3, 4.0)

    def body(_, carry):
        sigma, lo, hi = carry
        diff = bs_call(s0, k, t, r, sigma, q) - price
        lo = jnp.where(diff < 0.0, sigma, lo)
        hi = jnp.where(diff > 0.0, sigma, hi)
        vega = bs_vega(s0, k, t, r, sigma, q)
        newton = sigma - diff / jnp.maximum(vega, 1e-8)
        inside = jnp.logical_and(newton > lo, newton < hi)
        sigma = jnp.where(inside, newton, 0.5 * (lo + hi))
        return (sigma, lo, hi)

    sigma, _, _ = jax.lax.fori_loop(0, n_iter, body, (sigma0, lo, hi))
    return jnp.where(valid, sigma, jnp.nan)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PriceResult:
    """A Monte Carlo price with its statistical error.

    The reference printed bare point estimates (wrappers.cuh:52,86,119);
    every engine here returns the standard error as a first-class output so
    correctness is checkable as |price - oracle| <= 3 * stderr.
    """

    price: Any          # discounted mean payoff
    stderr: Any         # standard error of the discounted mean
    n_paths: Any        # effective number of (outer) paths
    payoff_mean: Any    # undiscounted mean payoff
    payoff_var: Any     # undiscounted payoff sample variance

    def within(self, oracle_price, n_se: float = 3.0) -> Any:
        """|price - oracle| <= n_se * stderr (the acceptance criterion)."""
        return jnp.abs(self.price - oracle_price) <= n_se * self.stderr


def summarize(sum_w, sum_w2, n, discount):
    """Build a PriceResult from fp64 accumulators of payoff and payoff^2."""
    n = jnp.asarray(n, jnp.asarray(sum_w).dtype)
    mean = sum_w / n
    var = jnp.maximum(sum_w2 / n - mean * mean, 0.0) * (n / jnp.maximum(n - 1.0, 1.0))
    stderr = jnp.sqrt(var / n) * discount
    return PriceResult(
        price=(discount * mean),
        stderr=stderr,
        n_paths=n,
        payoff_mean=mean,
        payoff_var=var,
    )


def vasicek_zbp(r0, a, b, sigma_r, t_expiry, t_bond, k) -> float:
    """European PUT on a zero-coupon bond under Vasicek: the option at
    ``t_expiry`` on P(t_expiry, t_bond) struck at ``k`` (Jamshidian's
    building block).  Black-like closed form with bond volatility
    sigma_p = (sigma_r/a)(1 - e^{-a(S-T)}) sqrt((1 - e^{-2aT})/(2a))."""
    r0, a, b, sigma_r, t_expiry, t_bond, k = map(
        float, (r0, a, b, sigma_r, t_expiry, t_bond, k))
    p_t = vasicek_zcb(r0, a, b, sigma_r, t_expiry)
    p_s = vasicek_zcb(r0, a, b, sigma_r, t_bond)
    sig_p = ((sigma_r / a) * (-math.expm1(-a * (t_bond - t_expiry)))
             * math.sqrt(-math.expm1(-2.0 * a * t_expiry) / (2.0 * a)))
    if sig_p < 1e-12:
        return max(k * p_t - p_s, 0.0)
    h = math.log(p_s / (k * p_t)) / sig_p + 0.5 * sig_p
    cnd = lambda x: 0.5 * math.erfc(-x / math.sqrt(2.0))
    return k * p_t * cnd(-h + sig_p) - p_s * cnd(-h)


def vasicek_swaption(r0, a, b, sigma_r, t_expiry, tenor, n_payments,
                     k_rate, payer=True) -> float:
    """European swaption under Vasicek via Jamshidian decomposition.

    Swap: fixed rate ``k_rate`` against float on unit notional, payment
    dates T_i = t_expiry + i*tenor (i = 1..n_payments).  A payer
    swaption is a basket of ZCB PUTS struck at K_i = P(T0, T_i; r*)
    where r* makes the coupon bond worth par at expiry; a receiver is
    the complementary basket of calls, obtained here by put-call parity
    on the swap (receiver = payer - swap value).
    """
    r0, a, b, sigma_r = map(float, (r0, a, b, sigma_r))
    t0, tau, kr = float(t_expiry), float(tenor), float(k_rate)
    n = int(n_payments)
    mats = [t0 + (i + 1) * tau for i in range(n)]
    cs = [kr * tau] * n
    cs[-1] += 1.0

    def coupon_bond(r):
        return sum(c * vasicek_zcb(r, a, b, sigma_r, s - t0)
                   for c, s in zip(cs, mats))

    # r*: coupon_bond(r*) = 1 (monotone decreasing in r) — bisection
    lo, hi = -2.0, 3.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if coupon_bond(mid) > 1.0:
            lo = mid
        else:
            hi = mid
    r_star = 0.5 * (lo + hi)

    payer_px = sum(
        c * vasicek_zbp(r0, a, b, sigma_r, t0, s,
                        vasicek_zcb(r_star, a, b, sigma_r, s - t0))
        for c, s in zip(cs, mats))
    if payer:
        return payer_px
    # receiver = payer - (float - fixed) = payer + fixed-leg - float-leg
    fixed_leg = sum(c * vasicek_zcb(r0, a, b, sigma_r, s)
                    for c, s in zip(cs, mats))
    float_leg = vasicek_zcb(r0, a, b, sigma_r, t0)
    return payer_px + fixed_leg - float_leg


def hw_zbp(a, sigma_r, p0_expiry, p0_bond, t_expiry, t_bond, k) -> float:
    """European PUT on a zero-coupon bond under curve-fitted Hull-White.

    Identical Black-like form to `vasicek_zbp` — the bond volatility
    depends only on (a, sigma_r), while the forward bond level comes
    from the INPUT curve discounts P(0, t_expiry), P(0, t_bond) (the
    defining property of the theta(t) fit: today's curve is repriced
    exactly).  Brigo-Mercurio (3.40-3.41).
    """
    a, sigma_r = float(a), float(sigma_r)
    p_t, p_s = float(p0_expiry), float(p0_bond)
    t0, s, k = float(t_expiry), float(t_bond), float(k)
    sig_p = ((sigma_r / a) * (-math.expm1(-a * (s - t0)))
             * math.sqrt(-math.expm1(-2.0 * a * t0) / (2.0 * a)))
    if sig_p < 1e-12:
        return max(k * p_t - p_s, 0.0)
    h = math.log(p_s / (k * p_t)) / sig_p + 0.5 * sig_p
    cnd = lambda x: 0.5 * math.erfc(-x / math.sqrt(2.0))
    return k * p_t * cnd(-h + sig_p) - p_s * cnd(-h)


def hw_swaption(a, sigma_r, df, t_expiry, tenor, n_payments, k_rate,
                payer=True) -> float:
    """European swaption under curve-fitted Hull-White (Jamshidian).

    ``df``: callable t -> P(0, t), the input discount curve the model
    reprices exactly.  Bonds at expiry are lognormal in the OU factor
    x(T0): P(T0, S; x) = (P(0,S)/P(0,T0)) exp(-B(S-T0) x
    - (sigma^2/(4a))(1 - e^{-2aT0}) B(S-T0)^2); Jamshidian finds x*
    putting the coupon bond at par and decomposes the payer swaption
    into ZCB puts struck at P(T0, T_i; x*).
    """
    a, sigma_r = float(a), float(sigma_r)
    t0, tau, kr = float(t_expiry), float(tenor), float(k_rate)
    n = int(n_payments)
    mats = [t0 + (i + 1) * tau for i in range(n)]
    cs = [kr * tau] * n
    cs[-1] += 1.0
    p0_t0 = float(df(t0))
    var_fac = (sigma_r * sigma_r / (4.0 * a)) * (-math.expm1(-2.0 * a * t0))
    # alpha(t0) - f(0, t0): the x-SHIFT term of the reconstruction.
    # Jamshidian strikes are invariant to it (pure shift of the bond
    # family), but it is kept so bond_at_expiry is the true P(T0, S; x)
    # (the MC intrinsics in models/hullwhite.py evaluate the same form
    # at simulated x, where omitting it is a real bias).
    shift = ((sigma_r * sigma_r / (2.0 * a * a))
             * math.expm1(-a * t0) ** 2)

    def bond_at_expiry(s, x):
        b = -math.expm1(-a * (s - t0)) / a
        return (float(df(s)) / p0_t0) * math.exp(
            -b * x - var_fac * b * b - b * shift)

    def coupon_bond(x):
        return sum(c * bond_at_expiry(s, x) for c, s in zip(cs, mats))

    lo, hi = -3.0, 3.0  # x is OU(0) with std << 1
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if coupon_bond(mid) > 1.0:
            lo = mid
        else:
            hi = mid
    x_star = 0.5 * (lo + hi)

    payer_px = sum(
        c * hw_zbp(a, sigma_r, p0_t0, float(df(s)), t0, s,
                   bond_at_expiry(s, x_star))
        for c, s in zip(cs, mats))
    if payer:
        return payer_px
    fixed_leg = sum(c * float(df(s)) for c, s in zip(cs, mats))
    return payer_px + fixed_leg - p0_t0


def g2_swaption(a, sigma, b_mr, eta, rho, df, t_expiry, tenor,
                n_payments, k_rate, payer=True, n_quad: int = 2001):
    """European swaption under curve-fitted G2++ (two-factor Gaussian).

    r = x + y + phi(t), dx = -a x dt + sigma dW1, dy = -b_mr y dt +
    eta dW2, corr rho; phi fits ``df`` exactly.  Semi-analytic
    "conditional Jamshidian": under the T-forward measure (x, y) at
    expiry are jointly Gaussian with known means (Brigo-Mercurio 4.33);
    GIVEN x the coupon bond is monotone in y, so the exercise boundary
    ybar(x) solves a 1-D root-find and the inner expectation is a sum
    of lognormal tails in y — the outer x-integral is Gauss-Hermite.
    eta -> 0 degenerates to `hw_swaption` (gated)."""
    import numpy as np

    a, s, b, e, rho = map(float, (a, sigma, b_mr, eta, rho))
    t0, tau, kr = float(t_expiry), float(tenor), float(k_rate)
    n = int(n_payments)
    mats = [t0 + (i + 1) * tau for i in range(n)]
    cs = np.array([kr * tau] * n)
    cs[-1] += 1.0
    p0_t = float(df(t0))
    p0_i = np.array([float(df(m)) for m in mats])

    def bf(k_, t):  # (1 - e^{-k t}) / k
        return -math.expm1(-k_ * t) / k_

    def v_of(t):  # Var[int_0^t (x + y)]
        return ((s * s / (a * a)) * (t - 2 * bf(a, t)
                                     - math.expm1(-2 * a * t) / (2 * a))
                + (e * e / (b * b)) * (t - 2 * bf(b, t)
                                       - math.expm1(-2 * b * t) / (2 * b))
                + (2 * rho * s * e / (a * b))
                * (t - bf(a, t) - bf(b, t)
                   - math.expm1(-(a + b) * t) / (a + b)))

    ba = np.array([bf(a, m - t0) for m in mats])
    bb = np.array([bf(b, m - t0) for m in mats])
    # A_i = (P(0,t_i)/P(0,T)) exp(0.5 [V(t_i - T) - V(t_i) + V(T)])
    av = np.array([
        (p0_i[i] / p0_t) * math.exp(0.5 * (v_of(mats[i] - t0)
                                           - v_of(mats[i]) + v_of(t0)))
        for i in range(n)])

    # T-forward-measure moments of (x, y) at T (B-M 4.33 / 4.34)
    sx = s * math.sqrt(-math.expm1(-2 * a * t0) / (2 * a))
    sy = e * math.sqrt(-math.expm1(-2 * b * t0) / (2 * b))
    rxy = (rho * s * e * (-math.expm1(-(a + b) * t0)) / (a + b)
           / (sx * sy)) if sx > 0 and sy > 0 else 0.0
    mx = -((s * s / (a * a) + rho * s * e / (a * b)) * (-math.expm1(-a * t0))
           - s * s / (2 * a * a) * (-math.expm1(-2 * a * t0))
           - rho * s * e / (b * (a + b)) * (-math.expm1(-(a + b) * t0)))
    my = -((e * e / (b * b) + rho * s * e / (a * b)) * (-math.expm1(-b * t0))
           - e * e / (2 * b * b) * (-math.expm1(-2 * b * t0))
           - rho * s * e / (a * (a + b)) * (-math.expm1(-(a + b) * t0)))

    from scipy.special import ndtr  # vectorized normal CDF

    s_cond = sy * math.sqrt(max(1.0 - rxy * rxy, 1e-16))
    # Trapezoid over +-8 sigma: unlike Gauss-Hermite it stays accurate
    # when eta -> 0 turns the conditional expectation into a STEP in x
    # (the degenerate-to-Hull-White gate), and hermegauss overflows
    # beyond ~600 nodes anyway.  n_quad ~ 2001 -> ~1e-9 relative.
    m = max(int(n_quad), 201)
    xs = np.linspace(mx - 8.0 * sx, mx + 8.0 * sx, m)  # (m,)
    pdf = np.exp(-0.5 * ((xs - mx) / sx) ** 2) / (sx * math.sqrt(2.0
                                                                 * math.pi))
    wts = np.full(m, xs[1] - xs[0])
    wts[0] = wts[-1] = 0.5 * (xs[1] - xs[0])
    mu_c = my + (rxy * sy / sx) * (xs - mx) if sx > 0 else np.full(m, my)
    coef = cs[None, :] * av[None, :] * np.exp(-np.outer(xs, ba))  # (m,n)

    # vectorized bisection for ybar(x): coupon bond decreasing in y
    lo = np.full(m, -6.0)
    hi = np.full(m, 6.0)
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        val = (coef * np.exp(-np.outer(mid, bb))).sum(axis=1)
        above = val > 1.0
        lo = np.where(above, mid, lo)
        hi = np.where(above, hi, mid)
    ybar = 0.5 * (lo + hi)
    d = (ybar - mu_c) / s_cond
    inner = ndtr(-d)
    for i in range(n):
        lam = bb[i]
        inner -= (coef[:, i]
                  * np.exp(-lam * mu_c + 0.5 * lam * lam
                           * s_cond * s_cond)
                  * ndtr(-d - lam * s_cond))
    payer_px = p0_t * float(np.sum(inner * pdf * wts))
    if payer:
        return payer_px
    return payer_px + float(np.dot(cs, p0_i)) - p0_t


def hw_swaption_multicurve(a, sigma_r, df_disc, df_proj, t_expiry,
                           tenor, n_payments, k_rate, payer=True,
                           n_quad: int = 4001):
    """European swaption under curve-fitted Hull-White with TWO curves:
    discounting off ``df_disc`` (OIS), forwards off ``df_proj``, linked
    by a DETERMINISTIC multiplicative basis (the standard post-2008
    multi-curve simplification — one factor drives both curves).

    With the basis spread s_j = B(t_{j-1})/B(t_j), B(t) =
    P_proj(0,t)/P_disc(0,t), the swap value at expiry is a MIXED-sign
    sum of discount bonds, so Jamshidian's monotone coupon-bond trick
    does not apply; the price is computed by direct (kink-robust
    trapezoid) quadrature of the positive part over the T-forward
    Gaussian law of x.  ``df_proj = df_disc`` reproduces `hw_swaption`
    to quadrature precision (gated)."""
    import numpy as np

    a, sig = float(a), float(sigma_r)
    t0, tau, kr = float(t_expiry), float(tenor), float(k_rate)
    n = int(n_payments)
    dates = [t0 + j * tau for j in range(n + 1)]
    pd_ = np.array([float(df_disc(t)) for t in dates], np.float64)
    pp_ = np.array([float(df_proj(t)) for t in dates], np.float64)
    basis = pp_ / pd_
    # V(x) = sum_m w_m P_d(T0, t_m; x); weights from the spread algebra:
    # float leg telescopes to s_{j} P_d(t_{j-1}) - P_d(t_j) per period
    w = np.zeros(n + 1)
    w[0] += basis[0] / basis[1]
    for m in range(1, n):
        w[m] += basis[m] / basis[m + 1] - 1.0 - kr * tau
    w[n] += -1.0 - kr * tau
    bvec = np.array([-math.expm1(-a * (t - t0)) / a for t in dates])
    var_fac = (sig * sig / (4.0 * a)) * (-math.expm1(-2.0 * a * t0))
    shift = (sig * sig / (2.0 * a * a)) * math.expm1(-a * t0) ** 2
    coef = w * (pd_ / pd_[0]) * np.exp(-var_fac * bvec * bvec
                                       - bvec * shift)

    sx = sig * math.sqrt(-math.expm1(-2 * a * t0) / (2 * a))
    mx = -((sig * sig / (a * a)) * (-math.expm1(-a * t0))
           - sig * sig / (2 * a * a) * (-math.expm1(-2 * a * t0)))
    m = max(int(n_quad), 201)
    xs = np.linspace(mx - 8.0 * sx, mx + 8.0 * sx, m)
    pdf = np.exp(-0.5 * ((xs - mx) / sx) ** 2) / (sx * math.sqrt(
        2.0 * math.pi))
    wts = np.full(m, xs[1] - xs[0])
    wts[0] = wts[-1] = 0.5 * (xs[1] - xs[0])
    v = (coef[None, :] * np.exp(-np.outer(xs, bvec))).sum(axis=1)
    if not payer:
        v = -v
    payer_px = pd_[0] * float(np.sum(np.maximum(v, 0.0) * pdf * wts))
    return payer_px


def g2_swaption_multicurve(a, sigma, b_mr, eta, rho, df_disc, df_proj,
                           t_expiry, tenor, n_payments, k_rate,
                           payer=True, n_quad: int = 501):
    """Multi-curve European swaption under G2++ (deterministic basis).

    The mixed-sign bond weights break BOTH Jamshidian tricks (no x*
    root, and given x the value is no longer monotone in y), so the
    price is a direct 2-D trapezoid over the T-forward Gaussian law of
    (x, y) — ~n_quad^2 nodes, kink-robust.  ``df_proj = df_disc``
    reproduces `g2_swaption` (gated)."""
    import numpy as np

    a, s, b, e, rho = map(float, (a, sigma, b_mr, eta, rho))
    t0, tau, kr = float(t_expiry), float(tenor), float(k_rate)
    n = int(n_payments)
    dates = [t0 + j * tau for j in range(n + 1)]
    pd_ = np.array([float(df_disc(t)) for t in dates], np.float64)
    pp_ = np.array([float(df_proj(t)) for t in dates], np.float64)
    basis = pp_ / pd_
    w = np.zeros(n + 1)
    w[0] += basis[0] / basis[1]
    for m in range(1, n):
        w[m] += basis[m] / basis[m + 1] - 1.0 - kr * tau
    w[n] += -1.0 - kr * tau

    def bf(k_, t):
        return -math.expm1(-k_ * t) / k_

    def v_of(t):
        return ((s * s / (a * a)) * (t - 2 * bf(a, t)
                                     - math.expm1(-2 * a * t) / (2 * a))
                + (e * e / (b * b)) * (t - 2 * bf(b, t)
                                       - math.expm1(-2 * b * t) / (2 * b))
                + (2 * rho * s * e / (a * b))
                * (t - bf(a, t) - bf(b, t)
                   - math.expm1(-(a + b) * t) / (a + b)))

    ba = np.array([bf(a, t - t0) for t in dates])
    bb = np.array([bf(b, t - t0) for t in dates])
    amat = np.array([0.5 * (v_of(t - t0) - v_of(t) + v_of(t0))
                     for t in dates])
    coef = w * (pd_ / pd_[0]) * np.exp(amat)

    sx = s * math.sqrt(-math.expm1(-2 * a * t0) / (2 * a))
    sy = e * math.sqrt(-math.expm1(-2 * b * t0) / (2 * b))
    rxy = (rho * s * e * (-math.expm1(-(a + b) * t0)) / (a + b)
           / (sx * sy)) if sx > 0 and sy > 0 else 0.0
    mx = -((s * s / (a * a) + rho * s * e / (a * b))
           * (-math.expm1(-a * t0))
           - s * s / (2 * a * a) * (-math.expm1(-2 * a * t0))
           - rho * s * e / (b * (a + b)) * (-math.expm1(-(a + b) * t0)))
    my = -((e * e / (b * b) + rho * s * e / (a * b))
           * (-math.expm1(-b * t0))
           - e * e / (2 * b * b) * (-math.expm1(-2 * b * t0))
           - rho * s * e / (a * (a + b)) * (-math.expm1(-(a + b) * t0)))

    m = max(int(n_quad), 101)
    xs = np.linspace(mx - 8.0 * sx, mx + 8.0 * sx, m)
    ys = np.linspace(my - 8.0 * sy, my + 8.0 * sy, m)
    dx, dy = xs[1] - xs[0], ys[1] - ys[0]
    wx = np.full(m, dx)
    wx[0] = wx[-1] = dx / 2
    wy = np.full(m, dy)
    wy[0] = wy[-1] = dy / 2
    xg, yg = np.meshgrid(xs, ys, indexing="ij")
    det = 1.0 - rxy * rxy
    zq = (((xg - mx) / sx) ** 2 - 2 * rxy * ((xg - mx) / sx)
          * ((yg - my) / sy) + ((yg - my) / sy) ** 2) / det
    pdf = np.exp(-0.5 * zq) / (2 * math.pi * sx * sy * math.sqrt(det))
    v = np.zeros_like(xg)
    for j in range(n + 1):
        v += coef[j] * np.exp(-ba[j] * xg - bb[j] * yg)
    if not payer:
        v = -v
    payer_px = pd_[0] * float(
        np.sum(np.maximum(v, 0.0) * pdf * wx[:, None] * wy[None, :]))
    return payer_px


def hw_equity_call(s0, k, t, sigma_s, a, sigma_r, rho, df, q=0.0):
    """European equity call under GBM + curve-fitted Hull-White rates
    (Merton 1973 on the curve).

    The integrated forward variance is IDENTICAL to `bsv_call`'s (it
    never involves the rate drift), so the only change is the discount
    bond: P(0,T) comes from the input curve the theta(t) fit reprices.
    Black formula: S0 e^{-qT} N(d1) - K P(0,T) N(d2)."""
    s0, k, t, sigma_s, a, sigma_r, rho, q = map(
        float, (s0, k, t, sigma_s, a, sigma_r, rho, q))
    p0t = float(df(t))
    bt = -math.expm1(-a * t) / a
    c2 = -math.expm1(-2.0 * a * t) / (2.0 * a)
    var = (sigma_s * sigma_s * t
           + (sigma_r * sigma_r / (a * a)) * (t - 2.0 * bt + c2)
           + 2.0 * rho * sigma_s * (sigma_r / a) * (t - bt))
    sig = math.sqrt(var)
    d1 = (math.log(s0 * math.exp(-q * t) / (k * p0t)) + 0.5 * var) / sig
    d2 = d1 - sig
    return s0 * math.exp(-q * t) * _phid(d1) - k * p0t * _phid(d2)
