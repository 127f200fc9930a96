"""Cross-currency family (models/fx): quanto/compo/GK/flexo vs exact
closed forms, measure-change identities, and the q_eff adapter."""

import math

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams, price
from mc_tpu.models.fx import (DEMO_FX, FX_CONTRACTS, FXDynamics, price_fx,
                              quanto_option_params)
from mc_tpu import oracle

OPT = OptionParams()                    # s0=100, k=100, r=0.1, sigma=0.2
FX = FXDynamics(x0=1.2, sigma_x=0.15, r_f=0.03, rho=-0.35)
SIM = SimParams(n_paths=1 << 20, n_steps=2, seed=11)


def _oracle(contract, opt=OPT, fx=FX):
    s0, t, k, r, sigma, _, _, _, q = (float(v) for v in opt.astuple())
    x0, sx, rf, rho = (float(fx.x0), float(fx.sigma_x), float(fx.r_f),
                       float(fx.rho))
    kx = x0 if fx.kx is None else float(fx.kx)
    xb = x0 if fx.x_bar is None else float(fx.x_bar)
    return {
        "gk_call": lambda: oracle.gk_call(x0, kx, t, r, rf, sx),
        "gk_put": lambda: oracle.gk_put(x0, kx, t, r, rf, sx),
        "quanto_call": lambda: oracle.quanto_call(s0, k, t, r, rf, sigma,
                                                  sx, rho, q, xb),
        "quanto_put": lambda: oracle.quanto_put(s0, k, t, r, rf, sigma,
                                                sx, rho, q, xb),
        "compo_call": lambda: oracle.compo_call(s0, x0, k, t, r, sigma,
                                                sx, rho, q),
        "compo_put": lambda: oracle.compo_put(s0, x0, k, t, r, sigma,
                                              sx, rho, q),
        "flexo_call": lambda: oracle.flexo_call(s0, x0, k, t, rf, sigma,
                                                q),
        "flexo_put": lambda: oracle.flexo_put(s0, x0, k, t, rf, sigma, q),
    }[contract]()


@pytest.mark.parametrize("contract", sorted(FX_CONTRACTS))
def test_mc_matches_closed_form(contract):
    """Every contract within 3.5 sigma of its exact oracle — jointly these
    pin the quanto drift tilt, the rho mixing, and the measure change."""
    opt = OPT if not contract.startswith("compo") else OptionParams(k=120.0)
    res = price_fx(opt, FX, SIM, contract)
    ref = _oracle(contract, opt)
    z = (float(res.price) - ref) / float(res.stderr)
    assert abs(z) < 3.5, (contract, float(res.price), ref, z)


def test_oracle_put_call_parities():
    """Exact f64 parities, one per contract family (1e-12 rel)."""
    s0, t, k, r, sig = 100.0, 2.0, 95.0, 0.07, 0.25
    x0, kx, sx, rf, rho, q, xb = 1.4, 1.3, 0.12, 0.02, 0.45, 0.015, 1.35
    # gk: C - P = x0 e^{-r_f t} - kx e^{-r t}
    lhs = oracle.gk_call(x0, kx, t, r, rf, sx) - oracle.gk_put(
        x0, kx, t, r, rf, sx)
    rhs = x0 * math.exp(-rf * t) - kx * math.exp(-r * t)
    assert lhs == pytest.approx(rhs, rel=1e-12)
    # quanto: C - P = xb e^{-rt} (F - K), F the quanto forward
    f = s0 * math.exp((rf - q - rho * sig * sx) * t)
    lhs = (oracle.quanto_call(s0, k, t, r, rf, sig, sx, rho, q, xb)
           - oracle.quanto_put(s0, k, t, r, rf, sig, sx, rho, q, xb))
    assert lhs == pytest.approx(xb * math.exp(-r * t) * (f - k), rel=1e-12)
    # compo: C - P = s0 x0 e^{-qt} - k e^{-rt}
    lhs = (oracle.compo_call(s0, x0, k * x0, t, r, sig, sx, rho, q)
           - oracle.compo_put(s0, x0, k * x0, t, r, sig, sx, rho, q))
    rhs = s0 * x0 * math.exp(-q * t) - k * x0 * math.exp(-r * t)
    assert lhs == pytest.approx(rhs, rel=1e-12)
    # flexo: C - P = x0 (s0 e^{-qt} - k e^{-r_f t})
    lhs = (oracle.flexo_call(s0, x0, k, t, rf, sig, q)
           - oracle.flexo_put(s0, x0, k, t, rf, sig, q))
    rhs = x0 * (s0 * math.exp(-q * t) - k * math.exp(-rf * t))
    assert lhs == pytest.approx(rhs, rel=1e-12)


def test_oracle_degenerate_limits():
    """rho=0 & sigma_x->0: quanto collapses to x_bar * BS at the foreign
    growth rate; compo vol collapses to sqrt(ss^2+sx^2) at rho=0."""
    bs = float(oracle.bs_call(100.0, 100.0, 1.0, 0.1, 0.2,
                              q=0.1 - 0.03))  # q_eff = r - r_f
    qc = oracle.quanto_call(100.0, 100.0, 1.0, 0.1, 0.03, 0.2, 1e-12,
                            0.0, 0.0, 1.0)
    assert qc == pytest.approx(bs, rel=1e-6)
    # flexo at sigma_x -> 0 equals x0 * foreign BS always (rate-exact)
    fl = oracle.flexo_call(100.0, 1.2, 100.0, 1.0, 0.03, 0.2)
    assert fl == pytest.approx(1.2 * float(oracle.bs_call(
        100.0, 100.0, 1.0, 0.03, 0.2)), rel=1e-6)


def test_quanto_adapter_exact_identity():
    """oracle.quanto_call == x_bar * bs_call(q=q_eff) with the adapter's
    q_eff — the f64 identity behind `quanto_option_params`."""
    opt, xb = quanto_option_params(OPT, FX)
    ref = oracle.quanto_call(100.0, 100.0, 1.0, 0.1, float(FX.r_f), 0.2,
                             float(FX.sigma_x), float(FX.rho), 0.0, 1.2)
    via = xb * float(oracle.bs_call(100.0, 100.0, 1.0, 0.1, 0.2,
                                    q=opt.q))
    assert via == pytest.approx(ref, rel=1e-6)
    assert xb == pytest.approx(1.2)


def test_quanto_adapter_prices_through_gbm_engine():
    """The WHOLE single-asset surface prices quanto contracts by
    composition: engines.price on the adapted params hits the quanto
    oracle within MC noise."""
    opt, xb = quanto_option_params(OPT, FX)
    res = price(opt, SimParams(n_paths=1 << 20, n_steps=2, seed=5))
    ref = _oracle("quanto_call")
    z = (xb * float(res.price) - ref) / (xb * float(res.stderr))
    assert abs(z) < 3.5, (xb * float(res.price), ref, z)


def test_quanto_asian_through_adapter_brackets():
    """Quanto Asian via the adapter: positive, below the quanto vanilla
    (Jensen on the averaged payout under the same drift), above the
    forward-start-free lower bound 0."""
    opt, xb = quanto_option_params(OPT, FX)
    asian = price(opt, SimParams(n_paths=1 << 18, n_steps=64, seed=7),
                  payoff="asian_call")
    vanilla = _oracle("quanto_call")
    a = xb * float(asian.price)
    assert 0.0 < a < vanilla
    # monotone in rho: more negative rho raises the quanto drift
    fx_hi = FXDynamics(x0=1.2, sigma_x=0.15, r_f=0.03, rho=-0.8)
    opt_hi, _ = quanto_option_params(OPT, fx_hi)
    asian_hi = price(opt_hi, SimParams(n_paths=1 << 18, n_steps=64,
                                       seed=7), payoff="asian_call")
    assert float(asian_hi.price) > float(asian.price)


def test_correlation_sensitivity_signs():
    """CRN rho-bump signs: compo call value rises with rho (higher
    compo vol); quanto call falls (lower quanto forward)."""
    sim = SimParams(n_paths=1 << 19, n_steps=2, seed=13)
    lo = FXDynamics(x0=1.2, sigma_x=0.15, r_f=0.03, rho=-0.6)
    hi = FXDynamics(x0=1.2, sigma_x=0.15, r_f=0.03, rho=0.6)
    ko = OptionParams(k=120.0)
    c_lo = price_fx(ko, lo, sim, "compo_call")
    c_hi = price_fx(ko, hi, sim, "compo_call")
    assert float(c_hi.price) > float(c_lo.price)
    q_lo = price_fx(OPT, lo, sim, "quanto_call")
    q_hi = price_fx(OPT, hi, sim, "quanto_call")
    assert float(q_hi.price) < float(q_lo.price)


def test_default_strikes_resolve_to_spot():
    """kx=None / x_bar=None resolve to x0 in as_f32 (ATM defaults)."""
    fx = FXDynamics(x0=1.3).as_f32()
    assert float(fx.kx) == pytest.approx(1.3)
    assert float(fx.x_bar) == pytest.approx(1.3)


def test_unknown_contract_and_engine_raise():
    with pytest.raises(KeyError, match="unknown fx contract"):
        price_fx(OPT, FX, SIM, "straddle")
    # one engine only: the option that chose among engines is gone
    with pytest.raises(TypeError, match="engine"):
        price_fx(OPT, FX, SIM, "gk_call", engine="xla")


def test_stream_independent_of_gbm():
    """The fx stream tag decorrelates fx draws from the GBM engine at
    the same seed: prices differ (not bit-coupled), statistics agree."""
    sim = SimParams(n_paths=1 << 16, n_steps=2, seed=11)
    opt, xb = quanto_option_params(OPT, FX)
    via_engine = xb * float(price(opt, sim).price)
    direct = float(price_fx(OPT, FX, sim, "quanto_call").price)
    assert via_engine != direct  # different streams, same seed
