"""Black-Scholes–Vasicek stochastic rates: affine/Merton-1973 gates.

The scheme is exact in law, so the sharpest test is the ZCB gate at a
TINY step count — any per-step covariance error would show as bias far
outside the (very small) discount-factor stderr.
"""

import math

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.models.vasicek import (DEMO_VASICEK, VasicekDynamics,
                                   price_vasicek)
from mc_tpu.oracle import bs_call, bsv_call, vasicek_zcb

SIM = SimParams(n_paths=200_000, n_steps=8)
OPT = OptionParams()  # r=0.1 is the initial short rate r0


def _gate(res, want, n_se=3.5):
    assert abs(float(res.price) - want) <= n_se * float(res.stderr), (
        float(res.price), want, float(res.stderr),
        (float(res.price) - want) / float(res.stderr))


@pytest.mark.parametrize("n_steps", [2, 20])
def test_zcb_exact_at_any_step_count(n_steps):
    """E[exp(-int r)] vs the affine closed form — the discount factor's
    stderr is ~1e-5, so this pins the OU covariance construction hard."""
    sim = SimParams(n_paths=200_000, n_steps=n_steps)
    res = price_vasicek(OPT, DEMO_VASICEK, sim, payoff="zcb",
                        tile_rows=8)
    _gate(res, vasicek_zcb(0.1, 0.3, 0.05, 0.015, 1.0))


def test_zcb_high_vol_gate():
    """Stronger rate vol + fast reversion exercises the OU kernels away
    from the near-deterministic regime."""
    dyn = VasicekDynamics(a=1.0, b=0.03, sigma_r=0.05, rho=0.0)
    res = price_vasicek(OPT, dyn, SIM, payoff="zcb",
                        tile_rows=8)
    _gate(res, vasicek_zcb(0.1, 1.0, 0.03, 0.05, 1.0))


@pytest.mark.parametrize("rho", [-0.3, 0.5])
def test_equity_call_merton73_gate(rho):
    dyn = VasicekDynamics(rho=rho)
    res = price_vasicek(OPT, dyn, SIM, antithetic=True,
                        tile_rows=8)
    want = bsv_call(100.0, 100.0, 1.0, 0.1, 0.2, 0.3, 0.05, 0.015, rho)
    _gate(res, want)


def test_degenerate_reduces_to_bs():
    """sigma_r ~ 0 AND b = r0: rates are constant, price is plain BS."""
    dyn = VasicekDynamics(a=0.3, b=0.1, sigma_r=1e-7, rho=0.0)
    res = price_vasicek(OPT, dyn, SIM, antithetic=True,
                        tile_rows=8)
    _gate(res, float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2)))


def test_put_call_parity_pathwise():
    """C - P on the SAME key is the discounted forward pathwise:
    equals S0 e^{-qT} - K P(0,T) within MC error of the forward."""
    kw = dict(dyn=DEMO_VASICEK, sim=SIM, tile_rows=8)
    c = price_vasicek(OPT, payoff="vanilla_call", **kw)
    p = price_vasicek(OPT, payoff="vanilla_put", **kw)
    want = 100.0 - 100.0 * vasicek_zcb(0.1, 0.3, 0.05, 0.015, 1.0)
    got = float(c.price) - float(p.price)
    se = math.hypot(float(c.stderr), float(p.stderr))
    assert abs(got - want) <= 3.5 * se


def test_rho_monotonicity():
    """Equity/rate correlation feeds the forward's total variance:
    call value increases with rho (Sigma^2 has +2 rho sigma_s sigma_r
    (T-B)/a)."""
    kw = dict(sim=SIM, antithetic=True, tile_rows=8)
    lo = price_vasicek(OPT, VasicekDynamics(rho=-0.9), **kw)
    hi = price_vasicek(OPT, VasicekDynamics(rho=0.9), **kw)
    # closed-form spread is ~0.4; MC with shared-stream antithetic at
    # 200k paths resolves it
    assert float(hi.price) > float(lo.price)
    want_spread = (bsv_call(100, 100, 1, 0.1, 0.2, 0.3, 0.05, 0.015, 0.9)
                   - bsv_call(100, 100, 1, 0.1, 0.2, 0.3, 0.05, 0.015,
                              -0.9))
    se = math.hypot(float(hi.stderr), float(lo.stderr))
    assert abs((float(hi.price) - float(lo.price)) - want_spread) <= 4 * se


def test_path_dependent_payoffs_run():
    """Registry payoffs see the S path unchanged; bullet/Asian price
    positive under stochastic discounting."""
    sim = SimParams(n_paths=20_000, n_steps=8)
    b = price_vasicek(OptionParams(p1=1.0, p2=6.0), DEMO_VASICEK, sim,
                      payoff="bullet_call", tile_rows=8)
    a = price_vasicek(OPT, DEMO_VASICEK, sim, payoff="asian_call", tile_rows=8)
    assert float(b.price) > 0 and float(a.price) > 0
    assert float(b.stderr) > 0 and float(a.stderr) > 0


def test_odd_steps_rejected():
    with pytest.raises(ValueError, match="even n_steps"):
        price_vasicek(sim=SimParams(n_paths=1024, n_steps=7))


def test_zcb_payoff_under_gbm_engines():
    """The zcb payoff in the plain GBM engine prices e^{-rT} exactly
    (deterministic payoff of 1)."""
    from mc_tpu import price
    res = price(OPT, SimParams(n_paths=8192, n_steps=2), payoff="zcb",
                method="terminal", tile_rows=8)
    assert float(res.price) == pytest.approx(math.exp(-0.1), rel=1e-6)
    assert float(res.stderr) == 0.0
