"""Discrete cash dividends: quadrature-oracle gate, model-exact
put-call parity, monotonicity, engine parity."""

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.models.dividends import (bs_call_cash_div, cash_div_forward,
                                     div_schedule, price_divs)
from mc_tpu.oracle import bs_call

SIM = SimParams(n_paths=400_000, n_steps=50)
OPT = OptionParams()


def test_zero_schedule_is_gbm():
    r = price_divs(sim=SIM)
    bs = float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2))
    assert abs(float(r.price) - bs) <= 3.5 * float(r.stderr)


def test_one_dividend_matches_quadrature_oracle():
    """One cash dividend at tau=0.5: the 1-D Gauss-Hermite oracle is
    exact for the scheme, so the gate is a plain z-score."""
    divs = div_schedule(50, [24], [5.0])
    r = price_divs(divs=divs, sim=SIM)
    want = bs_call_cash_div(100.0, 100.0, 1.0, 0.1, 0.2, 5.0, 0.5)
    assert abs(float(r.price) - want) <= 3.5 * float(r.stderr)


def test_put_call_parity_two_dividends():
    """C - P = e^{-rT}(E[S_T] - K) with the model-exact forward — holds
    for ANY schedule, no approximation."""
    divs = div_schedule(50, [12, 37], [3.0, 4.0])
    c = price_divs(OPT, divs, SIM, payoff="vanilla_call")
    p = price_divs(OPT, divs, SIM, payoff="vanilla_put")
    fwd = cash_div_forward(100.0, 1.0, 0.1, 0.2, divs, 50)
    lhs = float(c.price) - float(p.price)
    rhs = float(np.exp(-0.1) * (fwd - 100.0))
    joint = (float(c.stderr) ** 2 + float(p.stderr) ** 2) ** 0.5
    assert abs(lhs - rhs) <= 3.5 * joint


def test_dividends_lower_calls_raise_puts():
    divs = div_schedule(50, [24], [5.0])
    sim = SimParams(n_paths=100_000, n_steps=50)
    c0 = price_divs(OPT, None, sim, payoff="vanilla_call")
    cd = price_divs(OPT, divs, sim, payoff="vanilla_call")
    p0 = price_divs(OPT, None, sim, payoff="vanilla_put")
    pd = price_divs(OPT, divs, sim, payoff="vanilla_put")
    assert float(cd.price) < float(c0.price)
    assert float(pd.price) > float(p0.price)


def test_path_dependent_payoffs_see_post_div_path():
    divs = div_schedule(50, [12, 37], [3.0, 4.0])
    sim = SimParams(n_paths=50_000, n_steps=50)
    r = price_divs(divs=divs, sim=sim, payoff="asian_call")
    r0 = price_divs(sim=sim, payoff="asian_call")
    assert 0.0 < float(r.price) < float(r0.price)  # drops lower the mean


def test_validation():
    with pytest.raises(ValueError, match="even n_steps"):
        price_divs(sim=SimParams(n_paths=1024, n_steps=9))
    with pytest.raises(ValueError, match="shaped"):
        price_divs(divs=np.zeros(4, np.float32),
                   sim=SimParams(n_paths=1024, n_steps=10))
    with pytest.raises(ValueError, match="outside"):
        div_schedule(10, [10], [1.0])
    with pytest.raises(ValueError, match="negative"):
        div_schedule(10, [3], [-1.0])
    with pytest.raises(ValueError, match="tau"):
        bs_call_cash_div(100, 100, 1.0, 0.1, 0.2, 5.0, 1.5)
