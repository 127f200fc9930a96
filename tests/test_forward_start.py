"""Forward-start and cliquet payoffs: Rubinstein / call-spread gates."""

import math

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams, price
from mc_tpu.oracle import bs_call, bs_cliquet, bs_forward_start_call

SIM = SimParams(n_paths=200_000, n_steps=20)


def _gate(res, want, n_se=3.5):
    assert abs(float(res.price) - want) <= n_se * float(res.stderr), (
        float(res.price), want, float(res.stderr),
        (float(res.price) - want) / float(res.stderr))


@pytest.mark.parametrize("k_ratio", [0.9, 1.0, 1.1])
def test_forward_start_rubinstein_gate(k_ratio):
    """Strike fixes halfway (step 10 of 20 => t1 = 0.5)."""
    opt = OptionParams(k=k_ratio, p1=10.0)
    res = price(opt, SIM, payoff="forward_start_call", method="euler", antithetic=True, tile_rows=8)
    _gate(res, bs_forward_start_call(100.0, k_ratio, 0.5, 1.0, 0.1, 0.2))


def test_forward_start_t1_zero_is_vanilla():
    """p1=0: the strike fixes at S0 — a vanilla call struck at k*S0."""
    opt = OptionParams(k=1.0, p1=0.0)
    res = price(opt, SIM, payoff="forward_start_call", method="euler", antithetic=True, tile_rows=8)
    _gate(res, float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2)))


def test_forward_start_with_dividend():
    opt = OptionParams(k=1.0, p1=10.0, q=0.03)
    res = price(opt, SIM, payoff="forward_start_call", method="euler", antithetic=True, tile_rows=8)
    _gate(res, bs_forward_start_call(100.0, 1.0, 0.5, 1.0, 0.1, 0.2,
                                     q=0.03))


def test_cliquet_closed_form_gate():
    """4 periods of 5 steps, floor -2%, cap +4%."""
    opt = OptionParams(k=5.0, p1=-0.02, p2=0.04)
    res = price(opt, SIM, payoff="cliquet", method="euler",
                antithetic=True, tile_rows=8)
    _gate(res, bs_cliquet(4, 0.25, -0.02, 0.04, 1.0, 0.1, 0.2))


def test_cliquet_uncapped_forward_identity():
    """floor=-inf-ish, cap=+inf-ish: E[clamp] = E[R-1] = e^{(r-q)dt}-1,
    so the value is e^{-rT} n (e^{(r-q)dt}-1) exactly."""
    opt = OptionParams(k=5.0, p1=-100.0, p2=100.0)
    res = price(opt, SIM, payoff="cliquet", method="euler",
                antithetic=True, tile_rows=8)
    want = math.exp(-0.1) * 4 * (math.exp(0.1 * 0.25) - 1.0)
    _gate(res, want)
    # and the oracle agrees with the identity
    assert bs_cliquet(4, 0.25, -100.0, 100.0, 1.0, 0.1, 0.2) == \
        pytest.approx(want, rel=1e-9)


def test_cliquet_cap_monotone():
    """A higher cap can only raise the value (pathwise dominance) —
    exact on the same key."""
    kw = dict(sim=SIM, payoff="cliquet", method="euler",
              tile_rows=8)
    lo = price(OptionParams(k=5.0, p1=-0.02, p2=0.02), **kw)
    hi = price(OptionParams(k=5.0, p1=-0.02, p2=0.08), **kw)
    assert float(hi.price) >= float(lo.price)


def test_validation():
    """Out-of-range / non-integer step parameters are rejected at entry
    instead of silently mispricing."""
    sim = SimParams(n_paths=1024, n_steps=20)
    with pytest.raises(ValueError, match="determination step"):
        price(OptionParams(k=1.0, p1=50.0), sim,
              payoff="forward_start_call", method="euler")
    with pytest.raises(ValueError, match="determination step"):
        price(OptionParams(k=1.0, p1=10.5), sim,
              payoff="forward_start_call", method="euler")
    with pytest.raises(ValueError, match="period length"):
        price(OptionParams(k=0.0, p1=-0.02, p2=0.04), sim,
              payoff="cliquet", method="euler")
    with pytest.raises(ValueError, match="floor"):
        price(OptionParams(k=5.0, p1=0.04, p2=-0.02), sim,
              payoff="cliquet", method="euler")


def test_engines_bitwise():
    sim = SimParams(n_paths=50_000, n_steps=20)
    for payoff, opt in (("forward_start_call",
                         OptionParams(k=1.0, p1=10.0)),
                        ("cliquet",
                         OptionParams(k=5.0, p1=-0.02, p2=0.04))):
        a = price(opt, sim, payoff=payoff, method="euler",
                  engine="pallas", interpret=True, tile_rows=8)
        b = price(opt, sim, payoff=payoff, method="euler",
                  tile_rows=8)
        assert float(a.price) == float(b.price), payoff
        assert float(a.stderr) == float(b.stderr), payoff
