"""CEV local-volatility model tests vs the noncentral-chi2 closed form."""

import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.models.cev import (CEVDynamics, cev_call_closed_form, price_cev)
from mc_tpu.oracle import bs_call

SIM = SimParams(n_paths=200_000, n_steps=100)


def test_closed_form_gbm_limit():
    """beta -> 1: CEV call approaches the BS price."""
    cf = cev_call_closed_form(100.0, 100.0, 1.0, 0.1,
                              sigma_lv=0.2 * 100.0 ** 0.01, beta=0.99)
    bs = float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2))
    assert cf == pytest.approx(bs, rel=5e-3)


def test_mc_matches_closed_form():
    cev = CEVDynamics.from_atm_vol(0.2, 0.5, 100.0)
    ref = cev_call_closed_form(100.0, 100.0, 1.0, 0.1,
                               float(cev.sigma_lv), 0.5)
    res = price_cev(OptionParams(), cev, SIM,
                    antithetic=True, tile_rows=64)
    # level-space Euler carries O(dt) bias; 4 se + 0.5%
    tol = 4.0 * float(res.stderr) + 0.005 * ref
    assert abs(float(res.price) - ref) <= tol, (float(res.price), ref)


def test_skew_direction():
    """beta < 1: OTM puts rich / OTM calls cheap vs GBM at ATM-matched vol
    (equity skew).  Compare ITM-call (=OTM-put by parity) vs BS."""
    cev = CEVDynamics.from_atm_vol(0.2, 0.5, 100.0)
    itm = cev_call_closed_form(100.0, 80.0, 1.0, 0.1, float(cev.sigma_lv),
                               0.5)
    itm_bs = float(bs_call(100.0, 80.0, 1.0, 0.1, 0.2))
    otm = cev_call_closed_form(100.0, 125.0, 1.0, 0.1, float(cev.sigma_lv),
                               0.5)
    otm_bs = float(bs_call(100.0, 125.0, 1.0, 0.1, 0.2))
    assert itm > itm_bs          # low-strike vol above ATM vol
    assert otm < otm_bs          # high-strike vol below ATM vol


def test_path_dependent_payoffs():
    sim = SimParams(n_paths=50_000, n_steps=20)
    cev = CEVDynamics.from_atm_vol(0.2, 0.7, 100.0)
    vanilla = price_cev(OptionParams(), cev, sim, tile_rows=8)
    asian = price_cev(OptionParams(), cev, sim, payoff="asian_call", tile_rows=8)
    assert 0.0 < float(asian.price) < float(vanilla.price)


def test_odd_steps_guard():
    with pytest.raises(ValueError, match="even"):
        price_cev(sim=SimParams(n_paths=1024, n_steps=7))
