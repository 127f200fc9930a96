"""SABR model tests vs the Hagan (2002) implied-vol expansion."""

import math

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.models.sabr import (DEMO_SABR, SABRDynamics, price_sabr,
                                sabr_call_hagan, sabr_implied_vol)
from mc_tpu.oracle import bs_call, bs_implied_vol

OPT = OptionParams()
SIM = SimParams(n_paths=200_000, n_steps=100)


def test_hagan_black_limit():
    """nu -> 0, beta = 1: SABR degenerates to Black-Scholes vol alpha."""
    iv = sabr_implied_vol(100.0, 110.0, 1.0, alpha=0.2, beta=1.0,
                          nu=1e-8, rho=0.0)
    assert iv == pytest.approx(0.2, abs=1e-6)
    p = sabr_call_hagan(100.0, 100.0, 1.0, 0.1, alpha=0.2, beta=1.0,
                        nu=1e-8, rho=0.0)
    assert p == pytest.approx(float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2)),
                              rel=1e-5)


def test_hagan_atm_continuity():
    """The ATM branch (z/x(z) -> 1) joins the smile branch smoothly."""
    lo = sabr_implied_vol(100.0, 99.999, 1.0, 0.2, 0.7, 0.4, -0.4)
    at = sabr_implied_vol(100.0, 100.0, 1.0, 0.2, 0.7, 0.4, -0.4)
    hi = sabr_implied_vol(100.0, 100.001, 1.0, 0.2, 0.7, 0.4, -0.4)
    assert lo == pytest.approx(at, rel=1e-4)
    assert hi == pytest.approx(at, rel=1e-4)


def test_mc_lognormal_limit_matches_bs():
    """beta=1, nu tiny: the MC scheme is exact lognormal stepping — price
    must hit BS within pure MC noise (no discretization bias)."""
    dyn = SABRDynamics(alpha=0.2, beta=1.0, nu=1e-6, rho=0.0)
    res = price_sabr(OPT, dyn, SIM, antithetic=True,
                     tile_rows=64)
    bs = float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2))
    assert abs(float(res.price) - bs) <= 4.0 * float(res.stderr), (
        float(res.price), bs, float(res.stderr))


def test_mc_matches_hagan_within_expansion_error():
    """Full SABR vs Hagan: agreement within MC noise + the documented
    O(T) accuracy of the expansion (~1% here)."""
    ref = sabr_call_hagan(100.0, 100.0, 1.0, 0.1, alpha=0.2, beta=1.0,
                          nu=0.4, rho=-0.4)
    res = price_sabr(OPT, DEMO_SABR, SIM, antithetic=True,
                     tile_rows=64)
    tol = 4.0 * float(res.stderr) + 0.01 * ref
    assert abs(float(res.price) - ref) <= tol, (
        float(res.price), ref, float(res.stderr))


def test_mc_smile_slope_matches_hagan():
    """Invert MC prices on a strike ladder back to implied vols: with
    rho < 0 the smile slopes down, and each point sits near Hagan."""
    strikes = (85.0, 100.0, 115.0)
    ivs_mc, ivs_hagan = [], []
    for k in strikes:
        opt = OptionParams(k=k)
        res = price_sabr(opt, DEMO_SABR, SIM,
                         antithetic=True, tile_rows=64)
        ivs_mc.append(float(bs_implied_vol(res.price, 100.0, k, 1.0, 0.1)))
        f = 100.0 * math.exp(0.1)
        ivs_hagan.append(sabr_implied_vol(f, k, 1.0, 0.2, 1.0, 0.4, -0.4))
    assert ivs_mc[0] > ivs_mc[1] > ivs_mc[2]      # downward smile
    for mc, hg in zip(ivs_mc, ivs_hagan):
        assert mc == pytest.approx(hg, abs=0.01), (ivs_mc, ivs_hagan)


def test_beta_backbone():
    """beta < 1 tilts the backbone: OTM-put wing rich vs the beta=1 smile
    at matched ATM vol (equity-style skew from the CEV part alone)."""
    f = 100.0 * math.exp(0.1)
    # alpha scaled so ATM lognormal vol matches across betas
    lo = sabr_implied_vol(f, 80.0, 1.0, 0.2 * f ** 0.5, 0.5, 1e-8, 0.0)
    hi = sabr_implied_vol(f, 125.0, 1.0, 0.2 * f ** 0.5, 0.5, 1e-8, 0.0)
    assert lo > hi


def test_path_payoff_on_forward():
    """Asian on the forward path: positive, below the vanilla."""
    asian = price_sabr(OPT, DEMO_SABR, SIM, payoff="asian_call", tile_rows=64)
    vanilla = price_sabr(OPT, DEMO_SABR, SIM, tile_rows=64)
    assert 0.0 < float(asian.price)
    # forward path drifts from S0 e^{(r-q)T}: the running mean sits ABOVE
    # the spot-path mean, but still below the terminal-payoff call value
    assert float(asian.price) < 1.5 * float(vanilla.price)


def test_price_sabr_validates_payoff():
    """price_sabr runs the payoff validate hook (ADVICE r2): a cliquet
    with floor > cap must raise instead of pricing the degenerate leg."""
    opt = OptionParams(k=10.0, p1=0.5, p2=0.1)
    with pytest.raises(ValueError, match="floor"):
        price_sabr(opt, DEMO_SABR, SimParams(n_paths=2048, n_steps=10),
                   payoff="cliquet")
