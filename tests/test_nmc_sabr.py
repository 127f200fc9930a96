"""Nested MC under SABR on the generic engine: martingale EE on the
forward measure, engine parity, lognormal-limit gate."""

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.models.sabr import DEMO_SABR, SABRDynamics, price_sabr
from mc_tpu.nmc_sabr import price_nmc_sabr
from mc_tpu.oracle import bs_call

OPT = OptionParams()


def test_ee_flat_at_sabr_price():
    """F is a forward-measure martingale, so the fully-discounted
    conditional call value is flat at the time-0 SABR price."""
    sim = SimParams(n_paths=8192, n_steps=8, n_paths_inner=32)
    res = price_nmc_sabr(sim=sim)
    ref = price_sabr(sim=SimParams(n_paths=400_000, n_steps=8))
    ee, pfe = res.exposure_profile()
    np.testing.assert_allclose(np.asarray(ee), float(ref.price),
                               rtol=0.04)
    assert np.all(np.asarray(pfe) >= np.asarray(ee) - 1e-5)
    assert float(res.surface_mean) == pytest.approx(float(ref.price),
                                                    rel=0.03)


def test_lognormal_limit_matches_bs():
    """nu -> 0, beta = 1 is Black on the forward: surface mean ~= BS."""
    dyn = SABRDynamics(alpha=0.2, beta=1.0, nu=1e-6, rho=0.0)
    sim = SimParams(n_paths=8192, n_steps=8, n_paths_inner=32)
    res = price_nmc_sabr(OPT, dyn, sim)
    want = float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2))
    assert float(res.surface_mean) == pytest.approx(want, rel=0.03)


def test_path_dependent_state_resumes():
    sim = SimParams(n_paths=2048, n_steps=8, n_paths_inner=4)
    res = price_nmc_sabr(OptionParams(p1=1.0, p2=6.0), DEMO_SABR, sim,
                         payoff="bullet_call")
    assert np.all(np.isfinite(np.asarray(res.surface_matrix())))
    assert float(res.outer.stderr) > 0


def test_validation():
    with pytest.raises(ValueError, match="counter"):
        price_nmc_sabr(sim=SimParams(n_paths=256, n_steps=66_000,
                                     n_paths_inner=1024))
