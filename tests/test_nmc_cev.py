"""Nested MC under CEV — the generic-engine new-family proof
(`nmc_cev.py` is a dynamics definition only; everything else is
`nmc_engine`)."""

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.models.cev import DEMO_CEV, CEVDynamics, cev_call_closed_form
from mc_tpu.nmc_cev import price_nmc_cev
from mc_tpu.oracle import bs_call

OPT = OptionParams()


def test_ee_flat_at_cev_price():
    """Fully-discounted conditional value of a call is a martingale:
    EE_j == the Schroder closed-form CEV price at EVERY step."""
    sim = SimParams(n_paths=8192, n_steps=8, n_paths_inner=32)
    res = price_nmc_cev(sim=sim)
    want = cev_call_closed_form(100.0, 100.0, 1.0, 0.1,
                                DEMO_CEV.sigma_lv, DEMO_CEV.beta)
    ee, pfe = res.exposure_profile()
    np.testing.assert_allclose(np.asarray(ee), want, rtol=0.04)
    assert np.all(np.asarray(pfe) >= np.asarray(ee) - 1e-5)
    assert float(res.surface_mean) == pytest.approx(want, rel=0.03)


def test_beta_one_limit_matches_bs():
    """beta -> 1 with sigma_lv = 0.2 is GBM: surface mean ~= BS call."""
    sim = SimParams(n_paths=8192, n_steps=8, n_paths_inner=32)
    res = price_nmc_cev(dyn=CEVDynamics(sigma_lv=0.2, beta=1.0), sim=sim)
    want = float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2))
    assert float(res.surface_mean) == pytest.approx(want, rel=0.03)


def test_path_dependent_state_resumes():
    sim = SimParams(n_paths=2048, n_steps=8, n_paths_inner=4)
    res = price_nmc_cev(OptionParams(p1=1.0, p2=6.0), DEMO_CEV, sim,
                        payoff="bullet_call")
    assert np.all(np.isfinite(np.asarray(res.surface_matrix())))
    assert float(res.outer.stderr) > 0


def test_validation():
    with pytest.raises(ValueError, match="even n_steps"):
        price_nmc_cev(sim=SimParams(n_paths=256, n_steps=3,
                                    n_paths_inner=4))
    with pytest.raises(ValueError, match="counter"):
        price_nmc_cev(sim=SimParams(n_paths=256, n_steps=4096,
                                    n_paths_inner=1024))
