"""Nested MC under Merton jumps: tower property, engines, crash-risk CVA."""

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.models.merton import DEMO_MERTON, merton_call_closed_form
from mc_tpu.nmc_merton import price_nmc_merton

OPT = OptionParams()
SIM = SimParams(n_paths=4096, n_steps=10, n_paths_inner=64)


def test_tower_property():
    """For a European payoff the conditional value at EVERY point has the
    same expectation: surface_mean ~ the European Merton price."""
    res = price_nmc_merton(OPT, DEMO_MERTON, SIM)
    ref = merton_call_closed_form(100.0, 100.0, 1.0, 0.1, 0.2,
                                  lam=0.3, mu_j=-0.10, sigma_j=0.15)
    # surface_mean averages n_paths*n_steps correlated estimates
    assert float(res.surface_mean) == pytest.approx(ref, rel=0.05), (
        float(res.surface_mean), ref)
    # outer estimate agrees with the oracle within its own stderr
    assert abs(float(res.outer.price) - ref) <= 4.0 * float(res.outer.stderr)


def test_deterministic_last_step():
    """At the last stored point (j = n_steps-1) zero substeps remain: the
    conditional value is the discounted payoff at the stored state."""
    res = price_nmc_merton(OPT, DEMO_MERTON, SIM,
                           payoff="vanilla_call")
    surf = np.asarray(res.surface)  # (n_steps, rows, 128)
    last = surf[-1].ravel()[: SIM.n_paths]
    assert np.isfinite(last).all()
    assert (last >= 0.0).all()


def test_jumps_fatten_the_exposure_tail():
    """PFE(97.5%) under jumps exceeds the no-jump profile at matched
    diffusion vol — the XVA case for jump models."""
    from mc_tpu.models.merton import MertonDynamics
    nj = price_nmc_merton(OPT, MertonDynamics(lam=0.0), SIM)
    wj = price_nmc_merton(OPT, MertonDynamics(lam=1.0, mu_j=0.05,
                                              sigma_j=0.25), SIM)
    q = 0.975
    # compare the mean over dates of the per-date 97.5% exposure quantile
    def pfe(res):
        surf = np.asarray(res.surface)[:, : SIM.n_paths // 128, :]
        ee = np.maximum(surf, 0.0).reshape(SIM.n_steps, -1)
        return np.quantile(ee, q, axis=1).mean()

    assert pfe(wj) > pfe(nj)


def test_cva_under_jumps_exceeds_no_jump():
    from mc_tpu.models.merton import MertonDynamics
    nj = price_nmc_merton(OPT, MertonDynamics(lam=0.0), SIM)
    wj = price_nmc_merton(OPT, MertonDynamics(lam=1.0, mu_j=0.05,
                                              sigma_j=0.25), SIM)
    cva_nj = float(nj.cva(hazard_rate=0.02, recovery=0.4))
    cva_wj = float(wj.cva(hazard_rate=0.02, recovery=0.4))
    assert cva_wj > cva_nj > 0.0


def test_guards():
    with pytest.raises(ValueError, match="even n_steps"):
        price_nmc_merton(sim=SimParams(n_paths=1024, n_steps=9,
                                       n_paths_inner=8))
    with pytest.raises(ValueError, match="counter space"):
        price_nmc_merton(sim=SimParams(n_paths=1024, n_steps=40_000,
                                       n_paths_inner=4000))
