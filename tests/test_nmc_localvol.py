"""Nested MC under a local-vol smile: martingale exposure gates."""

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.models.localvol import LocalVolSurface
from mc_tpu.nmc_localvol import price_nmc_localvol
from mc_tpu.oracle import bs_call

SIM = SimParams(n_paths=4096, n_steps=8, n_paths_inner=16)
OPT = OptionParams()


def test_flat_surface_ee_flat_at_bs():
    """Flat surface + non-negative payoff: the fully-discounted
    conditional value is a martingale, so EE_j == the BS price at EVERY
    step (the smile analogue of the zcb gate)."""
    sim = SimParams(n_paths=8192, n_steps=8, n_paths_inner=32)
    res = price_nmc_localvol(OPT, LocalVolSurface.flat(0.2, 8), sim)
    want = float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2))
    ee, pfe = res.exposure_profile()
    np.testing.assert_allclose(np.asarray(ee), want, rtol=0.04)
    assert np.all(np.asarray(pfe) >= np.asarray(ee) - 1e-5)
    assert float(res.surface_mean) == pytest.approx(want, rel=0.03)


def test_tower_property_under_smile():
    """Surface mean == outer price under the demo smile (tower)."""
    sim = SimParams(n_paths=16_384, n_steps=8, n_paths_inner=32)
    res = price_nmc_localvol(OPT, LocalVolSurface.demo(8), sim)
    assert float(res.surface_mean) == pytest.approx(
        float(res.outer.price), rel=0.05)
    assert float(res.outer.stderr) > 0


def test_smile_widens_exposure_quantiles():
    """A strong smile disperses conditional values: the late-step
    PFE-EE gap exceeds the flat-surface gap (EE itself is pinned by the
    martingale property)."""
    def gap(surface):
        r = price_nmc_localvol(OPT, surface, SIM)
        ee, pfe = r.exposure_profile()
        return float(np.asarray(pfe)[-1] - np.asarray(ee)[-1])
    strong = LocalVolSurface.from_function(
        lambda x, t: 0.2 + 0.6 * x * x, 8)
    assert gap(strong) > gap(LocalVolSurface.flat(0.2, 8))


def test_path_dependent_state_resumes():
    sim = SimParams(n_paths=2048, n_steps=8, n_paths_inner=4)
    res = price_nmc_localvol(OptionParams(p1=1.0, p2=6.0),
                             LocalVolSurface.demo(8), sim,
                             payoff="bullet_call")
    assert np.all(np.isfinite(np.asarray(res.surface_matrix())))
    assert float(res.outer.stderr) > 0


def test_validation():
    with pytest.raises(ValueError, match="surface has"):
        price_nmc_localvol(surf=LocalVolSurface.flat(0.2, 4),
                           sim=SimParams(n_paths=256, n_steps=8,
                                         n_paths_inner=4))
    with pytest.raises(ValueError, match="counter"):
        price_nmc_localvol(surf=LocalVolSurface.flat(0.2, 4096),
                           sim=SimParams(n_paths=256, n_steps=4096,
                                         n_paths_inner=512))
    bad = LocalVolSurface(x_knots=np.array([0.5, -0.5], np.float32),
                          vols=np.full((8, 2), 0.2, np.float32))
    with pytest.raises(ValueError, match="ascending"):
        price_nmc_localvol(surf=bad, sim=SIM)
