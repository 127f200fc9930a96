"""Nested MC under term structures on the generic engine."""

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.models.term import TermStructure, price_term
from mc_tpu.nmc_term import price_nmc_term

OPT = OptionParams()


def _dyn(n):
    return TermStructure.from_knots([0.10, 0.07, 0.05],
                                    [0.15, 0.22, 0.30], n)


def test_ee_flat_at_term_price():
    """Scalar e^{-r_bar T} discounting makes the conditional call value
    a martingale: EE flat at the time-0 term-structure price."""
    sim = SimParams(n_paths=8192, n_steps=8, n_paths_inner=32)
    res = price_nmc_term(OPT, _dyn(8), sim)
    ref = price_term(OPT, _dyn(8),
                     SimParams(n_paths=400_000, n_steps=8))
    ee, pfe = res.exposure_profile()
    np.testing.assert_allclose(np.asarray(ee), float(ref.price),
                               rtol=0.04)
    assert np.all(np.asarray(pfe) >= np.asarray(ee) - 1e-5)
    assert float(res.surface_mean) == pytest.approx(float(ref.price),
                                                    rel=0.03)


def test_flat_curves_match_gbm_nmc_stats():
    """Flat curves = GBM: surface mean ~= BS."""
    from mc_tpu.oracle import bs_call
    dyn = TermStructure.from_knots([0.1, 0.1], [0.2, 0.2], 8)
    sim = SimParams(n_paths=8192, n_steps=8, n_paths_inner=32)
    res = price_nmc_term(OPT, dyn, sim)
    want = float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2))
    assert float(res.surface_mean) == pytest.approx(want, rel=0.03)


def test_validation():
    with pytest.raises(ValueError, match="term structure has"):
        price_nmc_term(OPT, _dyn(4),
                       SimParams(n_paths=256, n_steps=8, n_paths_inner=4))
    with pytest.raises(ValueError, match="even n_steps"):
        price_nmc_term(OPT, _dyn(5),
                       SimParams(n_paths=256, n_steps=5, n_paths_inner=4))
