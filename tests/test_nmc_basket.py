"""Multi-asset NMC: d-asset resume state, Margrabe exposure gate,
martingale EE, GBM degeneracy."""

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.models.basket import BasketDynamics, price_basket
from mc_tpu.nmc_basket import price_nmc_basket
from mc_tpu.oracle import bs_call, margrabe

SIM = SimParams(n_paths=4096, n_steps=8, n_paths_inner=16)
OPT = OptionParams()


def test_ee_flat_at_basket_call_price():
    """Fully-discounted conditional basket-call value is a martingale:
    EE_j flat at the time-0 basket price (high-path MC reference)."""
    sim = SimParams(n_paths=8192, n_steps=8, n_paths_inner=32)
    res = price_nmc_basket(sim=sim)
    ref = price_basket(sim=SimParams(n_paths=400_000, n_steps=8))
    ee, pfe = res.exposure_profile()
    np.testing.assert_allclose(np.asarray(ee), float(ref.price), rtol=0.04)
    assert np.all(np.asarray(pfe) >= np.asarray(ee) - 1e-5)


def test_margrabe_exposure_flat_at_closed_form():
    """Weights (1, -1) + k=0 make vanilla_call the exchange option:
    EE flat at the Margrabe (1978) closed form at EVERY step."""
    dyn = BasketDynamics(
        s0s=np.array([100.0, 95.0], np.float32),
        sigmas=np.array([0.25, 0.2], np.float32),
        weights=np.array([1.0, -1.0], np.float32),
        corr=np.array([[1.0, 0.4], [0.4, 1.0]], np.float32))
    sim = SimParams(n_paths=8192, n_steps=8, n_paths_inner=32)
    res = price_nmc_basket(OptionParams(k=0.0), dyn, sim)
    want = margrabe(100.0, 95.0, 1.0, 0.25, 0.2, 0.4)
    ee, _ = res.exposure_profile()
    np.testing.assert_allclose(np.asarray(ee), want, rtol=0.04)
    assert float(res.surface_mean) == pytest.approx(want, rel=0.03)


def test_d1_degenerates_to_gbm():
    """A 1-asset basket is GBM: surface mean ~= BS (the stream follows
    price_basket's pair-per-step layout, so the check is distributional,
    not bitwise — see module docstring)."""
    dyn = BasketDynamics(s0s=np.array([100.0], np.float32),
                         sigmas=np.array([0.2], np.float32),
                         weights=np.array([1.0], np.float32),
                         corr=np.eye(1, dtype=np.float32))
    sim = SimParams(n_paths=8192, n_steps=8, n_paths_inner=32)
    res = price_nmc_basket(OPT, dyn, sim)
    want = float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2))
    assert float(res.surface_mean) == pytest.approx(want, rel=0.03)


def test_path_dependent_state_resumes():
    res = price_nmc_basket(OptionParams(p1=1.0, p2=6.0), sim=SIM,
                           payoff="bullet_call")
    assert np.all(np.isfinite(np.asarray(res.surface_matrix())))
    assert float(res.outer.stderr) > 0


def test_correlation_moves_exposure_tail():
    """Higher correlation widens the basket's conditional distribution:
    late-step PFE increases with rho (EE pinned by the martingale)."""
    def pfe_last(rho):
        corr = np.full((3, 3), rho, np.float32)
        np.fill_diagonal(corr, 1.0)
        dyn = BasketDynamics(s0s=np.full(3, 100.0, np.float32),
                             sigmas=np.full(3, 0.2, np.float32),
                             weights=np.full(3, 1 / 3, np.float32),
                             corr=corr)
        r = price_nmc_basket(OPT, dyn, SIM)
        _, pfe = r.exposure_profile()
        return float(np.asarray(pfe)[-1])
    assert pfe_last(0.8) > pfe_last(0.0)
