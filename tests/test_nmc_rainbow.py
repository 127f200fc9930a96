"""Rainbow NMC: order-statistic exposure under correlation.

Gates: fully-discounted call-on-max EE is a martingale, flat at the
Stulz (1982) closed form at every step; put-on-min against
`oracle.stulz_min_put`; d=1 max/min bitwise degeneracy; pallas/XLA
bitwise parity; mesh wiring through `price_nmc_model_sharded`."""

import jax
import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.models.basket import BasketDynamics, _demo_basket
from mc_tpu.nmc_rainbow import price_nmc_rainbow
from mc_tpu.oracle import bs_call, stulz_max_call, stulz_min_put

SIM = SimParams(n_paths=4096, n_steps=8, n_paths_inner=16)
OPT = OptionParams()


def _two_asset(rho=0.4):
    return BasketDynamics(
        s0s=np.array([100.0, 100.0], np.float32),
        sigmas=np.array([0.25, 0.2], np.float32),
        weights=np.array([0.5, 0.5], np.float32),
        corr=np.array([[1.0, rho], [rho, 1.0]], np.float32))


@pytest.mark.slow
def test_ee_flat_at_stulz_max_call():
    """Fully-discounted conditional call-on-max value is a martingale:
    EE_j flat at the Stulz closed form at EVERY step."""
    sim = SimParams(n_paths=8192, n_steps=8, n_paths_inner=32)
    res = price_nmc_rainbow(OPT, _two_asset(), sim, "call_on_max")
    want = float(stulz_max_call(100.0, 100.0, 100.0, 1.0, 0.1,
                                0.25, 0.2, 0.4))
    ee, pfe = res.exposure_profile()
    np.testing.assert_allclose(np.asarray(ee), want, rtol=0.04)
    assert np.all(np.asarray(pfe) >= np.asarray(ee) - 1e-5)
    assert float(res.surface_mean) == pytest.approx(want, rel=0.03)


@pytest.mark.slow
def test_put_on_min_vs_stulz():
    sim = SimParams(n_paths=8192, n_steps=8, n_paths_inner=32)
    res = price_nmc_rainbow(OPT, _two_asset(), sim, "put_on_min")
    want = float(stulz_min_put(100.0, 100.0, 100.0, 1.0, 0.1,
                               0.25, 0.2, 0.4))
    assert float(res.surface_mean) == pytest.approx(want, rel=0.05)


def test_d1_max_equals_min_bitwise():
    """With one asset the order statistic IS the asset: the max and min
    families run the identical program on the identical stream."""
    dyn = _demo_basket(d=1)
    a = price_nmc_rainbow(OPT, dyn, SIM, "call_on_max")
    b = price_nmc_rainbow(OPT, dyn, SIM, "call_on_min")
    assert float(a.outer.price) == float(b.outer.price)
    np.testing.assert_array_equal(np.asarray(a.surface),
                                  np.asarray(b.surface))


@pytest.mark.slow
def test_d1_degenerates_to_bs():
    dyn = BasketDynamics(s0s=np.array([100.0], np.float32),
                         sigmas=np.array([0.2], np.float32),
                         weights=np.array([1.0], np.float32),
                         corr=np.eye(1, dtype=np.float32))
    sim = SimParams(n_paths=8192, n_steps=8, n_paths_inner=32)
    res = price_nmc_rainbow(OPT, dyn, sim, "call_on_max")
    want = float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2))
    assert float(res.surface_mean) == pytest.approx(want, rel=0.03)


def test_correlation_orders_best_of():
    """Lower correlation raises the best-of call (more dispersion in
    the maximum): surface means strictly ordered in rho."""
    def mean(rho):
        r = price_nmc_rainbow(OPT, _two_asset(rho), SIM, "call_on_max")
        return float(r.surface_mean)
    assert mean(0.0) > mean(0.9)


def test_sharded_one_device_bitwise():
    from mc_tpu.parallel import make_mesh, price_nmc_model_sharded
    single = price_nmc_rainbow(sim=SIM, tile_rows=8)
    m1 = price_nmc_model_sharded("rainbow", sim=SIM,
                                 mesh=make_mesh(jax.devices()[:1]),
                                 tile_rows=8)
    assert float(m1.outer.price) == float(single.outer.price)
    np.testing.assert_array_equal(np.asarray(m1.surface),
                                  np.asarray(single.surface))


