"""Sharded model-family NMC: 1-device-mesh bitwise vs single-chip,
mesh-size invariance, sharded surface layout."""

import jax
import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.parallel import make_mesh, price_nmc_model_sharded

SIM = SimParams(n_paths=2048, n_steps=8, n_paths_inner=8)
OPT = OptionParams()

SINGLE = {
    "heston": lambda **kw: __import__(
        "mc_tpu.nmc_heston", fromlist=["x"]).price_nmc_heston(**kw),
    "vasicek": lambda **kw: __import__(
        "mc_tpu.nmc_vasicek", fromlist=["x"]).price_nmc_vasicek(**kw),
    "cev": lambda **kw: __import__(
        "mc_tpu.nmc_cev", fromlist=["x"]).price_nmc_cev(**kw),
    "sabr": lambda **kw: __import__(
        "mc_tpu.nmc_sabr", fromlist=["x"]).price_nmc_sabr(**kw),
}


@pytest.mark.parametrize("model", sorted(SINGLE))
def test_one_device_mesh_bitwise(model):
    single = SINGLE[model](sim=SIM, tile_rows=8)
    m1 = price_nmc_model_sharded(model, sim=SIM,
                                 mesh=make_mesh(jax.devices()[:1]),
                                 tile_rows=8)
    assert float(m1.outer.price) == float(single.outer.price)
    assert float(m1.outer.stderr) == float(single.outer.stderr)
    np.testing.assert_array_equal(np.asarray(m1.surface),
                                  np.asarray(single.surface))


@pytest.mark.parametrize("model", ("heston", "merton", "localvol",
                                   "basket"))
def test_mesh_size_invariance(model):
    m1 = price_nmc_model_sharded(model, sim=SIM,
                                 mesh=make_mesh(jax.devices()[:1]),
                                 tile_rows=8)
    m4 = price_nmc_model_sharded(model, sim=SIM,
                                 mesh=make_mesh(jax.devices()[:4]),
                                 tile_rows=8)
    m8 = price_nmc_model_sharded(model, sim=SIM,
                                 mesh=make_mesh(jax.devices()[:8]),
                                 tile_rows=8)
    assert (float(m1.outer.price) == float(m4.outer.price)
            == float(m8.outer.price))
    assert float(m1.surface_mean) == pytest.approx(
        float(m8.surface_mean), rel=1e-6)
    # per-shard tile padding makes the padded row counts differ across
    # mesh sizes; the VALID-path view must be bitwise mesh-invariant
    np.testing.assert_array_equal(np.asarray(m4.surface_matrix()),
                                  np.asarray(m8.surface_matrix()))


def test_exposure_from_sharded_surface():
    """The sharded surface feeds the same exposure machinery."""
    res = price_nmc_model_sharded("heston", sim=SIM,
                                  mesh=make_mesh(jax.devices()[:4]),
                                  tile_rows=8)
    ee, pfe = res.exposure_profile()
    assert np.all(np.isfinite(np.asarray(ee)))
    assert np.all(np.asarray(pfe) >= np.asarray(ee) - 1e-5)


def test_unknown_model_rejected():
    with pytest.raises(ValueError, match="unknown model family"):
        price_nmc_model_sharded("bachelier")
