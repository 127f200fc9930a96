"""Sharded model families: mesh invariance + single-chip bitwise identity."""

import jax
import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.parallel import SHARDED_MODELS, make_mesh, price_model_sharded

OPT = OptionParams(p1=1.0, p2=6.0)
SIM = SimParams(n_paths=8 * 2048, n_steps=8)

_SINGLE = {}


def _single_chip(model, **kw):
    if model == "term":
        from mc_tpu.models.term import TermStructure, price_term
        dyn = TermStructure.from_knots([0.10, 0.07, 0.05],
                                       [0.15, 0.22, 0.30], SIM.n_steps)
        return price_term(OPT, dyn, sim=SIM, **kw)
    if model == "localvol":
        from mc_tpu.models.localvol import LocalVolSurface, price_localvol
        dyn = LocalVolSurface.demo(SIM.n_steps)
        return price_localvol(OPT, dyn, sim=SIM, **kw)
    if model == "heston":
        from mc_tpu.models.heston import price_heston as fn
    elif model == "bates":
        from mc_tpu.models.bates import price_bates as fn
    elif model == "cev":
        from mc_tpu.models.cev import price_cev as fn
    elif model == "merton":
        from mc_tpu.models.merton import price_merton as fn
    elif model == "rainbow":
        from mc_tpu.models.rainbow import price_rainbow as fn
    elif model == "vasicek":
        from mc_tpu.models.vasicek import price_vasicek as fn
    elif model == "fx":
        from mc_tpu.models.fx import price_fx as fn  # quanto_call default
    else:
        from mc_tpu.models.sabr import price_sabr as fn
    return fn(OPT, sim=SIM, **kw)


@pytest.mark.parametrize("model", SHARDED_MODELS)
def test_one_device_mesh_bitwise_equals_single_chip(model):
    """A 1-device mesh must reproduce price_<model> BIT-for-BIT (same
    stream tag, same tiling, same fold/Kahan order)."""
    mesh = make_mesh(jax.devices()[:1])
    single = _single_chip(model, tile_rows=8)
    sharded = price_model_sharded(model, OPT, sim=SIM, mesh=mesh, tile_rows=8)
    assert float(single.price) == float(sharded.price), model
    assert float(single.stderr) == float(sharded.stderr), model


@pytest.mark.parametrize("model", SHARDED_MODELS)
def test_mesh_size_invariance(model):
    """1 vs 8 devices: identical statistics (global-path-id counters) up
    to psum regrouping of the Kahan slabs (~1e-6 rel)."""
    m1 = make_mesh(jax.devices()[:1])
    m8 = make_mesh(jax.devices()[:8])
    a = price_model_sharded(model, OPT, sim=SIM, mesh=m1, tile_rows=8)
    b = price_model_sharded(model, OPT, sim=SIM, mesh=m8, tile_rows=8)
    np.testing.assert_allclose(float(a.payoff_mean), float(b.payoff_mean),
                               rtol=1e-6)
    np.testing.assert_allclose(float(a.stderr), float(b.stderr), rtol=1e-5)


def test_sharded_bullet_payoff_under_heston():
    """Path-dependent payoff through the sharded model path."""
    mesh = make_mesh(jax.devices()[:4])
    res = price_model_sharded("heston", OPT, sim=SIM, mesh=mesh,
                              payoff="bullet_call", tile_rows=8)
    assert float(res.stderr) > 0.0
    assert np.isfinite(float(res.price))


def test_unknown_model_rejected():
    with pytest.raises(ValueError, match="unknown model"):
        price_model_sharded("bachelier")


def test_merton_odd_steps_rejected():
    with pytest.raises(ValueError, match="even n_steps"):
        price_model_sharded("merton", OPT,
                            sim=SimParams(n_paths=2048, n_steps=9))


def test_sharded_localvol_rejects_bad_knots():
    """The sharded localvol path must run the full validate_surface
    check (ADVICE r2): non-ascending knots raise instead of pricing NaN."""
    from mc_tpu.models.localvol import LocalVolSurface
    sim = SimParams(n_paths=2048, n_steps=10)
    good = LocalVolSurface.demo(sim.n_steps)
    import numpy as np
    xs = np.asarray(good.x_knots)[::-1].copy()  # descending
    bad = LocalVolSurface(x_knots=xs, vols=good.vols)
    with pytest.raises(ValueError, match="ascending"):
        price_model_sharded("localvol", OPT, bad, sim)


def test_sharded_validates_payoff():
    """price_model_sharded runs the payoff validate hook (ADVICE r2)."""
    opt = OptionParams(p1=999.0)
    with pytest.raises(ValueError, match="determination step"):
        price_model_sharded("heston", opt,
                            sim=SimParams(n_paths=2048, n_steps=10),
                            payoff="forward_start_call")
