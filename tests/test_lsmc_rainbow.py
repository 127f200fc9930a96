"""Multi-asset LSMC: American rainbow contracts on the per-asset cross
basis (`BasketNMC.lsmc_design`), exercise level = order statistic.

Gates: non-dividend American call-on-max equals the European Stulz
value (early exercise never optimal); American put-on-min carries a
positive early-exercise premium over `oracle.stulz_min_put`; d=1
collapses to the CRR binomial American; the cross-basis basket engine
agrees with the dedicated level-basis `price_american_basket` within
the two-pass policy gap."""

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.lsmc import (binomial_american, price_american_basket,
                         price_american_family, price_american_rainbow)
from mc_tpu.models.basket import BasketDynamics, _demo_basket
from mc_tpu.nmc_basket import BasketNMC
from mc_tpu.oracle import stulz_max_call, stulz_min_put

OPT = OptionParams()
SIM = SimParams(n_paths=16384, n_steps=10)


def _two_asset(rho=0.4):
    return BasketDynamics(
        s0s=np.array([100.0, 100.0], np.float32),
        sigmas=np.array([0.25, 0.2], np.float32),
        weights=np.array([0.5, 0.5], np.float32),
        corr=np.array([[1.0, rho], [rho, 1.0]], np.float32))


@pytest.mark.slow
def test_american_call_on_max_equals_european_stulz():
    """No dividends: early exercise of a best-of call is never optimal,
    so the American LSMC value must sit at the European closed form."""
    res = price_american_rainbow(OPT, _two_asset(), SIM, "call_on_max",
                                 degree=3)
    want = float(stulz_max_call(100.0, 100.0, 100.0, 1.0, 0.1,
                                0.25, 0.2, 0.4))
    assert float(res.price) == pytest.approx(want, rel=0.02)


@pytest.mark.slow
def test_american_put_on_min_premium():
    """r=10% makes early exercise of the worst-of put valuable: the
    American value must clear the European Stulz put decisively."""
    res = price_american_rainbow(OPT, _two_asset(), SIM, "put_on_min",
                                 degree=3)
    euro = float(stulz_min_put(100.0, 100.0, 100.0, 1.0, 0.1,
                               0.25, 0.2, 0.4))
    assert float(res.price) > euro + 2 * float(res.stderr)


@pytest.mark.slow
def test_d1_matches_crr_binomial():
    dyn = BasketDynamics(s0s=np.array([100.0], np.float32),
                         sigmas=np.array([0.2], np.float32),
                         weights=np.array([1.0], np.float32),
                         corr=np.eye(1, dtype=np.float32))
    sim = SimParams(n_paths=32768, n_steps=50)
    res = price_american_rainbow(OPT, dyn, sim, "put_on_min", degree=4)
    want = binomial_american(100.0, 100.0, 1.0, 0.1, 0.2, kind="put")
    # two-pass LSMC is low-biased; 50 exercise dates under-resolve the
    # continuous boundary slightly as well
    assert float(res.price) == pytest.approx(want, rel=0.02)
    assert float(res.price) <= want + 3 * float(res.stderr)


@pytest.mark.slow
def test_cross_basis_basket_vs_level_basis():
    """The generic family engine prices the basket American on the
    per-asset cross basis; the dedicated engine regresses on the basket
    level only.  Both are valid low-biased two-pass estimators of the
    same contract — they must agree within the policy gap, and the
    richer basis must not be WORSE (it can only improve the policy)."""
    dyn = _demo_basket(d=3, rho=0.5)
    cross = price_american_family(BasketNMC(extras=(3,)), OPT,
                                  dyn.as_f32(), SIM, "vanilla_put",
                                  degree=3)
    level = price_american_basket(OPT, dyn, SIM, payoff="vanilla_put",
                                  degree=3)
    assert float(cross.price) == pytest.approx(float(level.price),
                                               rel=0.03)
    assert (float(cross.price)
            >= float(level.price) - 3 * float(cross.stderr))


def test_bermudan_monotone_in_schedule():
    sim = SimParams(n_paths=8192, n_steps=8)
    amer = price_american_rainbow(OPT, _two_asset(), sim, "put_on_min")
    berm = price_american_rainbow(OPT, _two_asset(), sim, "put_on_min",
                                  exercise_every=4)
    assert float(amer.price) >= float(berm.price) - 3 * float(amer.stderr)


@pytest.mark.slow
def test_basket_bounds_bracket():
    """Andersen-Broadie dual on the d-asset family: the bracket holds
    and the duality gap is tight at the basket American put."""
    from mc_tpu.lsmc import american_bounds_family
    sim = SimParams(n_paths=8192, n_steps=8)
    lo, up = american_bounds_family("basket", OPT, _two_asset(), sim,
                                    "vanilla_put", n_outer=1024,
                                    n_inner=32)
    assert float(lo.price) <= float(up.price) + 1e-6
    assert (float(up.price) - float(lo.price)
            <= 0.15 * float(lo.price))


@pytest.mark.slow
def test_rainbow_bounds_bracket_stulz():
    """American call-on-max == European (no dividends): the AB bracket
    must contain the Stulz closed form; the worst-of put bracket holds
    above its European value."""
    from mc_tpu.lsmc import american_bounds_family
    sim = SimParams(n_paths=8192, n_steps=8)
    lo, up = american_bounds_family("rainbow", OPT, _two_asset(), sim,
                                    "call_on_max", n_outer=1024,
                                    n_inner=32)
    want = float(stulz_max_call(100.0, 100.0, 100.0, 1.0, 0.1,
                                0.25, 0.2, 0.4))
    assert float(lo.price) - 3 * float(lo.stderr) <= want
    assert want <= float(up.price) + 3 * float(up.stderr)

    lo2, up2 = american_bounds_family("rainbow", OPT, _two_asset(), sim,
                                      "put_on_min", n_outer=1024,
                                      n_inner=32)
    euro = float(stulz_min_put(100.0, 100.0, 100.0, 1.0, 0.1,
                               0.25, 0.2, 0.4))
    assert float(lo2.price) <= float(up2.price) + 1e-6
    assert float(up2.price) > euro  # early-exercise premium survives


