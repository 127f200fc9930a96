"""Netting-set NMC tests: B=1 degeneracy, netting subadditivity,
long/short collapse, CRN engine parity."""

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.nmc import price_nmc
from mc_tpu.nmc_book import price_nmc_book

SIM = SimParams(n_paths=2048, n_steps=8, n_paths_inner=8)


def _book(ks, **kw):
    fields = dict(k=np.asarray(ks, np.float32))
    fields.update({f: np.asarray(v, np.float32) for f, v in kw.items()})
    return OptionParams(**fields)


def test_b1_bitwise_equals_price_nmc():
    opt = _book([100.0], p1=[1.0], p2=[6.0])
    b = price_nmc_book(opt, SIM, payoff="bullet_call", tile_rows=8)
    s = price_nmc(OptionParams(p1=1.0, p2=6.0), SIM, payoff="bullet_call",
                  tile_rows=8)
    np.testing.assert_array_equal(np.asarray(b.net_surface),
                                  np.asarray(s.surface))
    assert float(b.outers.price[0]) == float(s.outer.price)
    assert float(b.outers.stderr[0]) == float(s.outer.stderr)


def test_netting_subadditivity():
    """EE_net <= sum_b EE_b at every step — the netting-agreement
    inequality the netted profile exists to capture."""
    opt = _book([90.0, 100.0, 110.0])
    w = np.array([1.0, -2.0, 1.0], np.float32)
    r = price_nmc_book(opt, SIM, payoff="vanilla_call", weights=w)
    ee_net, pfe_net = r.exposure_profile()
    sum_ee = np.asarray(r.ee_contract).sum(axis=0)
    assert np.all(np.asarray(ee_net) <= sum_ee + 1e-5)
    assert np.all(np.asarray(pfe_net) >= np.asarray(ee_net) - 1e-5)
    # netting must BITE for a long/short book: strictly below the sum
    assert float(np.asarray(ee_net)[-1]) < float(sum_ee[-1]) - 1e-3


def test_long_short_collapse():
    """+1/-1 of the SAME contract nets to exactly zero exposure at every
    point (CRN makes the conditional values identical, not just equal in
    law)."""
    opt = _book([100.0, 100.0])
    r = price_nmc_book(opt, SIM, payoff="vanilla_call",
                       weights=[1.0, -1.0])
    np.testing.assert_array_equal(np.asarray(r.net_surface),
                                  np.zeros_like(np.asarray(r.net_surface)))
    assert float(r.net_outer_price) == 0.0


def test_cva_on_netted_profile():
    opt = _book([90.0, 110.0])
    r = price_nmc_book(opt, SIM, payoff="vanilla_call")
    cva = float(r.cva(0.02))
    assert 0.0 < cva < float(np.asarray(r.ee_contract).sum())


def test_validation():
    with pytest.raises(ValueError, match="one market state"):
        price_nmc_book(_book([90.0, 100.0], sigma=[0.2, 0.3]), SIM)
    with pytest.raises(ValueError, match="weights shape"):
        price_nmc_book(_book([90.0, 100.0]), SIM, weights=[1.0])
    with pytest.raises(ValueError, match="1-D"):
        price_nmc_book(OptionParams(), SIM)


def test_book_under_model_families():
    """Netting sets under family dynamics: B=1 bitwise to the family
    NMC, CRN netting collapses long/short, engines bitwise."""
    from mc_tpu.nmc_heston import price_nmc_heston
    opt1 = _book([100.0])
    b = price_nmc_book(opt1, SIM, model="heston",
                       tile_rows=8)
    s = price_nmc_heston(sim=SIM, tile_rows=8)
    np.testing.assert_array_equal(np.asarray(b.net_surface),
                                  np.asarray(s.surface))
    assert float(b.outers.price[0]) == float(s.outer.price)

    opt2 = _book([100.0, 100.0])
    r = price_nmc_book(opt2, SIM, model="vasicek",
                       weights=[1.0, -1.0], tile_rows=8)
    np.testing.assert_array_equal(np.asarray(r.net_surface),
                                  np.zeros_like(np.asarray(r.net_surface)))


def test_book_under_basket():
    """Basket netting: B=1 bitwise to price_nmc_basket; contracts net on
    the SAME correlated d-asset scenarios."""
    from mc_tpu.nmc_basket import price_nmc_basket
    b = price_nmc_book(_book([100.0]), SIM, model="basket",
                       tile_rows=8)
    s = price_nmc_basket(sim=SIM, tile_rows=8)
    np.testing.assert_array_equal(np.asarray(b.net_surface),
                                  np.asarray(s.surface))
    r = price_nmc_book(_book([100.0, 100.0]), SIM, model="basket",
                       weights=[1.0, -1.0], tile_rows=8)
    assert float(r.net_outer_price) == 0.0


def test_book_model_validation():
    with pytest.raises(ValueError, match="unknown book model"):
        price_nmc_book(_book([100.0]), SIM, model="bachelier")
