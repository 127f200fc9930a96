"""Correlated multi-asset basket tests."""

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.models.basket import BasketDynamics, DEMO_BASKET, price_basket
from mc_tpu.oracle import bs_call

SIM = SimParams(n_paths=100_000, n_steps=20)


def single_asset(sigma=0.2, s0=100.0):
    return BasketDynamics(s0s=np.array([s0], np.float32),
                          sigmas=np.array([sigma], np.float32),
                          weights=np.array([1.0], np.float32),
                          corr=np.eye(1, dtype=np.float32))


def perfectly_correlated(d=3, sigma=0.2):
    return BasketDynamics(s0s=np.full(d, 100.0, np.float32),
                          sigmas=np.full(d, sigma, np.float32),
                          weights=np.full(d, 1.0 / d, np.float32),
                          corr=np.ones((d, d), np.float32))


def test_single_asset_reduces_to_bs():
    res = price_basket(OptionParams(), single_asset(), SIM,
                       antithetic=True, tile_rows=8)
    bs = float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2))
    assert abs(float(res.price) - bs) <= 4.0 * float(res.stderr)


def test_perfect_correlation_equals_single_asset():
    """rho=1, equal vols/spots: the basket IS one asset in distribution."""
    res = price_basket(OptionParams(), perfectly_correlated(), SIM, antithetic=True, tile_rows=8)
    bs = float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2))
    assert abs(float(res.price) - bs) <= 4.0 * float(res.stderr)


def test_diversification_lowers_price():
    """Independent assets: basket vol < single vol => cheaper ATM call."""
    d = 4
    indep = BasketDynamics(s0s=np.full(d, 100.0, np.float32),
                           sigmas=np.full(d, 0.2, np.float32),
                           weights=np.full(d, 0.25, np.float32),
                           corr=np.eye(d, dtype=np.float32))
    res_i = price_basket(OptionParams(), indep, SIM,
                         antithetic=True, tile_rows=8)
    res_c = price_basket(OptionParams(), perfectly_correlated(4), SIM, antithetic=True, tile_rows=8)
    assert float(res_i.price) < float(res_c.price) - 2.0


def test_path_dependent_on_basket():
    sim = SimParams(n_paths=50_000, n_steps=20)
    vanilla = price_basket(OptionParams(), DEMO_BASKET, sim,
                           tile_rows=8)
    asian = price_basket(OptionParams(), DEMO_BASKET, sim,
                         payoff="asian_call", tile_rows=8)
    up_out = price_basket(OptionParams(), DEMO_BASKET, sim,
                          payoff="up_out_call", tile_rows=8)
    assert 0.0 < float(asian.price) < float(vanilla.price)
    assert 0.0 < float(up_out.price) < float(vanilla.price)


def test_correlation_is_traced():
    """Re-pricing at a new correlation does not recompile."""
    prices = []
    for rho in (0.0, 0.4, 0.8):
        d = 3
        corr = np.full((d, d), rho, np.float32)
        np.fill_diagonal(corr, 1.0)
        b = BasketDynamics(s0s=np.full(d, 100.0, np.float32),
                           sigmas=np.full(d, 0.2, np.float32),
                           weights=np.full(d, 1 / 3, np.float32),
                           corr=corr)
        res = price_basket(OptionParams(), b,
                           SimParams(n_paths=50_000, n_steps=10), tile_rows=8)
        prices.append(float(res.price))
    # more correlation -> more basket variance -> pricier ATM call
    assert prices == sorted(prices)


def test_basket_dimension_guard():
    """The unrolled Cholesky mixing is O(d^2) compile-time: oversized
    baskets must fail loudly, not hang the compiler."""
    import numpy as np
    import pytest

    from mc_tpu.models.basket import MAX_BASKET_D, BasketDynamics, \
        price_basket
    d = MAX_BASKET_D + 1
    corr = np.eye(d, dtype=np.float32)
    dyn = BasketDynamics(s0s=np.full(d, 100.0, np.float32),
                         sigmas=np.full(d, 0.2, np.float32),
                         weights=np.full(d, 1.0 / d, np.float32),
                         corr=corr)
    with pytest.raises(ValueError, match="MAX_BASKET_D"):
        price_basket(basket=dyn, sim=SimParams(n_paths=1024, n_steps=2))
