"""Dividend-yield (q) support across the framework."""

import pytest

from mc_tpu import OptionParams, SimParams, price
from mc_tpu.oracle import bs_call, bs_put

SIM = SimParams(n_paths=200_000, n_steps=20)
Q = 0.03


def test_bs_with_dividends():
    # q lowers the forward: call cheaper, put pricier
    assert float(bs_call(100, 100, 1, 0.1, 0.2, Q)) < \
        float(bs_call(100, 100, 1, 0.1, 0.2))
    assert float(bs_put(100, 100, 1, 0.1, 0.2, Q)) > \
        float(bs_put(100, 100, 1, 0.1, 0.2))


@pytest.mark.parametrize("method", ["terminal", "euler"])
def test_mc_matches_bs_with_q(method):
    res = price(OptionParams(q=Q), SIM, method=method,
                antithetic=True, tile_rows=8)
    bs = float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2, Q))
    assert abs(float(res.price) - bs) <= 4.0 * float(res.stderr)


def test_cv_expectation_with_q():
    """Control variate E[S_T] must use the q-adjusted forward."""
    from mc_tpu.oracle import bs_call
    res = price(OptionParams(q=Q), SIM, method="euler",
                control_variate=True, antithetic=True, tile_rows=8)
    bs = float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2, Q))
    assert abs(float(res.price) - bs) <= 4.0 * float(res.stderr) + 1e-3


def test_put_call_parity_with_q():
    import math
    c = price(OptionParams(q=Q), SIM, antithetic=True,
              tile_rows=8)
    p = price(OptionParams(q=Q), SIM, payoff="vanilla_put",
              antithetic=True, tile_rows=8)
    parity = 100.0 * math.exp(-Q) - 100.0 * math.exp(-0.1)
    tol = 4.0 * (float(c.stderr) + float(p.stderr))
    assert abs((float(c.price) - float(p.price)) - parity) <= tol


def test_american_call_early_exercise_with_q():
    """With dividends the American call IS worth more than European."""
    from mc_tpu.lsmc import binomial_american, price_american
    q = 0.08
    eur = float(bs_call(100.0, 100.0, 1.0, 0.05, 0.2, q))
    tree = binomial_american(100.0, 100.0, 1.0, 0.05, 0.2, kind="call",
                             div_yield=q)
    assert tree > eur + 0.05
    res = price_american(OptionParams(r=0.05, q=q),
                         SimParams(n_paths=100_000, n_steps=50),
                         payoff="vanilla_call")
    assert abs(float(res.price) - tree) <= 3.5 * float(res.stderr) + 0.015 * tree


def test_native_pricer_with_q():
    from mc_tpu.native import lib as native
    if not native.available:
        pytest.skip("native unavailable")
    from mc_tpu.rng import derive_key
    key = derive_key(1234, 0)
    px, se = native.price_cpu("vanilla_call", key, 100_000, 20, q=Q)
    bs = float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2, Q))
    assert abs(px - bs) <= 4.0 * se


def test_heston_and_basket_with_q():
    from mc_tpu.models.heston import price_heston, DEMO_HESTON
    from mc_tpu.models.basket import price_basket, DEMO_BASKET
    sim = SimParams(n_paths=50_000, n_steps=20)
    h0 = price_heston(OptionParams(), DEMO_HESTON, sim,
                      tile_rows=8)
    hq = price_heston(OptionParams(q=Q), DEMO_HESTON, sim,
                      tile_rows=8)
    assert float(hq.price) < float(h0.price)
    b0 = price_basket(OptionParams(), DEMO_BASKET, sim,
                      tile_rows=8)
    bq = price_basket(OptionParams(q=Q), DEMO_BASKET, sim,
                      tile_rows=8)
    assert float(bq.price) < float(b0.price)
