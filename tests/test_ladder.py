"""Strike-ladder tests: M strikes on shared paths, one kernel pass."""

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams, price
from mc_tpu.engines import price_ladder
from mc_tpu.oracle import bs_call

SIM = SimParams(n_paths=100_000, n_steps=20)
STRIKES = [80.0, 90.0, 100.0, 110.0, 120.0]


def test_ladder_matches_bs():
    res = price_ladder(STRIKES, sim=SIM, antithetic=True,
                       tile_rows=8)
    for i, k in enumerate(STRIKES):
        bs = float(bs_call(100.0, k, 1.0, 0.1, 0.2))
        assert abs(float(res.price[i]) - bs) <= 3.5 * float(res.stderr[i]), k


def test_ladder_monotone_decreasing():
    """Shared paths => the ladder is pathwise-monotone in strike (exactly,
    not just statistically)."""
    res = price_ladder(STRIKES, sim=SIM, tile_rows=8)
    p = np.asarray(res.price)
    assert (np.diff(p) < 0).all()


def test_ladder_matches_single_strike():
    """Ladder entry at K == single-strike price on the same stream."""
    for method in ("terminal", "euler"):
        res = price_ladder([100.0], sim=SIM, method=method,
                           tile_rows=8)
        single = price(sim=SIM, method=method, tile_rows=8)
        assert float(res.price[0]) == float(single.price), method


def test_ladder_bullet_payoff():
    res = price_ladder(STRIKES, option=OptionParams(p1=2.0, p2=12.0),
                       sim=SIM, payoff="bullet_call",
                       tile_rows=8)
    p = np.asarray(res.price)
    assert (np.diff(p) < 0).all()
    assert (p > 0).all()
