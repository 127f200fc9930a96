"""Importance sampling tests: unbiasedness + variance reduction."""

import math

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams, price
from mc_tpu.oracle import bs_call

# Deep out-of-the-money call: plain MC rarely sees a payoff.
OTM = OptionParams(k=180.0)
SIM = SimParams(n_paths=100_000, n_steps=20)
BS_OTM = float(bs_call(100.0, 180.0, 1.0, 0.1, 0.2))
SHIFT = math.log(180.0 / 100.0) / 0.2  # aim S_T at the strike (~2.94 sd)


@pytest.mark.parametrize("method", ["terminal", "euler"])
def test_is_unbiased(method):
    res = price(OTM, SIM, method=method,
                importance_shift=SHIFT, tile_rows=8)
    assert abs(float(res.price) - BS_OTM) <= 4.0 * float(res.stderr)


def test_is_reduces_stderr_massively():
    plain = price(OTM, SIM, method="terminal", tile_rows=8)
    shifted = price(OTM, SIM, method="terminal",
                    importance_shift=SHIFT, tile_rows=8)
    # ~2.9-sd OTM: IS typically cuts stderr by >5x at this strike
    assert float(shifted.stderr) < 0.3 * float(plain.stderr)


def test_is_engines_bitwise():
    a = price(OTM, SIM, engine="pallas", interpret=True, method="euler",
              importance_shift=SHIFT, tile_rows=8)
    b = price(OTM, SIM, method="euler",
              importance_shift=SHIFT, tile_rows=8)
    assert float(a.price) == float(b.price)


def test_is_zero_shift_is_plain():
    a = price(OTM, SIM, method="euler", importance_shift=0.0,
              tile_rows=8)
    b = price(OTM, SIM, method="euler", tile_rows=8)
    assert float(a.price) == float(b.price)


def test_is_terminal_euler_consistent():
    """Both methods estimate the same price under IS (different draws)."""
    a = price(OTM, SIM, method="terminal",
              importance_shift=SHIFT, tile_rows=8)
    b = price(OTM, SIM, method="euler",
              importance_shift=SHIFT, tile_rows=8)
    tol = 4.0 * (float(a.stderr) + float(b.stderr))
    assert abs(float(a.price) - float(b.price)) <= tol


def test_is_with_antithetic():
    res = price(OTM, SIM, method="euler", antithetic=True,
                importance_shift=SHIFT, tile_rows=8)
    assert abs(float(res.price) - BS_OTM) <= 4.0 * float(res.stderr)


def test_is_rejects_hw_rng():
    with pytest.raises(ValueError):
        price(OTM, SIM, rng_source="hw", importance_shift=SHIFT)


def test_auto_shift_otm():
    """importance_shift='auto' aims the paths at the strike: for the
    deep-OTM call it must match the oracle and collapse the stderr by
    >5x vs plain sampling at the same budget."""
    from mc_tpu import OptionParams, SimParams, price
    from mc_tpu.oracle import bs_call
    otm = OptionParams(k=180.0)
    sim = SimParams(n_paths=200_000, n_steps=10)
    auto = price(otm, sim, method="terminal", tile_rows=8,
                 importance_shift="auto")
    plain = price(otm, sim, method="terminal", tile_rows=8)
    bs = float(bs_call(100.0, 180.0, 1.0, 0.1, 0.2))
    assert abs(float(auto.price) - bs) <= 4.0 * float(auto.stderr)
    assert float(auto.stderr) < 0.2 * float(plain.stderr), (
        float(auto.stderr), float(plain.stderr))
