"""Heston model-family tests: CF oracle sanity, MC vs oracle, GBM limit."""

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.models.heston import (DEMO_HESTON, HestonDynamics,
                                  heston_call_cf, price_heston)
from mc_tpu.oracle import bs_call

OPT = OptionParams()
SIM = SimParams(n_paths=200_000, n_steps=100)


def test_cf_oracle_bs_limit():
    """xi -> 0, v0 = theta: Heston degenerates to BS with sigma=sqrt(v0)."""
    got = heston_call_cf(100.0, 100.0, 1.0, 0.1, 0.04, 2.0, 0.04, 1e-6, 0.0)
    want = float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2))
    assert got == pytest.approx(want, rel=1e-4)


def test_cf_oracle_known_regime():
    """Negative rho lowers OTM-call prices vs zero rho (skew sanity)."""
    base = dict(s0=100.0, k=120.0, t=1.0, r=0.05, v0=0.04, kappa=2.0,
                theta=0.04, xi=0.5)
    neg = heston_call_cf(rho=-0.8, **base)
    zero = heston_call_cf(rho=0.0, **base)
    assert neg < zero


def test_mc_matches_cf_oracle():
    ref = heston_call_cf(100.0, 100.0, 1.0, 0.1, *DEMO_HESTON.astuple())
    res = price_heston(OPT, DEMO_HESTON, SIM,
                       antithetic=True, tile_rows=64)
    # full-truncation Euler carries O(dt) bias; allow 4 se + 0.5% abs
    tol = 4.0 * float(res.stderr) + 0.005 * ref
    assert abs(float(res.price) - ref) <= tol, (float(res.price), ref)


def test_mc_gbm_limit():
    """xi ~ 0: Heston MC must reproduce the BS price."""
    flat = HestonDynamics(v0=0.04, kappa=1.0, theta=0.04, xi=1e-7, rho=0.0)
    res = price_heston(OPT, flat, SimParams(n_paths=100_000, n_steps=50), antithetic=True, tile_rows=8)
    bs = float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2))
    assert abs(float(res.price) - bs) <= 4.0 * float(res.stderr)


def test_path_dependent_payoffs_work():
    sim = SimParams(n_paths=50_000, n_steps=20)
    vanilla = price_heston(OPT, DEMO_HESTON, sim, tile_rows=8)
    asian = price_heston(OPT, DEMO_HESTON, sim, payoff="asian_call", tile_rows=8)
    up_out = price_heston(OPT, DEMO_HESTON, sim, payoff="up_out_call", tile_rows=8)
    assert 0.0 < float(asian.price) < float(vanilla.price)
    assert 0.0 < float(up_out.price) < float(vanilla.price)


def test_antithetic_reduces_stderr():
    sim = SimParams(n_paths=50_000, n_steps=20)
    plain = price_heston(OPT, DEMO_HESTON, sim, tile_rows=8)
    anti = price_heston(OPT, DEMO_HESTON, sim,
                        antithetic=True, tile_rows=8)
    assert float(anti.stderr) < float(plain.stderr)


def test_market_params_traced():
    """Re-pricing at new Heston params must not recompile (traced leaves)."""
    sim = SimParams(n_paths=20_000, n_steps=10)
    prices = []
    for xi in (0.1, 0.3, 0.5):
        res = price_heston(OPT, HestonDynamics(xi=xi), sim,
                           tile_rows=8)
        prices.append(float(res.price))
    assert len(set(prices)) == 3
