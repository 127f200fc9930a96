"""Bates SVJ model-family tests: CF factorization limits, MC vs oracle,
engine duals, martingale identity, and the heston q!=0 oracle regression.

Model scope is beyond the reference (GBM only,
/root/reference/inc/trajectories.cuh:14-113); the test STRUCTURE follows
its oracle-gating pattern (hello.cu:43-45 prints MC next to closed form).
"""

import math

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.models.bates import (DEMO_BATES, BatesDynamics, bates_call_cf,
                                 price_bates)
from mc_tpu.models.heston import heston_call_cf
from mc_tpu.models.merton import merton_call_closed_form
from mc_tpu.oracle import bs_call

OPT = OptionParams()
SIM = SimParams(n_paths=100_000, n_steps=50)


# --- CF oracle: factorization limits ---------------------------------------

def test_cf_heston_limit_exact():
    """lam = 0: the jump factor is identically 1, so the Bates CF price
    equals the Heston CF price EXACTLY (same quadrature, same code path)."""
    b = bates_call_cf(100.0, 100.0, 1.0, 0.1, 0.04, 2.0, 0.04, 0.3, -0.7,
                      0.0, -0.1, 0.15)
    h = heston_call_cf(100.0, 100.0, 1.0, 0.1, 0.04, 2.0, 0.04, 0.3, -0.7)
    assert b == h


def test_cf_merton_limit():
    """xi -> 0, v0 = theta: the diffusion degenerates to constant vol
    sqrt(theta), so Bates reduces to Merton's series closed form."""
    b = bates_call_cf(100.0, 100.0, 1.0, 0.1, 0.04, 2.0, 0.04, 1e-6, 0.0,
                      0.3, -0.1, 0.15)
    m = merton_call_closed_form(100.0, 100.0, 1.0, 0.1, 0.2, 0.3, -0.1,
                                0.15)
    assert b == pytest.approx(m, abs=2e-4)


def test_cf_bs_limit():
    """Both factors off (lam=0, xi->0): plain Black-Scholes."""
    b = bates_call_cf(100.0, 100.0, 1.0, 0.1, 0.04, 2.0, 0.04, 1e-6, 0.0,
                      0.0, -0.1, 0.15)
    assert b == pytest.approx(float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2)),
                              rel=1e-4)


def test_cf_dividend_yield():
    """q != 0 flows through both the forward and the e^{-qT} P1 leg
    (regression twin of the heston_call_cf q fix)."""
    b = bates_call_cf(100.0, 100.0, 1.0, 0.1, 0.04, 2.0, 0.04, 1e-6, 0.0,
                      0.0, -0.1, 0.15, q=0.03)
    assert b == pytest.approx(
        float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2, q=0.03)), rel=1e-4)


def test_cf_jumps_add_convexity_value():
    """Compensated jumps are a mean-preserving spread of S_T, so they
    strictly raise the (convex) call price at every strike."""
    base = dict(s0=100.0, t=1.0, r=0.05, v0=0.04, kappa=2.0,
                theta=0.04, xi=0.3, rho=-0.7)
    for k in (80.0, 100.0, 120.0):
        with_jumps = bates_call_cf(k=k, lam=0.5, mu_j=-0.2, sigma_j=0.2,
                                   **base)
        without = bates_call_cf(k=k, lam=0.0, mu_j=-0.2, sigma_j=0.2,
                                **base)
        assert with_jumps > without, k


def test_heston_cf_q_regression():
    """The heston oracle itself must honor q (was missing e^{-qT} on P1)."""
    h = heston_call_cf(100.0, 100.0, 1.0, 0.1, 0.04, 2.0, 0.04, 1e-6, 0.0,
                       q=0.03)
    assert h == pytest.approx(
        float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2, q=0.03)), rel=1e-4)


# --- MC vs oracle -----------------------------------------------------------

def test_mc_matches_cf_oracle_euler():
    ref = bates_call_cf(100.0, 100.0, 1.0, 0.1, *DEMO_BATES.astuple())
    res = price_bates(OPT, DEMO_BATES, SIM,
                      antithetic=True, tile_rows=64)
    # full-truncation Euler carries O(dt) bias; allow 4 se + 0.5% abs
    tol = 4.0 * float(res.stderr) + 0.005 * ref
    assert abs(float(res.price) - ref) <= tol, (float(res.price), ref)


def test_mc_matches_cf_oracle_qe():
    """QE diffusion + exact jumps: no Euler bias term needed at n=50."""
    ref = bates_call_cf(100.0, 100.0, 1.0, 0.1, *DEMO_BATES.astuple())
    res = price_bates(OPT, DEMO_BATES, SIM, scheme="qe",
                      antithetic=True, tile_rows=64)
    assert abs(float(res.price) - ref) <= 4.0 * float(res.stderr)


def test_mc_heston_limit():
    """lam ~ 0: Bates MC must reproduce the Heston CF price."""
    flat = BatesDynamics(lam=0.0)
    ref = heston_call_cf(100.0, 100.0, 1.0, 0.1, 0.04, 2.0, 0.04, 0.3,
                         -0.7)
    res = price_bates(OPT, flat, SIM, antithetic=True,
                      tile_rows=64)
    tol = 4.0 * float(res.stderr) + 0.005 * ref
    assert abs(float(res.price) - ref) <= tol


def test_mc_martingale():
    """k = 0 call pays S_T: discounted price must be s0 e^{-qT} — the
    compensator moved into `growth` keeps the spot a martingale."""
    opt = OptionParams(k=0.0)
    res = price_bates(opt, DEMO_BATES, SimParams(n_paths=200_000,
                                                 n_steps=20), scheme="qe", antithetic=True,
                      tile_rows=64)
    want = 100.0  # s0, q = 0
    assert abs(float(res.price) - want) <= 4.0 * float(res.stderr)


def test_tiling_invariance():
    """Counter-based draws: the price is independent of tile_rows."""
    sim = SimParams(n_paths=20_000, n_steps=10)
    a = price_bates(OPT, DEMO_BATES, sim, tile_rows=8)
    b = price_bates(OPT, DEMO_BATES, sim, tile_rows=32)
    assert float(a.price) == float(b.price)


def test_path_dependent_payoffs_work():
    sim = SimParams(n_paths=50_000, n_steps=20)
    vanilla = price_bates(OPT, DEMO_BATES, sim, tile_rows=8)
    asian = price_bates(OPT, DEMO_BATES, sim, payoff="asian_call", tile_rows=8)
    up_out = price_bates(OPT, DEMO_BATES, sim, payoff="up_out_call", tile_rows=8)
    assert 0.0 < float(asian.price) < float(vanilla.price)
    assert 0.0 < float(up_out.price) < float(vanilla.price)


def test_antithetic_reduces_stderr():
    sim = SimParams(n_paths=50_000, n_steps=20)
    plain = price_bates(OPT, DEMO_BATES, sim, tile_rows=8)
    anti = price_bates(OPT, DEMO_BATES, sim,
                       antithetic=True, tile_rows=8)
    assert float(anti.stderr) < float(plain.stderr)


def test_market_params_traced():
    """Re-pricing at new Bates params must not recompile (traced leaves;
    kmax is the only static rebuild trigger, keyed on lam)."""
    import jax
    sim = SimParams(n_paths=20_000, n_steps=10)
    prices = []
    with jax.log_compiles():
        for mu_j in (-0.15, -0.10, -0.05):
            dyn = BatesDynamics(mu_j=mu_j)
            prices.append(float(price_bates(OPT, dyn, sim,
                                            tile_rows=8).price))
    assert len(set(prices)) == 3  # params actually moved the price
