"""Realized-variance swap vs per-model quadratic-variation closed forms."""

import math

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams, price

SIM = SimParams(n_paths=200_000, n_steps=100)
KVAR = 0.03   # variance strike (OptionParams.k reused as the var strike)


def test_gbm_fair_variance_is_sigma_squared():
    """Under GBM the annualized realized variance is sigma^2 plus the
    exact discrete-sampling drift term mu^2 dt (E[(mu dt + sig sqrt(dt)
    z)^2] summed and annualized) — resolvable at this stderr (~1e-5)."""
    opt = OptionParams(k=KVAR)
    res = price(opt, SIM, payoff="variance_swap", method="euler", tile_rows=64)
    mu = 0.1 - 0.5 * 0.2 ** 2
    dt = 1.0 / SIM.n_steps
    want = math.exp(-0.1) * (0.2 ** 2 + mu * mu * dt - KVAR)
    assert abs(float(res.price) - want) <= 3.5 * float(res.stderr) + 1e-6, (
        float(res.price), want, float(res.stderr))


def test_zero_strike_gives_discounted_expected_rv():
    opt = OptionParams(k=0.0)
    res = price(opt, SIM, payoff="variance_swap", method="euler", tile_rows=64)
    mu = 0.1 - 0.5 * 0.2 ** 2
    want = math.exp(-0.1) * (0.04 + mu * mu / SIM.n_steps)
    assert float(res.price) == pytest.approx(want,
                                             abs=4 * float(res.stderr))


def test_heston_fair_variance():
    """E[(1/T) int v dt] = theta + (v0 - theta)(1 - e^{-kT})/(kT)."""
    from mc_tpu.models.heston import DEMO_HESTON, price_heston
    opt = OptionParams(k=0.0)
    res = price_heston(opt, DEMO_HESTON, SIM, payoff="variance_swap", tile_rows=64)
    v0, kap, th = (float(DEMO_HESTON.v0), float(DEMO_HESTON.kappa),
                   float(DEMO_HESTON.theta))
    fair = th + (v0 - th) * (1.0 - math.exp(-kap)) / kap
    want = math.exp(-0.1) * fair
    # full-truncation Euler carries O(dt) bias in the v integral
    tol = 4.0 * float(res.stderr) + 0.02 * want
    assert abs(float(res.price) - want) <= tol, (
        float(res.price), want, float(res.stderr))


def test_merton_jumps_add_quadratic_variation():
    """Jumps contribute lam*(mu_j^2 + sigma_j^2) to E[RV] — the signature
    that separates jump models from any diffusion at the same vol."""
    from mc_tpu.models.merton import DEMO_MERTON, price_merton
    opt = OptionParams(k=0.0)
    res = price_merton(opt, DEMO_MERTON, SIM, payoff="variance_swap",
                       method="euler", tile_rows=64)
    lam, mu_j, sig_j = 0.3, -0.10, 0.15
    want = math.exp(-0.1) * (0.2 ** 2 + lam * (mu_j ** 2 + sig_j ** 2))
    # O(dt) discrete-sampling terms (drift^2 dt, cross terms) ~ 5e-5
    assert abs(float(res.price) - want) <= 4.0 * float(res.stderr) + 2e-4, (
        float(res.price), want, float(res.stderr))


def test_pallas_xla_bitwise():
    opt = OptionParams(k=KVAR)
    sim = SimParams(n_paths=16_384, n_steps=10)
    a = price(opt, sim, payoff="variance_swap", method="euler",
              engine="pallas", interpret=True, tile_rows=8)
    b = price(opt, sim, payoff="variance_swap", method="euler", tile_rows=8)
    assert float(a.price) == float(b.price)
    assert float(a.stderr) == float(b.stderr)


def test_terminal_method_rejected():
    with pytest.raises(ValueError):
        price(OptionParams(k=KVAR), SIM, payoff="variance_swap",
              method="terminal")
