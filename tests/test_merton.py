"""Merton jump-diffusion tests vs the Merton (1976) series oracle."""

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.models.merton import (DEMO_MERTON, MertonDynamics,
                                  merton_call_closed_form, poisson_kmax,
                                  price_merton)
from mc_tpu.models.merton import _poisson_inv_cdf
from mc_tpu.oracle import bs_call

OPT = OptionParams()
SIM = SimParams(n_paths=200_000, n_steps=50)
ORACLE = merton_call_closed_form(100.0, 100.0, 1.0, 0.1, 0.2,
                                 lam=0.3, mu_j=-0.10, sigma_j=0.15)


def test_series_oracle_gbm_limit():
    """lam -> 0: the series collapses to Black-Scholes."""
    cf = merton_call_closed_form(100.0, 100.0, 1.0, 0.1, 0.2,
                                 lam=0.0, mu_j=-0.1, sigma_j=0.15)
    # bs_call computes in f32; the series term itself is f64-exact
    assert cf == pytest.approx(float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2)),
                               rel=1e-6)


def test_series_oracle_jumps_raise_otm_price():
    """Jump risk fattens the tails: deep-OTM calls are worth more."""
    otm_m = merton_call_closed_form(100.0, 160.0, 0.25, 0.05, 0.2,
                                    lam=1.0, mu_j=0.0, sigma_j=0.3)
    otm_bs = float(bs_call(100.0, 160.0, 0.25, 0.05, 0.2))
    assert otm_m > 2.0 * otm_bs


def test_terminal_matches_series():
    res = price_merton(OPT, DEMO_MERTON, SIM, method="terminal", tile_rows=64)
    assert abs(float(res.price) - ORACLE) <= 3.5 * float(res.stderr), (
        float(res.price), ORACLE, float(res.stderr))


def test_euler_matches_series():
    """The per-step log increment is exact in law — no discretization
    bias, only MC noise, even at 50 steps."""
    res = price_merton(OPT, DEMO_MERTON, SIM, method="euler", tile_rows=64)
    assert abs(float(res.price) - ORACLE) <= 3.5 * float(res.stderr), (
        float(res.price), ORACLE, float(res.stderr))


def test_martingale_compensation():
    """E[e^{-rT} S_T] = S0: the lam*kappa compensator is exact.

    Priced as a K=0 call (payoff = S_T)."""
    res = price_merton(OptionParams(k=0.0), DEMO_MERTON, SIM,
                       method="terminal", tile_rows=64)
    assert abs(float(res.price) - 100.0) <= 3.5 * float(res.stderr)


def test_antithetic_unbiased_and_tighter():
    plain = price_merton(OPT, DEMO_MERTON, SIM, method="euler", tile_rows=64)
    anti = price_merton(OPT, DEMO_MERTON, SIM, method="euler", antithetic=True, tile_rows=64)
    joint = np.hypot(float(plain.stderr), float(anti.stderr))
    assert abs(float(plain.price) - float(anti.price)) <= 4.0 * joint
    assert float(anti.stderr) < float(plain.stderr)


def test_path_dependent_payoff_under_jumps():
    """Asian call under jumps: sane bounds (below vanilla, positive)."""
    asian = price_merton(OPT, DEMO_MERTON, SIM, payoff="asian_call",
                         method="euler", tile_rows=64)
    vanilla = price_merton(OPT, DEMO_MERTON, SIM, method="euler", tile_rows=64)
    assert 0.0 < float(asian.price) < float(vanilla.price)


def test_terminal_rejects_path_dependent():
    with pytest.raises(ValueError, match="path-dependent"):
        price_merton(OPT, DEMO_MERTON, SIM, payoff="asian_call",
                     method="terminal")


def test_odd_steps_rejected():
    with pytest.raises(ValueError, match="even n_steps"):
        price_merton(OPT, DEMO_MERTON, SimParams(n_paths=1024, n_steps=9))


def test_poisson_inv_cdf_moments():
    """Branch-free Poisson sampler: mean/var match lam to MC tolerance."""
    import jax.numpy as jnp
    rng_np = np.random.default_rng(0)
    u = jnp.asarray(rng_np.random(200_000, dtype=np.float32))
    for lam in (0.05, 0.5, 2.0):
        n = np.asarray(_poisson_inv_cdf(u, jnp.float32(lam),
                                        poisson_kmax(lam)))
        se_mean = np.sqrt(lam / n.size)
        assert abs(n.mean() - lam) < 4.0 * se_mean, lam
        assert abs(n.var() - lam) < 0.02 * lam + 4.0 * se_mean, lam
    # lam = 0 draws identically zero
    n0 = np.asarray(_poisson_inv_cdf(u, jnp.float32(0.0), poisson_kmax(0.0)))
    assert (n0 == 0.0).all()


def test_poisson_kmax_tail():
    assert poisson_kmax(0.0) == 1
    # P(Poisson(1) > kmax) < 1e-12 requires kmax >= 12
    assert poisson_kmax(1.0) >= 12
    assert poisson_kmax(100.0) < 256


def test_poisson_kmax_depth_overflow_raises():
    """Intensities whose 1e-12 tail needs >256 scan steps must raise,
    not silently truncate (the bias would be invisible otherwise)."""
    with pytest.raises(ValueError, match="scan depth"):
        poisson_kmax(250.0)


def test_price_merton_validates_payoff():
    """price_merton runs the payoff validate hook (forward_start_call
    with an out-of-range determination step must not silently price the
    degenerate vanilla)."""
    opt = OptionParams(p1=999.0)
    with pytest.raises(ValueError, match="determination step"):
        price_merton(opt, DEMO_MERTON, SIM, payoff="forward_start_call")


def test_dividend_yield_through_merton():
    """q shifts the forward; series oracle and MC agree."""
    opt = OptionParams(q=0.03)
    ref = merton_call_closed_form(100.0, 100.0, 1.0, 0.1, 0.2,
                                  lam=0.3, mu_j=-0.10, sigma_j=0.15, q=0.03)
    res = price_merton(opt, DEMO_MERTON, SIM, method="terminal", tile_rows=64)
    assert abs(float(res.price) - ref) <= 3.5 * float(res.stderr)
