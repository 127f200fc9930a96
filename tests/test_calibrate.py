"""SABR smile calibration: jnp Hagan parity, round trips, MC loop."""

import math

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.calibrate import calibrate_sabr, hagan_iv
from mc_tpu.models.sabr import sabr_implied_vol

F, T = 100.0 * math.exp(0.1), 1.0
STRIKES = np.array([70.0, 85.0, 100.0, 115.0, 130.0, 150.0], np.float32)


def test_jnp_hagan_matches_host_oracle():
    for beta in (1.0, 0.7):
        for k in STRIKES:
            a = float(hagan_iv(F, k, T, 0.25, beta, 0.5, -0.3))
            b = sabr_implied_vol(F, float(k), T, 0.25, beta, 0.5, -0.3)
            assert a == pytest.approx(b, rel=2e-5), (beta, k)
    # ATM continuity of the z/x(z) series branch
    atm = float(hagan_iv(F, F, T, 0.25, 1.0, 0.5, -0.3))
    near = float(hagan_iv(F, F * 1.0001, T, 0.25, 1.0, 0.5, -0.3))
    assert atm == pytest.approx(near, rel=1e-3)


def test_round_trip_recovers_parameters():
    """IVs generated from known params, fit started far away."""
    true = dict(alpha=0.22, nu=0.6, rho=-0.5)
    target = np.asarray(hagan_iv(F, STRIKES, T, true["alpha"], 1.0,
                                 true["nu"], true["rho"]))
    fit = calibrate_sabr(F, T, STRIKES, target, beta=1.0,
                         init=(0.4, 0.2, 0.3))
    assert float(fit.rmse) < 1e-5, float(fit.rmse)
    assert float(fit.alpha) == pytest.approx(true["alpha"], rel=2e-3)
    assert float(fit.nu) == pytest.approx(true["nu"], rel=1e-2)
    assert float(fit.rho) == pytest.approx(true["rho"], abs=1e-2)


def test_round_trip_beta_half():
    target = np.asarray(hagan_iv(F, STRIKES, T, 0.2 * F ** 0.5, 0.5,
                                 0.4, -0.2))
    fit = calibrate_sabr(F, T, STRIKES, target, beta=0.5,
                         init=(0.1 * F ** 0.5, 0.8, 0.4))
    assert float(fit.rmse) < 1e-5
    assert float(fit.alpha) == pytest.approx(0.2 * F ** 0.5, rel=5e-3)


def test_vmap_across_maturities():
    import jax
    import jax.numpy as jnp
    ts = jnp.asarray([0.5, 1.0, 2.0], jnp.float32)
    targets = jnp.stack([hagan_iv(F, STRIKES, t, 0.22, 1.0, 0.6, -0.5)
                         for t in ts])
    fits = jax.vmap(lambda t, tv: calibrate_sabr(F, t, STRIKES, tv))(
        ts, targets)
    np.testing.assert_allclose(np.asarray(fits.alpha), 0.22, rtol=5e-3)
    assert np.all(np.asarray(fits.rmse) < 1e-4)


def test_full_mc_loop_recovers_dynamics():
    """The production loop: MC prices under known SABR dynamics -> implied
    vols -> calibration recovers the dynamics within MC noise."""
    from mc_tpu import OptionParams, SimParams
    from mc_tpu.models.sabr import DEMO_SABR, price_sabr
    from mc_tpu.oracle import bs_implied_vol

    sim = SimParams(n_paths=200_000, n_steps=50)
    ks = np.array([85.0, 95.0, 100.0, 105.0, 115.0], np.float32)
    ivs = []
    for k in ks:
        res = price_sabr(OptionParams(k=float(k)), DEMO_SABR, sim, antithetic=True, tile_rows=64)
        ivs.append(float(bs_implied_vol(res.price, 100.0, k, 1.0, 0.1)))
    fit = calibrate_sabr(F, T, ks, np.asarray(ivs, np.float32),
                         init=(0.3, 0.2, 0.0))
    # MC noise + Hagan expansion error: loose but identifying gates
    assert float(fit.alpha) == pytest.approx(0.2, abs=0.01)
    assert float(fit.rho) == pytest.approx(-0.4, abs=0.15)
    assert float(fit.nu) == pytest.approx(0.4, abs=0.15)
    assert float(fit.rmse) < 5e-3


# --- Heston calibration (round 3) -----------------------------------------

def test_heston_round_trip_recovers_parameters():
    """IVs generated from known Heston dynamics are recovered to
    sub-bp IV RMSE across a 3-maturity surface."""
    import numpy as np

    from mc_tpu.calibrate import _bs_iv_host, calibrate_heston
    from mc_tpu.models.heston import heston_call_cf
    true = dict(v0=0.05, kappa=1.5, theta=0.06, xi=0.4, rho=-0.6)
    s0, r = 100.0, 0.1
    strikes = np.array([80.0, 90.0, 100.0, 110.0, 125.0])
    mats = np.array([0.5, 1.0, 2.0])
    ivs = np.array([[_bs_iv_host(heston_call_cf(s0, k, t, r, **true),
                                 s0, k, t, r)
                     for k in strikes] for t in mats])
    fit = calibrate_heston(strikes, mats, ivs, s0=s0, r=r)
    assert fit.rmse < 1e-4
    assert fit.v0 == pytest.approx(true["v0"], rel=0.02)
    assert fit.theta == pytest.approx(true["theta"], rel=0.05)
    assert fit.xi == pytest.approx(true["xi"], rel=0.05)
    assert fit.rho == pytest.approx(true["rho"], abs=0.02)


def test_heston_fit_reprices_exotic():
    """The fitted dynamics re-price a path-dependent contract within MC
    tolerance of the true dynamics (the reason calibration exists)."""
    import numpy as np

    from mc_tpu.calibrate import _bs_iv_host, calibrate_heston
    from mc_tpu.models.heston import (HestonDynamics, heston_call_cf,
                                      price_heston)
    true = dict(v0=0.05, kappa=1.5, theta=0.06, xi=0.4, rho=-0.6)
    s0, r = 100.0, 0.1
    strikes = np.array([85.0, 95.0, 100.0, 105.0, 120.0])
    mats = np.array([0.5, 1.0])
    ivs = np.array([[_bs_iv_host(heston_call_cf(s0, k, t, r, **true),
                                 s0, k, t, r)
                     for k in strikes] for t in mats])
    fit = calibrate_heston(strikes, mats, ivs, s0=s0, r=r)
    sim = SimParams(n_paths=100_000, n_steps=50)
    a = price_heston(OptionParams(), HestonDynamics(**true), sim,
                     payoff="asian_call")
    b = price_heston(OptionParams(),
                     HestonDynamics(v0=fit.v0, kappa=fit.kappa,
                                    theta=fit.theta, xi=fit.xi,
                                    rho=fit.rho),
                     sim, payoff="asian_call")
    # CRN (same seed/stream): difference is the dynamics mismatch alone
    assert float(a.price) == pytest.approx(float(b.price), rel=0.02)


# --- Dupire local-vol calibration (round 3) --------------------------------

def test_localvol_flat_surface_exact():
    """A flat IV surface must produce the flat local vol exactly."""
    import numpy as np

    from mc_tpu.calibrate import calibrate_localvol
    strikes = np.array([80.0, 90.0, 100.0, 110.0, 125.0])
    surf = calibrate_localvol(strikes, np.array([0.5, 1.0]),
                              np.full((2, 5), 0.2), s0=100.0, r=0.1,
                              n_steps=8)
    np.testing.assert_allclose(np.asarray(surf.vols), 0.2, atol=1e-6)


def test_localvol_skew_shape():
    """A downward-sloping smile produces local vols higher below spot
    than above (the smile's local-vol image), monotone through ATM."""
    import numpy as np

    from mc_tpu.calibrate import calibrate_localvol
    strikes = np.array([80.0, 90.0, 100.0, 110.0, 125.0])
    ivs = np.array([[0.2 - 0.08 * np.log(k / 100.0) for k in strikes]
                    for _ in range(2)])
    surf = calibrate_localvol(strikes, np.array([0.5, 1.0]), ivs,
                              s0=100.0, r=0.1, n_steps=8,
                              x_lo=-0.3, x_hi=0.3)
    mid = np.asarray(surf.vols)[4]  # mid-horizon slice
    assert mid[0] > mid[-1]         # more vol below spot


def test_localvol_round_trip_reprices_smile():
    """Dupire consistency: vanillas re-priced under the extracted
    surface recover the input smile within fit + MC tolerance."""
    import numpy as np

    from mc_tpu.calibrate import calibrate_localvol
    from mc_tpu.models.localvol import price_localvol
    from mc_tpu.oracle import bs_implied_vol
    s0, r = 100.0, 0.1
    strikes = np.array([80.0, 90.0, 100.0, 110.0, 125.0])
    mats = np.array([0.5, 1.0])

    def iv_fn(k):
        y = np.log(k / s0)
        return 0.2 - 0.08 * y + 0.15 * y * y

    ivs = np.array([[iv_fn(k) for k in strikes] for _ in mats])
    surf = calibrate_localvol(strikes, mats, ivs, s0=s0, r=r,
                              n_steps=50, x_lo=-0.8, x_hi=0.8,
                              n_knots=33)
    sim = SimParams(n_paths=400_000, n_steps=50)
    for k in (80.0, 100.0, 125.0):
        res = price_localvol(OptionParams(k=k), surf, sim)
        iv = float(bs_implied_vol(float(res.price), s0, k, 1.0, r))
        assert iv == pytest.approx(iv_fn(k), abs=0.006)


def test_heston_nan_steps_rejected():
    """Trial parameters that push points outside the no-arb band (NaN
    IVs) must be penalized, not rewarded: the fit from an extreme start
    still lands on finite parameters with finite RMSE."""
    import numpy as np

    from mc_tpu.calibrate import _bs_iv_host, calibrate_heston
    from mc_tpu.models.heston import heston_call_cf
    true = dict(v0=0.04, kappa=2.0, theta=0.04, xi=0.3, rho=-0.5)
    s0, r = 100.0, 0.1
    strikes = np.array([90.0, 100.0, 110.0])
    mats = np.array([0.5, 1.0])
    ivs = np.array([[_bs_iv_host(heston_call_cf(s0, k, t, r, **true),
                                 s0, k, t, r)
                     for k in strikes] for t in mats])
    fit = calibrate_heston(strikes, mats, ivs, s0=s0, r=r,
                           init=(0.5, 0.1, 0.5, 2.0, 0.9), n_iter=40)
    # the extreme basin need not fully converge; the contract is NO NaN
    # poisoning: finite parameters and a penalized-but-improving RMSE
    assert np.isfinite([fit.v0, fit.kappa, fit.theta, fit.xi, fit.rho,
                        fit.rmse]).all()
    assert fit.rmse < 0.5
    # a merely-bad (in-band) start must still converge
    fit2 = calibrate_heston(strikes, mats, ivs, s0=s0, r=r,
                            init=(0.09, 0.8, 0.09, 0.8, 0.3), n_iter=40)
    assert fit2.rmse < 1e-3
