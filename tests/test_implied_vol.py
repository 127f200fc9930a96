"""Implied-vol solver: round-trip accuracy, vectorization, edge handling."""

import numpy as np
import pytest

from mc_tpu.oracle import bs_call, bs_implied_vol, bs_vega


def test_round_trip_grid():
    """price -> IV -> price closes over a wide (K, sigma, T) grid."""
    ks = np.array([50.0, 80.0, 100.0, 120.0, 200.0], np.float32)
    sigmas = np.array([0.05, 0.2, 0.5, 1.5], np.float32)
    ts = np.array([0.05, 1.0, 5.0], np.float32)
    for t in ts:
        kk, ss = np.meshgrid(ks, sigmas)
        price = np.asarray(bs_call(100.0, kk, t, 0.03, ss, 0.01))
        iv = np.asarray(bs_implied_vol(price, 100.0, kk, t, 0.03, 0.01))
        # Cells with no f32 time value (deep ITM/OTM at tiny sigma*sqrt(t))
        # are uninvertible by construction — the solver flags them NaN.
        lb = np.maximum(100.0 * np.exp(-0.01 * t) - kk * np.exp(-0.03 * t),
                        0.0)
        invertible = (price - lb > 1e-4) & (price > 1e-4)
        assert not np.isnan(iv[invertible]).any()
        # Wherever the solver answers: round-trip closes in PRICE space
        ok = ~np.isnan(iv)
        back = np.asarray(bs_call(100.0, kk, t, 0.03, iv, 0.01))
        np.testing.assert_allclose(back[ok], price[ok],
                                   rtol=2e-5, atol=2e-5)
        # and in vol space where vega is healthy
        healthy = (np.asarray(bs_vega(100.0, kk, t, 0.03, ss, 0.01)) > 1.0)
        np.testing.assert_allclose(iv[healthy], ss[healthy], rtol=2e-3)


def test_no_arbitrage_band_is_nan():
    # below forward intrinsic
    assert np.isnan(float(bs_implied_vol(0.0, 100.0, 100.0, 1.0, 0.1)))
    iv = bs_implied_vol(100.0 * np.exp(-0.1) - 100.0 * np.exp(-0.1) - 1.0,
                        100.0, 100.0, 1.0, 0.1)
    assert np.isnan(float(iv))
    # above the spot bound
    assert np.isnan(float(bs_implied_vol(101.0, 100.0, 100.0, 1.0, 0.1)))


def test_mc_price_to_iv():
    """Inverting an MC price recovers sigma within the MC error band."""
    from mc_tpu import SimParams, price
    res = price(sim=SimParams(n_paths=1_000_000, n_steps=1),
                method="terminal")
    iv = float(bs_implied_vol(res.price, 100.0, 100.0, 1.0, 0.1))
    vega = float(bs_vega(100.0, 100.0, 1.0, 0.1, 0.2))
    iv_se = float(res.stderr) / vega  # delta method
    assert abs(iv - 0.2) <= 4.0 * iv_se


def test_scalar_and_batched_agree():
    p = float(bs_call(100.0, 110.0, 0.5, 0.02, 0.35))
    single = float(bs_implied_vol(p, 100.0, 110.0, 0.5, 0.02))
    batch = np.asarray(bs_implied_vol(np.full(7, p, np.float32),
                                      100.0, 110.0, 0.5, 0.02))
    assert batch == pytest.approx(single)
    assert single == pytest.approx(0.35, rel=1e-4)
