"""Local-volatility surface: BS / term / CEV cross-model gates."""

import math

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.models.cev import cev_call_closed_form
from mc_tpu.models.localvol import LocalVolSurface, price_localvol
from mc_tpu.oracle import bs_call

SIM = SimParams(n_paths=200_000, n_steps=20)


def _gate(res, want, n_se=3.5, bias=0.0):
    assert abs(float(res.price) - want) <= n_se * float(res.stderr) + bias, (
        float(res.price), want, float(res.stderr),
        (float(res.price) - want) / float(res.stderr))


def test_flat_surface_is_bs_exact():
    """sigma constant: log-Euler is EXACT — plain BS gate."""
    surf = LocalVolSurface.flat(0.2, 20)
    res = price_localvol(OptionParams(), surf, SIM,
                         antithetic=True, tile_rows=8)
    _gate(res, float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2)))


def test_time_only_surface_is_averaged_bs():
    """sigma(t) independent of S: exact in law at (r, rms sigma)."""
    surf = LocalVolSurface.from_function(
        lambda x, t: 0.1 + 0.3 * t, 20)
    sg = np.asarray(surf.vols)[:, 0].astype(np.float64)
    res = price_localvol(OptionParams(), surf, SIM,
                         antithetic=True, tile_rows=8)
    _gate(res, float(bs_call(100.0, 100.0, 1.0, 0.1,
                             float(np.sqrt((sg ** 2).mean())))))


def test_cev_cross_model_gate():
    """sigma(S) = sigma_atm (S/S0)^(beta-1): the surface reproduces the
    CEV noncentral-chi^2 closed form through a completely different
    discretization (log-Euler + knot interpolation vs the CEV kernel's
    absorbing Euler).  Euler + interpolation bias bounded by a small
    absolute allowance on top of MC noise."""
    beta, sigma_atm, s0 = 0.7, 0.2, 100.0
    surf = LocalVolSurface.from_function(
        lambda x, t: sigma_atm * math.exp((beta - 1.0) * x),
        100, x_lo=-1.5, x_hi=1.5, n_knots=25)
    sim = SimParams(n_paths=400_000, n_steps=100)
    res = price_localvol(OptionParams(), surf, sim,
                         antithetic=True, tile_rows=8)
    want = cev_call_closed_form(s0, 100.0, 1.0, 0.1,
                                sigma_atm * s0 ** (1.0 - beta), beta)
    _gate(res, want, bias=0.02)


def test_smile_raises_otm_wings():
    """A smile (convex in x) prices OTM calls above flat-ATM-vol BS."""
    smile = LocalVolSurface.from_function(
        lambda x, t: 0.2 + 0.3 * x * x, 20)
    otm = OptionParams(k=130.0)
    res = price_localvol(otm, smile, SIM, antithetic=True,
                         tile_rows=8)
    flat_bs = float(bs_call(100.0, 130.0, 1.0, 0.1, 0.2))
    assert float(res.price) > flat_bs + 3 * float(res.stderr)


def test_path_dependent_payoffs_run():
    sim = SimParams(n_paths=20_000, n_steps=20)
    surf = LocalVolSurface.from_function(
        lambda x, t: 0.2 + 0.1 * x * x, 20)
    a = price_localvol(OptionParams(), surf, sim, payoff="asian_call", tile_rows=8)
    b = price_localvol(OptionParams(p1=1.0, p2=18.0), surf, sim,
                       payoff="bullet_call", tile_rows=8)
    assert float(a.price) > 0 and float(b.price) > 0


def test_interpolation_matches_numpy():
    """The clamped-ramp form equals numpy piecewise-linear interp with
    flat extrapolation, at every query point."""
    from mc_tpu.models.localvol import _make_sigma_at, _pack_localvol
    surf = LocalVolSurface.from_function(
        lambda x, t: 0.15 + 0.2 * abs(x) + 0.1 * t, 4, n_knots=7)
    params = _pack_localvol(OptionParams().as_f32(), surf.as_f32(), 4)
    sigma_at = _make_sigma_at(np.asarray(params), 4, 7)
    xs = np.asarray(surf.x_knots); vs = np.asarray(surf.vols)
    q = np.linspace(-2.0, 2.0, 41).astype(np.float32)
    for j in range(4):
        want = np.interp(q, xs, vs[j])  # np.interp extrapolates flat
        got = np.asarray([float(sigma_at(np.float32(x), j)) for x in q])
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_validation():
    with pytest.raises(ValueError, match="surface has"):
        price_localvol(surf=LocalVolSurface.flat(0.2, 10),
                       sim=SimParams(n_paths=1024, n_steps=20))
    with pytest.raises(ValueError, match="even n_steps"):
        price_localvol(surf=LocalVolSurface.flat(0.2, 7),
                       sim=SimParams(n_paths=1024, n_steps=7))


def test_american_flat_surface_matches_binomial():
    """Flat surface = GBM: the local-vol LSMC must land where the plain
    GBM LSMC does relative to the CRR American oracle."""
    from mc_tpu.lsmc import binomial_american, price_american_localvol
    sim = SimParams(n_paths=100_000, n_steps=50)
    r = price_american_localvol(surf=LocalVolSurface.flat(0.2, 50),
                                sim=sim)
    oracle = binomial_american(100.0, 100.0, 1.0, 0.1, 0.2, kind="put")
    assert float(r.price) <= oracle + 3.0 * float(r.stderr)
    assert float(r.price) >= oracle - 4.0 * float(r.stderr) - 0.06


def test_american_dominates_european_same_surface():
    """American put >= European put under the SAME smile surface, with
    the clearly positive early-exercise premium r=0.1 commands."""
    from mc_tpu.lsmc import price_american_localvol
    sim = SimParams(n_paths=100_000, n_steps=50)
    surf = LocalVolSurface.from_function(
        lambda x, t: 0.2 + 0.3 * x * x, 50)
    amer = price_american_localvol(surf=surf, sim=sim)
    euro = price_localvol(OptionParams(), surf, sim,
                          payoff="vanilla_put",
                          antithetic=True, tile_rows=8)
    assert float(amer.price) > float(euro.price) + 0.2, (
        float(amer.price), float(euro.price))
