"""Term-structure GBM: averaged-parameter closed-form gates.

Deterministic curves leave the terminal law exactly GBM at
(r_bar, sqrt(mean(sigma^2))) — every European gate is plain Black-
Scholes at the averaged parameters, and the forward-start gate shows
the vol curve BEFORE the determination date cancels entirely.
"""

import math

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.models.term import DEMO_TERM, TermStructure, price_term
from mc_tpu.oracle import bs_call, bs_forward_start_call

SIM = SimParams(n_paths=200_000, n_steps=20)


def _gate(res, want, n_se=3.5):
    assert abs(float(res.price) - want) <= n_se * float(res.stderr), (
        float(res.price), want, float(res.stderr),
        (float(res.price) - want) / float(res.stderr))


def _term(rates, sigmas, n=20):
    return TermStructure.from_knots(rates, sigmas, n)


def test_flat_curves_match_bs():
    res = price_term(OptionParams(), _term([0.1], [0.2]), SIM, antithetic=True, tile_rows=8)
    _gate(res, float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2)))


def test_varying_curves_match_averaged_bs():
    """Steep curves: the gate is BS at (mean r, rms sigma) — exact in
    law, not an approximation."""
    term = _term([0.12, 0.08, 0.04, 0.02], [0.1, 0.2, 0.3, 0.4])
    res = price_term(OptionParams(), term, SIM,
                     antithetic=True, tile_rows=8)
    rs = np.asarray(term.rates, np.float64)
    sg = np.asarray(term.sigmas, np.float64)
    want = float(bs_call(100.0, 100.0, 1.0, float(rs.mean()),
                         float(np.sqrt((sg ** 2).mean()))))
    _gate(res, want)


def test_forward_start_sees_only_late_vol():
    """The strike fixes at step 10 (t1=0.5): vol and rates BEFORE t1
    cancel by homogeneity — the closed form uses only the [t1, T]
    averages, and wildly different early vol must not move the price."""
    late_r, late_sg = 0.04, 0.35
    quiet = _term([0.10, late_r], [0.10, late_sg])
    wild = _term([0.25, late_r], [0.60, late_sg])
    opt = OptionParams(k=1.0, p1=10.0)
    kw = dict(sim=SIM, payoff="forward_start_call",
              antithetic=True, tile_rows=8)
    want = bs_forward_start_call(100.0, 1.0, 0.5, 1.0, late_r, late_sg)
    a = price_term(opt, quiet, **kw)
    b = price_term(opt, wild, **kw)
    _gate(a, want)
    _gate(b, want)


def test_asian_really_sees_the_curve():
    """Unlike Europeans, an Asian under back-loaded vol differs from its
    flat-rms twin: early averaging points are less volatile, so the
    back-loaded Asian is cheaper. Distinguishes the real curve from
    (r_bar, sigma_bar) equivalence."""
    back = _term([0.1], [0.1, 0.4])          # rms = 0.2915
    rms = float(np.sqrt(np.mean(np.asarray(back.sigmas) ** 2)))
    flat = _term([0.1], [rms])
    kw = dict(sim=SIM, payoff="asian_call",
              antithetic=True, tile_rows=8)
    a = price_term(OptionParams(), back, **kw)
    b = price_term(OptionParams(), flat, **kw)
    se = math.hypot(float(a.stderr), float(b.stderr))
    assert float(a.price) < float(b.price) - 3 * se


def test_from_knots_spread():
    t = TermStructure.from_knots([1.0, 2.0], [0.1], 10)
    assert np.asarray(t.rates).tolist() == [1.0] * 5 + [2.0] * 5
    np.testing.assert_allclose(np.asarray(t.sigmas), 0.1, rtol=1e-6)


def test_validation():
    with pytest.raises(ValueError, match="term structure has"):
        price_term(term=_term([0.1], [0.2], n=10),
                   sim=SimParams(n_paths=1024, n_steps=20))
    with pytest.raises(ValueError, match="even n_steps"):
        price_term(term=_term([0.1], [0.2], n=7),
                   sim=SimParams(n_paths=1024, n_steps=7))
