"""Andersen (2008) QE scheme tests.

Gates: (a) the sampler's conditional moments match the exact CIR
moments in BOTH branches, (b) the exact per-step martingale correction
holds at very coarse steps, (c) the coarse-step bias is far below
full-truncation Euler's against the CF oracle, (d) Pallas and XLA
engines are bitwise identical, (e) variance never goes negative.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.models.heston import (HestonDynamics, heston_call_cf,
                                  heston_qe_step, price_heston, qe_consts)

OPT = OptionParams(s0=100.0, t=1.0, k=100.0, r=0.03)
# Feller-violating stress regime: 2*kappa*theta = 0.18 < xi^2 = 1.0 —
# the case QE was designed for and where Euler is visibly biased.
STRESS = HestonDynamics(v0=0.09, kappa=1.0, theta=0.09, xi=1.0, rho=-0.9)


def _params(kappa, theta, xi, dt, rho=-0.7, growth=0.0):
    return SimpleNamespace(
        kappa=jnp.float32(kappa), theta=jnp.float32(theta),
        xi=jnp.float32(xi), dt=jnp.float32(dt), rho=jnp.float32(rho),
        growth=jnp.float32(growth))


def _step_stats(p, v_in, n=200_000, seed=0):
    rng_np = np.random.default_rng(seed)
    z_v = jnp.asarray(rng_np.standard_normal(n), jnp.float32)
    z_s = jnp.asarray(rng_np.standard_normal(n), jnp.float32)
    u = jnp.asarray(rng_np.random(n), jnp.float32)
    qc = qe_consts(p)
    w = jnp.zeros(n, jnp.float32)
    v = jnp.full(n, v_in, jnp.float32)
    _, v_next = heston_qe_step(p, qc, w, v, z_v, z_s, u)
    v_next = np.asarray(v_next, np.float64)
    # exact conditional CIR moments
    e = float(np.exp(-p.kappa * p.dt))
    m = float(p.theta) + (v_in - float(p.theta)) * e
    s2 = (v_in * float(p.xi) ** 2 * e * (1 - e) / float(p.kappa)
          + float(p.theta) * float(p.xi) ** 2 * (1 - e) ** 2
          / (2 * float(p.kappa)))
    return v_next, m, s2


def test_qe_quadratic_branch_moments():
    """psi < 1.5: sampled v' matches the exact CIR mean and variance."""
    p = _params(kappa=1.0, theta=0.04, xi=0.3, dt=0.5)
    v_next, m, s2 = _step_stats(p, v_in=0.04)
    n = len(v_next)
    assert np.all(v_next >= 0.0)
    assert abs(v_next.mean() - m) < 5 * np.sqrt(s2 / n)
    assert v_next.var() == pytest.approx(s2, rel=0.03)


def test_qe_exponential_branch_moments():
    """psi > 1.5 (near-zero v): moments still match, mass at exactly 0."""
    p = _params(kappa=1.0, theta=0.04, xi=1.0, dt=0.5)
    v_next, m, s2 = _step_stats(p, v_in=0.001)
    n = len(v_next)
    assert np.all(v_next >= 0.0)
    assert (v_next == 0.0).mean() > 0.3  # exponential branch's point mass
    assert abs(v_next.mean() - m) < 5 * np.sqrt(s2 / n)
    assert v_next.var() == pytest.approx(s2, rel=0.05)


def test_qe_martingale_exact():
    """Zero-strike call at 4 steps = discounted E[S_T] = s0 exactly
    (per-step martingale correction), even in the stress regime."""
    opt0 = OptionParams(s0=100.0, t=1.0, k=0.0, r=0.03)
    res = price_heston(opt0, STRESS,
                       SimParams(n_paths=1 << 19, n_steps=4, seed=11),
                       scheme="qe")
    err = abs(float(res.price) - 100.0)
    assert err <= 3.0 * float(res.stderr), (float(res.price),
                                            float(res.stderr))


def test_qe_coarse_bias_beats_euler():
    """At 8 steps in the stress regime Euler is ~10% biased; QE must be
    at least 5x closer to the CF oracle."""
    cf = heston_call_cf(100.0, 100.0, 1.0, 0.03, *STRESS.astuple())
    sim = SimParams(n_paths=1 << 18, n_steps=8, seed=7)
    eu = price_heston(OPT, STRESS, sim, scheme="euler")
    qe = price_heston(OPT, STRESS, sim, scheme="qe")
    err_eu = abs(float(eu.price) - cf)
    err_qe = abs(float(qe.price) - cf)
    assert err_eu > 0.5  # Euler really is biased here (guards the gate)
    assert err_qe < err_eu / 5.0, (err_qe, err_eu)
    # absolute: residual QE bias at 8 steps stays below 1% of price
    assert err_qe < 0.01 * cf


def test_qe_matches_cf_moderate_steps():
    cf = heston_call_cf(100.0, 100.0, 1.0, 0.03, *STRESS.astuple())
    res = price_heston(OPT, STRESS,
                       SimParams(n_paths=1 << 19, n_steps=32, seed=5),
                       scheme="qe", antithetic=True)
    tol = 4.0 * float(res.stderr) + 0.003 * cf
    assert abs(float(res.price) - cf) <= tol


def test_qe_antithetic_reduces_stderr():
    sim = SimParams(n_paths=50_000, n_steps=16, seed=3)
    plain = price_heston(OPT, STRESS, sim, scheme="qe",
                         tile_rows=8)
    anti = price_heston(OPT, STRESS, sim, scheme="qe",
                        antithetic=True, tile_rows=8)
    assert float(anti.stderr) < float(plain.stderr)


def test_qe_path_dependent_payoffs():
    sim = SimParams(n_paths=50_000, n_steps=16, seed=3)
    vanilla = price_heston(OPT, STRESS, sim, scheme="qe",
                           tile_rows=8)
    asian = price_heston(OPT, STRESS, sim, scheme="qe",
                         payoff="asian_call", tile_rows=8)
    assert 0.0 < float(asian.price) < float(vanilla.price)


def test_qe_disjoint_stream_from_euler():
    """QE uses counters (id, 2j)/(id, 2j+1); Euler uses (id, j) — the
    schemes must not produce correlated estimates at the same seed."""
    sim = SimParams(n_paths=50_000, n_steps=64, seed=9)
    eu = price_heston(OPT, STRESS, sim, scheme="euler",
                      tile_rows=8)
    qe = price_heston(OPT, STRESS, sim, scheme="qe",
                      tile_rows=8)
    assert float(eu.price) != float(qe.price)


def test_unknown_scheme_raises():
    with pytest.raises(ValueError, match="scheme"):
        price_heston(OPT, STRESS, SimParams(n_paths=1024, n_steps=2),
                     scheme="milstein")


def test_cli_heston_qe_smoke(capsys):
    import json

    from mc_tpu.cli import main
    rc = main(["heston", "--scheme", "qe", "--n-paths", "20000",
               "--n-steps", "8"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["scheme"] == "qe"
    assert abs(out["price"] - out["cf_oracle"]) < 0.5
