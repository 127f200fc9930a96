"""Randomized-QMC tests: construction validity, unbiasedness, and the
convergence advantage over plain MC."""

import math

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams, price
from mc_tpu.oracle import bs_call
from mc_tpu.qmc import lattice_vector, prev_prime, price_qmc
from mc_tpu.rng import inv_normal_cdf

BS = float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2))


def test_prev_prime():
    assert prev_prime(100) == 97
    assert prev_prime(4099) == 4099
    assert prev_prime(1 << 21) < (1 << 20)  # capped


def test_lattice_vector_properties():
    n = 509
    z = lattice_vector(n, 8)
    assert z.shape == (8,)
    assert (z > 0).all() and (z < n).all()
    # components must generate distinct 1-d projections
    assert len(set(int(v) for v in z)) == 8


def test_inv_normal_cdf_accuracy():
    from scipy.stats import norm
    u = np.linspace(0.001, 0.999, 9973)
    err = np.abs(np.asarray(inv_normal_cdf(u)) - norm.ppf(u))
    assert err.max() < 1e-4


def test_lattice_points_uniform():
    """First two dimensions of the lattice should be ~uniform marginally."""
    import jax.numpy as jnp
    from mc_tpu.qmc import _lattice_u
    n = 1021
    z = lattice_vector(n, 2)
    ids = jnp.arange(n, dtype=jnp.uint32)
    u0 = np.asarray(_lattice_u(ids, jnp.uint32(int(z[0])),
                               jnp.float32(0.3), n))
    # every lattice point in dim j is {i*z_j/n} + shift: a permutation of
    # the n/n grid -> exactly uniform
    assert abs(u0.mean() - 0.5) < 1e-3
    assert len(np.unique(np.round(u0 * n).astype(int) % n)) == n


def test_qmc_unbiased_terminal():
    res = price_qmc(sim=SimParams(n_paths=4099, n_steps=10), n_shifts=8,
                    tile_rows=8)
    assert abs(float(res.price) - BS) <= 4.0 * float(res.stderr) + 5e-3


def test_qmc_beats_mc_at_same_budget():
    """16 shifts x 4099 points vs plain MC with the same total paths."""
    n, shifts = 4099, 16
    qmc = price_qmc(sim=SimParams(n_paths=n, n_steps=10), n_shifts=shifts, tile_rows=8)
    mc = price(sim=SimParams(n_paths=n * shifts, n_steps=10),
               method="terminal", tile_rows=8)
    # the lattice rate should cut stderr by well over 2x at this size
    assert float(qmc.stderr) < 0.5 * float(mc.stderr), (
        float(qmc.stderr), float(mc.stderr))
    assert abs(float(qmc.price) - BS) < 5e-2


def test_qmc_euler_path_dependent():
    res = price_qmc(OptionParams(p1=1.0, p2=8.0),
                    SimParams(n_paths=2053, n_steps=10), payoff="bullet_call",
                    n_shifts=8, tile_rows=8)
    assert 0.0 < float(res.price) < BS
    assert float(res.stderr) > 0.0


def test_qmc_guards():
    with pytest.raises(ValueError):
        price_qmc(n_shifts=1)
    with pytest.raises(ValueError):
        price_qmc(payoff="bullet_call", method="terminal")


def test_bridge_schedule_valid():
    from mc_tpu.qmc import bridge_schedule
    for n in (4, 7, 16, 100):
        idx, coef = bridge_schedule(n)
        assert idx.shape == (n, 3) and coef.shape == (n, 3)
        assert idx[0, 0] == n  # terminal first
        # every interior node set exactly once
        assert sorted(idx[:, 0]) == sorted(set(range(1, n + 1)))
        # total variance of the constructed walk: Var(W_n) = n
        assert coef[0, 2] == pytest.approx(math.sqrt(n))


def test_bridge_marginals_match_plain():
    """Bridge reorders dimensions but W increments stay N(0,1): the price
    estimate must agree with the non-bridge QMC within the error bars."""
    from mc_tpu import SimParams
    sim = SimParams(n_paths=4099, n_steps=16)
    plain = price_qmc(sim=sim, method="euler", n_shifts=8,
                      tile_rows=8)
    bridged = price_qmc(sim=sim, method="euler", n_shifts=8,
                        tile_rows=8, bridge=True)
    tol = 5.0 * (float(plain.stderr) + float(bridged.stderr)) + 1e-3
    assert abs(float(plain.price) - float(bridged.price)) <= tol
    assert abs(float(bridged.price) - BS) <= 5.0 * float(bridged.stderr) + 5e-3


def test_bridge_improves_asian():
    """Asian (smooth, path-dependent): the bridge should cut the QMC
    stderr further by mapping leading dimensions to coarse levels."""
    from mc_tpu import SimParams
    sim = SimParams(n_paths=16381, n_steps=32)
    plain = price_qmc(sim=sim, payoff="asian_call", n_shifts=12, tile_rows=8)
    bridged = price_qmc(sim=sim, payoff="asian_call", n_shifts=12, tile_rows=8, bridge=True)
    assert float(bridged.stderr) < float(plain.stderr)


def test_bridge_guard():
    with pytest.raises(ValueError, match="bridge"):
        price_qmc(bridge=True, method="terminal")


def test_bridge_vmem_cap_on_default_tile_rows():
    """bridge=True at the default tile_rows and n_steps=100 would hold a
    ~13 MB per-tile bridge buffer; tile_rows auto-shrinks so it stays
    ~4 MB."""
    sim = SimParams(n_paths=1 << 14, n_steps=100)
    r = price_qmc(sim=sim, method="euler", n_shifts=2,
                  bridge=True)  # default tile_rows -> capped at 80
    assert np.isfinite(float(r.price)) and float(r.stderr) > 0


# --- Sobol digital-net family --------------------------------------------

def test_sobol_directions_match_scipy_points():
    """Our direct Gray-code formula with the extracted direction table
    reproduces scipy's first Sobol points exactly."""
    from scipy.stats import qmc as sqmc

    from mc_tpu.qmc import SOBOL_BITS, sobol_directions
    pts = sqmc.Sobol(d=5, scramble=False).random(16)
    sv = sobol_directions(5)

    def direct(i, j):
        g = i ^ (i >> 1)
        acc = 0
        for k in range(SOBOL_BITS):
            if (g >> k) & 1:
                acc ^= int(sv[j, k])
        return acc / 2.0 ** SOBOL_BITS

    ours = np.array([[direct(i, j) for j in range(5)] for i in range(16)])
    np.testing.assert_allclose(ours, pts, atol=1e-12)


def test_sobol_unbiased_terminal():
    res = price_qmc(sim=SimParams(n_paths=4096, n_steps=10), n_shifts=8,
                    family="sobol", tile_rows=8)
    assert abs(float(res.price) - BS) <= 4.0 * float(res.stderr) + 5e-3


def test_sobol_beats_mc_at_same_budget():
    n, shifts = 4096, 16
    s = price_qmc(sim=SimParams(n_paths=n, n_steps=10), n_shifts=shifts,
                  family="sobol", tile_rows=8)
    mc = price(sim=SimParams(n_paths=n * shifts, n_steps=10),
               method="terminal", tile_rows=8)
    assert float(s.stderr) < 0.5 * float(mc.stderr), (
        float(s.stderr), float(mc.stderr))
    assert abs(float(s.price) - BS) < 5e-2


def test_sobol_bridge_asian():
    """Sobol + Brownian bridge on the Asian call: a valid price from the
    canonical digital-net/bridge combination."""
    sim = SimParams(n_paths=8192, n_steps=16)
    a = price_qmc(sim=sim, payoff="asian_call", n_shifts=8, family="sobol",
                  tile_rows=8, bridge=True)
    assert 0.0 < float(a.price) < BS and float(a.stderr) > 0


def test_sobol_family_guard():
    with pytest.raises(ValueError, match="family"):
        price_qmc(family="halton")


# --- QMC over model families (round 3) -------------------------------------

def test_qmc_heston_matches_cf():
    """Heston QMC agrees with the CF oracle within its own stderr and
    beats plain MC variance at equal budget (the measured reduction)."""
    from mc_tpu.models.heston import (DEMO_HESTON, heston_call_cf,
                                      price_heston)
    from mc_tpu.qmc import price_qmc_model
    sim = SimParams(n_paths=1 << 14, n_steps=16)
    q = price_qmc_model("heston", sim=sim, n_shifts=8)
    cf = heston_call_cf(100.0, 100.0, 1.0, 0.1, *DEMO_HESTON.astuple())
    assert abs(float(q.price) - cf) <= 3.5 * float(q.stderr)
    mc = price_heston(sim=SimParams(n_paths=8 * (1 << 14), n_steps=16))
    assert float(q.stderr) < 0.55 * float(mc.stderr)  # measured ~3x


def test_qmc_basket_matches_mc():
    """Basket QMC agrees with plain MC within joint stderr; variance
    reduction is large (measured ~10x at 16 steps, 4 assets)."""
    from mc_tpu.models.basket import price_basket
    from mc_tpu.qmc import price_qmc_model
    sim = SimParams(n_paths=1 << 14, n_steps=16)
    q = price_qmc_model("basket", sim=sim, n_shifts=8)
    mc = price_basket(sim=SimParams(n_paths=8 * (1 << 14), n_steps=16))
    joint = (float(q.stderr) ** 2 + float(mc.stderr) ** 2) ** 0.5
    assert abs(float(q.price) - float(mc.price)) <= 3.5 * joint
    assert float(q.stderr) < 0.4 * float(mc.stderr)


def test_qmc_model_path_dependent_payoff():
    """Path-dependent payoffs ride the same legs (asian under Heston)."""
    from mc_tpu.qmc import price_qmc_model
    sim = SimParams(n_paths=1 << 13, n_steps=16)
    r = price_qmc_model("heston", sim=sim, payoff="asian_call",
                        n_shifts=8)
    assert 0.0 < float(r.price) < 15.0
    assert float(r.stderr) > 0.0


def test_qmc_model_validation():
    from mc_tpu.qmc import price_qmc_model
    with pytest.raises(ValueError, match="heston"):
        price_qmc_model("rainbow2")
    with pytest.raises(ValueError, match="n_shifts"):
        price_qmc_model("heston", n_shifts=1)


def test_qmc_model_validates_payoff():
    from mc_tpu.qmc import price_qmc_model
    with pytest.raises(ValueError, match="determination step"):
        price_qmc_model("heston", OptionParams(p1=999.0),
                        payoff="forward_start_call",
                        sim=SimParams(n_paths=1 << 12, n_steps=8))


def test_qmc_cev_and_sabr_match_mc():
    """CEV/SABR QMC agree with plain MC at the SAME discretization
    within joint stderr, with a measured variance reduction."""
    from mc_tpu.models.cev import price_cev
    from mc_tpu.models.sabr import price_sabr
    from mc_tpu.qmc import price_qmc_model
    sim = SimParams(n_paths=1 << 14, n_steps=16)
    big = SimParams(n_paths=8 * (1 << 14), n_steps=16)
    from mc_tpu.models.localvol import LocalVolSurface, price_localvol

    def lv(sim):
        return price_localvol(surf=LocalVolSurface.demo(sim.n_steps),
                              sim=sim)

    for model, mc_fn in (("cev", price_cev), ("sabr", price_sabr),
                         ("localvol", lv)):
        q = price_qmc_model(model, sim=sim, n_shifts=8)
        mc = mc_fn(sim=big)
        joint = (float(q.stderr) ** 2 + float(mc.stderr) ** 2) ** 0.5
        assert abs(float(q.price) - float(mc.price)) <= 3.5 * joint, model
        assert float(q.stderr) < 0.6 * float(mc.stderr), model


def test_qmc_model_sharded_bitwise_mesh_invariant():
    """Shift-sharded model QMC: 1-device mesh bitwise == single-chip;
    mesh size never changes the bits (per-shift means identical)."""
    import jax

    from mc_tpu.parallel import make_mesh, price_qmc_model_sharded
    from mc_tpu.qmc import price_qmc_model
    sim = SimParams(n_paths=1 << 13, n_steps=8)
    single = price_qmc_model("heston", sim=sim, n_shifts=8,
                             tile_rows=8)
    m1 = price_qmc_model_sharded("heston", sim=sim, n_shifts=8,
                                 mesh=make_mesh(jax.devices()[:1]),
                                 tile_rows=8)
    m8 = price_qmc_model_sharded("heston", sim=sim, n_shifts=8,
                                 mesh=make_mesh(jax.devices()[:8]),
                                 tile_rows=8)
    assert float(m1.price) == float(single.price)
    assert float(m1.stderr) == float(single.stderr)
    assert float(m8.price) == float(m1.price)


# --- QMC over the remaining step-loop families (round 3, late) -------------

def test_qmc_vasicek_zcb_exact():
    """QMC under stochastic rates: the zcb payoff (pays 1, pathwise
    discounted) must hit the Vasicek P(0,T) closed form within stderr —
    the discount is INSIDE the leg, so this also pins the no-double-
    discount contract of the model QMC impl."""
    from mc_tpu.models.vasicek import DEMO_VASICEK
    from mc_tpu.oracle import vasicek_zcb
    from mc_tpu.qmc import price_qmc_model
    sim = SimParams(n_paths=1 << 13, n_steps=16)
    q = price_qmc_model("vasicek", sim=sim, payoff="zcb", n_shifts=8)
    d = DEMO_VASICEK
    want = float(vasicek_zcb(0.1, float(d.a), float(d.b),
                             float(d.sigma_r), 1.0))
    assert abs(float(q.price) - want) <= 3.5 * float(q.stderr) + 1e-4


def test_qmc_vasicek_matches_mc():
    from mc_tpu.models.vasicek import price_vasicek
    from mc_tpu.qmc import price_qmc_model
    sim = SimParams(n_paths=1 << 14, n_steps=16)
    q = price_qmc_model("vasicek", sim=sim, n_shifts=8)
    mc = price_vasicek(sim=SimParams(n_paths=8 * (1 << 14), n_steps=16))
    joint = (float(q.stderr) ** 2 + float(mc.stderr) ** 2) ** 0.5
    assert abs(float(q.price) - float(mc.price)) <= 3.5 * joint
    assert float(q.stderr) < 0.7 * float(mc.stderr)


def test_qmc_bates_matches_cf_oracle():
    """SVJ QMC on the packed 4-dims-per-step layout (round-4 advisor
    finding: the old 6-per-step layout left a third of the allocated
    dimensions dead): gated on the factorized Bates CF oracle with a
    variance-reduction check against plain MC."""
    from mc_tpu.models.bates import DEMO_BATES, bates_call_cf, price_bates
    from mc_tpu.qmc import price_qmc_model
    sim = SimParams(n_paths=1 << 14, n_steps=16)
    d = DEMO_BATES
    q = price_qmc_model("bates", sim=sim, n_shifts=8)
    ref = float(bates_call_cf(100.0, 100.0, 1.0, 0.1, d.v0, d.kappa,
                              d.theta, d.xi, d.rho, d.lam, d.mu_j,
                              d.sigma_j))
    # Euler diffusion bias at 16 steps + QMC stderr
    assert abs(float(q.price) - ref) <= 4.0 * float(q.stderr) + 0.02 * ref
    mc = price_bates(sim=SimParams(n_paths=1 << 17, n_steps=16))
    # equal-budget comparison: per-point efficiency must beat MC
    se_mc_at_qmc_budget = float(mc.stderr) * (
        (1 << 17) / (sim.n_paths * 8)) ** 0.5
    assert float(q.stderr) < se_mc_at_qmc_budget


def test_qmc_merton_matches_series_oracle():
    """Jump-diffusion QMC: Poisson counts from RAW QMC uniforms
    (draw_pair.unit), sizes/diffusion from inverse-CDF normals; price
    gated on the Merton-76 series oracle."""
    from mc_tpu.models.merton import DEMO_MERTON, merton_call_closed_form
    from mc_tpu.qmc import price_qmc_model
    sim = SimParams(n_paths=1 << 14, n_steps=16)
    d = DEMO_MERTON
    q = price_qmc_model("merton", sim=sim, n_shifts=8)
    want = float(merton_call_closed_form(100.0, 100.0, 1.0, 0.1, 0.2,
                                         d.lam, d.mu_j, d.sigma_j))
    assert abs(float(q.price) - want) <= 3.5 * float(q.stderr) + 2e-3


def test_qmc_term_matches_exact():
    """Deterministic-curve QMC vs the averaged-BS exact value (the
    terminal log is Gaussian under the curves, so the gate is sharp)."""
    from mc_tpu.models.term import TermStructure, price_term
    from mc_tpu.qmc import price_qmc_model
    sim = SimParams(n_paths=1 << 14, n_steps=16)
    term = TermStructure.from_knots([0.10, 0.05], [0.15, 0.30], 16)
    q = price_qmc_model("term", dyn=term, sim=sim, n_shifts=8)
    mc = price_term(term=term,
                    sim=SimParams(n_paths=8 * (1 << 14), n_steps=16))
    joint = (float(q.stderr) ** 2 + float(mc.stderr) ** 2) ** 0.5
    assert abs(float(q.price) - float(mc.price)) <= 3.5 * joint
    assert float(q.stderr) < 0.7 * float(mc.stderr)


def test_qmc_new_models_sharded_bitwise():
    import jax

    from mc_tpu.parallel import make_mesh, price_qmc_model_sharded
    from mc_tpu.qmc import price_qmc_model
    sim = SimParams(n_paths=1 << 12, n_steps=8)
    for model in ("vasicek", "merton", "term", "bates"):
        single = price_qmc_model(model, sim=sim, n_shifts=4, tile_rows=8)
        m2 = price_qmc_model_sharded(model, sim=sim, n_shifts=4, tile_rows=8,
                                     mesh=make_mesh(jax.devices()[:2]))
        assert float(m2.price) == float(single.price), model
