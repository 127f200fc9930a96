"""Nested Monte Carlo tests (reference inc/nmc.cuh, SURVEY.md C10-C12)."""

import jax.numpy as jnp
import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.nmc import price_nmc
from mc_tpu.oracle import bs_call

# Tiny but live config: barrier window reachable within 8 steps.
OPT = OptionParams(p1=1.0, p2=6.0)
SIM = SimParams(n_paths=1024, n_steps=8, n_paths_inner=64)


@pytest.fixture(scope="module")
def fused():
    """The kernel pipeline (trajectories + inner kernel), interpreted."""
    return price_nmc(OPT, SIM, engine="pallas", interpret=True)


def test_surface_shape(fused):
    n_steps, rows, lanes = fused.surface.shape
    assert n_steps == SIM.n_steps and lanes == 128
    assert rows * lanes >= SIM.n_paths  # padded to whole tiles
    assert fused.surface_matrix().shape == (SIM.n_paths, SIM.n_steps)


def test_engines_bitwise_identical(fused):
    xla = price_nmc(OPT, SIM, engine="xla")
    np.testing.assert_array_equal(np.asarray(fused.surface),
                                  np.asarray(xla.surface))
    assert float(fused.outer.price) == float(xla.outer.price)


def test_last_step_is_deterministic_payoff(fused):
    """remaining=0 at the last step: every inner path IS the stored state,
    so surface[last] must equal e^{-rT} * payoff(S_T, count_T) exactly."""
    from mc_tpu import simulate_trajectories
    traj = simulate_trajectories(OPT, SIM, payoff="bullet_call", tile_rows=8)
    s_t = np.asarray(traj.path_matrix())[:, -1]
    count = np.asarray(traj.state_matrix())[:, -1]
    in_window = (count >= 1.0) & (count <= 6.0)
    pay = np.where(in_window, np.maximum(s_t - 100.0, 0.0), 0.0)
    want = np.float32(np.exp(np.float32(-0.1))) * pay.astype(np.float32)
    got = np.asarray(fused.surface_matrix())[:, -1]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_tower_property(fused):
    """E[surface[:, j]] == outer price for every j (tower property of
    conditional expectation under the full-T discount)."""
    surf = np.asarray(fused.surface_matrix())
    outer = float(fused.outer.price)
    se = float(fused.outer.stderr)
    for j in range(SIM.n_steps):
        col_mean = surf[:, j].mean()
        # inner noise adds variance; allow a generous 5-se band
        assert abs(col_mean - outer) < 5.0 * se + 0.05 * outer, (j, col_mean, outer)


def test_surface_mean_close_to_outer(fused):
    assert float(fused.surface_mean) == pytest.approx(
        float(fused.outer.price), rel=0.1)


def test_vanilla_nmc_tower():
    """Vanilla payoff: every surface column estimates the BS price."""
    sim = SimParams(n_paths=2048, n_steps=4, n_paths_inner=128)
    res = price_nmc(OptionParams(), sim, payoff="vanilla_call")
    bs = float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2))
    surf = np.asarray(res.surface_matrix())
    for j in range(sim.n_steps):
        assert surf[:, j].mean() == pytest.approx(bs, rel=0.05), j


def test_remaining_discount():
    """discount='remaining': last step has no discount at all."""
    res = price_nmc(OPT, SIM, discount="remaining")
    res_full = price_nmc(OPT, SIM, discount="full")
    last = np.asarray(res.surface_matrix())[:, -1]
    last_full = np.asarray(res_full.surface_matrix())[:, -1]
    nz = last_full > 0
    assert nz.any()
    ratio = last[nz] / last_full[nz]
    np.testing.assert_allclose(ratio, np.exp(0.1), rtol=1e-5)


def test_outer_matches_plain_price():
    """The NMC outer estimate equals price() on the same stream."""
    from mc_tpu import price
    res = price_nmc(OPT, SIM)
    plain = price(OPT, SIM, payoff="bullet_call", tile_rows=8)
    assert float(res.outer.price) == float(plain.price)


def test_exposure_profile(fused):
    ee, pfe = fused.exposure_profile(0.9)
    ee = np.asarray(ee)
    pfe = np.asarray(pfe)
    assert ee.shape == (SIM.n_steps,)
    assert (ee >= 0).all() and (pfe >= ee - 1e-6).all()
    # the bullet value surface collapses toward 0/positive split at the
    # last step; EE at the final step equals mean of positive payoffs
    last = np.asarray(fused.surface_matrix())[:, -1]
    assert ee[-1] == pytest.approx(np.maximum(last, 0).mean(), rel=1e-5)


def test_inner_counter_space_guard():
    """Regression (advisor): configs whose inner draw counters would wrap
    uint32 (silently reusing streams) are rejected up front."""
    from mc_tpu.ops.nmc_kernels import NMCConfig
    with pytest.raises(ValueError, match="counter"):
        NMCConfig(n_paths=1024, n_steps=4096, n_inner=1024)
    NMCConfig(n_paths=1024, n_steps=100, n_inner=1000)  # demo config ok


# --- nested MC under Heston (model-family x NMC composition) --------------

def test_nmc_heston_tower_property():
    """With the full e^{-rT} discount, the mean surface value at EVERY
    step is an unbiased estimate of the European Heston price (tower
    property), and so is the outer estimate — gate both against the CF
    oracle."""
    from mc_tpu.models.heston import DEMO_HESTON, heston_call_cf
    from mc_tpu.nmc_heston import price_nmc_heston
    sim = SimParams(n_paths=16384, n_steps=8, n_paths_inner=32)
    r = price_nmc_heston(sim=sim)
    cf = heston_call_cf(100.0, 100.0, 1.0, 0.1, *DEMO_HESTON.astuple())
    # Euler bias at 8 steps + MC noise: generous combined tolerance
    assert abs(float(r.surface_mean) - cf) < 0.02 * cf + 4 * 0.15, (
        float(r.surface_mean), cf)
    assert abs(float(r.outer.price) - cf) <= \
        4.0 * float(r.outer.stderr) + 0.02 * cf


def test_nmc_heston_exposure_profile():
    """EE under stochastic vol: positive, finite, PFE above EE."""
    from mc_tpu.nmc_heston import price_nmc_heston
    sim = SimParams(n_paths=4096, n_steps=8, n_paths_inner=16)
    r = price_nmc_heston(sim=sim, payoff="vanilla_call")
    ee, pfe = r.exposure_profile()
    assert np.all(np.asarray(ee) > 0) and np.all(np.isfinite(np.asarray(ee)))
    assert np.all(np.asarray(pfe) >= np.asarray(ee) - 1e-5)


def test_nmc_heston_counter_guard():
    from mc_tpu.nmc_heston import price_nmc_heston
    with pytest.raises(ValueError, match="counter"):
        price_nmc_heston(sim=SimParams(n_paths=64, n_steps=4096,
                                       n_paths_inner=1024))


def test_cva_from_exposure():
    """Unilateral CVA rollup: matches a hand-computed sum over the EE
    profile, scales linearly in (1-R), and vanishes at zero hazard."""
    from mc_tpu.nmc import price_nmc
    sim = SimParams(n_paths=2048, n_steps=8, n_paths_inner=8)
    res = price_nmc(OptionParams(p1=1.0, p2=6.0), sim)
    ee, _ = res.exposure_profile()
    lam, rec = 0.02, 0.4
    t = np.arange(1, 9) / 8.0
    tp = np.concatenate([[0.0], t[:-1]])
    want = (1 - rec) * np.sum(np.asarray(ee)
                              * (np.exp(-lam * tp) - np.exp(-lam * t)))
    got = float(res.cva(lam, rec))
    assert got == pytest.approx(want, rel=1e-5)
    assert float(res.cva(0.0)) == 0.0
    assert float(res.cva(lam, 0.0)) == pytest.approx(got / (1 - rec),
                                                     rel=1e-5)


def test_cva_uses_option_maturity():
    """t_horizon defaults to the traded option's T, not 1.0: a T=2 trade
    spreads default probability over [0, 2]."""
    from mc_tpu.nmc import price_nmc
    sim = SimParams(n_paths=1024, n_steps=8, n_paths_inner=8)
    res = price_nmc(OptionParams(t=2.0, p1=1.0, p2=6.0), sim)
    assert float(res.t_horizon) == 2.0
    assert float(res.cva(0.02)) == pytest.approx(
        float(res.cva(0.02, t_horizon=2.0)), rel=1e-6)
    # The wrong-horizon answer differs: flat-hazard PDs over [0,1] put
    # more weight on early (lower-EE) steps.
    assert float(res.cva(0.02)) != pytest.approx(
        float(res.cva(0.02, t_horizon=1.0)), rel=1e-4)


