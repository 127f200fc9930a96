"""Multilevel Monte Carlo tests (Heston Euler-bias removal)."""

import numpy as np
import pytest

from mc_tpu import OptionParams
from mc_tpu.mlmc import price_heston_mlmc
from mc_tpu.models.heston import DEMO_HESTON, heston_call_cf


@pytest.fixture(scope="module")
def result():
    # near-optimal allocation shape N_l ~ sqrt(V_l / C_l)
    return price_heston_mlmc(OptionParams(), DEMO_HESTON, n0=4, n_levels=5,
                             n_pilot=20_000,
                             n_per_level=(200_000, 52_000, 23_000,
                                          11_000, 5_000), tile_rows=8)


def test_mlmc_matches_cf_oracle(result):
    ref = heston_call_cf(100.0, 100.0, 1.0, 0.1, *DEMO_HESTON.astuple())
    # finest level = 64 substeps: residual bias ~ O(1/64); allow 4 se + 1%
    tol = 4.0 * result.stderr + 0.01 * ref
    assert abs(result.price - ref) <= tol, (result.price, ref)


def test_level_variance_decays(result):
    """Var[Y_l] must decay geometrically — the whole point of coupling."""
    v = np.asarray(result.level_vars)
    assert v[1] < v[0]            # first correction already much smaller
    rate = result.variance_decay_rate()
    assert rate > 0.5, (rate, v)  # ~O(dt) decay (beta ~ 1) expected


def test_level_means_telescope(result):
    """Corrections shrink: |E[Y_l]| decays with level (weak order 1)."""
    m = np.abs(np.asarray(result.level_means[1:]))
    assert m[-1] < m[0]


def test_mlmc_cheaper_than_single_level(result):
    """Cost comparison at equal variance: MLMC total substep count vs a
    single-level estimator at the finest grid with the same stderr."""
    v = np.asarray(result.level_vars)
    n = np.asarray(result.n_per_level, float)
    cost_mlmc = float(np.sum(n * np.asarray(result.levels)))
    # single-level at finest grid needs N = V0/stderr_target^2 paths
    var_target = float(np.sum(v / n))
    n_single = v[0] / var_target
    cost_single = n_single * result.levels[-1]
    # with the near-optimal allocation the multilevel estimator should
    # cost well under the single-finest-level estimator at equal variance
    assert cost_mlmc < 0.7 * cost_single, (cost_mlmc, cost_single)


def test_guard_path_dependent():
    with pytest.raises(ValueError, match="grid-refinable"):
        price_heston_mlmc(payoff="bullet_call")


def test_odd_n_fine_integrates_full_horizon():
    """Regression (advisor): odd n_fine previously dropped the last
    substep — n_fine=1 took ZERO steps and returned payoff(S0) (= 0 ATM)."""
    import jax.numpy as jnp

    from mc_tpu.mlmc import heston_level_moments
    from mc_tpu.ops.payoffs import get_payoff
    from mc_tpu import rng

    po = get_payoff("vanilla_call")
    key = jnp.asarray(rng.derive_key(7, 0x4D4C, 0), jnp.uint32)
    n = 8 * 128 * 8
    s1, _ = heston_level_moments(OptionParams().as_f32(),
                                 DEMO_HESTON.as_f32(), po, n, 1, False,
                                 8, key)
    m1 = float(s1) / n
    assert m1 > 1.0, m1  # one genuine full-horizon Euler step, not 0.0
    # odd count on a COUPLED level is un-pairable and must fail loudly
    with pytest.raises(ValueError, match="even"):
        heston_level_moments(OptionParams().as_f32(),
                             DEMO_HESTON.as_f32(), po, n, 3, True, 8, key)


def test_n0_one_prices_sanely():
    r = price_heston_mlmc(n0=1, n_levels=4, n_pilot=8192,
                          n_per_level=(65536, 16384, 8192, 8192),
                          tile_rows=8)
    ref = heston_call_cf(100.0, 100.0, 1.0, 0.1, *DEMO_HESTON.astuple())
    # n0=1 is very coarse; just require a live estimate in the right zone
    assert 0.5 * ref < r.price < 1.5 * ref, (r.price, ref)


def test_n0_zero_rejected():
    with pytest.raises(ValueError, match="n0"):
        price_heston_mlmc(n0=0)


def test_mlmc_asian_matches_fine_single_level():
    """Path-dependent MLMC (Giles's Asian case): the telescoped estimate
    must match a fine-grid single-level Heston Asian price, and the
    coupled-level variance must decay geometrically."""
    from mc_tpu import SimParams
    from mc_tpu.models.heston import price_heston
    r = price_heston_mlmc(payoff="asian_call", n0=4, n_levels=5,
                          n_pilot=16384,
                          n_per_level=(131072, 32768, 16384, 8192, 8192),
                          tile_rows=8)
    ref = price_heston(sim=SimParams(n_paths=1 << 20, n_steps=64),
                       payoff="asian_call", tile_rows=8)
    tol = 4.0 * (r.stderr + float(ref.stderr)) + 0.02
    assert abs(r.price - float(ref.price)) <= tol, (r.price,
                                                    float(ref.price))
    assert r.variance_decay_rate() > 0.7, r.level_vars


def test_mlmc_lookback_sane():
    r = price_heston_mlmc(payoff="lookback_call", n0=4, n_levels=4,
                          n_pilot=16384,
                          n_per_level=(65536, 16384, 8192, 8192),
                          tile_rows=8)
    assert np.isfinite(r.price) and r.price > 10.0  # lookback >> vanilla
    v = np.asarray(r.level_vars)
    assert v[-1] < v[1]  # corrections shrink (lookback beta ~ 1/2-1)


def test_mlmc_rejects_grid_defined_contract():
    with pytest.raises(ValueError, match="grid-refinable"):
        price_heston_mlmc(payoff="bullet_call")
