"""Generic multilevel MC over the NMCFamily rollout hooks.

The estimator's correctness splits into two independent claims, tested
separately:

1. UNBIASEDNESS needs no coupling-quality assumption — the coarse leg at
   level l is driven by (z1+z2)/sqrt(2) sums, iid standard normals, so
   its law equals level l-1's fine leg and the telescope is exact.
   Gated against each family's analytic oracle (Schroder chi^2 for CEV,
   the Heston CF, the Vasicek ZCB closed form).
2. COUPLING QUALITY (variance decay) is measured: Var[Y_l] must shrink
   geometrically for Euler-biased schemes, and the corrections of
   exact-in-law schemes (vasicek's OU triple) must be statistically
   zero at every level.
"""

import numpy as np
import pytest

from mc_tpu import OptionParams
from mc_tpu.mlmc import price_heston_mlmc, price_mlmc_family


@pytest.fixture(scope="module")
def cev_result():
    return price_mlmc_family("cev", OptionParams(), n0=4, n_levels=4,
                             n_pilot=20_000,
                             n_per_level=(200_000, 40_000, 16_000, 8_000),
                             tile_rows=8)


def test_cev_matches_schroder_oracle(cev_result):
    from mc_tpu.models.cev import DEMO_CEV, cev_call_closed_form
    ref = cev_call_closed_form(100.0, 100.0, 1.0, 0.1, DEMO_CEV.sigma_lv,
                               DEMO_CEV.beta)
    # finest level = 32 substeps: allow residual O(dt) bias + 4 se
    tol = 4.0 * cev_result.stderr + 0.012 * ref
    assert abs(cev_result.price - ref) <= tol, (cev_result.price, ref)


def test_cev_variance_decays(cev_result):
    v = np.asarray(cev_result.level_vars)
    assert v[1] < 1e-2 * v[0], v  # coupling collapses the correction
    assert cev_result.variance_decay_rate() > 0.5, v


def test_heston_family_matches_dedicated_estimator():
    """The rollout-hook estimator and the dedicated fused Pallas tile
    price the same telescoped quantity — agree within joint stderr
    (independent streams, so statistical, not bitwise)."""
    kw = dict(n0=4, n_levels=4, n_pilot=8192,
              n_per_level=(120_000, 30_000, 12_000, 6_000), tile_rows=8)
    a = price_mlmc_family("heston", OptionParams(), **kw)
    b = price_heston_mlmc(OptionParams(), **kw)
    joint = np.hypot(a.stderr, b.stderr)
    assert abs(a.price - b.price) <= 4.0 * joint, (a.price, b.price)
    assert a.variance_decay_rate() > 0.5


def test_vasicek_exact_scheme_corrections_are_zero():
    """The exact OU triple has NO discretization bias: every correction
    E[Y_l] is statistically zero and the level-0 ZCB price (pathwise
    discounting, payoff=1) hits the closed form."""
    from mc_tpu import oracle
    from mc_tpu.models.vasicek import DEMO_VASICEK
    r = price_mlmc_family("vasicek", OptionParams(), payoff="zcb",
                          n0=4, n_levels=3, n_pilot=8192,
                          n_per_level=(65_536, 16_384, 8_192),
                          tile_rows=8)
    d = DEMO_VASICEK  # r0 = option.r by the family's convention
    ref = oracle.vasicek_zcb(0.1, d.a, d.b, d.sigma_r, 1.0)
    assert abs(r.price - float(ref)) <= 4.0 * r.stderr + 2e-4
    for m, v, n in zip(r.level_means[1:], r.level_vars[1:],
                       r.n_per_level[1:]):
        se = np.sqrt(v / n)
        assert abs(m) <= 5.0 * se + 1e-5, (m, se)


def test_sabr_asian_path_payoff():
    """Path payoffs refine with the grid (Giles's Asian setting): the
    family estimator tracks payoff state per leg on its OWN grid and
    the variance still collapses under coupling."""
    r = price_mlmc_family("sabr", OptionParams(), payoff="asian_call",
                          n0=4, n_levels=3, n_pilot=8192,
                          n_per_level=(65_536, 16_384, 8_192),
                          tile_rows=8)
    v = np.asarray(r.level_vars)
    assert v[1] < 0.05 * v[0], v
    assert r.price > 0.0 and r.stderr > 0.0


def test_excluded_families_raise():
    # merton is SUPPORTED since the increment-level coupling hook
    with pytest.raises(ValueError, match="surface"):
        price_mlmc_family("localvol")
    with pytest.raises(ValueError, match="sim grid"):
        price_mlmc_family("term")
    with pytest.raises(ValueError, match="unknown model family"):
        price_mlmc_family("nope")
    with pytest.raises(ValueError, match="grid-refinable"):
        price_mlmc_family("cev", payoff="bullet_call")


def test_sharded_mlmc_mesh_invariant():
    """Every level's path range shards over the mesh; streams key by
    global path id, so a 1-device mesh is BITWISE the single-chip
    estimator and the 8-device mesh reproduces it."""
    import jax

    from mc_tpu.parallel import make_mesh
    kw = dict(n0=4, n_levels=3, n_pilot=4096,
              n_per_level=(16384, 8192, 4096), tile_rows=8)
    single = price_mlmc_family("cev", OptionParams(), **kw)
    m1 = price_mlmc_family("cev", OptionParams(),
                           mesh=make_mesh(jax.devices()[:1]), **kw)
    m8 = price_mlmc_family("cev", OptionParams(), mesh=make_mesh(), **kw)
    assert m1.price == single.price
    assert abs(m8.price - single.price) <= 1e-6 * abs(single.price)
    assert m8.n_per_level == single.n_per_level


def test_eps_driven_allocation():
    """The standard N_l ~ sqrt(V_l/C_l) allocation (no explicit
    n_per_level): achieved stderr lands at or under ~eps/sqrt(2) scale
    and deeper levels get fewer paths."""
    r = price_mlmc_family("cev", OptionParams(), n0=2, n_levels=3,
                          n_pilot=4096, eps=0.05, tile_rows=8)
    assert r.stderr <= 0.08
    assert r.n_per_level[0] >= r.n_per_level[1] >= r.n_per_level[2]


def test_merton_terminal_exact_in_law():
    """Merton's per-step log increment is exact in law at ANY grid, and
    the increment-level coupling (coarse jump = SUM of the two fine
    compound increments) makes the coarse leg's law exactly the coarser
    grid's fine leg — so coupled corrections are pure fp-rounding
    residue (measured |mean| ~2e-6 on a ~14 price) and the telescoped
    total matches the Merton-76 series oracle."""
    from mc_tpu.models.merton import DEMO_MERTON, merton_call_closed_form
    r = price_mlmc_family("merton", OptionParams(), n0=4, n_levels=4,
                          n_pilot=8192,
                          n_per_level=(200_000, 40_000, 16_000, 8_000),
                          tile_rows=8)
    ref = merton_call_closed_form(100.0, 100.0, 1.0, 0.1, 0.2,
                                  DEMO_MERTON.lam, DEMO_MERTON.mu_j,
                                  DEMO_MERTON.sigma_j)
    assert abs(r.price - float(ref)) <= 4.0 * r.stderr, (r.price, ref)
    for m in r.level_means[1:]:
        assert abs(m) < 1e-4, r.level_means


def test_merton_asian_coupling_decays_and_matches_fine_grid():
    """The real MLMC use under jumps: the Asian's observation grid
    refines, corrections are nonzero, variance decays geometrically
    (measured rate ~2), and the telescoped price matches a plain
    fine-grid run within joint stderr."""
    from mc_tpu.config import SimParams
    from mc_tpu.models.merton import price_merton
    r = price_mlmc_family("merton", OptionParams(), payoff="asian_call",
                          n0=4, n_levels=4, n_pilot=8192,
                          n_per_level=(200_000, 60_000, 24_000, 10_000),
                          tile_rows=8)
    assert r.variance_decay_rate() > 1.0, r.level_vars
    ref = price_merton(OptionParams(),
                       sim=SimParams(n_paths=1 << 19, n_steps=32),
                       payoff="asian_call")
    joint = np.hypot(r.stderr, float(ref.stderr))
    assert abs(r.price - float(ref.price)) <= 4.0 * joint


def test_jump_family_kmax_covers_the_coarsest_grid():
    """Regression (round-4 advisor): the static Poisson scan depth used
    by EVERY level must cover the COARSEST grid's per-step intensity
    lam*T/n0.  Keying bates' builder off the finest grid gave kmax=4
    where the coarse legs need 7 (lam=0.3, n0=4, 5 levels), truncating
    the coarse jump-count distribution and biasing the telescope."""
    from mc_tpu.config import SimParams
    from mc_tpu.mlmc import _family_builder_steps
    from mc_tpu.models.merton import poisson_kmax
    from mc_tpu.nmc_engine import NMC_FAMILY_BUILDERS, ensure_family

    n0, n_levels = 4, 5
    fines = tuple(n0 * (1 << l) for l in range(n_levels))
    for model in ("merton", "bates"):
        ensure_family(model)
        steps = _family_builder_steps(model, n0, fines)
        assert steps == n0
        opt = OptionParams().as_f32()
        fam, dyn32 = NMC_FAMILY_BUILDERS[model](
            opt, None, SimParams(n_paths=1024, n_steps=steps))
        need = poisson_kmax(float(dyn32.lam) * float(opt.t) / n0)
        assert fam.kmax >= need, (model, fam.kmax, need)
    # diffusion families still key off the finest grid (scheme tables)
    assert _family_builder_steps("heston", n0, fines) == fines[-1]


def test_bates_mlmc_matches_cf_oracle():
    """MLMC telescope under Bates gates against the factorized CF oracle
    (jump part exact in law per step; Heston substep Euler-biased)."""
    from mc_tpu.models.bates import DEMO_BATES, bates_call_cf

    res = price_mlmc_family("bates", OptionParams(), n0=4, n_levels=4,
                            n_pilot=20_000,
                            n_per_level=(150_000, 40_000, 16_000, 8_000),
                            tile_rows=8)
    d = DEMO_BATES
    ref = float(bates_call_cf(100.0, 100.0, 1.0, 0.1, d.v0, d.kappa,
                              d.theta, d.xi, d.rho, d.lam, d.mu_j,
                              d.sigma_j))
    tol = 4.0 * res.stderr + 0.02 * ref  # finest level = 32 substeps
    assert abs(res.price - ref) <= tol, (res.price, ref, tol)
    assert res.variance_decay_rate() > 0.5
