"""Multi-chip sharding tests on the 8-device virtual CPU mesh.

The capability the reference lacks entirely (SURVEY.md section 2: no NCCL /
MPI / multi-device anywhere) — here it must hold a strong invariant: the
sharded price equals the single-chip price BIT-FOR-BIT, because RNG counters
are global path ids and the summation tree is shard-count-invariant only up
to the psum order...  so the test pins exact equality of draws (via the xla
engine) and statistical equality of the final price.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mc_tpu import SimParams, price
from mc_tpu.oracle import bs_call
from mc_tpu.parallel import make_mesh, price_sharded

BS = float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2))
SIM = SimParams(n_paths=100_000, n_steps=20)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return make_mesh()


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_sharded_within_3se(mesh, engine):
    res = price_sharded(sim=SIM, mesh=mesh, engine=engine, tile_rows=8,
                        interpret=engine == "pallas")
    assert abs(float(res.price) - BS) <= 3.5 * float(res.stderr)


def test_sharded_matches_single_chip_draws(mesh):
    """Global-path-id RNG: mesh size must not change the sampled payoffs.

    Compare via payoff mean: the sharded sum differs from the single-chip
    sum only by psum/Kahan grouping, so agreement to ~1e-6 relative proves
    the draws are the same stream (a wrong stream shifts the mean by
    ~stderr, 1e-2 relative here).
    """
    # method pinned: sharded pricing rides the classic per-path counter
    # stream (shards need path_offset), so the single-chip side must too.
    single = price(sim=SIM, tile_rows=8, method="terminal")
    sharded = price_sharded(sim=SIM, mesh=mesh, tile_rows=8)
    assert float(sharded.payoff_mean) == pytest.approx(
        float(single.payoff_mean), rel=2e-6)
    assert float(sharded.n_paths) == float(single.n_paths)


def test_sharded_mesh_size_invariance():
    """1-device mesh == 4-device mesh == 8-device mesh."""
    res = {}
    for n in (1, 4, 8):
        mesh = make_mesh(jax.devices()[:n])
        r = price_sharded(sim=SIM, mesh=mesh, tile_rows=8)
        res[n] = float(r.payoff_mean)
    assert res[1] == pytest.approx(res[4], rel=2e-6)
    assert res[4] == pytest.approx(res[8], rel=2e-6)


def test_sharded_bullet_and_variance_reduction(mesh):
    rb = price_sharded(sim=SIM, mesh=mesh, payoff="bullet_call", tile_rows=8)
    assert 0.0 < float(rb.price) < BS
    plain = price_sharded(sim=SIM, mesh=mesh, tile_rows=8)
    anti = price_sharded(sim=SIM, mesh=mesh, tile_rows=8,
                         antithetic=True)
    cv = price_sharded(sim=SIM, mesh=mesh, tile_rows=8,
                       method="euler", control_variate=True)
    assert float(anti.stderr) < float(plain.stderr)
    assert float(cv.stderr) < float(plain.stderr)


def test_uneven_shard_masking(mesh):
    """n_paths not divisible by (devices * tile) — overhang must be masked."""
    sim = SimParams(n_paths=10_000, n_steps=10)  # 10000 < 8*1024
    res = price_sharded(sim=sim, mesh=mesh, tile_rows=8)
    single = price(sim=sim, tile_rows=8, method="terminal")
    assert float(res.payoff_mean) == pytest.approx(
        float(single.payoff_mean), rel=2e-6)


def test_sharded_nmc_matches_single(mesh):
    """Sharded NMC == single-device NMC: same surface content (per global
    path id) and same outer price within psum reordering noise."""
    from mc_tpu.nmc import price_nmc
    from mc_tpu.parallel import price_nmc_sharded
    from mc_tpu import OptionParams

    opt = OptionParams(p1=1.0, p2=6.0)
    sim = SimParams(n_paths=2048, n_steps=8, n_paths_inner=16)
    single = price_nmc(opt, sim)
    shard = price_nmc_sharded(opt, sim, mesh=mesh)
    # each chip padded its local range: global rows >= single rows; compare
    # the valid path range through the matrix views
    a = np.asarray(single.surface_matrix())
    b = np.asarray(shard.surface_matrix())[: sim.n_paths]
    np.testing.assert_array_equal(a, b)
    assert float(shard.outer.payoff_mean) == pytest.approx(
        float(single.outer.payoff_mean), rel=2e-6)


def test_sharded_nmc_pallas_interpret(mesh):
    from mc_tpu.parallel import price_nmc_sharded
    from mc_tpu import OptionParams
    opt = OptionParams(p1=1.0, p2=6.0)
    sim = SimParams(n_paths=1024, n_steps=4, n_paths_inner=8)
    res = price_nmc_sharded(opt, sim, mesh=mesh, engine="pallas", interpret=True)
    assert float(res.outer.stderr) > 0


def test_sharded_importance_sampling(mesh):
    """IS through the sharded pricer: unbiased and matches single-chip."""
    import math
    from mc_tpu.oracle import bs_call
    from mc_tpu import OptionParams
    otm = OptionParams(k=180.0)
    shift = math.log(1.8) / 0.2
    sim = SimParams(n_paths=100_000, n_steps=10)
    res = price_sharded(otm, sim, mesh=mesh, method="euler",
                        tile_rows=8, importance_shift=shift)
    bs = float(bs_call(100.0, 180.0, 1.0, 0.1, 0.2))
    assert abs(float(res.price) - bs) <= 4.0 * float(res.stderr)
    single = price(otm, sim, method="euler", tile_rows=8,
                   importance_shift=shift)
    assert float(res.payoff_mean) == pytest.approx(
        float(single.payoff_mean), rel=2e-6)


def test_sharded_qmc_bitwise_mesh_invariant(mesh):
    """Shift-sharded QMC: per-shift means are computed identically on
    every chip, so the price is BIT-identical across mesh sizes AND to
    the single-chip price_qmc at equal n_shifts."""
    from mc_tpu.parallel import price_qmc_sharded
    from mc_tpu.qmc import price_qmc
    sim = SimParams(n_paths=4096, n_steps=8)
    a = price_qmc_sharded(sim=sim, mesh=mesh, n_shifts=8, tile_rows=8)
    b = price_qmc_sharded(sim=sim, mesh=make_mesh(jax.devices()[:1]),
                          n_shifts=8, tile_rows=8)
    c = price_qmc(sim=sim, n_shifts=8, tile_rows=8)
    assert float(a.price) == float(b.price) == float(c.price)
    assert float(a.stderr) == float(c.stderr)


def test_sharded_qmc_sobol_bridge(mesh):
    from mc_tpu.parallel import price_qmc_sharded
    from mc_tpu.oracle import bs_call
    sim = SimParams(n_paths=4096, n_steps=8)
    r = price_qmc_sharded(sim=sim, mesh=mesh, n_shifts=8, tile_rows=8,
                          family="sobol", bridge=True, method="euler")
    bs = float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2))
    assert abs(float(r.price) - bs) <= 5.0 * float(r.stderr) + 5e-3


def test_sharded_book_matches_single_chip(mesh):
    """Paths-sharded batched book: mesh-size invariant to reduce-order
    rounding and equal to the single-chip batched kernel."""
    from mc_tpu import OptionParams
    from mc_tpu.engines import price_portfolio
    from mc_tpu.parallel import price_portfolio_sharded
    book = OptionParams(
        s0=np.full(4, 100.0, np.float32),
        k=np.array([90.0, 100.0, 110.0, 100.0], np.float32),
        sigma=np.full(4, 0.2, np.float32),
        p1=np.full(4, 1.0, np.float32), p2=np.full(4, 6.0, np.float32))
    sim = SimParams(n_paths=4096, n_steps=8)
    a = price_portfolio_sharded(book, sim, "bullet_call", mesh=mesh,
                                tile_rows=8)
    b = price_portfolio_sharded(book, sim, "bullet_call",
                                mesh=make_mesh(jax.devices()[:1]),
                                tile_rows=8)
    c = price_portfolio(book, sim, "bullet_call", tile_rows=8)
    np.testing.assert_allclose(np.asarray(a.price), np.asarray(b.price),
                               rtol=2e-6)
    np.testing.assert_allclose(np.asarray(a.price), np.asarray(c.price),
                               rtol=2e-6)
    # CRN: the two k=100 contracts are bit-equal even across the mesh
    assert float(a.price[1]) == float(a.price[3])


def test_sharded_lsmc_matches_single_chip(mesh):
    """Distributed LSMC: psum'd normal equations give one global policy;
    a 1-chip mesh is bitwise the single-chip estimator and an 8-chip
    mesh agrees to gram-sum reduction-order tolerance."""
    from mc_tpu.lsmc import price_american
    from mc_tpu.parallel import price_american_sharded
    sim = SimParams(n_paths=50_000, n_steps=20)
    a = price_american_sharded(sim=sim, mesh=mesh)
    b = price_american_sharded(sim=sim, mesh=make_mesh(jax.devices()[:1]))
    c = price_american(sim=sim)
    assert float(b.price) == float(c.price)
    assert abs(float(a.price) - float(c.price)) <= 0.02
    assert float(a.stderr) > 0


def test_sharded_lsmc_bermudan(mesh):
    from mc_tpu.parallel import price_american_sharded
    sim = SimParams(n_paths=30_000, n_steps=20)
    amer = price_american_sharded(sim=sim, mesh=mesh)
    berm = price_american_sharded(sim=sim, mesh=mesh, exercise_every=4)
    tol = 3.0 * (float(amer.stderr) + float(berm.stderr))
    assert float(berm.price) <= float(amer.price) + tol
