"""Trajectory-materialization tests (reference C9/C15/C16:
simulate_outer_trajectories + the Simulation harness CPU cross-checks)."""

import jax.numpy as jnp
import numpy as np
import pytest

from mc_tpu import SimParams, simulate_trajectories
from mc_tpu.config import OptionParams
from mc_tpu.rng import derive_key, normals

SIM = SimParams(n_paths=2048, n_steps=16)


@pytest.fixture(scope="module")
def traj():
    return simulate_trajectories(sim=SIM)


def test_shapes(traj):
    assert traj.path_matrix().shape == (SIM.n_paths, SIM.n_steps)
    assert traj.state_matrix().shape == (SIM.n_paths, SIM.n_steps)


def test_matches_host_recomputation(traj):
    """Bit-for-bit vs a pure-numpy-side GBM walk on the same RNG stream —
    the same-randomness CPU/GPU dual of inc/testing.cuh:75-91."""
    opt = OptionParams()
    key = derive_key(SIM.seed, 0)
    ids = jnp.arange(SIM.n_paths, dtype=jnp.uint32)
    z = np.asarray(normals(key, ids, n_draws=SIM.n_steps))  # (steps, paths)
    dt = 1.0 / SIM.n_steps
    drift = np.float32((0.1 - 0.5 * 0.2 * 0.2) * dt)
    vol = np.float32(0.2 * np.sqrt(np.float32(dt)))
    # log-space accumulation, matching the kernels
    w = np.zeros(SIM.n_paths, np.float32)
    path = np.asarray(traj.path_matrix())
    for j in range(SIM.n_steps):
        w = (w + (drift + vol * z[j].astype(np.float32))).astype(np.float32)
        s = np.float32(100.0) * np.exp(w, dtype=np.float32)
        np.testing.assert_allclose(path[:, j], s, rtol=1e-6)


def test_state_is_barrier_count(traj):
    """state grid == cumulative count of steps with S < B (cuh:304-305)."""
    path = np.asarray(traj.path_matrix())
    state = np.asarray(traj.state_matrix())
    want = np.cumsum(path < 120.0, axis=1).astype(np.float32)
    np.testing.assert_array_equal(state, want)


def test_payoff_partials_match_grid(traj):
    """The fused payoff sum equals recomputing the payoff from the grids."""
    path = np.asarray(traj.path_matrix())
    count = np.asarray(traj.state_matrix())[:, -1]
    s_t = path[:, -1]
    in_window = (count >= 10.0) & (count <= 50.0)
    pay = np.where(in_window, np.maximum(s_t - 100.0, 0.0), 0.0)
    assert float(traj.pay_sum) == pytest.approx(
        float(pay.astype(np.float64).sum()), rel=1e-5)


def test_resume_from_trajectory_state():
    """Kernels accept (S_k, state_k) resume arrays — the kernel form of the
    reference's (Ik, Sk, Tk) arguments (trajectories.cuh:116-117)."""
    from mc_tpu.ops import path_kernels as pk
    from mc_tpu.ops.payoffs import get_payoff
    from mc_tpu.ops.reduce import finish_sum
    from mc_tpu.config import OptionParams

    opt = OptionParams().as_f32()
    sim = SimParams(n_paths=1024, n_steps=8)
    key = jnp.asarray(derive_key(sim.seed, 0), jnp.uint32)
    params = pk.pack_params(opt, sim.n_steps)
    payoff = get_payoff("bullet_call")

    # Full run 0..8
    cfg_full = pk.KernelConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                               tile_rows=8)
    full = pk.simulate_partials(payoff, cfg_full, key, params,
                                interpret=True)

    # Two-phase: materialize to step 4, resume 4..8 from the stored state.
    half = SimParams(n_paths=1024, n_steps=8)
    traj = simulate_trajectories(sim=half, tile_rows=8)
    s4 = traj.s[3]          # price after step 4 (0-indexed step 3)
    c4 = traj.state[3]
    cfg_resume = pk.KernelConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                                 tile_rows=8, start_step=4)
    resumed = pk.simulate_partials(payoff, cfg_resume, key, params,
                                   s_init=s4, state_init=(c4,),
                                   interpret=True)
    assert float(finish_sum(full[0])) == pytest.approx(
        float(finish_sum(resumed[0])), rel=1e-6)
