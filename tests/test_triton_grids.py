"""Grid-writing Triton kernels, interpreted on the CPU, against XLA.

The trajectory kernel (the reference's C9 pass) and the NMC inner kernel
(C10) write whole (n_steps, rows, 128) grids; the Kahan finisher sums the
per-tile slabs the path kernels write.  Each is held to its XLA twin bit
for bit, over payoffs with and without state, path offsets, both discount
conventions and ragged path counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams, simulate_trajectories
from mc_tpu.nmc import price_nmc
from mc_tpu.ops._pallas import KAHAN_UNROLL, kahan_tiles, kahan_tiles_kernel

OPT = OptionParams(p1=1.0, p2=4.0)


@pytest.mark.parametrize("n_paths", [1000, 2300])
@pytest.mark.parametrize("path_offset", [0, 3001])
@pytest.mark.parametrize("payoff", ["bullet_call", "asian_call",
                                    "vanilla_call"])
def test_trajectory_kernel_matches_xla(payoff, path_offset, n_paths):
    sim = SimParams(n_paths=n_paths, n_steps=5)
    kw = dict(tile_rows=8, path_offset=path_offset)
    k = simulate_trajectories(OPT, sim, payoff, engine="pallas",
                              interpret=True, **kw)
    x = simulate_trajectories(OPT, sim, payoff, engine="xla", **kw)
    rows = 8 * -(-n_paths // 1024)  # whole 8-row tiles
    assert k.s.shape == x.s.shape == (5, rows, 128)
    np.testing.assert_array_equal(np.asarray(k.s), np.asarray(x.s))
    np.testing.assert_array_equal(np.asarray(k.state), np.asarray(x.state))
    assert float(k.pay_sum) == float(x.pay_sum)
    assert float(k.pay_sq) == float(x.pay_sq)


@pytest.mark.parametrize("n_paths", [1000, 1500])
@pytest.mark.parametrize("discount", ["full", "remaining"])
@pytest.mark.parametrize("payoff", ["bullet_call", "vanilla_call",
                                    "asian_call"])
def test_nmc_kernels_match_xla(payoff, discount, n_paths):
    """Trajectory kernel + inner kernel against the XLA engine: the same
    surface, spot grid and outer moments."""
    sim = SimParams(n_paths=n_paths, n_steps=5, n_paths_inner=4)
    k = price_nmc(OPT, sim, payoff, engine="pallas", interpret=True,
                  discount=discount)
    x = price_nmc(OPT, sim, payoff, engine="xla", discount=discount)
    np.testing.assert_array_equal(np.asarray(k.surface),
                                  np.asarray(x.surface))
    np.testing.assert_array_equal(np.asarray(k.spot_surface),
                                  np.asarray(x.spot_surface))
    assert float(k.outer.price) == float(x.outer.price)
    assert float(k.outer.stderr) == float(x.outer.stderr)
    # padding rows past n_paths stay zero
    pad = np.asarray(k.surface).reshape(5, -1)[:, n_paths:]
    assert not pad.any()


@pytest.mark.parametrize("n_tiles", [1, KAHAN_UNROLL - 1, KAHAN_UNROLL,
                                     2 * KAHAN_UNROLL + 11])
def test_kahan_kernel_matches_scan(n_tiles):
    """The Triton finisher sums slabs with the scan's operations in the
    scan's order, unrolled in blocks of KAHAN_UNROLL with a tail, each
    program on its own row and lane group."""
    parts = jax.random.normal(jax.random.PRNGKey(n_tiles),
                              (3, n_tiles, 8, 128), jnp.float32) * 1e3
    k = kahan_tiles_kernel(parts, interpret=True)
    assert k.shape == (3, 8, 128)
    for m in range(3):
        np.testing.assert_array_equal(np.asarray(k[m]),
                                      np.asarray(kahan_tiles(parts[m])))
