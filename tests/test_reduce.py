"""Reduction hierarchy tests — the analogue of the reference's
reduce3..6 cross-checks against the CPU ground truth
(inc/testing.cuh:185-235, testing.cu:82-88)."""

import jax.numpy as jnp
import numpy as np
import pytest

from mc_tpu.ops.reduce import (kahan_sum, pad_to_tiles, tile_sum,
                               tile_sum_sumsq, tile_partials)


@pytest.fixture(scope="module")
def random_array():
    rs = np.random.RandomState(42)
    return rs.standard_normal(100_000).astype(np.float32)


def test_pad_to_tiles_shapes():
    x = jnp.ones(1000, jnp.float32)
    x2d, n_tiles = pad_to_tiles(x, tile_rows=8)
    assert x2d.shape == (8, 128)
    assert n_tiles == 1
    assert float(jnp.sum(x2d)) == 1000.0


@pytest.mark.parametrize("n", [1, 127, 1024, 100_000])
@pytest.mark.parametrize("tile_rows", [8, 64])
def test_sum_pallas_matches_numpy(n, tile_rows):
    """`tile_sum`, the plain-jnp form of the former Pallas reduce."""
    rs = np.random.RandomState(n)
    x = rs.standard_normal(n).astype(np.float32)
    got = float(tile_sum(jnp.asarray(x), tile_rows=tile_rows))
    want = float(np.sum(x.astype(np.float64)))
    assert got == pytest.approx(want, abs=1e-2, rel=1e-6)


def test_tile_partials_sum(random_array):
    parts = tile_partials(jnp.asarray(random_array), tile_rows=64)
    assert parts.shape == (8, 128)
    got = float(np.asarray(parts).astype(np.float64).sum())
    want = float(random_array.astype(np.float64).sum())
    assert got == pytest.approx(want, abs=1e-2)


def test_sum_sumsq(random_array):
    s, s2 = tile_sum_sumsq(jnp.asarray(random_array), tile_rows=64)
    want_s = random_array.astype(np.float64).sum()
    want_s2 = (random_array.astype(np.float64) ** 2).sum()
    assert float(s) == pytest.approx(want_s, abs=1e-2)
    assert float(s2) == pytest.approx(want_s2, rel=1e-5)


def test_kahan_sum_ground_truth(random_array):
    x = random_array[:20_000]
    got = float(kahan_sum(jnp.asarray(x)))
    want = float(x.astype(np.float64).sum())
    assert got == pytest.approx(want, abs=1e-3)


def test_kahan_accumulation_beats_naive_f32():
    """The in-kernel Kahan combine must not lose precision over many tiles —
    the role fp64 accumulators play in the plan (SURVEY.md section 7b)."""
    # Large constant array: naive sequential f32 summation drifts, Kahan not.
    n = 4_000_000
    x = np.full(n, 0.123456789, dtype=np.float32)
    got = float(tile_sum(jnp.asarray(x), tile_rows=256))
    want = float(x.astype(np.float64).sum())
    assert got == pytest.approx(want, rel=1e-6)
