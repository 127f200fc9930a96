"""Hierarchical reductions: the equivalent of ``inc/reduce.cuh``.

The reference ships four escalating shared-memory tree-sum kernels
(reduce3..reduce6, ``inc/reduce.cuh:9-227``, ported from the NVIDIA sample)
plus global-memory ``atomicAdd`` for the grid-level combine.  Here:

* shared-memory tree + warp shuffle  ->  `fold_to_sublanes`, which sums a
  (tile_rows, 128) tile to one (8, 128) slab in a fixed row order;
* per-block partials (``g_odata[blockIdx.x]``)  ->  one (8, 128) slab per
  tile;
* ``atomicAdd`` across blocks  ->  a Kahan pass over the slabs in tile
  order (`kahan_tiles`), so the sum does not depend on scheduling;
* NCCL (absent in the reference)  ->  ``jax.lax.psum`` over a mesh axis
  (see mc_tpu/parallel/mesh.py).

Accuracy: payoff sums at 1e9 paths overflow f32 relative precision, so the
Kahan-exact (8, 128) cells are combined in float64 or double-float
(`finish_sum`).  A sequential Kahan f32 sum is provided as ground truth.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from mc_tpu.ops._pallas import (LANES, fold_to_sublanes, kahan_tiles,
                                round_up)

__all__ = [
    "tile_partials",
    "tile_sum",
    "tile_sum_sumsq",
    "finish_sum",
    "kahan_sum",
    "pad_to_tiles",
]


def pad_to_tiles(x, tile_rows: int):
    """Flatten to 1-D, zero-pad, reshape to (n_tiles * tile_rows, LANES)."""
    flat = jnp.ravel(x)
    n = flat.shape[0]
    per_tile = tile_rows * LANES
    padded = round_up(max(n, 1), per_tile)
    flat = jnp.pad(flat, (0, padded - n))
    return flat.reshape(padded // LANES, LANES), padded // per_tile


@functools.partial(jax.jit, static_argnames=("tile_rows",))
def tile_partials(x, tile_rows: int = 256):
    """Hierarchical sum partials: the reduce3..6 analogue.

    Folds each (tile_rows, 128) tile to (8, 128) and Kahan-accumulates the
    slabs in tile order.  Returns the (8, 128) f32 accumulator.
    """
    x2d, n_tiles = pad_to_tiles(x, tile_rows)
    tiles = x2d.reshape(n_tiles, tile_rows, LANES)
    return kahan_tiles(jax.vmap(lambda t: fold_to_sublanes(t, tile_rows))(
        tiles))


def _df_add(ah, al, bh, bl):
    """Double-float addition: Knuth TwoSum on the high parts + renorm.

    (ah, al) + (bh, bl) -> (hi, lo) with ~2^-47 relative error — two f32
    words emulate near-f64 precision with plain vector flops.
    """
    s = ah + bh
    bb = s - ah
    err = (ah - (s - bb)) + (bh - bb)
    lo = err + al + bl
    hi = s + lo
    lo = lo - (hi - s)
    return hi, lo


def finish_sum(partials, dtype=jnp.float64):
    """Combine the (8,128) accumulator block exactly.

    With x64 enabled this is a plain f64 tree-sum.  On an accelerator
    (x64 off), a double-float (TwoSum-compensated) BINARY TREE over the
    1024 cells carries ~47 bits of precision — the cells are already
    Kahan-exact, so the whole 1e9-path sum ends within ~1-2 ulp.  The
    tree is 10 fully-vectorized levels instead of 1024 dependent steps
    of a sequential Neumaier scan.

    On the CPU backend the scan is kept: latency is irrelevant there,
    and XLA:CPU's compiler was observed to segfault nondeterministically
    compiling large vmapped programs containing the unrolled tree late
    in long-lived processes (reproduced 4/4 full-suite runs with the
    tree — both reshape and slice forms — and 0/3 with the scan).
    """
    flat = jnp.ravel(partials)
    if dtype == jnp.float64 and jax.config.jax_enable_x64:
        return jnp.sum(flat.astype(jnp.float64))

    if jax.default_backend() == "cpu":
        def body(carry, v):
            s, c = carry
            t = s + v
            c = c + jnp.where(jnp.abs(s) >= jnp.abs(v),
                              (s - t) + v, (v - t) + s)
            return (t, c), None

        (s, c), _ = jax.lax.scan(
            body, (jnp.float32(0), jnp.float32(0)),
            flat.astype(jnp.float32))
        return s + c

    n = flat.shape[0]
    pad = 1
    while pad < n:
        pad *= 2
    hi = jnp.pad(flat.astype(jnp.float32), (0, pad - n))
    lo = jnp.zeros_like(hi)
    # fold-in-half levels (contiguous slices; no strided reshapes)
    while hi.shape[0] > 1:
        half = hi.shape[0] // 2
        hi, lo = _df_add(hi[:half], lo[:half], hi[half:], lo[half:])
    return (hi + lo)[0]


@functools.partial(jax.jit, static_argnames=("tile_rows",))
def tile_sum(x, tile_rows: int = 256):
    """Full hierarchical sum of an array (f32 in, f64-combined out)."""
    return finish_sum(tile_partials(x, tile_rows=tile_rows))


@functools.partial(jax.jit, static_argnames=("tile_rows",))
def tile_sum_sumsq(x, tile_rows: int = 256):
    """(sum, sum of squares) of an array.

    The moment pair feeds `oracle.summarize` (price + standard error); the
    reference never computed a standard error at all (SURVEY.md section 5).
    """
    x = jnp.asarray(x, jnp.float32)
    return (finish_sum(tile_partials(x, tile_rows=tile_rows)),
            finish_sum(tile_partials(x * x, tile_rows=tile_rows)))


@jax.jit
def kahan_sum(x):
    """Kahan-compensated sequential f32 sum (ground truth for tests).

    Plays the role of the reference's CPU ``sum_random_array`` oracle
    (``inc/testing.cuh:161-174``) that reduce3..6 are checked against.
    """
    flat = jnp.ravel(x)

    def body(carry, v):
        total, comp = carry
        y = v - comp
        t = total + y
        comp = (t - total) - y
        return (t, comp), None

    (total, _), _ = jax.lax.scan(body, (jnp.float32(0), jnp.float32(0)), flat)
    return total
