"""Shared tiling helpers, the engine choice, and the Triton-route launcher.

The XLA engine and the Pallas kernels tile paths the same way: a tile is
``tile_rows x 128`` paths, summed to one (8, 128) slab by `fold_to_sublanes`,
and the slabs are Kahan-accumulated in tile order (`kahan_tiles`).  The
kernels compile through Pallas's Triton route for NVIDIA GPUs; on any
other backend they run only when the caller asks for the interpreter.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["cdiv", "round_up", "LANES", "SUBLANES", "fold_to_sublanes",
           "kahan_xla_update", "kahan_tiles", "xla_moment_scan",
           "resolve_engine", "triton_call", "tile_path_ids",
           "kahan_tiles_kernel"]

LANES = 128      # last-dim tile unit
SUBLANES = 8     # rows per (8, 128) partial-sum slab and per kernel chunk

# Warps per Triton program: a program walks its tile in (8, 128) chunks,
# so 4 warps hold 8 paths per thread.
NUM_WARPS = 4


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def fold_to_sublanes(v, tile_rows: int):
    """(tile_rows, 128) -> (8, 128) partial sums, row groups added in order.

    This is THE summation grouping every engine shares: the kernels add
    their (8, 128) chunks in the same order, so the XLA engine and the
    interpreted kernels agree bit for bit.
    """
    p8 = v[0:SUBLANES]
    for k in range(1, tile_rows // SUBLANES):
        p8 = p8 + v[k * SUBLANES:(k + 1) * SUBLANES]
    return p8


def kahan_xla_update(acc, comp, idx, p8):
    """One Kahan accumulation step on stacked functional arrays.

    ``acc``/``comp`` are (..., 8, 128) arrays indexed at ``idx``; returns
    the updated pair.  `kahan_tiles` applies the same operations in the
    same order, so both finishes agree bit for bit.
    """
    a = acc[idx]
    y = p8 - comp[idx]
    t = a + y
    return acc.at[idx].set(t), comp.at[idx].set((t - a) - y)


def kahan_tiles(parts):
    """Kahan-sum per-tile (8, 128) slabs ``(n_tiles, 8, 128)`` in tile order
    (the XLA engine's summation order)."""
    def body(carry, p8):
        acc, comp = carry
        y = p8 - comp
        t = acc + y
        return (t, (t - acc) - y), None

    zero = jnp.zeros(parts.shape[1:], jnp.float32)
    (acc, _), _ = jax.lax.scan(body, (zero, zero), parts)
    return acc


# Every element of a slab is its own Kahan chain, walked in tile order.  A
# `kahan_tiles_kernel` program takes KAHAN_LANES elements of one slab row
# (one warp, one element per thread) and loads KAHAN_UNROLL tiles ahead of
# its running sum: the chain is bound by load latency, not by bandwidth.
KAHAN_LANES = 32
KAHAN_UNROLL = 32


def _make_kahan_kernel(n_tiles: int):
    def kahan(slab, carry):
        acc, comp = carry
        y = slab - comp
        t = acc + y
        return t, (t - acc) - y

    def kernel(parts_ref, out_ref):
        m, row, group = (pl.program_id(a) for a in range(3))
        lanes = pl.ds(group * KAHAN_LANES, KAHAN_LANES)

        def block(b, carry):
            slabs = [parts_ref[m, b * KAHAN_UNROLL + u, row, lanes]
                     for u in range(KAHAN_UNROLL)]
            for slab in slabs:
                carry = kahan(slab, carry)
            return carry

        def single(t, carry):
            return kahan(parts_ref[m, t, row, lanes], carry)

        zero = jnp.zeros((KAHAN_LANES,), jnp.float32)
        n_blocks = n_tiles // KAHAN_UNROLL
        carry = jax.lax.fori_loop(0, n_blocks, block, (zero, zero))
        acc, _ = jax.lax.fori_loop(n_blocks * KAHAN_UNROLL, n_tiles, single,
                                   carry)
        out_ref[m, row, lanes] = acc

    return kernel


def kahan_tiles_kernel(parts, interpret: bool = False):
    """`kahan_tiles` for stacked moments ``(n_out, n_tiles, 8, 128)`` as one
    Triton launch, one program per (moment, slab row, lane group).

    The path kernels write one slab per tile (their programs run in
    parallel and in no fixed order); this pass sums them with the same
    operations in the same order as `kahan_tiles`, without a device loop
    of ``n_tiles`` XLA steps.  Returns ``(n_out, 8, 128)``.
    """
    n_out, n_tiles = parts.shape[:2]
    return triton_call(
        _make_kahan_kernel(n_tiles),
        jax.ShapeDtypeStruct((n_out, SUBLANES, LANES), jnp.float32),
        grid=(n_out, SUBLANES, LANES // KAHAN_LANES), name="mc_kahan_tiles",
        num_warps=KAHAN_LANES // 32, interpret=interpret)(parts)


def tile_path_ids(first_row, shape=(SUBLANES, LANES)):
    """Row-major uint32 path ids of a ``shape`` block starting at a row."""
    flat = (jax.lax.broadcasted_iota(jnp.uint32, shape, 0) * LANES
            + jax.lax.broadcasted_iota(jnp.uint32, shape, 1))
    return jnp.asarray(first_row, jnp.uint32) * jnp.uint32(LANES) + flat


def xla_moment_scan(tile_fn, n_paths: int, tile_rows: int, n_out: int,
                    offset=0, bound=None):
    """Scan path tiles and Kahan-accumulate n_out (8,128) moment slabs.

    The ONE tile-iteration loop every XLA engine shares (GBM, Heston,
    basket, MLMC): builds global path ids and the validity mask, calls
    ``tile_fn(ids, valid) -> [v_0 .. v_{n_out-1}]`` (each (tile_rows, 128)),
    folds each to (8,128), and Kahan-accumulates across tiles in tile
    order.  Returns a tuple of n_out (8,128) f32 arrays.
    """
    per_tile = tile_rows * LANES
    n_tiles = cdiv(n_paths, per_tile)
    flat = tile_path_ids(0, (tile_rows, LANES))
    offset = jnp.asarray(offset, jnp.uint32)
    bound = (offset + jnp.uint32(n_paths) if bound is None
             else jnp.asarray(bound, jnp.uint32))

    def one_tile(carry, i):
        acc, comp = carry
        ids = offset + jnp.uint32(i * per_tile) + flat
        valid = ids < bound
        for m, v in enumerate(tile_fn(ids, valid)):
            acc, comp = kahan_xla_update(acc, comp, m,
                                         fold_to_sublanes(v, tile_rows))
        return (acc, comp), None

    # `+ 0 * offset` aligns the scan carry's varying-manual-axes type with
    # the body output under shard_map; a numerical no-op otherwise.
    zeros = (jnp.zeros((n_out, SUBLANES, LANES), jnp.float32)
             + jnp.float32(0) * offset.astype(jnp.float32))
    (acc, _), _ = jax.lax.scan(
        one_tile, (zeros, zeros), jnp.arange(n_tiles, dtype=jnp.uint32))
    return tuple(acc[m] for m in range(n_out))


def resolve_engine(engine, interpret: bool = False) -> str:
    """The engine a pricer runs: ``None`` picks by platform.

    ``"pallas"`` (the Triton-route kernels) on a GPU backend, ``"xla"``
    elsewhere.  An explicit ``"pallas"`` off the GPU needs
    ``interpret=True``: the kernels compile only for NVIDIA GPUs.
    """
    backend = jax.default_backend()
    if engine is None:
        engine = "pallas" if backend == "gpu" else "xla"
    if engine not in ("pallas", "xla"):
        raise ValueError(f"unknown engine {engine!r}; use 'pallas' or 'xla'")
    if engine == "pallas" and not interpret and backend != "gpu":
        raise ValueError(
            f"engine='pallas' compiles Triton kernels for an NVIDIA GPU; "
            f"the {backend!r} backend needs interpret=True or engine='xla'")
    return engine


def triton_call(kernel, out_shape, *, grid, name: str, interpret: bool,
                num_warps: int = NUM_WARPS):
    """``pallas_call`` on the Triton route with whole-array operands.

    Every operand and result is a whole-array reference: kernels index
    (8, 128) chunks themselves, so array shapes need not be powers of two.
    """
    whole = pl.BlockSpec(memory_space=pl.ANY)

    def call(*args):
        return pl.pallas_call(
            kernel,
            grid=grid,
            in_specs=[whole] * len(args),
            out_specs=jax.tree_util.tree_map(lambda _: whole, out_shape),
            out_shape=out_shape,
            backend="triton",
            compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                                 num_stages=1),
            interpret=interpret,
            name=name,
        )(*args)

    return call
