"""Multi-device path sharding: the framework's distributed layer.

The reference is single-GPU — its only cross-"device" combine is global
memory atomics plus a host-side gather of per-block partials
(``inc/wrappers.cuh:79-85``; SURVEY.md section 2 "Distributed communication
backend: ABSENT").  Here it is first-class:

* paths are data-parallel across a 1-D ``jax.sharding.Mesh`` axis
  (``"paths"``) via ``shard_map`` — each device runs the same fused kernel
  on its own contiguous global path-id range;
* the per-device (8,128) moment accumulators are combined with
  ``jax.lax.psum``, which XLA hands to NCCL over NVLink — the collective
  tier the reference never had;
* counter-based RNG keyed by GLOBAL path id makes the result invariant to
  the mesh size: pricing on 1 device or many consumes the same stream
  (tests/test_parallel.py), which is what makes elastic restarts and
  shard-count changes safe.  Only the summation order changes with the
  mesh: each device Kahan-sums its own tiles and the psum adds the
  per-device slabs, so the price agrees to float32 rounding of the sum.

Works unchanged on the GPUs of one host (joined all to all by NVLink) or
on the 8-device virtual CPU mesh used by the test suite (conftest.py sets
``--xla_force_host_platform_device_count=8``).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from mc_tpu import rng
from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.oracle import PriceResult, summarize
from mc_tpu.ops import path_kernels as pk
from mc_tpu.ops._pallas import LANES, cdiv, resolve_engine, round_up
from mc_tpu.ops.payoffs import get_payoff
from mc_tpu.ops.reduce import finish_sum

__all__ = ["make_mesh", "price_sharded", "price_qmc_sharded",
           "price_portfolio_sharded", "shard_bounds"]

PATHS_AXIS = "paths"


def make_mesh(devices: Optional[Sequence] = None,
              axis: str = PATHS_AXIS) -> Mesh:
    """A 1-D mesh over all (or the given) devices.

    The path dimension of an MC pricer is embarrassingly parallel, and
    every GPU of a host reaches every other at the same NVLink rate, so
    one flat axis is the right mesh: the algorithm alone shapes it.
    """
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(devices, (axis,))


def shard_bounds(n_paths: int, n_shards: int, tile_rows: int):
    """Static per-shard geometry: local path count, rounded to whole tiles.

    Every shard runs the same static-shape program (SPMD); the last shard's
    overhang is masked inside the kernel against the global bound.
    """
    per_tile = tile_rows * LANES
    n_local = round_up(cdiv(n_paths, n_shards), per_tile)
    return n_local


@functools.partial(
    jax.jit,
    static_argnames=("payoff", "sim", "mesh", "engine", "antithetic",
                     "control_variate", "tile_rows", "rng_source", "method",
                     "interpret", "importance_shift"))
def _price_sharded_impl(option, payoff, sim, mesh, engine, antithetic,
                        control_variate, tile_rows, rng_source, method,
                        interpret, key, importance_shift=0.0):
    from mc_tpu.engines import _xla_partials  # circular-import avoidance

    n_shards = mesh.devices.size
    n_local = shard_bounds(sim.n_paths, n_shards, tile_rows)
    cfg = pk.KernelConfig(
        n_paths=n_local,
        n_steps=sim.n_steps,
        tile_rows=tile_rows,
        antithetic=antithetic,
        with_cv=control_variate,
        rng_source=rng_source,
        method=method,
        is_shift=importance_shift,
    )
    params = pk.pack_params(option, sim.n_steps)
    n_total = jnp.uint32(sim.n_paths)

    def shard_fn(key, params, n_total):
        rank = jax.lax.axis_index(PATHS_AXIS).astype(jnp.uint32)
        offset = rank * jnp.uint32(n_local)
        if engine == "pallas":
            parts = pk.simulate_partials(
                payoff, cfg, key, params, path_offset=offset,
                n_valid=n_total, interpret=interpret)
        else:
            parts = _xla_partials(payoff, cfg, key, option, offset,
                                  n_valid=n_total)
        # The collective tier: one psum of n_out (8,128) slabs.
        return tuple(jax.lax.psum(p, PATHS_AXIS) for p in parts)

    # check_vma=False: pallas_call out_shapes carry no varying-axis metadata,
    # and correctness is pinned by the mesh-size-invariance tests.
    parts = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )(key, params, n_total)

    sums = [finish_sum(x) for x in parts]
    r = jnp.asarray(option.r, sums[0].dtype)
    t = jnp.asarray(option.t, r.dtype)
    discount = jnp.exp(-r * t)
    n = jnp.asarray(sim.n_paths, sums[0].dtype)

    if not control_variate:
        return summarize(sums[0], sums[1], n, discount)
    sum_p, sum_p2, sum_x, sum_x2, sum_px = sums
    mean_p = sum_p / n
    mean_x = sum_x / n
    var_p = jnp.maximum(sum_p2 / n - mean_p * mean_p, 0.0)
    var_x = jnp.maximum(sum_x2 / n - mean_x * mean_x, 1e-30)
    cov = sum_px / n - mean_p * mean_x
    beta = cov / var_x
    if payoff.has_control:
        from mc_tpu.engines import _payoff_namespace
        ex = payoff.control_expectation(
            _payoff_namespace(option, sim.n_steps))
    else:
        ex = (jnp.asarray(option.s0, n.dtype)
              * jnp.exp((r - jnp.asarray(option.q, r.dtype)) * t))
    adj_mean = mean_p - beta * (mean_x - ex)
    adj_var = jnp.maximum(var_p - cov * cov / var_x, 0.0)
    return PriceResult(
        price=discount * adj_mean,
        stderr=jnp.sqrt(adj_var / n) * discount,
        n_paths=n,
        payoff_mean=adj_mean,
        payoff_var=adj_var,
    )


def price_sharded(option: OptionParams = DEMO_OPTION,
                  sim: SimParams = DEMO_SIM,
                  payoff="vanilla_call",
                  *,
                  mesh: Optional[Mesh] = None,
                  engine: Optional[str] = None,
                  method: Optional[str] = None,
                  antithetic: bool = False,
                  control_variate: bool = False,
                  tile_rows: Optional[int] = None,
                  rng_source: str = "threefry13",
                  stream: int = 0,
                  key=None,
                  importance_shift: float = 0.0,
                  interpret: bool = False) -> PriceResult:
    """Multi-device Monte Carlo price: paths sharded over a device mesh.

    The billion-path configuration of BASELINE.json: each device simulates
    a contiguous global path-id range with the same engine as the
    single-device `mc_tpu.price` (``engine``/``tile_rows`` defaults as
    there), partial moments meet in one `psum`, and the f64-grade finish
    happens once on the replicated result.
    """
    mesh = mesh if mesh is not None else make_mesh()
    engine = resolve_engine(engine, interpret)
    if tile_rows is None:
        tile_rows = pk.default_tile_rows(engine)
    pk.check_rng_source(rng_source)
    po = get_payoff(payoff)
    if method is None:
        method = "terminal" if po.terminal_only else "euler"
    if po.n_state > 0 and method == "terminal":
        raise ValueError(f"{po.name} is path-dependent; method='terminal' invalid")
    if key is None:
        key = jnp.asarray(rng.derive_key(sim.seed, stream), jnp.uint32)
    return _price_sharded_impl(
        option.as_f32(), po, sim.replace(seed=0), mesh, engine, antithetic,
        control_variate, tile_rows, rng_source, method, interpret, key,
        float(importance_shift))


# ---------------------------------------------------------------------------
# Sharded randomized QMC: the randomization axis (independent shifts) is
# the natural multi-device axis — each device evaluates the FULL point set
# for its share of shifts, so the per-shift means are bit-identical to the
# single-device ones and scaling raises the shift budget linearly (the
# documented way to grow a QMC budget: more shifts, not more points).
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("payoff", "n", "n_steps", "method", "tile_rows",
                     "bridge", "family", "mesh"))
def _qmc_sharded_impl(option, payoff, n, n_steps, method, tile_rows, bridge,
                      family, mesh, zvec, shifts):
    from mc_tpu.qmc import _shift_mean_fn

    cfg = pk.KernelConfig(n_paths=n, n_steps=n_steps, tile_rows=tile_rows,
                          method=method)
    params = pk.pack_params(option, n_steps)

    def shard_fn(zvec, shifts_local, params):
        one_shift = _shift_mean_fn(payoff, cfg, option, zvec, n, bridge,
                                   family)
        means_local = jax.lax.map(one_shift, shifts_local)
        return jax.lax.all_gather(means_local, PATHS_AXIS, tiled=True)

    means = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(PATHS_AXIS), P()),
        out_specs=P(),
        check_vma=False,
    )(zvec, shifts, params)

    # identical finish to the single-chip _price_qmc_impl
    r_reps = shifts.shape[0]
    mean = jnp.mean(means)
    var = jnp.sum((means - mean) ** 2) / jnp.float32(max(r_reps - 1, 1))
    r = jnp.asarray(option.r, jnp.float32)
    t = jnp.asarray(option.t, jnp.float32)
    discount = jnp.exp(-r * t)
    return PriceResult(
        price=discount * mean,
        stderr=discount * jnp.sqrt(var / r_reps),
        n_paths=jnp.float32(n * r_reps),
        payoff_mean=mean,
        payoff_var=var,
    )


def price_qmc_sharded(option: OptionParams = DEMO_OPTION,
                      sim: SimParams = DEMO_SIM,
                      payoff="vanilla_call",
                      *,
                      mesh: Optional[Mesh] = None,
                      n_shifts: int = 16,
                      method: Optional[str] = None,
                      family: str = "lattice",
                      tile_rows: int = 128,
                      gamma: float = 0.1,
                      bridge: bool = False,
                      stream: int = 0) -> PriceResult:
    """Multi-device randomized QMC: shifts sharded over the mesh.

    ``n_shifts`` is rounded up to a multiple of the mesh size; per-shift
    means are BIT-identical to `price_qmc`'s (each device evaluates the full
    point set for its shifts), so at equal n_shifts the two APIs agree
    exactly regardless of mesh size.
    """
    from mc_tpu.qmc import _qmc_pointset
    mesh = mesh if mesh is not None else make_mesh()
    n_shards = mesh.devices.size
    n_shifts = cdiv(n_shifts, n_shards) * n_shards
    po = get_payoff(payoff)
    n, method, tile_rows, zvec, shifts = _qmc_pointset(
        po, sim, n_shifts, method, family, bridge, tile_rows, gamma,
        stream, sim.seed)
    return _qmc_sharded_impl(option.as_f32(), po, n, sim.n_steps, method,
                             tile_rows, bridge, family, mesh, zvec, shifts)


# ---------------------------------------------------------------------------
# Sharded batched-book pricing: paths data-parallel over the mesh, the
# whole B-contract book vmapped over the XLA engine per device, one psum of
# the (B, 8, 128) moment slabs.
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("payoff", "sim", "mesh", "method", "antithetic",
                     "tile_rows"))
def _book_sharded_impl(opts32, payoff, sim, mesh, method, antithetic,
                       tile_rows, key):
    from mc_tpu.engines import _xla_partials

    n_shards = mesh.devices.size
    n_local = shard_bounds(sim.n_paths, n_shards, tile_rows)
    b = jax.tree_util.tree_leaves(opts32)[0].shape[0]
    cfg = pk.KernelConfig(n_paths=n_local, n_steps=sim.n_steps,
                          tile_rows=tile_rows, antithetic=antithetic,
                          method=method)
    n_total = jnp.uint32(sim.n_paths)

    def shard_fn(key, opts, n_total):
        rank = jax.lax.axis_index(PATHS_AXIS).astype(jnp.uint32)
        offset = rank * jnp.uint32(n_local)
        sums, sqs = jax.vmap(lambda o: _xla_partials(
            payoff, cfg, key, o, offset, n_valid=n_total))(opts)
        return (jax.lax.psum(sums, PATHS_AXIS),
                jax.lax.psum(sqs, PATHS_AXIS))

    sums, sqs = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )(key, opts32, n_total)

    s = jax.vmap(finish_sum)(sums)
    sq = jax.vmap(finish_sum)(sqs)
    r = jnp.asarray(opts32.r, jnp.float32)
    t = jnp.asarray(opts32.t, r.dtype)
    n = jnp.full((b,), sim.n_paths, jnp.float32)
    return summarize(s, sq, n, jnp.exp(-r * t))


def price_portfolio_sharded(options: OptionParams,
                            sim: SimParams = DEMO_SIM,
                            payoff="vanilla_call",
                            *,
                            mesh: Optional[Mesh] = None,
                            method: Optional[str] = None,
                            antithetic: bool = False,
                            tile_rows: int = 128,
                            stream: int = 0,
                            key=None) -> PriceResult:
    """Multi-device book pricing: paths sharded, the book vmapped per
    device.

    Returns a PriceResult of (B,)-shaped arrays like `price_portfolio`;
    common random numbers across the whole book AND the whole mesh (the
    counter-based stream is keyed by global path id).
    """
    mesh = mesh if mesh is not None else make_mesh()
    po = get_payoff(payoff)
    if method is None:
        method = "terminal" if po.terminal_only else "euler"
    if po.n_state > 0 and method == "terminal":
        raise ValueError(f"{po.name} is path-dependent; "
                         "method='terminal' invalid")
    if key is None:
        key = jnp.asarray(rng.derive_key(sim.seed, stream), jnp.uint32)
    opts32 = jax.tree_util.tree_map(
        lambda x: jnp.atleast_1d(jnp.asarray(x, jnp.float32)), options)
    b = max(int(x.shape[0]) for x in jax.tree_util.tree_leaves(opts32))
    opts32 = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (b,)), opts32)
    return _book_sharded_impl(opts32, po, sim.replace(seed=0), mesh,
                              method, antithetic, tile_rows, key)
