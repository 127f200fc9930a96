"""Checkpoint/resume for long Monte Carlo runs.

The reference has no checkpointing subsystem (SURVEY.md section 5) — its
only nod to resumability is kernels accepting an intermediate state
``(Ik, Sk, Tk)`` (``trajectories.cuh:116-117``).  Here resumability is a
property of the design: counter-based RNG means any global path range
``[offset, offset+n)`` is recomputable from ``(seed, offset)`` alone, so a
checkpoint is just the accumulated moment slabs plus the next offset —
a few KB regardless of path count.

`chunked_price` runs an arbitrarily large path count in fixed-size chunks
(bounding per-kernel latency for preemptible workers), persisting an .npz
snapshot after each chunk; `chunked_price(resume=...)` continues from the
newest snapshot and produces BIT-IDENTICAL results to an uninterrupted
run (tests/test_checkpoint.py), because the chunk boundaries — not wall
clock — define the summation tree.

ELASTIC restarts: pass ``mesh=`` to fan the chunks over a device mesh —
the CHUNK stays the atomic unit (chip r of a round computes chunk
c0 + r; the host combines the gathered slabs in chunk-index order), so
the result is bit-identical across ANY mesh size, and a run checkpointed
on N chips resumes on M chips without so much as a rounding difference.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mc_tpu import rng
from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.engines import STREAM_OUTER, _xla_partials
from mc_tpu.oracle import PriceResult, summarize
from mc_tpu.ops import path_kernels as pk
from mc_tpu.ops._pallas import LANES, SUBLANES, resolve_engine, round_up
from mc_tpu.ops.payoffs import get_payoff
from mc_tpu.ops.reduce import finish_sum

__all__ = ["chunked_price", "load_checkpoint", "Checkpoint"]

_MAGIC = "mc_tpu-checkpoint-v1"


@dataclasses.dataclass
class Checkpoint:
    """Accumulated moment state after `paths_done` paths."""

    paths_done: int
    n_paths: int
    acc: np.ndarray           # (n_out, 8, 128) f32 Kahan-style accumulators
    comp: np.ndarray          # (n_out, 8, 128) f32 compensations
    meta: dict

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        np.savez(tmp, magic=_MAGIC, paths_done=self.paths_done,
                 n_paths=self.n_paths, acc=self.acc, comp=self.comp,
                 **{f"meta_{k}": v for k, v in self.meta.items()})
        os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_checkpoint(path: str) -> Checkpoint:
    with np.load(path, allow_pickle=False) as z:
        if str(z["magic"]) != _MAGIC:
            raise ValueError(f"{path} is not a mc_tpu checkpoint")
        meta = {k[5:]: z[k].item() if z[k].ndim == 0 else z[k]
                for k in z.files if k.startswith("meta_")}
        return Checkpoint(paths_done=int(z["paths_done"]),
                          n_paths=int(z["n_paths"]),
                          acc=z["acc"], comp=z["comp"], meta=meta)


@functools.partial(
    jax.jit,
    static_argnames=("payoff", "cfg", "engine", "mesh", "interpret",
                     "model", "kmax"))
def _chunk_slabs_mesh(payoff, cfg, engine, mesh, interpret, key, params,
                      option, c0, n_total, model="gbm", kmax=0, dyn=None):
    """One elastic round: device r computes the (8,128) moment slabs of
    chunk c0 + r; the gathered (D, 8, 128) stacks come back in rank
    (= chunk) order."""
    from jax.sharding import PartitionSpec as P

    from mc_tpu.parallel.mesh import PATHS_AXIS

    def shard_fn(key, params, c0, n_total, dyn):
        rank = jax.lax.axis_index(PATHS_AXIS).astype(jnp.uint32)
        offset = (c0 + rank) * jnp.uint32(cfg.n_paths)
        if model != "gbm":
            from mc_tpu.parallel.models_sharded import _model_def
            params_m, partials = _model_def(model).build(
                payoff, cfg, option, dyn, cfg.n_steps, kmax)
            parts = partials(key, params_m, offset, n_total)
        elif engine == "pallas":
            parts = pk.simulate_partials(
                payoff, cfg, key, params, path_offset=offset,
                n_valid=n_total, interpret=interpret)
        else:
            parts = _xla_partials(payoff, cfg, key, option, offset,
                                  n_valid=n_total)
        return tuple(jax.lax.all_gather(x, PATHS_AXIS) for x in parts)

    return jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )(key, params, c0, n_total, dyn)


@functools.partial(
    jax.jit,
    static_argnames=("model", "payoff", "cfg", "kmax", "n_steps"))
def _model_chunk_slabs(model, payoff, cfg, kmax, n_steps, key, option, dyn,
                       offset, bound):
    from mc_tpu.parallel.models_sharded import _model_def
    params, partials = _model_def(model).build(
        payoff, cfg, option, dyn, n_steps, kmax)
    return partials(key, params, offset, bound)


def chunked_price(option: OptionParams = DEMO_OPTION,
                  sim: SimParams = DEMO_SIM,
                  payoff="vanilla_call",
                  *,
                  chunk_paths: int = 1 << 24,
                  checkpoint_path: Optional[str] = None,
                  resume: bool = False,
                  engine: Optional[str] = None,
                  method: Optional[str] = None,
                  rng_source: str = "threefry13",
                  tile_rows: int = 128,
                  stream: int = STREAM_OUTER,
                  mesh=None,
                  model: str = "gbm",
                  dyn=None,
                  interpret: bool = False) -> PriceResult:
    """Price `sim.n_paths` paths in chunks with optional checkpointing.

    The per-chunk (8,128) moment slabs are combined across chunks with the
    same Kahan update the kernels use internally, so the final sums do not
    depend on where the run was interrupted.

    ``model`` extends the same contract to the model families (any
    path-kernel entry of `parallel.SHARDED_MODELS`): the family kernels
    key their counters by global path id, so a chunk range is
    recomputable from (seed, offset) under ANY dynamics and resume stays
    bit-identical across mesh sizes.  ``dyn`` defaults to the family's
    demo dynamics; its parameter fingerprint joins the checkpoint meta
    (resuming under different dynamics fails loudly).  ``engine`` (as in
    `price`) runs the GBM chunks; the families run their XLA engines.
    """
    po = get_payoff(payoff)
    engine = resolve_engine(engine, interpret)
    pk.check_rng_source(rng_source)
    mdef, kmax, dyn32 = None, 0, None
    if model != "gbm":
        from mc_tpu.parallel.models_sharded import _model_def
        try:
            mdef = _model_def(model)
        except KeyError:
            from mc_tpu.parallel.models_sharded import SHARDED_MODELS
            raise ValueError(f"unknown model {model!r}; chunked models: "
                             f"{tuple(m for m in SHARDED_MODELS)}")
        if mdef.resolve_payoff is not None or mdef.terminal_only:
            raise ValueError(f"chunked_price supports step-loop families; "
                             f"{model!r} is a terminal-draw family")
        po.validate(option, sim.n_steps)
        if dyn is None:
            dyn = mdef.default_dyn(sim)
        if mdef.prepare is not None:
            dyn, kmax = mdef.prepare(option, dyn, sim)
        if mdef.even_steps and sim.n_steps % 2:
            raise ValueError(f"{model} requires an even n_steps "
                             "(pair-consuming step loop)")
        dyn32 = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float32), dyn)
        method = "euler"
    elif method is None:
        method = "terminal" if po.terminal_only else "euler"
    chunk_paths = round_up(min(chunk_paths, sim.n_paths), tile_rows * LANES)
    tag = () if mdef is None else (mdef.tag,)
    key = jnp.asarray(rng.derive_key(sim.seed, stream, *tag), jnp.uint32)
    n_out = 2

    start = 0
    acc = np.zeros((n_out, SUBLANES, LANES), np.float32)
    comp = np.zeros_like(acc)
    meta = dict(seed=sim.seed, payoff=po.name, method=method,
                chunk_paths=chunk_paths, engine=engine,
                # the stream is part of the contract: resuming a run
                # recorded under a different round count must fail loudly
                # (pre-upgrade checkpoints lack the key -> mismatch).
                rng_source=rng_source,
                n_steps=sim.n_steps, tile_rows=tile_rows,
                # full market-data fingerprint: resuming under different
                # dynamics must fail loudly, not merge distributions
                option=",".join(f"{v:.9g}" for v in
                                (float(x) for x in option.astuple())),
                model=model,
                dyn="" if dyn32 is None else ",".join(
                    f"{float(v):.9g}"
                    for leaf in jax.tree_util.tree_leaves(dyn32)
                    for v in np.asarray(leaf, np.float64).ravel()))

    if resume:
        if not (checkpoint_path and os.path.exists(checkpoint_path)):
            raise FileNotFoundError(
                f"resume requested but no checkpoint at {checkpoint_path}")
        ck = load_checkpoint(checkpoint_path)
        for k, v in meta.items():
            if str(ck.meta.get(k)) != str(v):
                raise ValueError(
                    f"checkpoint mismatch for {k!r}: {ck.meta.get(k)} != {v}")
        if ck.n_paths != sim.n_paths:
            raise ValueError("checkpoint n_paths mismatch")
        start, acc, comp = ck.paths_done, ck.acc.copy(), ck.comp.copy()

    params = pk.pack_params(option.as_f32(), sim.n_steps)
    opt32 = option.as_f32()

    def model_slabs(n_local, start):
        cfg_m = pk.KernelConfig(n_paths=n_local, n_steps=sim.n_steps,
                                tile_rows=tile_rows)
        return _model_chunk_slabs(model, po, cfg_m, kmax, sim.n_steps, key,
                                  opt32, dyn32,
                                  jnp.uint32(start),
                                  jnp.uint32(sim.n_paths))

    def combine(slab_tuple):
        nonlocal acc, comp
        for m in range(n_out):
            p8 = np.asarray(slab_tuple[m], np.float32)
            y = p8 - comp[m]
            t = acc[m] + y
            comp[m] = (t - acc[m]) - y
            acc[m] = t

    if mesh is not None and mesh.devices.size > 1:
        # Elastic path: rounds of D full chunks in parallel, combined in
        # chunk-index order (chunk = atomic unit -> mesh-size-invariant
        # bitwise).  A trailing partial chunk falls through to the
        # sequential loop below.
        if start % chunk_paths:
            raise ValueError(
                "elastic resume requires the checkpoint to sit on a "
                f"chunk boundary (paths_done={start}, "
                f"chunk_paths={chunk_paths})")
        d = mesh.devices.size
        cfg_full = pk.KernelConfig(n_paths=chunk_paths, n_steps=sim.n_steps,
                                   tile_rows=tile_rows, method=method,
                                   rng_source=rng_source)
        while start + chunk_paths <= sim.n_paths:
            n_chunks_left = (sim.n_paths - start) // chunk_paths
            d_used = min(d, n_chunks_left)
            slabs = _chunk_slabs_mesh(po, cfg_full, engine, mesh,
                                      interpret, key, params, opt32,
                                      jnp.uint32(start // chunk_paths),
                                      jnp.uint32(sim.n_paths),
                                      model=model, kmax=kmax, dyn=dyn32)
            slabs = [np.asarray(x, np.float32) for x in slabs]
            for kk in range(d_used):
                combine([slabs[m][kk] for m in range(n_out)])
            start += d_used * chunk_paths
            if checkpoint_path:
                Checkpoint(paths_done=start, n_paths=sim.n_paths, acc=acc,
                           comp=comp, meta=meta).save(checkpoint_path)

    while start < sim.n_paths:
        n_local = min(chunk_paths, round_up(sim.n_paths - start,
                                            tile_rows * LANES))
        cfg = pk.KernelConfig(n_paths=n_local, n_steps=sim.n_steps,
                              tile_rows=tile_rows, method=method,
                              rng_source=rng_source)
        if model != "gbm":
            parts = model_slabs(n_local, start)
        elif engine == "pallas":
            parts = pk.simulate_partials(
                po, cfg, key, params, path_offset=jnp.uint32(start),
                n_valid=jnp.uint32(sim.n_paths), interpret=interpret)
        else:
            parts = _xla_partials(po, cfg, key, opt32, jnp.uint32(start),
                                  n_valid=jnp.uint32(sim.n_paths))
        # Kahan-combine the chunk slab into the running accumulators
        # (numpy f32, same update the kernels apply per tile).
        combine(parts)
        start += n_local
        if checkpoint_path:
            Checkpoint(paths_done=start, n_paths=sim.n_paths, acc=acc,
                       comp=comp, meta=meta).save(checkpoint_path)

    sums = [finish_sum(jnp.asarray(acc[m])) for m in range(n_out)]
    r = jnp.float32(option.r)
    t = jnp.float32(option.t)
    if mdef is not None and mdef.discount is not None:
        cfg_d = pk.KernelConfig(n_paths=tile_rows * LANES,
                                n_steps=sim.n_steps, tile_rows=tile_rows)
        params_m, _ = mdef.build(po, cfg_d, opt32, dyn32, sim.n_steps,
                                 kmax)
        discount = mdef.discount(params_m, r, t)
    else:
        discount = jnp.exp(-r * t)
    return summarize(sums[0], sums[1],
                     jnp.asarray(sim.n_paths, jnp.float32),
                     discount)
