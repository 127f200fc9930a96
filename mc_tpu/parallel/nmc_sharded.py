"""Multi-device nested Monte Carlo: outer-path axis sharded over the mesh.

The answer to the reference's C12 "optimal" task-decomposed scheduler
(``nmc.cuh:280-386``) across devices: the reference balanced inner-path
work across SMs by hand; here the whole (outer path x step x inner path)
iteration space is embarrassingly parallel along the outer-path axis, so
devices each run the NMC engine on their contiguous global path range —
identical per-device work by construction — and only the tiny
outer-moment slabs cross devices in one psum.  The surface stays sharded
in place (one (n_steps, local_rows, 128) block per device), which is
exactly the layout a downstream exposure/Bermudan pipeline wants.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from mc_tpu import rng
from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.engines import STREAM_INNER, STREAM_OUTER
from mc_tpu.nmc import NMCResult, nmc_partials
from mc_tpu.oracle import summarize
from mc_tpu.ops import nmc_kernels as nk
from mc_tpu.ops import path_kernels as pk
from mc_tpu.ops._pallas import resolve_engine
from mc_tpu.ops.payoffs import get_payoff
from mc_tpu.ops.reduce import finish_sum
from mc_tpu.parallel.mesh import PATHS_AXIS, make_mesh, shard_bounds

__all__ = ["price_nmc_sharded", "price_nmc_model_sharded"]


@functools.partial(
    jax.jit,
    static_argnames=("payoff", "sim", "mesh", "engine", "tile_rows",
                     "discount", "interpret"))
def _impl(option, payoff, sim, mesh, engine, tile_rows, discount, interpret,
          key_outer, key_inner):
    n_shards = mesh.devices.size
    n_local = shard_bounds(sim.n_paths, n_shards, tile_rows)
    cfg = nk.NMCConfig(n_paths=n_local, n_steps=sim.n_steps,
                       n_inner=sim.n_paths_inner, tile_rows=tile_rows,
                       discount=discount)
    params = pk.pack_params(option, sim.n_steps)
    n_total = jnp.uint32(sim.n_paths)

    def shard_fn(ko, ki, params, n_total):
        rank = jax.lax.axis_index(PATHS_AXIS).astype(jnp.uint32)
        offset = rank * jnp.uint32(n_local)
        surf, _, osum, osq = nmc_partials(
            payoff, cfg, engine, interpret, ko, ki, params, option,
            path_offset=offset, n_valid=n_total)
        osum = jax.lax.psum(osum, PATHS_AXIS)
        osq = jax.lax.psum(osq, PATHS_AXIS)
        ssum = jax.lax.psum(jnp.sum(surf, dtype=jnp.float32), PATHS_AXIS)
        return surf, osum, osq, ssum

    surf, osum, osq, ssum = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P(None, PATHS_AXIS, None), P(), P(), P()),
        check_vma=False,
    )(key_outer, key_inner, params, n_total)

    r = jnp.asarray(option.r, jnp.float32)
    t = jnp.asarray(option.t, r.dtype)
    outer = summarize(finish_sum(osum), finish_sum(osq),
                      jnp.asarray(sim.n_paths, jnp.float32),
                      jnp.exp(-r * t))
    n_points = sim.n_paths * sim.n_steps
    return NMCResult(surface=surf, outer=outer,
                     surface_mean=ssum / n_points,
                     n_points=jnp.asarray(n_points, jnp.float32),
                     t_horizon=jnp.asarray(option.t, jnp.float32))


def price_nmc_sharded(option: OptionParams = DEMO_OPTION,
                      sim: SimParams = DEMO_SIM,
                      payoff="bullet_call",
                      *,
                      mesh: Optional[Mesh] = None,
                      engine: Optional[str] = None,
                      tile_rows: int = 8,
                      discount: str = "full",
                      key_outer=None,
                      key_inner=None,
                      interpret: bool = False) -> NMCResult:
    """NMC price surface with outer paths sharded across the mesh.

    The surface comes back as a sharded (n_steps, global_rows, 128) array
    (each chip holds its own path range); outer price and surface mean are
    replicated scalars.  ``engine`` as in `price_nmc`.
    """
    mesh = mesh if mesh is not None else make_mesh()
    engine = resolve_engine(engine, interpret)
    po = get_payoff(payoff)
    if po.n_state > 1:
        raise ValueError("NMC supports payoffs with at most one state array")
    if key_outer is None:
        key_outer = jnp.asarray(rng.derive_key(sim.seed, STREAM_OUTER),
                                jnp.uint32)
    if key_inner is None:
        key_inner = jnp.asarray(rng.derive_key(sim.seed, STREAM_INNER),
                                jnp.uint32)
    return _impl(option.as_f32(), po, sim.replace(seed=0), mesh, engine,
                 tile_rows, discount, interpret, key_outer, key_inner)


# ---------------------------------------------------------------------------
# Model-family NMC over the mesh: the generic engine's path-offset
# plumbing makes every family's exposure surface shardable with the same
# construction — one dispatcher over the family registry.
# ---------------------------------------------------------------------------

def price_nmc_model_sharded(model: str,
                            option: OptionParams = DEMO_OPTION,
                            dyn=None,
                            sim: SimParams = DEMO_SIM,
                            payoff="vanilla_call",
                            *,
                            mesh: Optional[Mesh] = None,
                            tile_rows: int = 8) -> NMCResult:
    """Family NMC surface with outer paths sharded across the mesh.

    ``model``: any registered NMC family.  Streams key by GLOBAL path id,
    so the result is mesh-size invariant and a 1-device mesh is bitwise
    identical to the single-device `price_nmc_<model>`; the surface comes
    back sharded along the path axis.
    """
    from mc_tpu.nmc_engine import (NMC_FAMILY_BUILDERS, ensure_family,
                                   price_nmc_family_sharded)
    ensure_family(model)
    fam, dyn32 = NMC_FAMILY_BUILDERS[model](option, dyn, sim)
    return price_nmc_family_sharded(fam, option, dyn32, sim, payoff,
                                    mesh=mesh, tile_rows=tile_rows)
