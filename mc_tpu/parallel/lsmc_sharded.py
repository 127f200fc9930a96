"""Multi-chip Longstaff-Schwartz: distributed cross-sectional regression.

LSMC is the one engine whose per-date statistic is not a plain moment
sum: the continuation regression needs the normal equations over ALL
paths.  Sharded, those are two small psums per exercise date — each chip
computes its local (B,B) X^T W X and (B,) X^T W y over its path range,
the psums produce the GLOBAL normal equations, and every chip solves the
same tiny system, so the fitted policy is identical everywhere (the
distributed-training pattern: data-parallel gram matrices, replicated
solve).  The cashflow moments then meet in one final psum like every
other sharded engine.

Paths are keyed by GLOBAL id (counter-based RNG), so the simulated paths
are mesh-size-invariant; the regression itself differs from single-chip
only in summation order (~1 ulp on the gram matrices), hence prices agree
to float tolerance rather than bitwise.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from mc_tpu import rng
from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.engines import _payoff_namespace
from mc_tpu.lsmc import _apply_policy_pass, _backward_fit
from mc_tpu.oracle import PriceResult
from mc_tpu.ops import path_kernels as pk
from mc_tpu.ops._pallas import LANES, resolve_engine
from mc_tpu.ops.payoffs import get_payoff
from mc_tpu.parallel.mesh import PATHS_AXIS, make_mesh, shard_bounds

__all__ = ["price_american_sharded"]


@functools.partial(
    jax.jit,
    static_argnames=("payoff", "sim", "mesh", "degree", "tile_rows",
                     "every", "two_pass"))
def _impl(option, payoff, sim, mesh, degree, tile_rows, every, two_pass,
          key, key_b):
    p = _payoff_namespace(option, sim.n_steps)
    n = sim.n_steps
    n_shards = mesh.devices.size
    n_local = shard_bounds(sim.n_paths, n_shards, tile_rows)
    cfg = pk.KernelConfig(n_paths=n_local, n_steps=n, tile_rows=tile_rows)
    params = pk.pack_params(option, n)
    disc = jnp.exp(-p.r * p.dt)
    inv_k = 1.0 / p.k
    n_total = jnp.uint32(sim.n_paths)

    def shard_fn(key, key_b, params, n_total):
        rank = jax.lax.axis_index(PATHS_AXIS).astype(jnp.uint32)
        offset = rank * jnp.uint32(n_local)

        def grids(k):
            s_g, c_g, _, _ = pk.trajectories(
                payoff, cfg, k, params, resolve_engine(None),
                path_offset=offset, n_valid=n_total)
            n_pad = s_g.shape[1] * LANES
            ids = offset + jnp.arange(n_pad, dtype=jnp.uint32)
            return (s_g.reshape(n, n_pad), c_g.reshape(n, n_pad),
                    ids < n_total)

        s_a, c_a, valid = grids(key)

        def immediate(s_f, c_f, j):
            st = (c_f[j],) if payoff.n_state else ()
            return payoff.terminal(st, s_f[j], p)

        # the SAME backward induction as single-chip LSMC; the psum hook
        # turns the per-chip gram sums into the GLOBAL normal equations,
        # so every chip solves one system and fits one policy.
        v, betas = _backward_fit(
            payoff, p, s_a, c_a, valid, n, degree, inv_k, disc, immediate,
            every, reduce_fn=lambda x: jax.lax.psum(x, PATHS_AXIS))
        v_final, valid_f = v, valid

        if two_pass:
            s_b, c_b, valid_b = grids(key_b)
            v_final = _apply_policy_pass(payoff, p, s_b, c_b, valid_b,
                                         betas, n, degree, inv_k, disc,
                                         immediate, every)
            valid_f = valid_b

        v_final = jnp.where(valid_f, v_final * disc, 0.0)
        s1 = jax.lax.psum(jnp.sum(v_final), PATHS_AXIS)
        s2 = jax.lax.psum(jnp.sum(v_final * v_final), PATHS_AXIS)
        return s1, s2

    s1, s2 = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )(key, key_b, params, n_total)

    nn = jnp.float32(sim.n_paths)
    mean = s1 / nn
    var = jnp.maximum(s2 / nn - mean * mean, 0.0) * (
        nn / jnp.maximum(nn - 1.0, 1.0))
    return PriceResult(price=mean, stderr=jnp.sqrt(var / nn), n_paths=nn,
                       payoff_mean=mean, payoff_var=var)


def price_american_sharded(option: OptionParams = DEMO_OPTION,
                           sim: SimParams = DEMO_SIM,
                           payoff="vanilla_put",
                           *,
                           mesh: Optional[Mesh] = None,
                           degree: int = 3,
                           two_pass: bool = True,
                           exercise_every: int = 1,
                           tile_rows: int = 8,
                           stream: int = 0) -> PriceResult:
    """Multi-chip two-pass Longstaff-Schwartz over a device mesh.

    Same estimator and streams as `mc_tpu.lsmc.price_american`; the
    regression's normal equations are psum'd so all chips fit one global
    policy (prices agree with single-chip to float tolerance — the gram
    sums reduce in a different order).
    """
    mesh = mesh if mesh is not None else make_mesh()
    po = get_payoff(payoff)
    if po.n_state > 1:
        raise ValueError("LSMC supports payoffs with at most one state "
                         "array")
    if exercise_every < 1:
        raise ValueError("exercise_every must be >= 1")
    key = jnp.asarray(rng.derive_key(sim.seed, stream), jnp.uint32)
    key_b = jnp.stack(rng.fold_key(key[0], key[1], 0x25A55))
    return _impl(option.as_f32(), po, sim.replace(seed=0), mesh, degree,
                 tile_rows, exercise_every, two_pass, key,
                 key_b)
