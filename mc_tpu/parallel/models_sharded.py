"""Multi-device pricing for the non-GBM model families.

`mesh.price_sharded` shards the GBM engines; this module extends the same
construction — paths data-parallel over a 1-D mesh, each device pricing a
contiguous GLOBAL path-id range, one (8,128)-slab `psum`, f64-grade finish
on the replicated result — to every model family.  Because every model
keys its counter-based RNG by global path id, the result is invariant to
the mesh size and, on a 1-device mesh, BIT-identical to the single-device
`price_<model>` at equal tiling (pinned in tests/test_parallel.py).

Round 3: the per-model dispatch is a REGISTRY (`_MODEL_DEFS`), not an
elif chain — one `ShardedModel` row per family carries its stream tag,
demo dynamics, validation, parameter packing, partials kernel, and
discount convention.  `price_model_sharded` and `_model_sharded_impl`
are fully generic; adding family N+1 is one `_def_<model>` function and
one registry line.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from mc_tpu import rng
from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.oracle import PriceResult, summarize
from mc_tpu.ops import path_kernels as pk
from mc_tpu.ops.payoffs import get_payoff
from mc_tpu.parallel.mesh import PATHS_AXIS, make_mesh, shard_bounds

__all__ = ["price_model_sharded", "SHARDED_MODELS"]


@dataclasses.dataclass(frozen=True)
class ShardedModel:
    """One model family's multi-device wiring.

    ``prepare(option, dyn, sim) -> (dyn, kmax)`` validates and returns
    static extras; ``build(payoff, cfg, option, dyn32, n_steps, kmax) ->
    (params, partials)`` supplies the packed parameter vector and the
    per-shard partials function; ``discount(params, r, t)``
    the finish-side discount.
    """

    tag: int
    default_dyn: Callable[[SimParams], Any]
    build: Callable[..., Any]
    prepare: Optional[Callable[..., Any]] = None
    discount: Optional[Callable[..., Any]] = None
    even_steps: bool = False
    terminal_only: bool = False   # rainbow/fx: one exact draw, n_steps = 1
    # Families whose payoff is a NAME in their own registry (rainbow,
    # fx contracts) supply a resolver: payoff-or-None -> static name.
    resolve_payoff: Optional[Callable[[Any], Any]] = None


def _def_heston():
    from mc_tpu.models.heston import DEMO_HESTON
    return ShardedModel(
        tag=0x4E57, default_dyn=lambda sim: DEMO_HESTON,
        build=_build_heston)


def _build_heston(payoff, cfg, option, dyn, n_steps, kmax):
    from mc_tpu.models.heston import _heston_partials, _pack_heston
    params = _pack_heston(option, dyn, n_steps)

    def partials(key, params, offset, bound):
        return _heston_partials(payoff, cfg, key, params, offset, bound)

    return params, partials


def _def_cev():
    from mc_tpu.models.cev import DEMO_CEV
    return ShardedModel(
        tag=0xCE4, default_dyn=lambda sim: DEMO_CEV, build=_build_cev,
        even_steps=True)


def _build_cev(payoff, cfg, option, dyn, n_steps, kmax):
    from mc_tpu.models.cev import _cev_partials, _pack_cev
    params = _pack_cev(option, dyn, n_steps)

    def partials(key, params, offset, bound):
        return _cev_partials(payoff, cfg, key, params, offset, bound)

    return params, partials


def _def_merton():
    from mc_tpu.models.merton import DEMO_MERTON

    def prepare(option, dyn, sim):
        from mc_tpu.models.merton import poisson_kmax
        return dyn, poisson_kmax(float(dyn.lam) * float(option.t)
                                 / sim.n_steps)

    return ShardedModel(
        tag=0x3E44, default_dyn=lambda sim: DEMO_MERTON,
        build=_build_merton, prepare=prepare, even_steps=True)


def _build_merton(payoff, cfg, option, dyn, n_steps, kmax):
    from mc_tpu.models.merton import _merton_partials, _pack_merton
    params = _pack_merton(option, dyn, n_steps)

    def partials(key, params, offset, bound):
        return _merton_partials(payoff, cfg, kmax, key, params, offset,
                                bound)

    return params, partials


def _def_bates():
    from mc_tpu.models.bates import DEMO_BATES

    def prepare(option, dyn, sim):
        from mc_tpu.models.merton import poisson_kmax
        return dyn, poisson_kmax(float(dyn.lam) * float(option.t)
                                 / sim.n_steps)

    return ShardedModel(
        tag=0xBA7E, default_dyn=lambda sim: DEMO_BATES,
        build=_build_bates, prepare=prepare)


def _build_bates(payoff, cfg, option, dyn, n_steps, kmax):
    from mc_tpu.models.bates import _bates_partials, _pack_bates
    params = _pack_bates(option, dyn, n_steps)

    def partials(key, params, offset, bound):
        return _bates_partials(payoff, cfg, kmax, key, params, offset,
                               bound)

    return params, partials


def _def_sabr():
    from mc_tpu.models.sabr import DEMO_SABR
    return ShardedModel(
        tag=0x5AB4, default_dyn=lambda sim: DEMO_SABR, build=_build_sabr)


def _build_sabr(payoff, cfg, option, dyn, n_steps, kmax):
    from mc_tpu.models.sabr import _pack_sabr, _sabr_partials
    params = _pack_sabr(option, dyn, n_steps)

    def partials(key, params, offset, bound):
        return _sabr_partials(payoff, cfg, key, params, offset, bound)

    return params, partials


def _resolve_rainbow_payoff(payoff):
    from mc_tpu.models.rainbow import RAINBOW_PAYOFFS
    if payoff is None:
        payoff = "call_on_max"
    if payoff not in RAINBOW_PAYOFFS:
        raise KeyError(f"unknown rainbow payoff {payoff!r}; "
                       f"available: {sorted(RAINBOW_PAYOFFS)}")
    return payoff


def _def_rainbow():
    from mc_tpu.models.basket import DEMO_BASKET
    return ShardedModel(
        tag=0xBE0F, default_dyn=lambda sim: DEMO_BASKET,
        build=_build_rainbow, terminal_only=True,
        resolve_payoff=_resolve_rainbow_payoff)


def _build_rainbow(payoff, cfg, option, dyn, n_steps, kmax):
    from mc_tpu.models.basket import _basket_namespace, _pack_basket
    from mc_tpu.models.rainbow import _rainbow_partials
    d = int(dyn.s0s.shape[0])
    params = _pack_basket(_basket_namespace(option, dyn, 1), d)

    def partials(key, params, offset, bound):
        # `payoff` is the rainbow payoff NAME (static string)
        return _rainbow_partials(payoff, cfg, d, key, params, offset,
                                 bound)

    return params, partials


def _resolve_fx_contract(payoff):
    from mc_tpu.models.fx import get_fx_contract
    return get_fx_contract("quanto_call" if payoff is None else payoff)


def _def_fx():
    from mc_tpu.models.fx import DEMO_FX, FX_TAG
    return ShardedModel(
        tag=FX_TAG, default_dyn=lambda sim: DEMO_FX, build=_build_fx,
        terminal_only=True, resolve_payoff=_resolve_fx_contract)


def _build_fx(payoff, cfg, option, dyn, n_steps, kmax):
    from mc_tpu.models.fx import _fx_partials, _pack_fx
    params = _pack_fx(option, dyn)

    def partials(key, params, offset, bound):
        # `payoff` is the fx CONTRACT name (static string)
        return _fx_partials(payoff, cfg, key, params, offset, bound)

    return params, partials


def _def_vasicek():
    from mc_tpu.models.vasicek import DEMO_VASICEK
    return ShardedModel(
        tag=0x7A51, default_dyn=lambda sim: DEMO_VASICEK,
        build=_build_vasicek, even_steps=True,
        discount=lambda params, r, t: jnp.float32(1.0))  # pathwise


def _build_vasicek(payoff, cfg, option, dyn, n_steps, kmax):
    from mc_tpu.models.vasicek import _pack_vasicek, _vasicek_partials
    params = _pack_vasicek(option, dyn, n_steps)

    def partials(key, params, offset, bound):
        return _vasicek_partials(payoff, cfg, key, params, offset, bound)

    return params, partials


def _def_term():
    from mc_tpu.models.term import TermStructure

    def default_dyn(sim):
        return TermStructure.from_knots([0.10, 0.07, 0.05],
                                        [0.15, 0.22, 0.30], sim.n_steps)

    def prepare(option, dyn, sim):
        if dyn.rates.shape[0] != sim.n_steps:
            raise ValueError(
                f"term structure has {dyn.rates.shape[0]} steps, sim has "
                f"{sim.n_steps}")
        return dyn, 0

    return ShardedModel(
        tag=0x7E53, default_dyn=default_dyn, build=_build_term,
        prepare=prepare, even_steps=True,
        # term discounts off its curve average (r_bar packed at slot 9)
        discount=lambda params, r, t: jnp.exp(-params[9] * t))


def _build_term(payoff, cfg, option, dyn, n_steps, kmax):
    from mc_tpu.models.term import _pack_term, _term_partials
    params = _pack_term(option, dyn, n_steps)

    def partials(key, params, offset, bound):
        return _term_partials(payoff, cfg, key, params, offset, bound)

    return params, partials


def _def_localvol():
    from mc_tpu.models.localvol import LocalVolSurface

    def prepare(option, dyn, sim):
        from mc_tpu.models.localvol import validate_surface
        return validate_surface(dyn, sim.n_steps), 0

    return ShardedModel(
        tag=0x10CA,
        default_dyn=lambda sim: LocalVolSurface.demo(sim.n_steps),
        build=_build_localvol, prepare=prepare, even_steps=True)


def _build_localvol(payoff, cfg, option, dyn, n_steps, kmax):
    from mc_tpu.models.localvol import _localvol_partials, _pack_localvol
    n_knots = int(dyn.x_knots.shape[0])
    params = _pack_localvol(option, dyn, n_steps)

    def partials(key, params, offset, bound):
        return _localvol_partials(payoff, cfg, n_knots, key, params,
                                  offset, bound)

    return params, partials


# Registry: model name -> lazy ShardedModel definition.  Lazy so that
# importing mc_tpu.parallel stays cheap (model modules import on use).
_MODEL_DEFS: dict = {
    "heston": _def_heston, "bates": _def_bates, "cev": _def_cev,
    "merton": _def_merton,
    "sabr": _def_sabr, "rainbow": _def_rainbow, "vasicek": _def_vasicek,
    "term": _def_term, "localvol": _def_localvol, "fx": _def_fx,
}

SHARDED_MODELS = tuple(_MODEL_DEFS)


@functools.lru_cache(maxsize=None)
def _model_def(model: str) -> ShardedModel:
    return _MODEL_DEFS[model]()


@functools.partial(
    jax.jit,
    static_argnames=("model", "payoff", "sim", "mesh", "antithetic",
                     "tile_rows", "kmax"))
def _model_sharded_impl(model, option, dyn, payoff, sim, mesh, antithetic,
                        tile_rows, key, kmax=0):
    mdef = _model_def(model)
    n_shards = mesh.devices.size
    n_local = shard_bounds(sim.n_paths, n_shards, tile_rows)
    n_steps = 1 if mdef.terminal_only else sim.n_steps
    cfg = pk.KernelConfig(n_paths=n_local, n_steps=n_steps,
                          tile_rows=tile_rows, antithetic=antithetic)
    params, partials = mdef.build(payoff, cfg, option, dyn, sim.n_steps,
                                  kmax)
    n_total = jnp.uint32(sim.n_paths)

    def shard_fn(key, params, n_total):
        rank = jax.lax.axis_index(PATHS_AXIS).astype(jnp.uint32)
        offset = rank * jnp.uint32(n_local)
        s, sq = partials(key, params, offset, n_total)
        return (jax.lax.psum(s, PATHS_AXIS), jax.lax.psum(sq, PATHS_AXIS))

    s, sq = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )(key, params, n_total)

    from mc_tpu.ops.reduce import finish_sum
    r = jnp.float32(option.r)
    t = jnp.float32(option.t)
    discount = (mdef.discount(params, r, t) if mdef.discount is not None
                else jnp.exp(-r * t))
    return summarize(finish_sum(s), finish_sum(sq),
                     jnp.asarray(sim.n_paths, jnp.float32),
                     discount)


def price_model_sharded(model: str,
                        option: OptionParams = DEMO_OPTION,
                        dyn=None,
                        sim: SimParams = DEMO_SIM,
                        payoff=None,
                        *,
                        mesh: Optional[Mesh] = None,
                        antithetic: bool = False,
                        tile_rows: int = 128,
                        stream: int = 0,
                        key=None) -> PriceResult:
    """Multi-device Monte Carlo price under a non-GBM model family.

    ``model``: one of `SHARDED_MODELS`.  ``dyn`` defaults to the model's
    demo dynamics.  ``payoff=None`` picks the model's default contract
    (vanilla_call; call_on_max for "rainbow", quanto_call for "fx" —
    those two families key payoffs in their OWN registries, so names
    like "vanilla_call" are rejected there rather than silently
    remapped).  The per-model stream tag
    matches the single-device `price_<model>` entry point, so a 1-device
    mesh reproduces it bitwise and larger meshes reproduce its
    statistics exactly (global-path-id keyed counters).
    """
    if model not in _MODEL_DEFS:
        raise ValueError(f"unknown model {model!r}; "
                         f"sharded models: {SHARDED_MODELS}")
    mdef = _model_def(model)
    if mdef.resolve_payoff is not None:
        # rainbow/fx payoffs live in their own registries, keyed by NAME
        po = mdef.resolve_payoff(payoff)
    else:
        po = get_payoff("vanilla_call" if payoff is None else payoff)
        po.validate(option, sim.n_steps)
    mesh = mesh if mesh is not None else make_mesh()
    if dyn is None:
        dyn = mdef.default_dyn(sim)
    kmax = 0
    if mdef.prepare is not None:
        dyn, kmax = mdef.prepare(option, dyn, sim)
    if mdef.even_steps and sim.n_steps % 2:
        raise ValueError(f"{model} requires an even n_steps "
                         "(pair-consuming step loop)")
    if key is None:
        key = jnp.asarray(rng.derive_key(sim.seed, stream, mdef.tag),
                          jnp.uint32)
    return _model_sharded_impl(model, option.as_f32(), dyn.as_f32(), po,
                               sim.replace(seed=0), mesh, antithetic,
                               tile_rows, key, kmax=kmax)
