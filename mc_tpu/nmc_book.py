"""Netting-set nested Monte Carlo: EE/PFE/CVA of a B-contract book.

The reference's NMC re-prices ONE hard-coded contract
(``/root/reference/hello.cu:5-19`` + ``inc/nmc.cuh``); XVA desks compute
exposure on a NETTING SET — many trades with one counterparty, netted
per (path, step) point before the positive part is taken:

    EE_net(t_j) = E[ max( sum_b w_b V^b_ij , 0 ) ]

which is <= sum_b EE_b (netting subadditivity — the whole point of a
netting agreement, asserted in tests).

Construction: all contracts share the SAME outer trajectories and the
SAME inner-leg draws (common random numbers — the outer/inner threefry
keys are reused per contract, so the per-point conditional values are
priced under identical market scenarios and the netted surface has the
right cross-contract correlation by construction, not estimate).  Each
contract runs the standard C10 grid pipeline (`simulate_trajectories
_kernel` + `nmc_inner_kernel`), so a B=1 book is BIT-identical to
`price_nmc` (gated in tests).

Netting semantics require one market state: the market-data fields
(s0, r, sigma, q, t) must be equal across the book's rows — contract
terms (k, barrier, p1, p2) vary freely.  Shorts are first-class:
``weights`` takes +/- position sizes, and netting a long against a short
collapses exposure (asserted).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from mc_tpu import rng
from mc_tpu.config import DEMO_SIM, OptionParams, SimParams
from mc_tpu.nmc import STREAM_INNER, STREAM_OUTER, nmc_partials
from mc_tpu.oracle import PriceResult, summarize
from mc_tpu.ops import nmc_kernels as nk
from mc_tpu.ops import path_kernels as pk
from mc_tpu.ops._pallas import LANES, resolve_engine
from mc_tpu.ops.payoffs import get_payoff
from mc_tpu.ops.reduce import finish_sum
from mc_tpu.xva import ExposureMetrics

__all__ = ["price_nmc_book", "NMCBookResult"]

_MARKET_FIELDS = ("s0", "r", "sigma", "q", "t")


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class NMCBookResult(ExposureMetrics):
    """Netted value surface + per-contract diagnostics.

    ``net_surface[j]`` is the netted MtM sum_b w_b V^b at every
    (path, step) point, step-major (n_steps, rows, 128);
    ``outers`` the per-contract outer estimates (array-valued
    PriceResult, length B); ``ee_contract[b]`` contract b's standalone
    expected-exposure profile (of w_b V^b), shape (B, n_steps).
    """

    net_surface: Any
    outers: PriceResult
    ee_contract: Any
    net_outer_price: Any
    n_paths: Any
    t_horizon: Any

    def surface_matrix(self):
        """(n_paths, n_steps) netted-MtM view (drops lane padding)."""
        n_steps, rows, lanes = self.net_surface.shape
        out = jnp.moveaxis(self.net_surface, 0, -1).reshape(
            rows * lanes, n_steps)
        return out[: int(self.n_paths)]

    # exposure_profile / cva / dva / fva / ... operate on the NETTED
    # profile through ExposureMetrics — the counterparty-level outputs a
    # netting agreement exists for (uniform step-grid observation).


@functools.partial(
    jax.jit,
    static_argnames=("fam", "payoff", "sim", "n_contracts", "engine",
                     "tile_rows"))
def _price_nmc_book_impl(options, dyn, weights, payoff, sim, n_contracts,
                         engine, tile_rows, key_outer, key_inner, fam=None):
    cfg = nk.NMCConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                       n_inner=sim.n_paths_inner, tile_rows=tile_rows)
    n_pathsf = jnp.asarray(sim.n_paths, jnp.float32)
    valid_rows = (jnp.arange(cfg.n_tiles * tile_rows * LANES,
                             dtype=jnp.uint32).reshape(
                      cfg.n_tiles * tile_rows, LANES)
                  < jnp.uint32(sim.n_paths))

    # lax.scan over the contract rows: the NMC program compiles ONCE
    # (only the traced params vector differs per contract), so compile
    # time stays flat in B.
    def body(net, xs):
        opt_b, w = xs
        if fam is not None:
            from mc_tpu.nmc_engine import _xla_nmc_family
            params = fam.pack(opt_b, dyn, sim.n_steps)
            p_b = fam.unpack(params)
            surface, _, osum, osq = _xla_nmc_family(
                fam, payoff, sim, params, key_outer, key_inner, tile_rows)
            outer_b = summarize(finish_sum(osum), finish_sum(osq),
                                n_pathsf, fam.outer_discount(p_b))
        else:
            params = pk.pack_params(opt_b, sim.n_steps)
            surface, _, osum, osq = nmc_partials(
                payoff, cfg, engine, False, key_outer, key_inner, params,
                opt_b)
            outer_b = summarize(
                finish_sum(osum), finish_sum(osq), n_pathsf,
                jnp.exp(-jnp.float32(opt_b.r) * jnp.float32(opt_b.t)))
        w_surface = surface * w
        # standalone EE of the weighted position (padding contributes 0)
        pos = jnp.maximum(jnp.where(valid_rows[None], w_surface, 0.0), 0.0)
        ee_b = jnp.sum(pos, axis=(1, 2)) / n_pathsf
        return net + w_surface, (outer_b, ee_b)

    rows = cfg.n_tiles * tile_rows
    net0 = jnp.zeros((sim.n_steps, rows, LANES), jnp.float32)
    net, (outer_stack, ees) = jax.lax.scan(body, net0, (options, weights))
    net_outer = jnp.sum(weights * outer_stack.price)
    return NMCBookResult(net_surface=net, outers=outer_stack,
                         ee_contract=ees,
                         net_outer_price=net_outer,
                         n_paths=jnp.asarray(sim.n_paths, jnp.float32),
                         t_horizon=jnp.asarray(options.t, jnp.float32)[0])


def price_nmc_book(options: OptionParams,
                   sim: SimParams = DEMO_SIM,
                   payoff="vanilla_call",
                   weights=None,
                   *,
                   model: str = "gbm",
                   dyn=None,
                   tile_rows: int = 8,
                   stream_outer: int = STREAM_OUTER,
                   stream_inner: int = STREAM_INNER) -> NMCBookResult:
    """Netting-set NMC: netted EE/PFE/CVA over a B-contract book.

    ``options``: OptionParams with (B,)-array fields — market-data fields
    (s0, r, sigma, q, t) must be equal across rows (one counterparty, one
    market state); contract terms (k, barrier, p1, p2) vary per row.
    ``weights``: (B,) position sizes (negative = short); default all +1.
    ``model``: any NMC family ("heston", "merton", "cev", "localvol",
    "sabr", "vasicek", "basket") nets the book under that family's
    dynamics ``dyn`` — the scenarios stay CRN-shared across contracts,
    and a B=1 book is bitwise-equal to `price_nmc_<model>` ("basket"
    nets contracts on the SAME correlated d-asset state: a book of
    basket options at different strikes).  GBM books run `price_nmc`'s
    engine for the platform; family books run the family engine.
    """
    po = get_payoff(payoff)
    if po.n_state > 1:
        raise ValueError("NMC supports payoffs with at most one state "
                         "array")
    po.validate(options, sim.n_steps)
    b = np.asarray(options.k).shape
    if len(b) != 1 or b[0] < 1:
        raise ValueError("options fields must be 1-D (B,) arrays; got "
                         f"strike shape {b}")
    n_contracts = int(b[0])
    opt32 = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(jnp.asarray(x, jnp.float32),
                                   (n_contracts,)),
        options)
    for f in _MARKET_FIELDS:
        col = np.asarray(getattr(opt32, f))
        if not np.all(col == col[0]):
            raise ValueError(
                f"netting requires one market state: field {f!r} differs "
                f"across the book ({col.tolist()}); only contract terms "
                "(k, barrier, p1, p2) may vary")
    if weights is None:
        weights = jnp.ones((n_contracts,), jnp.float32)
    weights = jnp.asarray(weights, jnp.float32)
    if weights.shape != (n_contracts,):
        raise ValueError(f"weights shape {weights.shape} != "
                         f"({n_contracts},)")
    fam, dyn32 = None, None
    tag = ()
    if model != "gbm":
        from mc_tpu.nmc_engine import NMC_FAMILY_BUILDERS, ensure_family
        _BOOK_MODELS = ("heston", "bates", "merton", "cev", "localvol",
                        "sabr", "vasicek", "basket")  # rainbow/term: no book form
        if model not in _BOOK_MODELS:
            raise ValueError(f"unknown book model {model!r}; available: "
                             f"('gbm',) + {_BOOK_MODELS}")
        ensure_family(model)
        opt0 = jax.tree_util.tree_map(lambda x: x[0], opt32)
        fam, dyn32 = NMC_FAMILY_BUILDERS[model](opt0, dyn, sim)
        if fam.even_steps and sim.n_steps % 2:
            raise ValueError(f"{fam.name} requires an even n_steps")
        span, desc = fam.span(sim.n_steps, sim.n_paths_inner)
        if span >= 1 << 32:
            raise ValueError(f"inner RNG counter space exhausted: {desc} "
                             f"= {span} >= 2^32")
        tag = (fam.tag,)
    key_outer = jnp.asarray(rng.derive_key(sim.seed, stream_outer, *tag),
                            jnp.uint32)
    key_inner = jnp.asarray(rng.derive_key(sim.seed, stream_inner, *tag),
                            jnp.uint32)
    return _price_nmc_book_impl(opt32, dyn32, weights, po,
                                sim.replace(seed=0), n_contracts,
                                resolve_engine(None), tile_rows, key_outer,
                                key_inner, fam=fam)
