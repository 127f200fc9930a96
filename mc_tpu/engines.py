"""Pricing engines: the orchestration layer (SURVEY.md C13).

One function per pricing capability, mirroring the reference's host wrappers
(``inc/wrappers.cuh:10-340``) but as pure jitted programs:

* ``price(...)``            — vanilla / bullet / Asian / barrier / lookback
                              pricing, engine="pallas" (fused Triton kernel,
                              the default on a GPU) or "xla" (plain jnp, the
                              default elsewhere); antithetic +
                              control-variate variance reduction.
* ``simulate_trajectories`` — full (S_t, state_t) grid materialization (C9).

Both engines consume the *same* counter-based RNG stream and sum in the
same order, so they agree to the last bits of the transcendentals — the
framework's version of the reference's shared-random-array CPU/GPU
fixture (``inc/testing.cuh:17-42``; SURVEY.md section 4 "same-randomness
determinism").

The reference finished its reductions on the host over memcpy'd partials
(``wrappers.cuh:79-85``); here the f64 finish is part of the same jitted
program and only two scalars leave the device.
"""

from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace
from typing import Any, Optional

import jax
import jax.numpy as jnp

from mc_tpu import rng
from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.oracle import PriceResult, summarize
from mc_tpu.ops import path_kernels as pk
from mc_tpu.ops._pallas import LANES, resolve_engine
from mc_tpu.ops.payoffs import PathPayoff, get_payoff
from mc_tpu.ops.reduce import finish_sum

__all__ = ["price", "price_ladder", "price_portfolio",
           "simulate_trajectories", "Trajectories",
           "STREAM_OUTER", "STREAM_INNER"]

# Stream tags (replace the reference's magic seeds 1234/1235,
# wrappers.cuh:41,151: outer vs inner NMC draws must be independent).
STREAM_OUTER = 0
STREAM_INNER = 1


def _payoff_namespace(option: OptionParams, n_steps: int) -> SimpleNamespace:
    """Traced option params + derived fields, as attribute access for payoffs."""
    s0, t, k, r, sigma, barrier, p1, p2, q = (
        jnp.float32(v) for v in option.astuple())
    n = jnp.float32(n_steps)
    dt = t / n
    return SimpleNamespace(
        s0=s0, t=t, k=k, r=r, sigma=sigma, barrier=barrier, p1=p1, p2=p2,
        q=q, dt=dt,
        drift_dt=(r - q - 0.5 * sigma * sigma) * dt,
        vol_dt=sigma * jnp.sqrt(dt),
        drift_t=(r - q - 0.5 * sigma * sigma) * t,
        vol_t=sigma * jnp.sqrt(t),
        inv_n_steps=1.0 / n,
    )


# ---------------------------------------------------------------------------
# XLA engine: the CPU-runnable dual of the Pallas kernel (same RNG stream).
# ---------------------------------------------------------------------------


def _xla_partials(payoff: PathPayoff, cfg: pk.KernelConfig, key, option,
                  path_offset, n_valid=None):
    """Pure-jnp twin of `pk.simulate_partials`: identical draws AND identical
    summation order (8x128 sublane fold + Kahan tile accumulation).

    Iterates tiles with `lax.scan` so memory stays bounded at one
    (tile_rows, 128) tile regardless of n_paths.
    """
    p = _payoff_namespace(option, cfg.n_steps)
    k0 = jnp.asarray(key[0], jnp.uint32)
    k1 = jnp.asarray(key[1], jnp.uint32)

    def tile_fn(ids, valid):
        s0 = jnp.full(ids.shape, p.s0, jnp.float32)
        return pk.path_moments(payoff, cfg, p, k0, k1, ids, valid, s0)

    return pk.xla_moment_scan(tile_fn, cfg.n_paths, cfg.tile_rows,
                              5 if cfg.with_cv else 2,
                              offset=path_offset, bound=n_valid)


# ---------------------------------------------------------------------------
# Differentiable Pallas primal: jax.grad cannot trace into a Triton
# kernel, but the XLA engine computes the same function of the same
# stream — so the fused kernel is the forward pass and the XLA engine
# defines the backward.  Any computation composing price(engine="pallas")
# (calibration loops, chunked pipelines, greeks with jax.grad)
# differentiates instead of erroring.
# ---------------------------------------------------------------------------


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def _pallas_partials_diff(payoff, cfg, interpret, key, option, path_offset):
    params = pk.pack_params(option, cfg.n_steps)
    return tuple(pk.simulate_partials(payoff, cfg, key, params,
                                      path_offset=path_offset,
                                      interpret=interpret))


def _pallas_partials_fwd(payoff, cfg, interpret, key, option, path_offset):
    out = _pallas_partials_diff(payoff, cfg, interpret, key, option,
                                path_offset)
    return out, (key, option, path_offset)


def _pallas_partials_bwd(payoff, cfg, interpret, res, ct):
    import numpy as np
    key, option, path_offset = res
    _, vjp = jax.vjp(
        lambda o: tuple(_xla_partials(payoff, cfg, key, o, path_offset)),
        option)
    (d_option,) = vjp(tuple(ct))

    def f0(x):
        return np.zeros(jnp.shape(x), jax.dtypes.float0)

    return (f0(key), d_option, f0(path_offset))


_pallas_partials_diff.defvjp(_pallas_partials_fwd, _pallas_partials_bwd)


# ---------------------------------------------------------------------------
# Public pricing API
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("payoff", "sim", "method", "engine", "antithetic",
                     "control_variate", "tile_rows", "rng_source",
                     "interpret", "path_count_override", "importance_shift"))
def _price_impl(option, payoff, sim, method, engine, antithetic,
                control_variate, tile_rows, rng_source, interpret,
                key, path_offset, path_count_override,
                importance_shift=0.0):
    n_paths = path_count_override or sim.n_paths
    if method == "terminal_pair":
        # both Box-Muller halves become paths: element e = paths (2e, 2e+1)
        n_elems = (n_paths + 1) // 2
        cfgp = pk.KernelConfig(n_paths=n_elems, n_steps=sim.n_steps,
                               tile_rows=tile_rows, rng_source=rng_source)
        params = pk.pack_params(option, sim.n_steps)
        partials = pk.terminal_pair_partials(
            payoff, cfgp, key, params, jnp.uint32(n_paths), engine=engine,
            interpret=interpret)
        sums = [finish_sum(x) for x in partials]
        r = jnp.asarray(option.r, jnp.float32)
        t = jnp.asarray(option.t, r.dtype)
        return summarize(sums[0], sums[1],
                         jnp.asarray(n_paths, sums[0].dtype),
                         jnp.exp(-r * t))
    cfg = pk.KernelConfig(
        n_paths=n_paths,
        n_steps=sim.n_steps,
        tile_rows=tile_rows,
        antithetic=antithetic,
        with_cv=control_variate,
        rng_source=rng_source,
        method=method,
        is_shift=importance_shift,
    )
    if engine == "pallas":
        partials = _pallas_partials_diff(
            payoff, cfg, interpret, key, option,
            jnp.asarray(path_offset, jnp.uint32))
    elif engine == "xla":
        partials = _xla_partials(payoff, cfg, key, option, path_offset)
    else:
        raise ValueError(f"unknown engine {engine!r}")

    sums = [finish_sum(x) for x in partials]
    r = jnp.asarray(option.r, jnp.float64 if sums[0].dtype == jnp.float64
                    else jnp.float32)
    t = jnp.asarray(option.t, r.dtype)
    discount = jnp.exp(-r * t)
    n = jnp.asarray(n_paths, sums[0].dtype)

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
        ex = payoff.control_expectation(_payoff_namespace(option, sim.n_steps))
    else:
        q = jnp.asarray(option.q, r.dtype)
        ex = jnp.asarray(option.s0, n.dtype) * jnp.exp((r - q) * t)  # E[S_T]
    adj_mean = mean_p - beta * (mean_x - ex)
    adj_var = jnp.maximum(var_p - cov * cov / var_x, 0.0)
    stderr = jnp.sqrt(adj_var / n) * discount
    return PriceResult(
        price=discount * adj_mean,
        stderr=stderr,
        n_paths=n,
        payoff_mean=adj_mean,
        payoff_var=adj_var,
    )


def price(option: OptionParams = DEMO_OPTION,
          sim: SimParams = DEMO_SIM,
          payoff="vanilla_call",
          *,
          method: Optional[str] = None,
          engine: Optional[str] = None,
          antithetic: bool = False,
          control_variate: bool = False,
          tile_rows: Optional[int] = None,
          rng_source: str = "threefry13",
          stream: int = STREAM_OUTER,
          key=None,
          path_offset: int = 0,
          n_paths: Optional[int] = None,
          importance_shift: float = 0.0,
          interpret: bool = False) -> PriceResult:
    """Price an option by Monte Carlo.

    Replaces (and unifies) the reference wrappers:
      * wrapper_gpu_option_vanilla   -> price(payoff="vanilla_call")
        (exact one-shot terminal draw, trajectories.cuh:54-113)
      * wrapper_gpu_bullet_option[_atomic] -> price(payoff="bullet_call")
        (log-Euler step loop + windowed payoff, trajectories.cuh:115-271;
        the partial-vs-atomic aggregation distinction disappears —
        tiles write per-tile partials, summed in tile order)
      * plus Asian / knock-out / lookback payoffs and antithetic /
        control-variate variance reduction (BASELINE.json configs 2-3).

    engine: None picks by platform — "pallas" (the Triton kernels) on a
    GPU, "xla" elsewhere; "pallas" off the GPU needs ``interpret=True``.
    tile_rows: paths per tile / 128; None takes the engine's default
    (`path_kernels.DEFAULT_TILE_ROWS`).  The two engines agree bit for
    bit on the CPU (interpreted kernels) at equal tile_rows.

    method: "terminal" (exact, European-only) | "terminal_pair" (exact,
    both Box-Muller halves become paths — half the threefry and
    Box-Muller work per path; no antithetic/CV/IS/offset combos) |
    "euler".  Default: "terminal_pair" for plain terminal-only pricing,
    "terminal" when antithetic/CV/IS/path_offset need the per-path
    counter stream, "euler" for path-dependent payoffs.  NOTE the two
    terminal kernels draw DIFFERENT streams (pair element e covers
    paths (2e, 2e+1)); pass method="terminal" explicitly to reproduce
    pre-round-5 default streams.

    importance_shift: shift the sampled terminal log-price by this many
    sigma*sqrt(T) standard deviations with exact likelihood-ratio
    re-weighting (unbiased).  Aim the paths at the money for deep-OTM
    strikes: shift ~= log(K/S0)/(sigma*sqrt(T)) collapses the stderr by
    orders of magnitude.  ``importance_shift="auto"`` centers the
    terminal log-price distribution AT the strike (the standard
    aim-at-the-money heuristic — near-optimal for OTM vanillas/digitals,
    a no-op-ish small shift ATM).
    """
    po = get_payoff(payoff)
    if method is None:
        # terminal_pair is the default for plain terminal pricing: one
        # threefry + Box-Muller pair prices two paths.  Variance
        # reduction / IS / resume offsets need the per-path counter
        # stream, so they keep the classic terminal kernel.
        if (po.terminal_only and not antithetic and not control_variate
                and not importance_shift and not path_offset):
            method = "terminal_pair"
        else:
            method = "terminal" if po.terminal_only else "euler"
    if po.n_state > 0 and method in ("terminal", "terminal_pair"):
        raise ValueError(f"{po.name} is path-dependent; "
                         f"method={method!r} invalid")
    if method == "terminal_pair":
        if antithetic or control_variate or importance_shift:
            raise ValueError("terminal_pair is the plain fast path: "
                             "antithetic/control_variate/importance_shift "
                             "route through method='terminal'")
        if path_offset:
            raise ValueError("terminal_pair does not take a path_offset "
                             "(element ids cover paths (2e, 2e+1))")
    po.validate(option, sim.n_steps)
    if importance_shift == "auto":
        # center E[log S_T] at log K: shift = (log(K/S0) - mu T)/(sigma vT)
        import math
        mu = option.r - option.q - 0.5 * option.sigma ** 2
        importance_shift = float(
            (math.log(option.k / option.s0) - mu * option.t)
            / (option.sigma * math.sqrt(option.t)))
    pk.check_rng_source(rng_source)
    engine = resolve_engine(engine, interpret)
    if tile_rows is None:
        tile_rows = pk.default_tile_rows(engine)
    if key is None:
        key = jnp.asarray(rng.derive_key(sim.seed, stream), jnp.uint32)
    # seed is consumed into `key` above; zero it in the static argument so
    # re-seeding never recompiles (the reference recompiled for ANY change).
    return _price_impl(
        option.as_f32(), po, sim.replace(seed=0), method, engine, antithetic,
        control_variate, tile_rows, rng_source, interpret, key,
        jnp.uint32(path_offset), n_paths, float(importance_shift))


# ---------------------------------------------------------------------------
# Trajectory materialization (C9 / C16 support)
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Trajectories:
    """Materialized path grids, step-major (n_steps, rows, 128).

    ``s[j]`` is the price after step j+1; ``state[j]`` the payoff state
    (e.g. the bullet barrier count) after step j+1 — exactly the
    (d_stock_prices, d_sums_i) grids of trajectories.cuh:304-305.
    """

    s: Any
    state: Any
    pay_sum: Any
    pay_sq: Any
    n_paths: Any

    def path_matrix(self):
        """(n_paths, n_steps) price matrix (drops padding)."""
        n_steps, rows, lanes = self.s.shape
        out = jnp.moveaxis(self.s, 0, -1).reshape(rows * lanes, n_steps)
        return out[: self.n_paths]

    def state_matrix(self):
        n_steps, rows, lanes = self.state.shape
        out = jnp.moveaxis(self.state, 0, -1).reshape(rows * lanes, n_steps)
        return out[: self.n_paths]


@functools.partial(
    jax.jit,
    static_argnames=("payoff", "sim", "tile_rows", "engine", "interpret"))
def _trajectories_impl(option, payoff, sim, tile_rows, engine, interpret, key,
                       path_offset):
    cfg = pk.KernelConfig(
        n_paths=sim.n_paths, n_steps=sim.n_steps, tile_rows=tile_rows)
    params = pk.pack_params(option, sim.n_steps)
    if engine == "pallas":
        s, st, psum, psq = pk.simulate_trajectories_kernel(
            payoff, cfg, key, params, path_offset=path_offset,
            interpret=interpret)
    else:
        s, st, psum, psq = pk.xla_trajectories(
            payoff, cfg, key, params, path_offset=path_offset)
    return Trajectories(s=s, state=st, pay_sum=finish_sum(psum),
                        pay_sq=finish_sum(psq), n_paths=sim.n_paths)


def simulate_trajectories(option: OptionParams = DEMO_OPTION,
                          sim: SimParams = DEMO_SIM,
                          payoff="bullet_call",
                          *,
                          tile_rows: int = 8,
                          stream: int = STREAM_OUTER,
                          key=None,
                          path_offset: int = 0,
                          engine: Optional[str] = None,
                          interpret: bool = False) -> Trajectories:
    """Simulate and persist full trajectories (simulate_outer_trajectories,
    trajectories.cuh:273-351).  ``engine`` as in `price`."""
    po = get_payoff(payoff)
    engine = resolve_engine(engine, interpret)
    if key is None:
        key = jnp.asarray(rng.derive_key(sim.seed, stream), jnp.uint32)
    return _trajectories_impl(option.as_f32(), po, sim.replace(seed=0),
                              tile_rows, engine, interpret, key,
                              jnp.uint32(path_offset))


# ---------------------------------------------------------------------------
# Strike-ladder pricing: M strikes on shared paths in one pass.
# ---------------------------------------------------------------------------


def _xla_ladder(payoff, cfg, n_strikes, key, option, strikes, path_offset=0):
    """One simulation per tile, M payoff evaluations (same draws and Kahan
    order as `price` at each strike)."""
    p = _payoff_namespace(option, cfg.n_steps)
    k0 = jnp.asarray(key[0], jnp.uint32)
    k1 = jnp.asarray(key[1], jnp.uint32)
    shape = (cfg.tile_rows, LANES)
    flat = (jax.lax.broadcasted_iota(jnp.uint32, shape, 0) * LANES
            + jax.lax.broadcasted_iota(jnp.uint32, shape, 1))
    offset = jnp.asarray(path_offset, jnp.uint32)
    bound = offset + jnp.uint32(cfg.n_paths)
    strikes = jnp.asarray(strikes, jnp.float32)

    def one_tile(carry, i):
        acc_s, acc_q, comp = carry
        ids = offset + jnp.uint32(i * cfg.paths_per_tile) + flat
        valid = ids < bound

        def draw_pair(m):
            c1 = jnp.full(shape, 0, jnp.uint32) + jnp.asarray(m, jnp.uint32)
            return rng.normal_pair(k0, k1, ids, c1, rounds=cfg.rng_rounds)

        s0 = jnp.full(shape, p.s0, jnp.float32)
        s_t, state, wgt = pk._simulate_leg(payoff, cfg, p, s0, draw_pair)
        if cfg.antithetic:
            s_t2, state2, wgt2 = pk._simulate_leg(
                payoff, cfg, p, s0,
                lambda m: tuple(-z for z in draw_pair(m)))
        def strike_body(m, carry):
            acc_s, acc_q, comp = carry
            pm = SimpleNamespace(**{**p.__dict__, "k": strikes[m]})
            pay = payoff.terminal(state, s_t, pm)
            if wgt is not None:
                pay = pay * wgt
            if cfg.antithetic:
                pay2 = payoff.terminal(state2, s_t2, pm)
                if wgt is not None:
                    pay2 = pay2 * wgt2
                pay = 0.5 * (pay + pay2)
            pay = jnp.where(valid, pay, 0.0)
            for which, cslot, v in ((0, 2 * m, pay), (1, 2 * m + 1, pay * pay)):
                acc = acc_s if which == 0 else acc_q
                p8 = pk.fold_to_sublanes(v, cfg.tile_rows)
                a = acc[m]
                y = p8 - comp[cslot]
                t = a + y
                comp = comp.at[cslot].set((t - a) - y)
                if which == 0:
                    acc_s = acc_s.at[m].set(t)
                else:
                    acc_q = acc_q.at[m].set(t)
            return (acc_s, acc_q, comp)

        acc_s, acc_q, comp = jax.lax.fori_loop(
            0, n_strikes, strike_body, (acc_s, acc_q, comp))
        return (acc_s, acc_q, comp), None

    zero = jnp.zeros((n_strikes, pk.SUBLANES, LANES), jnp.float32)
    comp0 = jnp.zeros((2 * n_strikes, pk.SUBLANES, LANES), jnp.float32)
    (acc_s, acc_q, _), _ = jax.lax.scan(
        one_tile, (zero, zero, comp0),
        jnp.arange(cfg.n_tiles, dtype=jnp.uint32))
    return acc_s, acc_q


@functools.partial(
    jax.jit,
    static_argnames=("payoff", "sim", "n_strikes", "method", "antithetic",
                     "tile_rows"))
def _price_ladder_impl(option, payoff, sim, n_strikes, method, antithetic,
                       tile_rows, key, strikes):
    cfg = pk.KernelConfig(
        n_paths=sim.n_paths, n_steps=sim.n_steps, tile_rows=tile_rows,
        antithetic=antithetic, method=method)
    acc_s, acc_q = _xla_ladder(payoff, cfg, n_strikes, key, option, strikes)
    sums = jax.vmap(finish_sum)(acc_s)
    sqs = jax.vmap(finish_sum)(acc_q)
    r = jnp.float32(option.r)
    t = jnp.float32(option.t)
    return summarize(sums, sqs, jnp.float32(sim.n_paths), jnp.exp(-r * t))


def price_ladder(strikes,
                 option: OptionParams = DEMO_OPTION,
                 sim: SimParams = DEMO_SIM,
                 payoff="vanilla_call",
                 *,
                 method: Optional[str] = None,
                 antithetic: bool = False,
                 tile_rows: int = 128,
                 stream: int = STREAM_OUTER,
                 key=None) -> PriceResult:
    """Price a strike ladder on SHARED paths in one pass.

    Returns a PriceResult whose fields are (n_strikes,) arrays.  The path
    simulation (the entire cost) runs once; each strike adds only a
    terminal-payoff evaluation — an M-strike vol-surface row costs ~the
    same as one price.  Strike enters every registered payoff only through
    ``terminal``, so sharing the path state is exact.  Estimates across
    strikes are positively correlated (same paths), which is precisely
    what calibration wants (smooth ladders, stable digitals/spreads).
    """
    po = get_payoff(payoff)
    if method is None:
        method = "terminal" if po.terminal_only else "euler"
    if po.n_state > 0 and method == "terminal":
        raise ValueError(f"{po.name} is path-dependent; method='terminal' invalid")
    strikes = jnp.atleast_1d(jnp.asarray(strikes, jnp.float32))
    if key is None:
        key = jnp.asarray(rng.derive_key(sim.seed, stream), jnp.uint32)
    return _price_ladder_impl(
        option.as_f32(), po, sim.replace(seed=0), int(strikes.shape[0]),
        method, antithetic, tile_rows, key, strikes)


def price_portfolio(options: OptionParams,
                    sim: SimParams = DEMO_SIM,
                    payoff="vanilla_call",
                    *,
                    method: Optional[str] = None,
                    antithetic: bool = False,
                    control_variate: bool = False,
                    tile_rows: int = 128,
                    stream: int = STREAM_OUTER,
                    key=None) -> PriceResult:
    """Price a whole book in one jitted program.

    ``options`` is an OptionParams whose leaves are (B,)-shaped arrays —
    B contracts (any mix of spots/strikes/vols/maturities/barriers) priced
    under common random numbers (same stream for every contract, so
    spreads and book-level Greeks are low-variance).  Because OptionParams
    leaves are traced, this is a single `jax.vmap` over the XLA engine:
    one compile for any B, and each contract's result is bit-identical to
    its standalone ``price(engine="xla")``.
    """
    po = get_payoff(payoff)
    if method is None:
        method = "terminal" if po.terminal_only else "euler"
    if po.n_state > 0 and method == "terminal":
        raise ValueError(f"{po.name} is path-dependent; method='terminal' invalid")
    if key is None:
        key = jnp.asarray(rng.derive_key(sim.seed, stream), jnp.uint32)
    opts32 = jax.tree_util.tree_map(
        lambda x: jnp.atleast_1d(jnp.asarray(x, jnp.float32)), options)
    # broadcast scalar fields (e.g. a default q) to the book size
    b = max(int(x.shape[0]) for x in jax.tree_util.tree_leaves(opts32))
    opts32 = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (b,)), opts32)

    def one(option):
        return _price_impl(option, po, sim.replace(seed=0), method, "xla",
                           antithetic, control_variate, tile_rows,
                           "threefry13", False, key, jnp.uint32(0), None)

    return jax.vmap(one)(opts32)
