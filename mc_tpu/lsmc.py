"""American/Bermudan option pricing by Longstaff-Schwartz regression.

Beyond the reference (European/bullet only): the NMC surface estimates
conditional values by brute inner simulation (nmc.py); LSMC gets the same
continuation values by cross-sectional regression over the already-
materialized trajectory grid — thousands of times cheaper, and the one
component of the framework built on matrix products: the per-step normal
equations ``(X^T W X) beta = X^T W y`` are batched matmuls over the
(paths, basis) design matrix.

Algorithm (Longstaff & Schwartz 2001):
  1. simulate + materialize the (S_t, state_t) grid (the C9 kernel);
  2. at maturity, V = payoff(S_T);
  3. backward over exercise dates: discount V one step; regress it on a
     polynomial basis of S_t over in-the-money paths; exercise where the
     immediate value beats the fitted continuation;
  4. price = discounted mean of the resulting cashflows.

Any registry payoff works: the immediate exercise value at step t is
``payoff.terminal(state_t, S_t, p)`` using the stored path state, so
American Asian or barrier-window contracts price the same way.

Validated against a CRR binomial-tree oracle (`binomial_american`, host
numpy) — the American analogue of the Black-Scholes check.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from mc_tpu import rng
from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.engines import STREAM_OUTER, _payoff_namespace
from mc_tpu.oracle import PriceResult
from mc_tpu.ops import path_kernels as pk
from mc_tpu.ops._pallas import LANES, resolve_engine
from mc_tpu.ops.payoffs import get_payoff

__all__ = ["price_american", "american_greeks", "american_bounds_family",
           "american_exposure_family",
           "price_american_heston",
           "price_american_basket", "price_american_rainbow",
           "price_american_vasicek",
           "price_american_localvol", "american_bounds",
           "binomial_american"]


def _basis(s_norm, degree: int):
    """Centered monomial basis in x = s/K - 1: (paths, degree+1).

    Centering keeps the f32 normal equations well-conditioned (raw s/K
    powers square the condition number badly enough that the fitted
    continuation policy visibly degrades); a ridge epsilon covers the
    rest.
    """
    x = s_norm - 1.0
    cols = [jnp.ones_like(x)]
    p = x
    for _ in range(degree):
        cols.append(p)
        p = p * x
    return jnp.stack(cols, axis=-1)


def _flat_grids(payoff, cfg, params, key, sim):
    """The GBM exercise grids, from `price_nmc`'s trajectory engine for the
    platform (the Triton kernel on a GPU, XLA elsewhere)."""
    s_grid, c_grid, _, _ = pk.trajectories(payoff, cfg, key, params,
                                           resolve_engine(None))
    n_pad = s_grid.shape[1] * LANES
    return (s_grid.reshape(sim.n_steps, n_pad),
            c_grid.reshape(sim.n_steps, n_pad), n_pad)


def _summ(v, valid, n_paths):
    n = jnp.float32(n_paths)
    v = jnp.where(valid, v, 0.0)
    mean = jnp.sum(v) / n
    var = jnp.sum(jnp.where(valid, (v - mean) ** 2, 0.0)) / jnp.maximum(
        n - 1.0, 1.0)
    return PriceResult(price=mean, stderr=jnp.sqrt(var / n), n_paths=n,
                       payoff_mean=mean, payoff_var=var)


def _backward_fit(payoff, p, s_flat, c_flat, valid, n_steps, degree,
                  inv_k, disc, immediate, every=1, reduce_fn=None,
                  design_fn=None, n_basis=None, disc_fn=None):
    """One-pass backward induction: returns (in-sample cashflows v at
    date 0 pre-discount, per-date continuation betas (n_steps-1, B)).

    ``every``: exercise allowed only at grid dates t with (t+1) % every
    == 0 plus maturity — a Bermudan schedule decoupled from the
    simulation grid (every=1: every date, the American limit).
    ``reduce_fn``: optional cross-chip reduction applied to the gram
    sums (lax.psum over the mesh axis in the sharded engine) — the ONE
    difference between single-chip and distributed LSMC.
    ``disc_fn(t)``: discount from date t+1 back to t — scalar by default;
    the stochastic-rate engine passes per-path exp(-(y_{t+1}-y_t)).
    """
    if reduce_fn is None:
        reduce_fn = lambda x: x
    if design_fn is None:
        design_fn = lambda t: _basis(s_flat[t] * inv_k, degree)
    if n_basis is None:
        n_basis = degree + 1
    if disc_fn is None:
        disc_fn = lambda t: disc
    v = immediate(s_flat, c_flat, n_steps - 1)
    betas0 = jnp.zeros((max(n_steps - 1, 1), n_basis), jnp.float32)

    def step_back(j, carry):
        # j runs n_steps-2 .. 0 backward over grid dates.
        v, betas = carry
        t = n_steps - 2 - j
        v = v * disc_fn(t)

        def fit_and_exercise(v):
            ex = immediate(s_flat, c_flat, t)
            itm = jnp.logical_and(ex > 0.0, valid)
            w = itm.astype(jnp.float32)
            x = design_fn(t)                           # (P, B)
            xw = x * w[:, None]
            # Normal equations in full float32 (no TF32); ridge eps for
            # conditioning.
            xtx = reduce_fn(
                jnp.dot(xw.T, x, preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST))
            xty = reduce_fn(
                jnp.dot(xw.T, v, preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST))
            eye = jnp.eye(n_basis, dtype=jnp.float32)
            beta = jnp.linalg.solve(xtx + 1e-4 * eye, xty)
            cont = jnp.dot(x, beta, preferred_element_type=jnp.float32,
                           precision=jax.lax.Precision.HIGHEST)
            exercise = jnp.logical_and(itm, ex > cont)
            return jnp.where(exercise, ex, v), beta

        # non-exercise dates: skip the regression entirely (itm would be
        # identically False — the matmuls and solve would compute beta=0)
        v, beta = jax.lax.cond(
            ((t + 1) % every) == 0, fit_and_exercise,
            lambda v: (v, jnp.zeros((n_basis,), jnp.float32)), v)
        return (v, betas.at[t].set(beta))

    return jax.lax.fori_loop(0, n_steps - 1, step_back, (v, betas0))


def _apply_policy_pass(payoff, p, s_b, c_b, valid_b, betas, n_steps,
                       degree, inv_k, disc, immediate, every=1,
                       design_fn=None, disc_fn=None):
    """Forward application of a FROZEN policy (betas) to a path set."""
    if design_fn is None:
        design_fn = lambda t: _basis(s_b[t] * inv_k, degree)
    if disc_fn is None:
        disc_fn = lambda t: disc
    vb = immediate(s_b, c_b, n_steps - 1)

    def apply_policy(j, vb):
        t = n_steps - 2 - j
        vb = vb * disc_fn(t)
        ex = immediate(s_b, c_b, t)
        is_ex_date = ((t + 1) % every) == 0
        itm = jnp.logical_and(jnp.logical_and(ex > 0.0, valid_b),
                              is_ex_date)
        x = design_fn(t)
        cont = jnp.dot(x, betas[t], preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
        return jnp.where(jnp.logical_and(itm, ex > cont), ex, vb)

    return jax.lax.fori_loop(0, n_steps - 1, apply_policy, vb)


@functools.partial(
    jax.jit,
    static_argnames=("payoff", "sim", "degree", "tile_rows", "two_pass",
                     "every"))
def _price_american_impl(option, payoff, sim, degree, tile_rows, two_pass,
                         key, key_b, every=1):
    p = _payoff_namespace(option, sim.n_steps)
    cfg = pk.KernelConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                          tile_rows=tile_rows)
    params = pk.pack_params(option, sim.n_steps)
    s_flat, c_flat, n_pad = _flat_grids(payoff, cfg, params, key, sim)
    valid = (jnp.arange(n_pad, dtype=jnp.uint32)
             < jnp.uint32(sim.n_paths))

    disc = jnp.exp(-p.r * p.dt)
    inv_k = 1.0 / p.k

    def immediate(s_f, c_f, j):
        st = (c_f[j],) if payoff.n_state else ()
        return payoff.terminal(st, s_f[j], p)

    # --- regression pass: backward induction, refitting beta per date ---
    v, betas = _backward_fit(payoff, p, s_flat, c_flat, valid,
                             sim.n_steps, degree, inv_k, disc, immediate,
                             every)
    if not two_pass:
        return _summ(v * disc, valid, sim.n_paths)

    # --- pricing pass: INDEPENDENT paths, the frozen policy (betas) ---
    # Regression foresight bias is gone: the exercise rule never sees the
    # paths it prices, so the estimator is low-biased (a valid lower
    # bound up to MC noise) instead of in-sample high-biased.
    s_b, c_b, n_pad_b = _flat_grids(payoff, cfg, params, key_b, sim)
    valid_b = (jnp.arange(n_pad_b, dtype=jnp.uint32)
               < jnp.uint32(sim.n_paths))
    vb = _apply_policy_pass(payoff, p, s_b, c_b, valid_b, betas,
                            sim.n_steps, degree, inv_k, disc, immediate,
                            every)
    return _summ(vb * disc, valid_b, sim.n_paths)


def price_american(option: OptionParams = DEMO_OPTION,
                   sim: SimParams = DEMO_SIM,
                   payoff="vanilla_put",
                   *,
                   degree: int = 3,
                   two_pass: bool = True,
                   exercise_every: int = 1,
                   tile_rows: int = 8,
                   stream: int = STREAM_OUTER,
                   key=None) -> PriceResult:
    """Longstaff-Schwartz price (Bermudan/American).

    ``exercise_every=k`` restricts exercise to every k-th simulation date
    (+ maturity): a Bermudan schedule on a fine simulation grid.  The
    default 1 exercises at every date (the American limit).

    ``two_pass=True`` (default, Longstaff & Schwartz's own protocol): the
    regression is fitted on one path set and the resulting exercise
    policy priced on an INDEPENDENT second set (stream tag 0x25A55), so
    the in-sample foresight bias of naive one-pass LSMC is removed and
    the estimate is a clean lower bound up to MC noise.
    ``two_pass=False`` gives the one-pass (high-biased) estimator; the
    spread between the two brackets the regression error.
    """
    po = get_payoff(payoff)
    if po.n_state > 1:
        raise ValueError("LSMC supports payoffs with at most one state "
                         "array")
    if key is None:
        key = jnp.asarray(rng.derive_key(sim.seed, stream), jnp.uint32)
    # pricing-pass key folded from the ACTUAL regression key so explicit
    # keys keep the two passes independent (fold_key == derive_key chain)
    if exercise_every < 1:
        raise ValueError("exercise_every must be >= 1")
    key_b = jnp.stack(rng.fold_key(key[0], key[1], 0x25A55))
    return _price_american_impl(option.as_f32(), po, sim.replace(seed=0),
                                degree, tile_rows, two_pass,
                                key, key_b, exercise_every)


@functools.partial(
    jax.jit,
    static_argnames=("fam", "payoff", "sim", "degree", "tile_rows",
                     "two_pass", "every"))
def _price_american_family_impl(fam, option, dyn, payoff, sim, degree,
                                tile_rows, two_pass, key, key_b,
                                every=1):
    """Generic Longstaff-Schwartz client over the `nmc_engine.NMCFamily`
    protocol: the family supplies its trajectory grids, continuation
    basis (`lsmc_design`) and discounting (`lsmc_discount`); the
    backward induction, two-pass protocol, and summarization are shared.
    """
    params = fam.pack(option, dyn, sim.n_steps)
    p = fam.unpack(params)
    cfg = pk.KernelConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                          tile_rows=tile_rows)

    def grids(k):
        *gs, _, _ = fam.trajectories(payoff, cfg, k, params)
        n_pad = gs[0].shape[1] * LANES
        return (tuple(g.reshape(sim.n_steps, n_pad) for g in gs), n_pad)

    gs_a, n_pad = grids(key)
    valid = (jnp.arange(n_pad, dtype=jnp.uint32)
             < jnp.uint32(sim.n_paths))
    inv_k = 1.0 / p.k

    def immediate(s_f, c_f, j):
        st = (c_f[j],) if payoff.n_state else ()
        return payoff.terminal(st, s_f[j], p)

    design_fn, n_basis = fam.lsmc_design(p, gs_a, degree, inv_k)
    disc, disc_fn, disc0 = fam.lsmc_discount(p, gs_a)
    v_val, betas = _backward_fit(
        payoff, p, fam.lsmc_level(p, gs_a), gs_a[-1], valid,
        sim.n_steps, degree, inv_k, disc, immediate, every,
        design_fn=design_fn, n_basis=n_basis, disc_fn=disc_fn)
    if not two_pass:
        return _summ(v_val * disc0, valid, sim.n_paths)

    gs_b, n_pad_b = grids(key_b)
    valid_b = (jnp.arange(n_pad_b, dtype=jnp.uint32)
               < jnp.uint32(sim.n_paths))
    design_fn_b, _ = fam.lsmc_design(p, gs_b, degree, inv_k)
    disc_b, disc_fn_b, disc0_b = fam.lsmc_discount(p, gs_b)
    vb = _apply_policy_pass(
        payoff, p, fam.lsmc_level(p, gs_b), gs_b[-1], valid_b, betas,
        sim.n_steps, degree, inv_k, disc_b, immediate, every,
        design_fn=design_fn_b, disc_fn=disc_fn_b)
    return _summ(vb * disc0_b, valid_b, sim.n_paths)


def price_american_family(fam, option, dyn,
                          sim: SimParams = DEMO_SIM,
                          payoff="vanilla_put",
                          *,
                          degree: int = 3,
                          two_pass: bool = True,
                          exercise_every: int = 1,
                          tile_rows: int = 8,
                          stream: int = STREAM_OUTER,
                          key=None) -> PriceResult:
    """Shared LSMC entry point over a model family: validation + keys."""
    po = get_payoff(payoff) if isinstance(payoff, str) else payoff
    if po.n_state > 1:
        raise ValueError("LSMC supports payoffs with at most one state "
                         "array")
    if fam.even_steps and sim.n_steps % 2:
        raise ValueError(f"{fam.name} requires an even n_steps")
    if exercise_every < 1:
        raise ValueError("exercise_every must be >= 1")
    if key is None:
        key = jnp.asarray(rng.derive_key(sim.seed, stream, fam.tag),
                          jnp.uint32)
    key_b = jnp.stack(rng.fold_key(key[0], key[1], 0x25A55))
    return _price_american_family_impl(fam, option.as_f32(), dyn, po,
                                       sim.replace(seed=0), degree,
                                       tile_rows, two_pass,
                                       key, key_b, exercise_every)


def binomial_american(s0, k, t, r, sigma, n_steps=2000, kind="put",
                      div_yield=0.0):
    """CRR binomial-tree American option price (host numpy oracle)."""
    dt = t / n_steps
    u = np.exp(sigma * np.sqrt(dt))
    d = 1.0 / u
    disc = np.exp(-r * dt)
    q = (np.exp((r - div_yield) * dt) - d) / (u - d)
    j = np.arange(n_steps + 1)
    s = s0 * u ** (n_steps - j) * d ** j
    pay = (np.maximum(k - s, 0.0) if kind == "put"
           else np.maximum(s - k, 0.0))
    v = pay
    for m in range(n_steps - 1, -1, -1):
        v = disc * (q * v[:-1] + (1 - q) * v[1:])
        s = s0 * u ** (m - np.arange(m + 1)) * d ** np.arange(m + 1)
        ex = (np.maximum(k - s, 0.0) if kind == "put"
              else np.maximum(s - k, 0.0))
        v = np.maximum(v, ex)
    return float(v[0])


# ---------------------------------------------------------------------------
# American exercise under Heston stochastic volatility: the C9 trajectory
# grid + LSMC machinery composed with the Heston model family.  The
# regression basis is augmented with the variance state (the standard
# stochastic-vol LSMC design): continuation value depends on (S_t, v_t).
# ---------------------------------------------------------------------------


def _basis_sv(s_norm, v, degree: int):
    """Monomials of x = s/K - 1 up to ``degree``, augmented with the
    variance regressors (v, v^2, v*x).  v is clipped at 0 (the stored
    full-truncation state can be negative)."""
    x = s_norm - 1.0
    cols = [jnp.ones_like(x)]
    p = x
    for _ in range(degree):
        cols.append(p)
        p = p * x
    vp = jnp.maximum(v, 0.0)
    cols += [vp, vp * vp, vp * x]
    return jnp.stack(cols, axis=-1)


def price_american_heston(option: OptionParams = DEMO_OPTION,
                          heston=None,
                          sim: SimParams = DEMO_SIM,
                          payoff="vanilla_put",
                          *,
                          degree: int = 3,
                          two_pass: bool = True,
                          exercise_every: int = 1,
                          tile_rows: int = 8,
                          stream: int = STREAM_OUTER,
                          key=None) -> PriceResult:
    """Longstaff-Schwartz American/Bermudan price under Heston.

    Composes the Heston trajectory kernel (full-truncation Euler,
    materialized (S_t, v_t) grids) with the LSMC backward induction; the
    continuation regression runs on the (S, v) basis.  Same two-pass
    protocol as `price_american`.

    Oracle gates (tests): in the degenerate limit xi -> 0, v0 = theta the
    model is GBM with sigma = sqrt(v0) and the price must match the CRR
    binomial American; in the general model the price must dominate the
    European CF price with a positive early-exercise premium.
    """
    from mc_tpu.models.heston import DEMO_HESTON
    from mc_tpu.nmc_heston import HestonNMC
    heston = DEMO_HESTON if heston is None else heston
    return price_american_family(HestonNMC(), option, heston.as_f32(),
                                 sim, payoff, degree=degree,
                                 two_pass=two_pass,
                                 exercise_every=exercise_every,
                                 tile_rows=tile_rows, stream=stream,
                                 key=key)


def price_american_merton(option: OptionParams = DEMO_OPTION,
                          merton=None,
                          sim: SimParams = DEMO_SIM,
                          payoff="vanilla_put",
                          *,
                          degree: int = 3,
                          two_pass: bool = True,
                          exercise_every: int = 1,
                          tile_rows: int = 8,
                          stream: int = STREAM_OUTER,
                          key=None) -> PriceResult:
    """Longstaff-Schwartz American/Bermudan price under Merton jumps.

    Composes the Merton trajectory kernel (exact-in-law compound-Poisson
    log increments, materialized S_t grids) with the LSMC backward
    induction on the standard S-monomial basis (the jump-diffusion is
    Markov in S).  Same two-pass protocol as `price_american`.

    Oracle gates (tests): lam -> 0 degenerates to GBM and must match the
    CRR binomial American; downward jumps (mu_j < 0) must RAISE the
    American put above its no-jump value; American >= European (series
    oracle via put-call parity).
    """
    from mc_tpu.models.merton import DEMO_MERTON, poisson_kmax
    from mc_tpu.nmc_merton import MertonNMC
    merton = DEMO_MERTON if merton is None else merton
    # The jump state is Markov in S alone (i.i.d. increments), so the
    # default S-monomial basis applies unchanged — only the trajectory
    # law differs.
    kmax = poisson_kmax(float(merton.lam) * float(option.t) / sim.n_steps)
    return price_american_family(MertonNMC(extras=(kmax,)), option,
                                 merton.as_f32(), sim, payoff,
                                 degree=degree, two_pass=two_pass,
                                 exercise_every=exercise_every,
                                 tile_rows=tile_rows, stream=stream,
                                 key=key)


def _basis_sr(s_norm, x_r, degree: int):
    """Monomials of x = s/K - 1 up to ``degree``, augmented with the
    short-rate regressors (x_r, x_r^2, x_r*x).  x_r = r - b is NOT
    clipped — rates legitimately go below their long-run level (and can
    go negative)."""
    x = s_norm - 1.0
    cols = [jnp.ones_like(x)]
    p = x
    for _ in range(degree):
        cols.append(p)
        p = p * x
    cols += [x_r, x_r * x_r, x_r * x]
    return jnp.stack(cols, axis=-1)


def price_american_vasicek(option: OptionParams = DEMO_OPTION,
                           dyn=None,
                           sim: SimParams = DEMO_SIM,
                           payoff="vanilla_put",
                           *,
                           degree: int = 3,
                           two_pass: bool = True,
                           exercise_every: int = 1,
                           tile_rows: int = 8,
                           stream: int = STREAM_OUTER,
                           key=None) -> PriceResult:
    """Longstaff-Schwartz American/Bermudan price under STOCHASTIC rates.

    Composes the Vasicek trajectory kernel (exact-in-law hybrid steps,
    materialized (S, r, int r) grids) with the LSMC backward induction:
    the continuation regression runs on the (S, r) basis and cashflows
    discount PATHWISE along each path's own rate — both the exercise
    decision and the value see the stochastic discounting.  Same
    two-pass protocol as `price_american`.

    Oracle gates (tests): sigma_r -> 0, b = r0 degenerates to constant
    rates and must match the CRR binomial American; in the general model
    the price dominates the European put (parity closed form from
    oracle.bsv_call) by a positive early-exercise premium.
    """
    from mc_tpu.models.vasicek import DEMO_VASICEK
    from mc_tpu.nmc_vasicek import VasicekNMC
    dyn = DEMO_VASICEK if dyn is None else dyn
    return price_american_family(VasicekNMC(), option, dyn.as_f32(), sim,
                                 payoff, degree=degree, two_pass=two_pass,
                                 exercise_every=exercise_every,
                                 tile_rows=tile_rows, stream=stream,
                                 key=key)


def price_american_localvol(option: OptionParams = DEMO_OPTION,
                            surf=None,
                            sim: SimParams = DEMO_SIM,
                            payoff="vanilla_put",
                            *,
                            degree: int = 3,
                            two_pass: bool = True,
                            exercise_every: int = 1,
                            tile_rows: int = 8,
                            stream: int = STREAM_OUTER,
                            key=None
                            ) -> PriceResult:
    """Longstaff-Schwartz American/Bermudan price under a LOCAL-VOL
    surface sigma(S, t).

    Composes the local-vol trajectory kernel (gather-free clamped-ramp
    interpolation, materialized S_t grids) with the LSMC backward
    induction on the S-monomial basis (local vol is Markov in S).  Same
    two-pass protocol as `price_american`.

    Oracle gates (tests): a FLAT surface is exact GBM and must match the
    CRR binomial American; a skewed surface (more vol below spot) must
    RAISE the American put above its flat-ATM-vol value.
    """
    from mc_tpu.models.localvol import LocalVolSurface, validate_surface
    from mc_tpu.nmc_localvol import LocalVolNMC
    if surf is None:
        surf = LocalVolSurface.demo(sim.n_steps)
    s32 = validate_surface(surf, sim.n_steps)
    # Local vol is Markov in S, so the default S-monomial basis applies —
    # only the trajectory law (the surface) differs from the GBM engine.
    return price_american_family(LocalVolNMC(extras=(s32.n_knots,)),
                                 option, s32, sim, payoff, degree=degree,
                                 two_pass=two_pass,
                                 exercise_every=exercise_every,
                                 tile_rows=tile_rows, stream=stream,
                                 key=key)


# ---------------------------------------------------------------------------
# Andersen-Broadie duality: an UPPER bound to pair with the two-pass LSMC
# lower bound, so the American price is bracketed with statistical error
# bars on both sides (Haugh-Kogan/Rogers duality: for ANY martingale M,
# V_0 <= E[max_t (h_t - M_t)]; AB builds M from the LSMC policy's value
# process, estimated by nested one-step sub-simulations).
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("payoff", "sim", "degree", "tile_rows", "n_outer",
                     "n_inner", "every"))
def _ab_upper_impl(option, payoff, sim, degree, tile_rows, n_outer,
                   n_inner, key_fit, key_outer, key_inner,
                   every=1):
    p = _payoff_namespace(option, sim.n_steps)
    n = sim.n_steps
    disc = jnp.exp(-p.r * p.dt)
    inv_k = 1.0 / p.k
    params = pk.pack_params(option, sim.n_steps)

    def immediate(s_f, c_f, j):
        return payoff.terminal((), s_f[j], p)

    # 1) the SAME policy the lower bound prices (fit on set A)
    cfg_a = pk.KernelConfig(n_paths=sim.n_paths, n_steps=n,
                            tile_rows=tile_rows)
    s_a, c_a, n_pad_a = _flat_grids(payoff, cfg_a, params, key_fit, sim)
    valid_a = (jnp.arange(n_pad_a, dtype=jnp.uint32)
               < jnp.uint32(sim.n_paths))
    _, betas = _backward_fit(payoff, p, s_a, c_a, valid_a, n, degree,
                             inv_k, disc, immediate, every)

    # 2) independent outer set B
    cfg_b = pk.KernelConfig(n_paths=n_outer, n_steps=n,
                            tile_rows=tile_rows)
    s_b, c_b, n_pad_b = _flat_grids(payoff, cfg_b, params, key_outer, sim)
    valid_b = (jnp.arange(n_pad_b, dtype=jnp.uint32)
               < jnp.uint32(n_outer))
    ids_b = jnp.arange(n_pad_b, dtype=jnp.uint32)
    ki0 = jnp.asarray(key_inner[0], jnp.uint32)
    ki1 = jnp.asarray(key_inner[1], jnp.uint32)
    jn = jnp.float32(n_inner)

    def draw(branch, u):
        # inner normal for (outer path, branch, step u): counter
        # branch*n + u with branch < 4*n*n_inner (rollout + transition
        # blocks) — the public wrapper guards 4*n^2*n_inner < 2^32
        c1 = (jnp.asarray(branch, jnp.uint32) * jnp.uint32(n)
              + jnp.asarray(u, jnp.uint32))
        z, _ = rng.normal_pair(ki0, ki1, ids_b,
                               jnp.full(ids_b.shape, 0, jnp.uint32) + c1)
        return z

    def rollout(t, s_t, branch):
        """Discounted-to-0 value of following the policy from date t."""
        def body(u, carry):
            s, done, val = carry
            ex = payoff.terminal((), s, p)
            x = _basis(s * inv_k, degree)
            cont = jnp.dot(x, betas[u],
                           preferred_element_type=jnp.float32,
                           precision=jax.lax.Precision.HIGHEST)
            is_ex_date = ((u + 1) % every) == 0
            trig = jnp.logical_and(
                jnp.logical_and(jnp.logical_and(ex > 0.0, ex > cont),
                                jnp.logical_not(done)), is_ex_date)
            val = jnp.where(trig,
                            ex * disc ** (jnp.float32(u) + 1.0), val)
            done = jnp.logical_or(done, trig)
            s = s * jnp.exp(p.drift_dt + p.vol_dt * draw(branch, u))
            return (s, done, val)

        s, done, val = jax.lax.fori_loop(
            t, n - 1, body,
            (s_t, jnp.zeros_like(s_t, bool), jnp.zeros_like(s_t)))
        ex = payoff.terminal((), s, p)
        return jnp.where(done, val, ex * disc ** jnp.float32(n))

    two_j_total = n * 2 * n_inner  # transition branches live past these
    # maturity is ALWAYS an exercise date; when n is not divisible by
    # `every` its distance to the previous exercise date is shorter
    gap_mat = n - every * ((n - 1) // every)

    def date_step(carry, t):
        m, run_max = carry
        base = t * (2 * n_inner)
        is_ex_date = jnp.logical_or(((t + 1) % every) == 0, t == n - 1)
        gap = jnp.where(t == n - 1, jnp.int32(gap_mat), jnp.int32(every))

        def delta_fn(_):
            # policy value from the realized state: n_inner fresh
            # rollouts (a single rollout would inject a random walk into
            # M whose running max inflates the bound far past the value)
            def here_j(j, acc):
                return acc + rollout(t, s_b[t], base + j)

            l_here = jax.lax.fori_loop(0, n_inner, here_j,
                                       jnp.zeros_like(s_b[0])) / jn

            # The conditioning point is the PREVIOUS EXERCISE DATE (one
            # sim step back only when every == 1): conditioning on t-1
            # would leave the value moves of the in-between steps
            # un-hedged by M and blow the bound wide open.
            prev_idx = t - gap
            prev_s = jnp.where(
                prev_idx >= 0,
                s_b[jnp.maximum(prev_idx, 0)],
                jnp.full_like(s_b[0], p.s0))

            def inner_j(j, acc):
                branch = base + n_inner + j
                branch_tr = two_j_total + branch

                def tr_step(k, s):
                    z = draw(branch_tr, k)
                    return s * jnp.exp(p.drift_dt + p.vol_dt * z)

                # `gap` fresh transition steps prev-ex-date -> date t
                s_t = jax.lax.fori_loop(0, gap, tr_step, prev_s)
                return acc + rollout(t, s_t, branch)

            e_t = jax.lax.fori_loop(0, n_inner, inner_j,
                                    jnp.zeros_like(l_here)) / jn
            return l_here - e_t

        # non-exercise dates contribute nothing: skip their 2J rollouts
        m = m + jax.lax.cond(jnp.logical_and(is_ex_date, t >= 1),
                             delta_fn,
                             lambda _: jnp.zeros_like(m), 0)
        hd = immediate(s_b, c_b, t) * disc ** (jnp.float32(t) + 1.0)
        run_max = jnp.maximum(run_max,
                              jnp.where(is_ex_date, hd - m, -1e30))
        return (m, run_max), None

    zeros = jnp.zeros((n_pad_b,), jnp.float32)
    (m, run_max), _ = jax.lax.scan(date_step,
                                   (zeros, jnp.full_like(zeros, -1e30)),
                                   jnp.arange(n, dtype=jnp.int32))
    u = jnp.where(valid_b, run_max, 0.0)
    nn = jnp.float32(n_outer)
    mean = jnp.sum(u) / nn
    var = jnp.sum(jnp.where(valid_b, (u - mean) ** 2, 0.0)) / jnp.maximum(
        nn - 1.0, 1.0)
    return PriceResult(price=mean, stderr=jnp.sqrt(var / nn), n_paths=nn,
                       payoff_mean=mean, payoff_var=var)


def american_bounds(option: OptionParams = DEMO_OPTION,
                    sim: SimParams = DEMO_SIM,
                    payoff="vanilla_put",
                    *,
                    heston=None,
                    degree: int = 3,
                    n_outer: int = 4096,
                    n_inner: int = 128,
                    exercise_every: int = 1,
                    tile_rows: int = 8,
                    stream: int = STREAM_OUTER):
    """(lower, upper) bracketing the American price with error bars.

    lower: the two-pass LSMC estimate (valid lower bound up to MC noise).
    upper: Andersen-Broadie duality bound built from the SAME fitted
    policy — the value-process martingale is estimated on an independent
    outer set with ``n_inner`` one-step nested sub-simulations per date.
    Any noise in the nested estimates only LOOSENS the upper bound; the
    bracket [lower - 3se, upper + 3se] is a conservative confidence
    interval for the true Bermudan price.  Terminal payoffs only (the
    classic AB setting).

    Tightness scales like sqrt(n_steps / n_inner): with exercise at
    every grid date the martingale accumulates nested-estimate noise per
    date, so use a coarse exercise grid (n_steps ~ 10-20) or raise
    n_inner (measured: N=10/J=128 gives a ~0.07 gap on the reference
    put; N=50 needs J in the thousands for the same).

    Returns (lower: PriceResult, upper: PriceResult).
    """
    po = get_payoff(payoff)
    if po.n_state != 0:
        raise ValueError("american_bounds supports terminal payoffs "
                         "(n_state == 0); path-state rollout resume is "
                         "not implemented")
    if exercise_every < 1:
        raise ValueError("exercise_every must be >= 1")
    span = 4 * sim.n_steps * sim.n_steps * n_inner
    if span >= 1 << 32:
        raise ValueError(
            "inner RNG counter space exhausted: 4 * n_steps^2 * n_inner "
            f"= {span} >= 2^32; reduce n_steps or n_inner")
    if heston is not None:
        # stochastic-vol bracket — the generic family dual (verified
        # bitwise-identical to the retired dedicated Heston impl)
        return american_bounds_family(
            "heston", option, heston, sim, payoff, degree=degree,
            n_outer=n_outer, n_inner=n_inner,
            exercise_every=exercise_every, tile_rows=tile_rows,
            stream=stream)
    lower = price_american(option, sim, payoff, degree=degree,
                           tile_rows=tile_rows, stream=stream,
                           two_pass=True,
                           exercise_every=exercise_every)
    key_fit = jnp.asarray(rng.derive_key(sim.seed, stream), jnp.uint32)
    key_outer = jnp.asarray(rng.derive_key(sim.seed, stream, 0xAB01),
                            jnp.uint32)
    key_inner = jnp.asarray(rng.derive_key(sim.seed, stream, 0xAB02),
                            jnp.uint32)
    upper = _ab_upper_impl(option.as_f32(), po, sim.replace(seed=0),
                           degree, tile_rows, n_outer, n_inner, key_fit,
                           key_outer, key_inner, exercise_every)
    return lower, upper


# ---------------------------------------------------------------------------
# American exercise on a correlated basket: the basket trajectory kernel
# composed with the shared LSMC machinery (regression on the basket level).
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("payoff", "sim", "d", "degree", "tile_rows",
                     "two_pass", "every"))
def _price_american_basket_impl(option, basket, payoff, sim, d, degree,
                                tile_rows, two_pass, key, key_b,
                                every=1):
    from mc_tpu.models.basket import (_basket_namespace, _pack_basket,
                                      basket_trajectories)
    ns = _basket_namespace(option, basket, sim.n_steps)
    params = _pack_basket(ns, d)
    cfg = pk.KernelConfig(n_paths=sim.n_paths, n_steps=sim.n_steps,
                          tile_rows=tile_rows)
    disc = jnp.exp(-ns.r * ns.dt)
    inv_k = 1.0 / ns.k

    def grids(k):
        b_g, c_g, _, _ = basket_trajectories(payoff, cfg, d, k, params)
        n_pad = b_g.shape[1] * LANES
        return (b_g.reshape(sim.n_steps, n_pad),
                c_g.reshape(sim.n_steps, n_pad), n_pad)

    b_a, c_a, n_pad = grids(key)
    valid = (jnp.arange(n_pad, dtype=jnp.uint32)
             < jnp.uint32(sim.n_paths))

    def immediate(b_f, c_f, j):
        st = (c_f[j],) if payoff.n_state else ()
        return payoff.terminal(st, b_f[j], ns)

    v, betas = _backward_fit(payoff, ns, b_a, c_a, valid, sim.n_steps,
                             degree, inv_k, disc, immediate, every)
    if not two_pass:
        return _summ(v * disc, valid, sim.n_paths)

    b_b, c_b, n_pad_b = grids(key_b)
    valid_b = (jnp.arange(n_pad_b, dtype=jnp.uint32)
               < jnp.uint32(sim.n_paths))
    vb = _apply_policy_pass(payoff, ns, b_b, c_b, valid_b, betas,
                            sim.n_steps, degree, inv_k, disc, immediate,
                            every)
    return _summ(vb * disc, valid_b, sim.n_paths)


def price_american_basket(option: OptionParams = DEMO_OPTION,
                          basket=None,
                          sim: SimParams = DEMO_SIM,
                          payoff="vanilla_put",
                          *,
                          degree: int = 3,
                          two_pass: bool = True,
                          exercise_every: int = 1,
                          tile_rows: int = 8,
                          stream: int = STREAM_OUTER,
                          key=None) -> PriceResult:
    """Longstaff-Schwartz American/Bermudan option on a correlated
    basket: exercise decisions regress on the BASKET level (the standard
    1-D design — the basket value is the payoff's only state variable).

    Oracle gate (tests): with d=1 the basket collapses to a single GBM
    asset, so the price must match the CRR binomial American for
    sigma = sigmas[0].
    """
    from mc_tpu.models.basket import DEMO_BASKET
    basket = DEMO_BASKET if basket is None else basket
    po = get_payoff(payoff)
    if po.n_state > 1:
        raise ValueError("LSMC supports payoffs with at most one state "
                         "array")
    if exercise_every < 1:
        raise ValueError("exercise_every must be >= 1")
    if key is None:
        key = jnp.asarray(rng.derive_key(sim.seed, stream, 0xBA5C),
                          jnp.uint32)
    key_b = jnp.stack(rng.fold_key(key[0], key[1], 0x25A55))
    return _price_american_basket_impl(option.as_f32(), basket.as_f32(),
                                       po, sim.replace(seed=0), basket.d,
                                       degree, tile_rows, two_pass, key,
                                       key_b,
                                       exercise_every)


def price_american_rainbow(option: OptionParams = DEMO_OPTION,
                           basket=None,
                           sim: SimParams = DEMO_SIM,
                           payoff="put_on_min",
                           *,
                           degree: int = 3,
                           two_pass: bool = True,
                           exercise_every: int = 1,
                           tile_rows: int = 8,
                           stream: int = STREAM_OUTER,
                           key=None) -> PriceResult:
    """Longstaff-Schwartz American/Bermudan rainbow option: early
    exercise of best-of / worst-of contracts on d correlated assets.

    The exercise level is the order statistic (``put_on_min`` =
    vanilla_put on ``min_i S_i`` etc., `nmc_rainbow.RAINBOW_NMC_PAYOFFS`)
    while the continuation value regresses on the PER-ASSET cross basis
    (`nmc_basket.BasketNMC.lsmc_design`) — the standard multi-asset
    LSMC design: the folded level alone is not a sufficient statistic
    for the continuation value.

    Gates (tests): the American call-on-max without dividends equals
    the European Stulz value (early exercise never optimal on a
    non-dividend best-of call); the American put-on-min carries a
    positive early-exercise premium over `oracle.stulz_min_put`; d=1
    collapses to the CRR binomial American.
    """
    from mc_tpu.models.basket import DEMO_BASKET
    from mc_tpu.nmc_rainbow import RAINBOW_NMC_PAYOFFS, RainbowNMC
    basket = DEMO_BASKET if basket is None else basket
    agg, po = RAINBOW_NMC_PAYOFFS.get(payoff, ("max", payoff))
    b32 = basket.as_f32()
    return price_american_family(RainbowNMC(extras=(b32.d, agg)),
                                 option, b32, sim, po, degree=degree,
                                 two_pass=two_pass,
                                 exercise_every=exercise_every,
                                 tile_rows=tile_rows, stream=stream,
                                 key=key)


# ---------------------------------------------------------------------------
# American Greeks: frozen-exercise-policy pathwise differentiation
# (round 3).  Fit the LSMC policy on one path set, FREEZE it, and
# differentiate the frozen-policy value on an independent set — the
# standard two-pass construction: at the fitted boundary the exercise
# value equals the continuation value, so the policy's own derivative
# contributes nothing to first order, and the pathwise derivative
# through max/where (which never differentiates the exercise indicator)
# is a consistent estimator of the American delta/vega.
# ---------------------------------------------------------------------------


def _diff_gbm_grids(payoff, p, n_steps, n_pad, k0, k1, s0, sigma, r, q, t):
    """Differentiable GBM trajectory grids (pure jnp, one normal per
    step — an independent pricing stream; no kernel-parity contract)."""
    ids = jnp.arange(n_pad, dtype=jnp.uint32)
    dt = t / n_steps
    drift_dt = (r - q - 0.5 * sigma * sigma) * dt
    vol_dt = sigma * jnp.sqrt(dt)
    s0v = jnp.full((n_pad,), 1.0, jnp.float32) * s0
    state0 = payoff.init(p, jnp.zeros((n_pad,), jnp.float32))

    def step(carry, m):
        w, state = carry
        z, _ = rng.normal_pair(k0, k1, ids,
                               jnp.full((n_pad,), 0, jnp.uint32) + m)
        w = w + drift_dt + vol_dt * z
        s = s0v * jnp.exp(w)
        state = payoff.update(state, s, p)
        cv = state[0] if payoff.n_state else jnp.zeros_like(s)
        return (w, state), (s, cv)

    (_, _), (s_hist, c_hist) = jax.lax.scan(
        step, (jnp.zeros((n_pad,), jnp.float32), state0),
        jnp.arange(n_steps, dtype=jnp.uint32))
    return s_hist, c_hist


@functools.partial(
    jax.jit,
    static_argnames=("payoff", "sim", "fam", "degree", "every"))
def _american_greeks_impl(option, dyn, payoff, sim, fam, degree, every,
                          key, key_b):
    """fam=None: differentiable GBM grids.  fam=NMCFamily instance: the
    family's `xla_outer` simulation + its `lsmc_design`/`lsmc_discount`
    hooks — one construction covers every model family."""
    n_pad = -(-sim.n_paths // LANES) * LANES
    valid = jnp.arange(n_pad, dtype=jnp.uint32) < jnp.uint32(sim.n_paths)
    n = sim.n_steps
    ka0, ka1 = (jnp.asarray(key[i], jnp.uint32) for i in (0, 1))
    kb0, kb1 = (jnp.asarray(key_b[i], jnp.uint32) for i in (0, 1))
    t = jnp.float32(option.t)
    r = jnp.float32(option.r)
    q = jnp.float32(option.q)

    if fam is not None:

        def simulate(s0v, sigv, k0, k1):
            # sigma drives nothing under stochastic-vol/surface families
            # (their vol state is part of the dynamics); it IS the vol
            # for families packing option.sigma (none currently do).
            opt2 = dataclasses.replace(option, s0=s0v)
            params2 = fam.pack(opt2, dyn, n)
            p2 = fam.unpack(params2)
            ctx = fam.make_ctx(params2, n)
            ids = jnp.arange(n_pad, dtype=jnp.uint32)
            s0a = jnp.full((n_pad,), 1.0, jnp.float32) * s0v
            state0 = payoff.init(p2, jnp.zeros((n_pad,), jnp.float32))
            hists, c_hist, _ = fam.xla_outer(payoff, p2, ctx, ids, k0,
                                             k1, s0a, state0, n)
            return p2, hists, c_hist

        def hooks_of(p2, hists):
            inv_k = 1.0 / p2.k
            design_fn, n_basis = fam.lsmc_design(p2, hists, degree, inv_k)
            if design_fn is None:
                design_fn = lambda tt: _basis(hists[0][tt] * inv_k, degree)
            disc, disc_fn, disc0 = fam.lsmc_discount(p2, hists)
            if disc_fn is None:
                disc_fn = lambda tt: disc
            return design_fn, n_basis, disc, disc_fn, disc0
    else:

        def simulate(s0v, sigv, k0, k1):
            p2 = _payoff_namespace(
                dataclasses.replace(option, s0=s0v, sigma=sigv), n)
            s_hist, c_hist = _diff_gbm_grids(payoff, p2, n, n_pad, k0, k1,
                                             s0v, sigv, r, q, t)
            return p2, (s_hist,), c_hist

        def hooks_of(p2, hists):
            inv_k = 1.0 / p2.k
            d = jnp.exp(-r * t / n)
            return (lambda tt: _basis(hists[0][tt] * inv_k, degree),
                    degree + 1, d, lambda tt: d, d)

    def level_of(p2, hists):
        return hists[0] if fam is None else fam.lsmc_level(p2, hists)

    def immediate_of(p2, hists, c_hist):
        lvl = level_of(p2, hists)

        def immediate(s_f, c_f, j):
            st = (c_hist[j],) if payoff.n_state else ()
            return payoff.terminal(st, lvl[j], p2)
        return immediate

    # --- pass A: fit the policy (no gradients flow) --------------------
    s0_0 = jnp.float32(option.s0)
    sig_0 = jnp.float32(option.sigma)
    p_a, hists_a, c_a = simulate(s0_0, sig_0, ka0, ka1)
    design_a, n_basis, disc_a, disc_fn_a, _ = hooks_of(p_a, hists_a)
    _, betas = _backward_fit(
        payoff, p_a, level_of(p_a, hists_a), c_a, valid, n, degree,
        1.0 / p_a.k, disc_a, immediate_of(p_a, hists_a, c_a), every,
        design_fn=design_a, n_basis=n_basis, disc_fn=disc_fn_a)
    betas = jax.lax.stop_gradient(betas)

    # --- pass B: frozen-policy value, differentiable in (s0, sigma) ----
    def value(s0v, sigv):
        p_b, hists_b, c_b = simulate(s0v, sigv, kb0, kb1)
        design_b, _, disc_b, disc_fn_b, disc0_b = hooks_of(p_b, hists_b)
        vb = _apply_policy_pass(
            payoff, p_b, level_of(p_b, hists_b), c_b, valid, betas, n,
            degree, 1.0 / p_b.k, disc_b,
            immediate_of(p_b, hists_b, c_b), every,
            design_fn=design_b, disc_fn=disc_fn_b)
        vb = jnp.where(valid, vb * disc0_b, 0.0)
        return jnp.sum(vb) / jnp.float32(sim.n_paths)

    price, (delta, vega) = jax.value_and_grad(value, argnums=(0, 1))(
        s0_0, sig_0)
    return {"price": price, "delta": delta, "vega": vega}


def american_greeks(option: OptionParams = DEMO_OPTION,
                    sim: SimParams = DEMO_SIM,
                    payoff="vanilla_put",
                    *,
                    model: str = "gbm",
                    dyn=None,
                    degree: int = 3,
                    exercise_every: int = 1,
                    stream: int = STREAM_OUTER,
                    key=None) -> dict:
    """Frozen-policy pathwise Greeks of an American/Bermudan option.

    Returns ``{"price", "delta", "vega"}`` — the price is the two-pass
    (low-biased) frozen-policy value, delta/vega its pathwise
    derivatives on the independent pricing pass.  ``model`` may be any
    NMC family with LSMC hooks ("heston", "vasicek", "cev", "sabr",
    "localvol") — the family's `xla_outer` simulation, basis, and
    discounting are reused.  Every family's vol lives in its dynamics
    object, so the flat-vol ``vega`` is ~0 there by construction (the
    vol risk sits in the dynamics parameters); it is the true BS vega
    only for model="gbm".

    Gate (tests): CRR binomial central differences on the reference put
    config agree within MC tolerance.
    """
    po = get_payoff(payoff)
    if po.n_state > 1:
        raise ValueError("LSMC supports payoffs with at most one state "
                         "array")
    if exercise_every < 1:
        raise ValueError("exercise_every must be >= 1")
    fam = None
    if model == "heston":
        from mc_tpu.models.heston import DEMO_HESTON
        from mc_tpu.nmc_heston import HestonNMC
        dyn = (DEMO_HESTON if dyn is None else dyn).as_f32()
        fam = HestonNMC()
    elif model == "vasicek":
        from mc_tpu.models.vasicek import DEMO_VASICEK
        from mc_tpu.nmc_vasicek import VasicekNMC
        dyn = (DEMO_VASICEK if dyn is None else dyn).as_f32()
        fam = VasicekNMC()
    elif model == "cev":
        from mc_tpu.models.cev import DEMO_CEV
        from mc_tpu.nmc_cev import CEVNMC
        dyn = (DEMO_CEV if dyn is None else dyn).as_f32()
        fam = CEVNMC()
    elif model == "sabr":
        from mc_tpu.models.sabr import DEMO_SABR
        from mc_tpu.nmc_sabr import SABRNMC
        dyn = (DEMO_SABR if dyn is None else dyn).as_f32()
        fam = SABRNMC()
    elif model == "localvol":
        from mc_tpu.models.localvol import LocalVolSurface, \
            validate_surface
        from mc_tpu.nmc_localvol import LocalVolNMC
        if dyn is None:
            dyn = LocalVolSurface.demo(sim.n_steps)
        dyn = validate_surface(dyn, sim.n_steps)
        fam = LocalVolNMC(extras=(dyn.n_knots,))
    elif model != "gbm":
        raise ValueError(f"unknown model {model!r} for american_greeks")
    if fam is not None and fam.even_steps and sim.n_steps % 2:
        raise ValueError(f"{fam.name} requires an even n_steps")
    tag = () if fam is None else (fam.tag,)
    if key is None:
        key = jnp.asarray(rng.derive_key(sim.seed, stream, *tag),
                          jnp.uint32)
    key_b = jnp.stack(rng.fold_key(key[0], key[1], 0x25A55))
    out = _american_greeks_impl(option.as_f32(), dyn, po,
                                sim.replace(seed=0), fam, degree,
                                exercise_every, key, key_b)
    return {k: float(v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# Generic Andersen-Broadie dual over the NMC family protocol (round 3):
# the same value-process-martingale construction as the GBM/Heston duals,
# with the family's rollout hooks supplying the physics.  Rollouts are
# fresh estimators on their own stream, so every family shares one
# uniform counter layout (see NMCFamily rollout hooks).  Scalar-discount
# families only (Vasicek's pathwise-discount dual needs different
# algebra and is not offered).
# ---------------------------------------------------------------------------


def _family_policy_tools(fam, option, dyn, payoff, sim, degree,
                         tile_rows, n_outer, key_fit, key_outer,
                         key_inner, every=1, betas=None, path_offset=0,
                         n_valid=None):
    """Shared frozen-policy machinery over the NMCFamily protocol:
    fit the LSMC policy on a pilot set (key_fit), build an independent
    outer set (key_outer), and expose policy rollouts keyed by
    (branch, date) under key_inner.  Consumed by the Andersen-Broadie
    dual and the American exposure surface — the rollout/exercise-rule
    computation is IDENTICAL in both (pure code motion from the
    dual).

    Multi-chip: pass the replicated ``betas`` (fit once, identically,
    outside the shard_map) plus this shard's global path-id range
    (``path_offset``/``n_valid``) — outer grids AND rollout streams key
    by GLOBAL id, so the sharded values are bitwise the single-chip
    ones."""
    from types import SimpleNamespace

    from mc_tpu.nmc_engine import xla_family_trajectories

    params = fam.pack(option, dyn, sim.n_steps)
    p = fam.unpack(params)
    ctx = fam.make_ctx(params, sim.n_steps)
    n = sim.n_steps
    inv_k = 1.0 / p.k

    def grids(n_paths_g, k, offset=0, bound=None):
        cfg = pk.KernelConfig(n_paths=n_paths_g, n_steps=n,
                              tile_rows=tile_rows)
        *gs, _, _ = xla_family_trajectories(fam, payoff, cfg, params, k,
                                            path_offset=offset,
                                            n_valid=bound)
        n_pad = gs[0].shape[1] * LANES
        return tuple(g.reshape(n, n_pad) for g in gs[:-1]), n_pad

    def immediate_of(gs):
        lvl = fam.lsmc_level(p, gs)
        return lambda s_f, c_f, j: payoff.terminal((), lvl[j], p)

    if betas is None:
        # 1) the policy the lower bound prices
        gs_a, n_pad_a = grids(sim.n_paths, key_fit)
        valid_a = (jnp.arange(n_pad_a, dtype=jnp.uint32)
                   < jnp.uint32(sim.n_paths))
        lvl_a = fam.lsmc_level(p, gs_a)
        design_a, n_basis = fam.lsmc_design(p, gs_a, degree, inv_k)
        if design_a is None:
            design_a = lambda t: _basis(lvl_a[t] * inv_k, degree)
        disc_a, disc_fn_a, _ = fam.lsmc_discount(p, gs_a)
        _, betas = _backward_fit(
            payoff, p, lvl_a, lvl_a, valid_a, n, degree, inv_k, disc_a,
            immediate_of(gs_a), every, design_fn=design_a,
            n_basis=n_basis, disc_fn=disc_fn_a)

    # 2) independent outer set (this shard's global path-id range)
    gs_b, n_pad_b = grids(n_outer, key_outer, offset=path_offset,
                          bound=n_valid)
    lvl_b = fam.lsmc_level(p, gs_b)
    offset_b = jnp.asarray(path_offset, jnp.uint32)
    bound_b = (offset_b + jnp.uint32(n_outer) if n_valid is None
               else jnp.asarray(n_valid, jnp.uint32))
    ids_b = offset_b + jnp.arange(n_pad_b, dtype=jnp.uint32)
    valid_b = ids_b < bound_b
    ki0 = jnp.asarray(key_inner[0], jnp.uint32)
    ki1 = jnp.asarray(key_inner[1], jnp.uint32)
    pps = fam.rollout_pairs_per_step

    def mk_draw(branch, u):
        base = ((jnp.asarray(branch, jnp.uint32) * jnp.uint32(n)
                 + jnp.asarray(u, jnp.uint32)) * jnp.uint32(pps))

        def pair(q):
            c1 = (jnp.full(ids_b.shape, 0, jnp.uint32) + base
                  + jnp.uint32(q))
            return rng.normal_pair(ki0, ki1, ids_b, c1)

        def unit(q):
            c1 = (jnp.full(ids_b.shape, 0, jnp.uint32) + base
                  + jnp.uint32(q))
            b0, _ = rng.threefry2x32(ki0, ki1, ids_b, c1,
                                     rounds=rng.DEFAULT_ROUNDS)
            return rng.bits_to_unit(b0)

        def normal1(q):
            # ONE normal from one threefry call (inverse CDF) — the
            # single-factor families' rollouts need no Box-Muller pair
            return rng.inv_normal_cdf(unit(q))

        return SimpleNamespace(pair=pair, unit=unit, normal1=normal1)

    def rollout(t, carry0, df0, branch):
        """Policy rollout from ``carry0`` at date t; ``df0`` the
        discount-to-0 factor AT the rollout's start state (per path).
        The discount accumulates multiplicatively through the family's
        per-step factors, so pathwise-rate families discount exactly."""
        def body(u, st):
            carry, df, done, val = st
            s = fam.rollout_spot(p, ctx, carry)
            ex = payoff.terminal((), s, p)
            x = fam.lsmc_basis_point(p, carry, s, degree, inv_k)
            cont = jnp.dot(x, betas[u],
                           preferred_element_type=jnp.float32,
                           precision=jax.lax.Precision.HIGHEST)
            is_ex_date = ((u + 1) % every) == 0
            trig = jnp.logical_and(
                jnp.logical_and(jnp.logical_and(ex > 0.0, ex > cont),
                                jnp.logical_not(done)), is_ex_date)
            val = jnp.where(trig, ex * df, val)
            done = jnp.logical_or(done, trig)
            carry, step_df = fam.rollout_step(p, ctx, carry,
                                              mk_draw(branch, u), u)
            return (carry, df * step_df, done, val)

        zerosb = jnp.zeros((n_pad_b,), jnp.float32)
        carry, df, done, val = jax.lax.fori_loop(
            t, n - 1, body,
            (carry0, df0, jnp.zeros((n_pad_b,), bool), zerosb))
        ex = payoff.terminal((), fam.rollout_spot(p, ctx, carry), p)
        return jnp.where(done, val, ex * df)

    def carry_at(t_idx):
        return fam.rollout_carry(p, ctx,
                                 tuple(g[t_idx] for g in gs_b))

    return SimpleNamespace(p=p, ctx=ctx, n=n, inv_k=inv_k, gs_b=gs_b,
                           lvl_b=lvl_b, n_pad_b=n_pad_b,
                           valid_b=valid_b, betas=betas,
                           mk_draw=mk_draw, rollout=rollout,
                           carry_at=carry_at)


@functools.partial(
    jax.jit,
    static_argnames=("fam", "payoff", "sim", "degree", "tile_rows",
                     "n_outer", "n_inner", "every"))
def _ab_upper_family_impl(fam, option, dyn, payoff, sim, degree, tile_rows,
                          n_outer, n_inner, key_fit, key_outer,
                          key_inner, every=1):
    T = _family_policy_tools(fam, option, dyn, payoff, sim, degree,
                             tile_rows, n_outer, key_fit, key_outer,
                             key_inner, every)
    p, ctx, n = T.p, T.ctx, T.n
    gs_b, lvl_b, n_pad_b, valid_b = (T.gs_b, T.lvl_b, T.n_pad_b,
                                     T.valid_b)
    mk_draw, rollout, carry_at = T.mk_draw, T.rollout, T.carry_at
    jn = jnp.float32(n_inner)

    two_j_total = n * 2 * n_inner
    gap_mat = n - every * ((n - 1) // every)

    def date_step(carry_scan, t):
        m, run_max = carry_scan
        base = t * (2 * n_inner)
        is_ex_date = jnp.logical_or(((t + 1) % every) == 0, t == n - 1)
        gap = jnp.where(t == n - 1, jnp.int32(gap_mat), jnp.int32(every))

        df_t = fam.ab_grid_df(p, gs_b, t) * jnp.ones((n_pad_b,),
                                                      jnp.float32)

        def delta_fn(_):
            def here_j(j, acc):
                return acc + rollout(t, carry_at(t), df_t, base + j)

            l_here = jax.lax.fori_loop(
                0, n_inner, here_j,
                jnp.zeros((n_pad_b,), jnp.float32)) / jn

            prev_idx = t - gap
            prev_safe = jnp.maximum(prev_idx, 0)
            carry_prev_grid = carry_at(prev_safe)
            carry_t0 = fam.rollout_carry(
                p, ctx,
                tuple(jnp.full((n_pad_b,), 1.0, jnp.float32) * g0
                      for g0 in fam.rollout_t0(p)))
            carry_prev = jax.tree_util.tree_map(
                lambda a, b: jnp.where(prev_idx >= 0, a, b),
                carry_prev_grid, carry_t0)
            df_prev = jnp.where(
                prev_idx >= 0,
                fam.ab_grid_df(p, gs_b, prev_safe)
                * jnp.ones((n_pad_b,), jnp.float32),
                jnp.ones((n_pad_b,), jnp.float32))

            def inner_j(j, acc):
                branch = base + n_inner + j
                branch_tr = two_j_total + branch

                def tr_step(k, st):
                    c, df = st
                    # rollout_step's `u` is the DATE the step leaves
                    # (its move has index u+1 — surface families index
                    # their curves by that).  From date prev, step k
                    # leaves date prev+k; from the t=0 anchor (one date
                    # before grid row 0), step k leaves date k-1.
                    u_abs = jnp.where(prev_idx >= 0, prev_safe + k, k - 1)
                    c, step_df = fam.rollout_step(p, ctx, c,
                                                  mk_draw(branch_tr, k),
                                                  u_abs)
                    return (c, df * step_df)

                c, df = jax.lax.fori_loop(0, gap, tr_step,
                                          (carry_prev, df_prev))
                return acc + rollout(t, c, df, branch)

            e_t = jax.lax.fori_loop(
                0, n_inner, inner_j,
                jnp.zeros((n_pad_b,), jnp.float32)) / jn
            return l_here - e_t

        m = m + jax.lax.cond(jnp.logical_and(is_ex_date, t >= 1),
                             delta_fn,
                             lambda _: jnp.zeros_like(m), 0)
        hd = payoff.terminal((), lvl_b[t], p) * df_t
        run_max = jnp.maximum(run_max,
                              jnp.where(is_ex_date, hd - m, -1e30))
        return (m, run_max), None

    zeros = jnp.zeros((n_pad_b,), jnp.float32)
    (m, run_max), _ = jax.lax.scan(date_step,
                                   (zeros, jnp.full_like(zeros, -1e30)),
                                   jnp.arange(n, dtype=jnp.int32))
    u = jnp.where(valid_b, run_max, 0.0)
    nn = jnp.float32(n_outer)
    mean = jnp.sum(u) / nn
    var = jnp.sum(jnp.where(valid_b, (u - mean) ** 2, 0.0)) / jnp.maximum(
        nn - 1.0, 1.0)
    return PriceResult(price=mean, stderr=jnp.sqrt(var / nn), n_paths=nn,
                       payoff_mean=mean, payoff_var=var)


def american_bounds_family(model: str,
                           option: OptionParams = DEMO_OPTION,
                           dyn=None,
                           sim: SimParams = DEMO_SIM,
                           payoff="vanilla_put",
                           *,
                           degree: int = 3,
                           n_outer: int = 2048,
                           n_inner: int = 128,
                           exercise_every: int = 1,
                           tile_rows: int = 8,
                           stream: int = STREAM_OUTER):
    """Andersen-Broadie bracket under a model family: (lower, upper).

    ``model``: "heston" | "merton" | "cev" | "localvol" | "sabr" |
    "vasicek" | "basket" | "rainbow" — any NMC family with LSMC +
    rollout hooks ("rainbow" also accepts the rainbow contract names,
    e.g. payoff="put_on_min" brackets the American worst-of put);
    discounting
    rides the rollout carry, so Vasicek's PATHWISE stochastic
    discounting is exact (each rollout accumulates its own e^{-dy} and
    anchors on the stored integrated-rate grid).  The lower
    bound is the family's two-pass LSMC; the upper bound the duality gap
    built from the SAME fitted policy with family-physics rollouts.
    """
    from mc_tpu.nmc_engine import NMC_FAMILY_BUILDERS, ensure_family
    _DUAL_MODELS = ("heston", "bates", "merton", "cev", "localvol",
                    "sabr", "vasicek", "basket", "rainbow")  # term: no dual yet
    if model not in _DUAL_MODELS:
        raise ValueError(f"american_bounds_family supports "
                         f"{_DUAL_MODELS}, got {model!r}")
    ensure_family(model)
    if model == "rainbow":
        # rainbow contract names select the order statistic; the
        # standard payoff then reads the folded level
        from mc_tpu.nmc_rainbow import RAINBOW_NMC_PAYOFFS, RainbowNMC
        from mc_tpu.models.basket import DEMO_BASKET
        agg, payoff = RAINBOW_NMC_PAYOFFS.get(payoff, ("max", payoff))
        dyn32 = (DEMO_BASKET if dyn is None else dyn).as_f32()
        fam = RainbowNMC(extras=(dyn32.d, agg))
    else:
        fam, dyn32 = NMC_FAMILY_BUILDERS[model](option, dyn, sim)
    po = get_payoff(payoff)
    if po.n_state != 0:
        raise ValueError("american_bounds supports terminal payoffs "
                         "(n_state == 0)")
    if exercise_every < 1:
        raise ValueError("exercise_every must be >= 1")
    if fam.even_steps and sim.n_steps % 2:
        raise ValueError(f"{fam.name} requires an even n_steps")
    span = 4 * sim.n_steps * sim.n_steps * n_inner \
        * fam.rollout_pairs_per_step
    if span >= 1 << 32:
        raise ValueError(
            "rollout RNG counter space exhausted: "
            f"4*n_steps^2*n_inner*pairs = {span} >= 2^32")
    lower = price_american_family(fam, option, dyn32, sim, payoff,
                                  degree=degree, two_pass=True,
                                  exercise_every=exercise_every,
                                  tile_rows=tile_rows, stream=stream)
    key_fit = jnp.asarray(rng.derive_key(sim.seed, stream, fam.tag),
                          jnp.uint32)
    key_outer = jnp.asarray(
        rng.derive_key(sim.seed, stream, fam.tag, 0xAB01), jnp.uint32)
    key_inner = jnp.asarray(
        rng.derive_key(sim.seed, stream, fam.tag, 0xAB02), jnp.uint32)
    upper = _ab_upper_family_impl(fam, option.as_f32(), dyn32, po,
                                  sim.replace(seed=0), degree, tile_rows,
                                  n_outer, n_inner, key_fit,
                                  key_outer, key_inner, exercise_every)
    return lower, upper


def _american_exposure_values(fam, option, dyn, payoff, sim, degree,
                              tile_rows, n_outer, n_inner, key_fit,
                              key_outer, key_inner, every=1,
                              path_offset=0, n_valid=None):
    """(n_pad, n_steps) exposure value matrix for the path range
    [path_offset, path_offset + n_outer) — the per-shard piece the
    single-chip and sharded entries share (streams key by GLOBAL id)."""
    T = _family_policy_tools(fam, option, dyn, payoff, sim, degree,
                             tile_rows, n_outer, key_fit, key_outer,
                             key_inner, every, path_offset=path_offset,
                             n_valid=n_valid)
    p, n = T.p, T.n
    jn = jnp.float32(n_inner)
    alive = jnp.ones((T.n_pad_b,), bool)
    vals = []
    for t in range(n):
        df_t = (fam.ab_grid_df(p, T.gs_b, t)
                * jnp.ones((T.n_pad_b,), jnp.float32))
        carry_t = T.carry_at(t)

        # MtM at date t: mean of n_inner frozen-policy rollouts from
        # the realized state.  Where the policy exercises AT t every
        # rollout returns the intrinsic deterministically (zero noise);
        # after an EARLIER exercise the position has settled and left
        # the netting set -> 0.
        def v_j(j, acc, t=t, carry_t=carry_t, df_t=df_t):
            return acc + T.rollout(t, carry_t, df_t,
                                   t * n_inner + j)

        v_t = jax.lax.fori_loop(0, n_inner, v_j,
                                jnp.zeros((T.n_pad_b,), jnp.float32)) / jn
        vals.append(jnp.where(jnp.logical_and(alive, T.valid_b), v_t,
                              0.0))

        # the OUTER path's own policy decision at t (same rule as the
        # rollouts: exercise dates only, maturity always exercises ITM)
        ex = payoff.terminal((), T.lvl_b[t], p)
        if t == n - 1:
            take = ex > 0.0
        elif (t + 1) % every == 0:
            x = fam.lsmc_basis_point(p, carry_t, T.lvl_b[t], degree,
                                     T.inv_k)
            cont = jnp.dot(x, T.betas[t],
                           preferred_element_type=jnp.float32,
                           precision=jax.lax.Precision.HIGHEST)
            take = jnp.logical_and(ex > 0.0, ex > cont)
        else:
            take = jnp.zeros((T.n_pad_b,), bool)
        alive = jnp.logical_and(alive, jnp.logical_not(take))
    return jnp.stack(vals, axis=1)


@functools.partial(
    jax.jit,
    static_argnames=("fam", "payoff", "sim", "degree", "tile_rows",
                     "n_outer", "n_inner", "every"))
def _american_exposure_family_impl(fam, option, dyn, payoff, sim, degree,
                                   tile_rows, n_outer, n_inner, key_fit,
                                   key_outer, key_inner, every=1):
    return _american_exposure_values(fam, option, dyn, payoff, sim,
                                     degree, tile_rows, n_outer, n_inner,
                                     key_fit, key_outer, key_inner,
                                     every)


@functools.partial(
    jax.jit,
    static_argnames=("fam", "payoff", "sim", "degree", "tile_rows",
                     "n_outer", "n_inner", "every", "mesh"))
def _american_exposure_family_sharded(fam, option, dyn, payoff, sim,
                                      degree, tile_rows, n_outer,
                                      n_inner, key_fit, key_outer,
                                      key_inner, every, mesh):
    """Outer path ranges sharded over the mesh.  The pilot FIT runs
    replicated inside every shard (same keys -> identical betas,
    bitwise), outer grids and rollout streams key by GLOBAL path id —
    so the gathered value matrix is bitwise the single-chip one on ANY
    mesh size; no collectives are needed at all."""
    from jax.sharding import PartitionSpec as P

    from mc_tpu.parallel.mesh import PATHS_AXIS, shard_bounds

    n_shards = mesh.devices.size
    n_local = shard_bounds(n_outer, n_shards, tile_rows)

    def shard_fn(option, dyn, key_fit, key_outer, key_inner):
        rank = jax.lax.axis_index(PATHS_AXIS).astype(jnp.uint32)
        local_off = rank * jnp.uint32(n_local)
        return _american_exposure_values(
            fam, option, dyn, payoff, sim, degree, tile_rows, n_local,
            n_inner, key_fit, key_outer, key_inner, every,
            path_offset=local_off, n_valid=jnp.uint32(n_outer))

    return jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=P(PATHS_AXIS), check_vma=False,
    )(option, dyn, key_fit, key_outer, key_inner)


def american_exposure_family(model: str,
                             option: OptionParams = DEMO_OPTION,
                             dyn=None,
                             sim: SimParams = DEMO_SIM,
                             payoff="vanilla_put",
                             *,
                             degree: int = 3,
                             n_outer: int = 4096,
                             n_inner: int = 16,
                             exercise_every: int = 1,
                             tile_rows: int = 8,
                             mesh=None,
                             stream: int = STREAM_OUTER):
    """Counterparty exposure of a long AMERICAN/Bermudan position under
    any model family — the American-Monte-Carlo XVA surface.

    The LSMC policy is fitted on a ``sim.n_paths`` pilot set, then on an
    independent ``n_outer`` set the position's MtM at every step is
    re-priced by ``n_inner`` frozen-policy rollouts from the stored
    market state (family physics; pathwise-rate families discount
    exactly along each rollout).  Exercise ABSORBS: once the outer
    policy exercises, the cash settles and the position leaves the
    netting set — so the discounted EE profile telescopes, EE(t_j) =
    E[cash at j] + EE(t_{j+1}): nonincreasing, with EE at the first
    date ~ the (policy) price.  Returns a `CollateralizedExposure`
    carrying the full XVA metric set.  Same model menu and policy
    construction as `american_bounds_family` (the rollout machinery is
    shared code).

    ``mesh=`` shards the outer path range over the devices: the pilot
    fit replicates (identical betas), outer grids and rollout streams
    key by GLOBAL path id, so the exposure matrix is BITWISE the
    single-chip one on any mesh size."""
    from mc_tpu.nmc_engine import NMC_FAMILY_BUILDERS, ensure_family
    _DUAL_MODELS = ("heston", "bates", "merton", "cev", "localvol",
                    "sabr", "vasicek", "basket", "rainbow")
    if model not in _DUAL_MODELS:
        raise ValueError(f"american_exposure_family supports "
                         f"{_DUAL_MODELS}, got {model!r}")
    ensure_family(model)
    if model == "rainbow":
        from mc_tpu.models.basket import DEMO_BASKET
        from mc_tpu.nmc_rainbow import RAINBOW_NMC_PAYOFFS, RainbowNMC
        agg, payoff = RAINBOW_NMC_PAYOFFS.get(payoff, ("max", payoff))
        dyn32 = (DEMO_BASKET if dyn is None else dyn).as_f32()
        fam = RainbowNMC(extras=(dyn32.d, agg))
    else:
        fam, dyn32 = NMC_FAMILY_BUILDERS[model](option, dyn, sim)
    po = get_payoff(payoff)
    if po.n_state != 0:
        raise ValueError("american exposure supports terminal payoffs "
                         "(n_state == 0)")
    if exercise_every < 1:
        raise ValueError("exercise_every must be >= 1")
    if fam.even_steps and sim.n_steps % 2:
        raise ValueError(f"{fam.name} requires an even n_steps")
    span = (sim.n_steps * n_inner * sim.n_steps
            * fam.rollout_pairs_per_step)
    if span >= 1 << 32:
        raise ValueError(
            "rollout RNG counter space exhausted: "
            f"n_steps^2*n_inner*pairs = {span} >= 2^32")
    key_fit = jnp.asarray(rng.derive_key(sim.seed, stream, fam.tag),
                          jnp.uint32)
    key_outer = jnp.asarray(
        rng.derive_key(sim.seed, stream, fam.tag, 0xAE01), jnp.uint32)
    key_inner = jnp.asarray(
        rng.derive_key(sim.seed, stream, fam.tag, 0xAE02), jnp.uint32)
    if mesh is None:
        values = _american_exposure_family_impl(
            fam, option.as_f32(), dyn32, po, sim.replace(seed=0),
            degree, tile_rows, n_outer, n_inner, key_fit, key_outer,
            key_inner, exercise_every)[:n_outer]
    else:
        values = _american_exposure_family_sharded(
            fam, option.as_f32(), dyn32, po, sim.replace(seed=0),
            degree, tile_rows, n_outer, n_inner, key_fit, key_outer,
            key_inner, exercise_every, mesh)[:n_outer]
    from mc_tpu.xva import CollateralizedExposure
    return CollateralizedExposure(
        values=values, t_horizon=jnp.float32(option.as_f32().t))
