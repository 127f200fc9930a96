"""Interest-rate swaptions under the Vasicek short rate.

The rates-native product family on the framework's stochastic-rate
machinery (`models/vasicek.py` holds the equity-hybrid engine; here the
rate IS the underlying).  Design point: the Vasicek (x, y) =
(r - b, int r du) pair has an EXACT joint Gaussian transition over ANY
horizon, so the simulation grid is the COUPON grid — one exact step per
exercise date, no Euler substeps, no discretization bias anywhere
(`vasicek_step`'s covariance algebra, models/vasicek.py:87-120, reduced
to the 2x2 rates block).

* `price_swaption` — European payer/receiver swaption by one exact
  draw of (r_T0, y_T0): the swap's bonds are affine in r_T0 and the
  pathwise discount e^{-y} is exact.  Oracle:
  `oracle.vasicek_swaption` (Jamshidian decomposition).
* `price_bermudan_swaption` — co-terminal Bermudan (exercise at any
  coupon date into the remaining swap) by Longstaff-Schwartz on the
  exact date-grid: regression basis in r, intrinsic values in closed
  form (affine bonds), pathwise discounting — no inner simulation
  needed anywhere.  Gates: one-date Bermudan == European (same draws),
  Bermudan >= every standalone European on the remaining swaps,
  sigma_r -> 0 collapses to the deterministic max.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from mc_tpu import rng
from mc_tpu.config import SimParams
from mc_tpu.engines import STREAM_OUTER
from mc_tpu.models.vasicek import DEMO_VASICEK, VasicekDynamics
from mc_tpu.oracle import PriceResult, summarize

__all__ = ["SwaptionSpec", "price_swaption", "price_bermudan_swaption",
           "price_swaption_sharded", "price_swaption_qmc", "swaption_greeks",
           "swap_exposure",
           "DEMO_SWAPTION"]


def _mm(a, b):
    """float32 product at full precision: a GPU would otherwise run it in
    TF32, which keeps about three decimal digits."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


@dataclasses.dataclass(frozen=True)
class SwaptionSpec:
    """Unit-notional swap: fixed ``k_rate`` vs float, payments at
    expiry + i*tenor (i = 1..n_payments).  Hashable/static (shapes and
    the date grid depend on it)."""

    expiry: float = 1.0
    tenor: float = 0.5
    n_payments: int = 10
    k_rate: float = 0.05
    payer: bool = True

    def validate(self) -> "SwaptionSpec":
        if self.expiry <= 0 or self.tenor <= 0:
            raise ValueError(f"expiry/tenor must be > 0, got "
                             f"({self.expiry}, {self.tenor})")
        if self.n_payments < 1:
            raise ValueError(f"n_payments must be >= 1, "
                             f"got {self.n_payments}")
        return self


DEMO_SWAPTION = SwaptionSpec()


def _exact_xy_coeffs(a, sigma_r, dt):
    """Cholesky of the exact (eps, eta) covariance over one step of
    size ``dt`` — the 2x2 rates block of models/vasicek._pack_vasicek,
    in `vasicek.ou_chol2`'s cancellation-free closed form (the textbook
    c11 - l21^2 discriminant loses (a dt)^-2 relative digits in f32 and
    went NaN on an accelerator backend — see `vasicek.ou_gap`)."""
    from mc_tpu.models.vasicek import ou_chol2
    return ou_chol2(a, sigma_r, dt)


def _zcb_affine(a, b, sigma_r, s, r):
    """P(t, t+s) = A(s) e^{-B(s) r} (affine Vasicek bond), traced in r."""
    bt = -jnp.expm1(-a * s) / a
    loga = ((b - sigma_r * sigma_r / (2.0 * a * a)) * (bt - s)
            - sigma_r * sigma_r * bt * bt / (4.0 * a))
    return jnp.exp(loga - bt * r)


def _swap_intrinsic(spec: SwaptionSpec, a, b, sigma_r, r, i0: int):
    """Exercise value AT coupon date i0 (i0 = 0 is the expiry) of the
    remaining swap paying at dates i0+1 .. n_payments: payer intrinsic
    max(1 - P_N - K tau sum P_i, 0), affine in the prevailing rate."""
    tau = jnp.float32(spec.tenor)
    fixed = jnp.zeros_like(r)
    n_rem = spec.n_payments - i0
    for j in range(1, n_rem + 1):
        fixed = fixed + _zcb_affine(a, b, sigma_r, tau * j, r)
    p_last = _zcb_affine(a, b, sigma_r, tau * n_rem, r)
    swap = 1.0 - p_last - jnp.float32(spec.k_rate) * tau * fixed
    if not spec.payer:
        swap = -swap
    return jnp.maximum(swap, 0.0)


def _simulate_rate_grid(spec, a, b, sigma_r, r0, n_paths, n_ex, key,
                        path_offset=0):
    """(r, y) at the n_ex exercise dates by exact steps: expiry first,
    then tenor-sized steps date-to-date.  Draw convention: date u of
    GLOBAL path i consumes threefry pair (i, u) — path_offset keys the
    sharded entry by global id, so sharding never changes the draws."""
    k0 = jnp.asarray(key[0], jnp.uint32)
    k1 = jnp.asarray(key[1], jnp.uint32)
    ids = (jnp.asarray(path_offset, jnp.uint32)
           + jnp.arange(n_paths, dtype=jnp.uint32))

    def step(carry, u):
        x, y = carry
        c1 = jnp.full(ids.shape, 0, jnp.uint32) + u
        z0, z1 = rng.normal_pair(k0, k1, ids, c1)
        # date 0 steps over [0, expiry]; later dates over one tenor
        e1, big_b, l11, l21, l22 = _exact_xy_coeffs(
            a, sigma_r, jnp.where(u == 0, jnp.float32(spec.expiry),
                                  jnp.float32(spec.tenor)))
        eps = l11 * z0
        eta = l21 * z0 + l22 * z1
        dtv = jnp.where(u == 0, jnp.float32(spec.expiry),
                        jnp.float32(spec.tenor))
        y = y + b * dtv + x * big_b + eta
        x = x * e1 + eps
        return (x, y), (x + b, y)

    x0 = jnp.full((n_paths,), jnp.float32(r0 - b), jnp.float32)
    y0 = jnp.zeros((n_paths,), jnp.float32)
    _, (r_grid, y_grid) = jax.lax.scan(
        step, (x0, y0), jnp.arange(n_ex, dtype=jnp.uint32))
    return r_grid, y_grid  # (n_ex, n_paths) each


@functools.partial(jax.jit,
                   static_argnames=("spec", "n_paths", "payoff_date"))
def _european_impl(spec, a, b, sigma_r, r0, n_paths, key,
                   payoff_date: int = 0):
    r_grid, y_grid = _simulate_rate_grid(spec, a, b, sigma_r, r0,
                                         n_paths, payoff_date + 1, key)
    pay = (_swap_intrinsic(spec, a, b, sigma_r, r_grid[payoff_date],
                           payoff_date)
           * jnp.exp(-y_grid[payoff_date]))
    n = jnp.float32(n_paths)
    return summarize(jnp.sum(pay), jnp.sum(pay * pay), n, 1.0)


def price_swaption(spec: SwaptionSpec = DEMO_SWAPTION,
                   dyn: VasicekDynamics = DEMO_VASICEK,
                   sim: SimParams = SimParams(n_paths=1 << 20, n_steps=1),
                   *,
                   r0: float = 0.05,
                   seed: Optional[int] = None,
                   stream: int = STREAM_OUTER) -> PriceResult:
    """European payer/receiver swaption: ONE exact draw of (r, int r)
    at expiry, pathwise discounting, swap bonds in closed affine form.
    Oracle gate: `oracle.vasicek_swaption` (Jamshidian)."""
    spec = spec.validate()
    d32 = dyn.as_f32()
    seed = sim.seed if seed is None else seed
    key = jnp.asarray(rng.derive_key(seed, stream, 0x5A97), jnp.uint32)
    return _european_impl(spec, jnp.float32(d32.a), jnp.float32(d32.b),
                          jnp.float32(d32.sigma_r), jnp.float32(r0),
                          sim.n_paths, key)


def _fit_bermudan(spec, a, b, sigma_r, r_grid, y_grid, degree):
    """Backward Longstaff-Schwarz on the date grid: returns the
    realized discounted-to-0 cashflows AND the fitted per-date betas
    ((n_ex-1, degree+1); date n_ex-1 has no continuation).

    The regression is in DATE-i FORWARD terms: target = cf * e^{y_i}
    (the cashflow discounted to date i, not to 0), compared against the
    UNdiscounted intrinsic — so the fitted policy is a function of the
    short rate alone.  Regressing 0-discounted values on an r-only
    basis would smuggle the path's accumulated discount y into the
    decision (a y-dependent, inconsistent policy — measured ~25%
    duality gap vs ~3% with this convention)."""
    n_ex = spec.n_payments
    cf = (_swap_intrinsic(spec, a, b, sigma_r, r_grid[n_ex - 1],
                          n_ex - 1) * jnp.exp(-y_grid[n_ex - 1]))
    betas = [None] * max(n_ex - 1, 0)

    # python loop over dates: n_ex is static and small (the coupon grid)
    for i in range(n_ex - 2, -1, -1):
        ex = _swap_intrinsic(spec, a, b, sigma_r, r_grid[i], i)
        itm = ex > 0.0
        x = _rate_basis(r_grid[i], b, degree)
        w = jnp.where(itm, 1.0, 0.0)[:, None]
        xtx = (_mm((x * w).T, x)
               + 1e-6 * jnp.eye(x.shape[1], dtype=x.dtype))
        xty = _mm((x * w).T, cf * jnp.exp(y_grid[i]))
        # frozen-policy convention: sensitivities (swaption_greeks) hold
        # the fitted policy fixed — envelope theorem; forward unchanged
        beta = jax.lax.stop_gradient(jnp.linalg.solve(xtx, xty))
        betas[i] = beta
        cont = _mm(x, beta)
        take = jnp.logical_and(itm, ex > cont)
        cf = jnp.where(take, ex * jnp.exp(-y_grid[i]), cf)
    return cf, betas


@functools.partial(jax.jit, static_argnames=("spec", "n_paths", "degree"))
def _bermudan_impl(spec, a, b, sigma_r, r0, n_paths, degree, key):
    n_ex = spec.n_payments  # exercise at every coupon date 0..N-1
    r_grid, y_grid = _simulate_rate_grid(spec, a, b, sigma_r, r0,
                                         n_paths, n_ex, key)
    cf, _ = _fit_bermudan(spec, a, b, sigma_r, r_grid, y_grid, degree)
    n = jnp.float32(n_paths)
    return summarize(jnp.sum(cf), jnp.sum(cf * cf), n, 1.0)


def price_bermudan_swaption(spec: SwaptionSpec = DEMO_SWAPTION,
                            dyn: VasicekDynamics = DEMO_VASICEK,
                            sim: SimParams = SimParams(n_paths=1 << 17,
                                                       n_steps=1),
                            *,
                            r0: float = 0.05,
                            degree: int = 3,
                            seed: Optional[int] = None,
                            stream: int = STREAM_OUTER) -> PriceResult:
    """Co-terminal Bermudan swaption (exercise at any coupon date into
    the remaining swap) by Longstaff-Schwartz on the exact date grid:
    polynomial basis in the short rate, closed-form intrinsics, exact
    pathwise discounting.  The LSMC estimate is the standard slightly-
    low-biased lower bound (policy fitted and evaluated on the same
    paths — same convention as `lsmc.price_american`)."""
    spec = spec.validate()
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}")
    d32 = dyn.as_f32()
    seed = sim.seed if seed is None else seed
    # SAME stream tag as price_swaption: the rate grids are CRN, so the
    # Bermudan-vs-European premium collapses variance, and a 1-payment
    # Bermudan (only exercise date = expiry) is BITWISE the European.
    key = jnp.asarray(rng.derive_key(seed, stream, 0x5A97), jnp.uint32)
    return _bermudan_impl(spec, jnp.float32(d32.a), jnp.float32(d32.b),
                          jnp.float32(d32.sigma_r), jnp.float32(r0),
                          sim.n_paths, degree, key)


def swaption_greeks(spec: SwaptionSpec = DEMO_SWAPTION,
                    dyn: VasicekDynamics = DEMO_VASICEK,
                    sim: SimParams = SimParams(n_paths=1 << 18, n_steps=1),
                    *,
                    r0: float = 0.05,
                    style: str = "european",
                    degree: int = 3,
                    seed: Optional[int] = None,
                    stream: int = STREAM_OUTER):
    """Rate-desk sensitivities by reverse mode through the exact-grid
    pricer: {"dv01": dP/dr0, "vega_r": dP/dsigma_r, "kappa": dP/da,
    "theta_b": dP/db} in ONE backward pass (the simulation, the affine
    bonds, and the pathwise discount are all traced).  For
    style="bermudan" the gradient holds the fitted exercise policy
    fixed through `stop_gradient` on the regression betas — the
    frozen-policy convention of `lsmc.american_greeks` (first-order
    exact by the envelope theorem at the optimal policy)."""
    spec = spec.validate()
    if style not in ("european", "bermudan"):
        raise ValueError(f"style must be european|bermudan, got {style!r}")
    d32 = dyn.as_f32()
    seed = sim.seed if seed is None else seed
    key = jnp.asarray(rng.derive_key(seed, stream, 0x5A97), jnp.uint32)

    def f(r0_, a_, b_, sig_):
        if style == "european":
            res = _european_impl(spec, a_, b_, sig_, r0_, sim.n_paths,
                                 key)
        else:
            res = _bermudan_impl(spec, a_, b_, sig_, r0_, sim.n_paths,
                                 degree, key)
        return res.price

    g = jax.grad(f, argnums=(0, 1, 2, 3))(
        jnp.float32(r0), jnp.float32(d32.a), jnp.float32(d32.b),
        jnp.float32(d32.sigma_r))
    return {"dv01": g[0], "kappa": g[1], "theta_b": g[2], "vega_r": g[3]}


# ---------------------------------------------------------------------------
# Multi-chip: the rate grid shards over the path axis (streams key by
# GLOBAL path id, so a 1-device mesh is bitwise the single-chip pricer).
# The Bermudan's regression stays EXACT under sharding: per-shard normal
# equations (X'X, X'y) meet in one psum per exercise date, so every chip
# solves the IDENTICAL global system and fits the same policy the
# single-chip LSMC would.
# ---------------------------------------------------------------------------


@functools.partial(jax.jit,
                   static_argnames=("spec", "n_paths", "degree", "style",
                                    "mesh"))
def _swaption_sharded_impl(spec, a, b, sigma_r, r0, n_paths, degree,
                           style, mesh, key):
    from jax.sharding import PartitionSpec as P

    from mc_tpu.parallel.mesh import PATHS_AXIS

    n_shards = mesh.devices.size
    n_local = -(-n_paths // n_shards)  # ceil; overhang masked below
    n_ex = 1 if style == "european" else spec.n_payments

    def shard_fn(key):
        rank = jax.lax.axis_index(PATHS_AXIS).astype(jnp.uint32)
        off = rank * jnp.uint32(n_local)
        mask = (off + jnp.arange(n_local, dtype=jnp.uint32)
                < jnp.uint32(n_paths))
        r_grid, y_grid = _simulate_rate_grid(spec, a, b, sigma_r, r0,
                                             n_local, n_ex, key, off)
        if style == "european":
            cf = (_swap_intrinsic(spec, a, b, sigma_r, r_grid[0], 0)
                  * jnp.exp(-y_grid[0]))
        else:
            cf = (_swap_intrinsic(spec, a, b, sigma_r, r_grid[n_ex - 1],
                                  n_ex - 1)
                  * jnp.exp(-y_grid[n_ex - 1]))
            eye = 1e-6 * jnp.eye(degree + 1, dtype=jnp.float32)
            for i in range(n_ex - 2, -1, -1):
                # date-i FORWARD regression — see _fit_bermudan
                ex = _swap_intrinsic(spec, a, b, sigma_r, r_grid[i], i)
                itm = jnp.logical_and(ex > 0.0, mask)
                x = _rate_basis(r_grid[i], b, degree)
                w = jnp.where(itm, 1.0, 0.0)[:, None]
                xtx = jax.lax.psum(_mm((x * w).T, x), PATHS_AXIS) + eye
                xty = jax.lax.psum(_mm((x * w).T, cf * jnp.exp(y_grid[i])),
                                   PATHS_AXIS)
                beta = jax.lax.stop_gradient(jnp.linalg.solve(xtx, xty))
                cont = _mm(x, beta)
                take = jnp.logical_and(itm, ex > cont)
                cf = jnp.where(take, ex * jnp.exp(-y_grid[i]), cf)
        cf = jnp.where(mask, cf, 0.0)
        return (jax.lax.psum(jnp.sum(cf), PATHS_AXIS),
                jax.lax.psum(jnp.sum(cf * cf), PATHS_AXIS))

    s, sq = jax.shard_map(shard_fn, mesh=mesh, in_specs=(P(),),
                          out_specs=P(), check_vma=False)(key)
    return summarize(s, sq, jnp.float32(n_paths), 1.0)


def _rate_basis(r, b, degree):
    cols = [jnp.ones_like(r)]
    x = (r - b) / jnp.maximum(jnp.abs(b), 1e-3)
    pw = x
    for _ in range(degree):
        cols.append(pw)
        pw = pw * x
    return jnp.stack(cols, axis=-1)


def price_swaption_sharded(spec: SwaptionSpec = DEMO_SWAPTION,
                           dyn: VasicekDynamics = DEMO_VASICEK,
                           sim: SimParams = SimParams(n_paths=1 << 20,
                                                      n_steps=1),
                           *,
                           mesh=None,
                           style: str = "european",
                           r0: float = 0.05,
                           degree: int = 3,
                           seed: Optional[int] = None,
                           stream: int = STREAM_OUTER) -> PriceResult:
    """European or Bermudan swaption with paths sharded over the mesh
    (default: all local devices).  Gates: 1-device mesh bitwise equals
    the single-chip pricer; the Bermudan's psum'd normal equations give
    mesh-size-invariant policies."""
    from mc_tpu.parallel.mesh import make_mesh

    spec = spec.validate()
    if style not in ("european", "bermudan"):
        raise ValueError(f"style must be european|bermudan, got {style!r}")
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}")
    mesh = make_mesh() if mesh is None else mesh
    d32 = dyn.as_f32()
    seed = sim.seed if seed is None else seed
    key = jnp.asarray(rng.derive_key(seed, stream, 0x5A97), jnp.uint32)
    return _swaption_sharded_impl(spec, jnp.float32(d32.a),
                                  jnp.float32(d32.b),
                                  jnp.float32(d32.sigma_r),
                                  jnp.float32(r0), sim.n_paths, degree,
                                  style, mesh, key)


def swap_exposure(spec: SwaptionSpec = DEMO_SWAPTION,
                  dyn: VasicekDynamics = DEMO_VASICEK,
                  sim: SimParams = SimParams(n_paths=1 << 16, n_steps=1),
                  *,
                  r0: float = 0.05,
                  seed: Optional[int] = None,
                  stream: int = STREAM_OUTER):
    """Counterparty exposure of the SWAP itself — the textbook CVA
    object.  The swap's MtM at each coupon date is closed-form affine
    in the prevailing rate (no inner simulation needed, unlike the
    equity NMC surfaces), so the (path, date) value matrix comes from
    one exact rate-grid pass; it returns a `CollateralizedExposure`
    carrying the ENTIRE XVA metric surface: EE/PFE, CVA/DVA/BCVA,
    FVA, quantile-of-PnL IM + MVA, two-way CSA collateralization, and
    wrong-way-risk CVA (`cva_wwr` — rates up = payer ITM = default
    more likely, the classic WWR pairing).

    Values are discounted to 0 along each path's own exp(-int r)
    (consistent with the NMC surfaces' EE* convention).  At date i the
    MtM is the REMAINING swap's value (payments i+1..N), signed + for
    the payer; the profile decays to 0 at the final coupon (gated).
    """
    spec = spec.validate()
    d32 = dyn.as_f32()
    seed = sim.seed if seed is None else seed
    key = jnp.asarray(rng.derive_key(seed, stream, 0x5A97), jnp.uint32)
    a, b, sig = (jnp.float32(d32.a), jnp.float32(d32.b),
                 jnp.float32(d32.sigma_r))
    n_ex = spec.n_payments
    r_grid, y_grid = _simulate_rate_grid(spec, a, b, sig,
                                         jnp.float32(r0), sim.n_paths,
                                         n_ex, key)

    vals = []
    for i in range(n_ex):
        tau = jnp.float32(spec.tenor)
        r = r_grid[i]
        fixed = jnp.zeros_like(r)
        n_rem = spec.n_payments - i - 1  # payments STRICTLY after date i
        for j in range(1, n_rem + 1):
            fixed = fixed + _zcb_affine(a, b, sig, tau * j, r)
        if n_rem == 0:
            mtm = jnp.zeros_like(r)  # all cashflows settled
        else:
            p_last = _zcb_affine(a, b, sig, tau * n_rem, r)
            mtm = 1.0 - p_last - jnp.float32(spec.k_rate) * tau * fixed
        if not spec.payer:
            mtm = -mtm
        vals.append(mtm * jnp.exp(-y_grid[i]))

    from mc_tpu.xva import CollateralizedExposure, coupon_dates
    horizon = spec.expiry + (n_ex - 1) * spec.tenor
    return CollateralizedExposure(
        values=jnp.stack(vals, axis=1), t_horizon=jnp.float32(horizon),
        obs_dates=coupon_dates(spec.expiry, spec.tenor, n_ex))


def _ab_bracket(n_ex: int, n_paths: int, n_branch: int, z_at, v_at,
                cond_at):
    """Generic Andersen-Broadie running max over an exercise-date grid.

    ``z_at(i)`` -> (n_paths,) discounted intrinsic on the outer grid at
    date i; ``v_at(i, ids_b)`` -> (n_branch, n_paths) policy values
    rolled from the REALIZED date-i states; ``cond_at(i, ids_b)`` ->
    (n_branch, n_paths) values from one-step branches off date i-1.
    Both legs are branch-averaged (a single rollout injects a random
    walk into M whose running max blows the bound).  Returns the upper
    bound as a PriceResult.  Shared by the Vasicek/Hull-White/G2++
    swaption duals — the model supplies only the three closures."""
    ids = jnp.arange(n_paths, dtype=jnp.uint32)
    ids_b = (ids[None, :]
             + (jnp.arange(n_branch, dtype=jnp.uint32)[:, None]
                + jnp.uint32(1)) * jnp.uint32(1 << 22))
    m_t = jnp.zeros((n_paths,), jnp.float32)
    gap = jnp.full((n_paths,), -jnp.inf, jnp.float32)
    for i in range(n_ex):
        z_i = z_at(i)
        if i > 0:
            v_i = jnp.mean(v_at(i, ids_b), axis=0)
            cond = jnp.mean(cond_at(i, ids_b), axis=0)
            m_t = m_t + v_i - cond
        gap = jnp.maximum(gap, z_i - m_t)
    upper_gap = jnp.maximum(gap, 0.0)
    n = jnp.float32(n_paths)
    u_mean = jnp.sum(upper_gap) / n
    u_se = jnp.sqrt(jnp.maximum(
        jnp.sum(upper_gap * upper_gap) / n - u_mean * u_mean, 0.0) / n)
    return PriceResult(price=u_mean, stderr=u_se, n_paths=n,
                       payoff_mean=u_mean, payoff_var=u_se * u_se * n)


def _policy_machinery(spec, a, b, sigma_r, degree, betas, key):
    """(step_tenor, draws, policy_value) for frozen-policy rollouts.

    ``policy_value(i, r, y, ids, tag)`` is the value (discounted to 0)
    of the fitted policy from state (r, y) AT date i; rollout draws are
    keyed by (tag, date) under ``key``.  The exercise rule compares
    UNdiscounted intrinsics to the forward continuation fit — the same
    r-only policy `_fit_bermudan` fits.  Shared by the Andersen-Broadie
    dual and the Bermudan exposure surface."""
    from mc_tpu.models.rates_policy import (check_rollout_dates,
                                            frozen_policy_value)
    n_ex = spec.n_payments
    check_rollout_dates(n_ex)
    k0 = jnp.asarray(key[0], jnp.uint32)
    k1 = jnp.asarray(key[1], jnp.uint32)
    e1, big_b, l11, l21, l22 = _exact_xy_coeffs(
        a, sigma_r, jnp.float32(spec.tenor))

    def step_tenor(r, y, z0, z1):
        x = r - b
        y = y + b * jnp.float32(spec.tenor) + x * big_b \
            + (l21 * z0 + l22 * z1)
        return b + x * e1 + l11 * z0, y

    def draws(ids, tag, u):
        c1 = (jnp.full(ids.shape, 0, jnp.uint32)
              + jnp.uint32(tag) * jnp.uint32(64) + jnp.uint32(u))
        return rng.normal_pair(k0, k1, ids, c1)

    def policy_value(i, r, y, ids, tag):
        return frozen_policy_value(
            n_ex, i, (r, y), ids, tag, draws=draws,
            step=lambda st, zs: step_tenor(st[0], st[1], zs[0], zs[1]),
            exercise=lambda u, st: _swap_intrinsic(spec, a, b, sigma_r,
                                                   st[0], u),
            continuation=lambda u, st: _mm(_rate_basis(st[0], b, degree),
                                           betas[u]),
            cashflow=lambda u, ex, st: ex * jnp.exp(-st[1]))

    return step_tenor, draws, policy_value


@functools.partial(jax.jit,
                   static_argnames=("spec", "n_paths", "n_inner",
                                    "n_fit", "degree"))
def _bermudan_exposure_impl(spec, a, b, sigma_r, r0, n_paths, n_inner,
                            n_fit, degree, key_fit, key_outer,
                            key_inner):
    n_ex = spec.n_payments
    r_fit, y_fit = _simulate_rate_grid(spec, a, b, sigma_r, r0, n_fit,
                                       n_ex, key_fit)
    _, betas = _fit_bermudan(spec, a, b, sigma_r, r_fit, y_fit, degree)
    r_grid, y_grid = _simulate_rate_grid(spec, a, b, sigma_r, r0,
                                         n_paths, n_ex, key_outer)
    _, _, policy_value = _policy_machinery(spec, a, b, sigma_r, degree,
                                           betas, key_inner)
    ids = jnp.arange(n_paths, dtype=jnp.uint32)
    ids_b = (ids[None, :]
             + (jnp.arange(n_inner, dtype=jnp.uint32)[:, None]
                + jnp.uint32(1)) * jnp.uint32(1 << 22))
    alive = jnp.ones((n_paths,), bool)
    vals = []
    for i in range(n_ex):
        ex = _swap_intrinsic(spec, a, b, sigma_r, r_grid[i], i)
        if i < n_ex - 1:
            cont = _mm(_rate_basis(r_grid[i], b, degree), betas[i])
            take = jnp.logical_and(ex > 0.0, ex > cont)
        else:
            take = ex > 0.0
        # MtM at date i: mean of n_inner frozen-policy rollouts from
        # the realized state (exact — not the regression proxy — and
        # where the policy exercises AT i every rollout returns the
        # intrinsic, so those points carry zero rollout noise); 0 once
        # the position was exercised at an EARLIER date (cash settled,
        # it left the netting set)
        v_i = jnp.mean(policy_value(
            i, jnp.broadcast_to(r_grid[i], ids_b.shape),
            jnp.broadcast_to(y_grid[i], ids_b.shape), ids_b, tag=i),
            axis=0)
        vals.append(jnp.where(alive, v_i, 0.0))
        alive = jnp.logical_and(alive, jnp.logical_not(take))
    return jnp.stack(vals, axis=1)


def bermudan_swaption_exposure(spec: SwaptionSpec = DEMO_SWAPTION,
                               dyn: VasicekDynamics = DEMO_VASICEK,
                               sim: SimParams = SimParams(
                                   n_paths=4096, n_steps=1,
                                   n_paths_inner=16),
                               *,
                               r0: float = 0.05,
                               degree: int = 3,
                               n_fit: int = 16384,
                               seed: Optional[int] = None,
                               stream: int = STREAM_OUTER):
    """Counterparty exposure of a long BERMUDAN swaption position —
    the American-Monte-Carlo XVA object for rates.

    Two passes: the exercise policy is fitted on an ``n_fit``-path
    pilot set (the pricing LSMC's key convention), then on an
    independent outer set the position's MtM at every coupon date is
    re-priced by ``sim.n_paths_inner`` frozen-policy rollouts from the
    realized (r, ∫r) state.  Exercise ABSORBS: once the outer policy
    exercises, the cash settles and the position leaves the netting
    set, so later dates carry zero exposure — which makes the
    discounted EE profile a telescoping supermartingale: EE(t_i) =
    E[cash at i] + EE(t_{i+1}), hence nonincreasing with EE(t_0) equal
    to the Bermudan price (both gated).  Returns a
    `CollateralizedExposure` carrying the full XVA metric surface."""
    spec = spec.validate()
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}")
    if sim.n_paths > (1 << 22):
        raise ValueError(
            "bermudan_swaption_exposure shards rollout streams by "
            f"id + branch * 2^22: n_paths must be <= 2^22, got "
            f"{sim.n_paths}")
    d32 = dyn.as_f32()
    seed = sim.seed if seed is None else seed
    key_fit = jnp.asarray(rng.derive_key(seed, stream, 0x5A97),
                          jnp.uint32)
    key_outer = jnp.asarray(rng.derive_key(seed, stream, 0x5AE0),
                            jnp.uint32)
    key_inner = jnp.asarray(rng.derive_key(seed, stream, 0x5AE1),
                            jnp.uint32)
    values = _bermudan_exposure_impl(
        spec, jnp.float32(d32.a), jnp.float32(d32.b),
        jnp.float32(d32.sigma_r), jnp.float32(r0), sim.n_paths,
        sim.n_paths_inner, n_fit, degree, key_fit, key_outer, key_inner)
    from mc_tpu.xva import CollateralizedExposure, coupon_dates
    horizon = spec.expiry + (spec.n_payments - 1) * spec.tenor
    return CollateralizedExposure(
        values=values, t_horizon=jnp.float32(horizon),
        obs_dates=coupon_dates(spec.expiry, spec.tenor, spec.n_payments))


SWAP_CVA_GREEK_FIELDS = ("dv01", "vega_r", "kappa", "theta_b")


def swap_cva_greeks(spec: SwaptionSpec = DEMO_SWAPTION,
                    dyn: VasicekDynamics = DEMO_VASICEK,
                    sim: SimParams = SimParams(n_paths=1 << 16,
                                               n_steps=1),
                    *,
                    hazard_rate: float,
                    recovery: float = 0.4,
                    r0: float = 0.05,
                    which=("dv01", "vega_r"),
                    seed: Optional[int] = None,
                    stream: int = STREAM_OUTER):
    """d(swap CVA)/d(market) — the rates-desk XVA sensitivities.

    Forward-mode AD through the whole pipeline: exact rate grid, affine
    remaining-swap MtM, pathwise discounting, exposure positive part,
    default-leg integral.  Greek names follow `swaption_greeks`:
    dv01 = d/dr0, vega_r = d/dsigma_r, kappa = d/da, theta_b = d/db.
    Every EE point is a Jamshidian swaption price, so dv01/vega_r are
    gated against finite differences of the closed-form swaption-strip
    CVA (tests/test_swaption.py)."""
    import dataclasses as _dc

    spec = spec.validate()
    bad = set(which) - set(SWAP_CVA_GREEK_FIELDS)
    if bad:
        raise ValueError(f"unknown greeks {sorted(bad)}; available: "
                         f"{list(SWAP_CVA_GREEK_FIELDS)}")
    d32 = dyn.as_f32()
    fields = {"dv01": "r0", "vega_r": "sigma_r", "kappa": "a",
              "theta_b": "b"}

    def f(*vals):
        kw = {fields[g]: v for g, v in zip(which, vals)}
        rr = kw.pop("r0", jnp.float32(r0))
        d = _dc.replace(d32, **kw) if kw else d32
        e = swap_exposure(spec, d, sim, r0=rr, seed=seed, stream=stream)
        return e.cva(hazard_rate, recovery)

    base = {"r0": jnp.float32(r0), "sigma_r": jnp.float32(d32.sigma_r),
            "a": jnp.float32(d32.a), "b": jnp.float32(d32.b)}
    vals = [base[fields[g]] for g in which]
    out = {}
    for i, g in enumerate(which):
        tangents = [jnp.float32(1.0 if j == i else 0.0)
                    for j in range(len(vals))]
        _, dot = jax.jvp(f, vals, tangents)
        out[g] = dot
    return out


def _swaption_qmc_shift_fn(spec, a, b, sigma_r, r0, n, zvec):
    """shift -> per-shift sample mean for the 2-dim Vasicek Sobol net;
    shared by the single-chip and shift-sharded QMC programs."""

    from mc_tpu.qmc import _sobol_u

    ids = jnp.arange(n, dtype=jnp.uint32)
    e1, big_b, l11, l21, l22 = _exact_xy_coeffs(
        a, sigma_r, jnp.float32(spec.expiry))
    x0 = r0 - b

    def one_shift(shift):
        u0 = _sobol_u(ids, zvec, shift, jnp.int32(0))
        u1 = _sobol_u(ids, zvec, shift, jnp.int32(1))
        z0 = rng.inv_normal_cdf(u0)
        z1 = rng.inv_normal_cdf(u1)
        r = b + x0 * e1 + l11 * z0
        y = (b * jnp.float32(spec.expiry) + x0 * big_b
             + l21 * z0 + l22 * z1)
        pay = _swap_intrinsic(spec, a, b, sigma_r, r, 0) * jnp.exp(-y)
        return jnp.mean(pay)

    return one_shift


def _shift_means_result(means, n, n_shifts):
    price = jnp.mean(means)
    stderr = jnp.std(means, ddof=1) / jnp.sqrt(jnp.float32(n_shifts))
    return PriceResult(price=price, stderr=stderr,
                       n_paths=jnp.float32(n * n_shifts),
                       payoff_mean=price, payoff_var=stderr * stderr)


@functools.partial(jax.jit, static_argnames=("spec", "n", "n_shifts"))
def _swaption_qmc_impl(spec, a, b, sigma_r, r0, n, n_shifts, zvec,
                       shifts):
    one_shift = _swaption_qmc_shift_fn(spec, a, b, sigma_r, r0, n, zvec)
    return _shift_means_result(jax.vmap(one_shift)(shifts), n, n_shifts)


@functools.partial(jax.jit, static_argnames=("spec", "n", "n_shifts",
                                             "mesh"))
def _swaption_qmc_sharded_impl(spec, a, b, sigma_r, r0, n, n_shifts,
                               zvec, shifts, mesh):
    """Shift-sharded Vasicek-swaption QMC (the `price_qmc_sharded`
    layout): each chip runs the full point set for its shifts, so the
    result is BITWISE mesh-invariant."""
    from jax.sharding import PartitionSpec as P

    from mc_tpu.parallel.mesh import PATHS_AXIS

    def shard_fn(zvec, shifts_local, a, b, sigma_r, r0):
        one_shift = _swaption_qmc_shift_fn(spec, a, b, sigma_r, r0, n,
                                           zvec)
        means_local = jax.vmap(one_shift)(shifts_local)
        return jax.lax.all_gather(means_local, PATHS_AXIS, tiled=True)

    means = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(PATHS_AXIS), P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )(zvec, shifts, a, b, sigma_r, r0)
    return _shift_means_result(means, n, n_shifts)


def price_swaption_qmc(spec: SwaptionSpec = DEMO_SWAPTION,
                       dyn: VasicekDynamics = DEMO_VASICEK,
                       sim: SimParams = SimParams(n_paths=1 << 16,
                                                  n_steps=1),
                       *,
                       n_shifts: int = 16,
                       mesh=None,
                       r0: float = 0.05,
                       seed: Optional[int] = None,
                       stream: int = STREAM_OUTER) -> PriceResult:
    """Randomized-QMC European swaption: the exact draw is TWO
    dimensional ((r, int r) at expiry), the regime where Sobol nets
    earn their full O(1/N) rate — measured ~an-order-of-magnitude
    stderr reduction vs plain MC at equal budget (gated).  Digital
    shifts give the unbiased error estimate, as in `price_qmc`.

    ``mesh``: shard the SHIFT axis over a device mesh (n_shifts rounds
    up to a mesh multiple; BITWISE mesh-invariant).
    """
    import math as _math

    from mc_tpu.qmc import sobol_directions

    spec = spec.validate()
    if n_shifts < 2:
        raise ValueError("n_shifts >= 2 required for an error estimate")
    if mesh is not None:
        n_shards = mesh.devices.size
        n_shifts = -(-n_shifts // n_shards) * n_shards
    d32 = dyn.as_f32()
    seed = sim.seed if seed is None else seed
    n = 1 << min(int(_math.log2(max(sim.n_paths, 2))), 20)
    import numpy as _np
    zvec = jnp.asarray(sobol_directions(2).reshape(-1).astype(_np.int32))
    key = rng.derive_key(seed, stream, 0x51AD)
    sidx = jnp.arange(n_shifts * 2, dtype=jnp.uint32)
    bits, _ = rng.threefry2x32(jnp.uint32(key[0]), jnp.uint32(key[1]),
                               sidx, jnp.zeros_like(sidx))
    shifts = jax.lax.shift_right_logical(
        bits, jnp.uint32(2)).astype(jnp.int32).reshape(n_shifts, 2)
    if mesh is not None:
        return _swaption_qmc_sharded_impl(
            spec, jnp.float32(d32.a), jnp.float32(d32.b),
            jnp.float32(d32.sigma_r), jnp.float32(r0), n, n_shifts,
            zvec, shifts, mesh)
    return _swaption_qmc_impl(spec, jnp.float32(d32.a),
                              jnp.float32(d32.b),
                              jnp.float32(d32.sigma_r), jnp.float32(r0),
                              n, n_shifts, zvec, shifts)


@functools.partial(jax.jit,
                   static_argnames=("spec", "n", "n_shifts", "n_fit",
                                    "degree"))
def _bermudan_qmc_impl(spec, a, b, sigma_r, r0, n, n_shifts, n_fit,
                       degree, zvec, shifts, key_fit):
    """Frozen-policy randomized-QMC Bermudan: fit the LSMC policy on a
    plain-MC pilot set (same stream convention as the pricing LSMC),
    then price THAT policy on a 2*n_ex-dimensional Sobol net — the
    whole exact date grid is the integrand's domain, two exact (r, ∫r)
    coordinates per exercise date.  The estimate is the value of the
    fitted policy (a Bermudan lower bound, like the plain LSMC's
    out-of-sample pass), with QMC's variance decay on top.  n_ex = 1
    degenerates BITWISE to `price_swaption_qmc` (same net, same shift
    stream, policy pinned to exercise-if-ITM)."""
    n_ex = spec.n_payments
    r_grid, y_grid = _simulate_rate_grid(spec, a, b, sigma_r, r0,
                                         n_fit, n_ex, key_fit)
    _, betas = _fit_bermudan(spec, a, b, sigma_r, r_grid, y_grid,
                             degree)
    one_shift = _bermudan_qmc_shift_fn(spec, a, b, sigma_r, r0, n,
                                       degree, zvec, betas)
    means = jax.vmap(one_shift)(shifts)
    price = jnp.mean(means)
    stderr = jnp.std(means, ddof=1) / jnp.sqrt(jnp.float32(n_shifts))
    return PriceResult(price=price, stderr=stderr,
                       n_paths=jnp.float32(n * n_shifts),
                       payoff_mean=price, payoff_var=stderr * stderr)


def _bermudan_qmc_shift_fn(spec, a, b, sigma_r, r0, n, degree, zvec,
                           betas):
    """shift -> frozen-policy per-shift mean on the full date-grid
    Sobol net; shared by the single-chip and shift-sharded programs."""

    from mc_tpu.qmc import _sobol_u

    n_ex = spec.n_payments
    ids = jnp.arange(n, dtype=jnp.uint32)
    coeffs = [_exact_xy_coeffs(a, sigma_r,
                               jnp.float32(spec.expiry if i == 0
                                           else spec.tenor))
              for i in range(n_ex)]
    dts = [jnp.float32(spec.expiry if i == 0 else spec.tenor)
           for i in range(n_ex)]

    def one_shift(shift):
        def zdim(j):
            return rng.inv_normal_cdf(
                _sobol_u(ids, zvec, shift, jnp.int32(j)))

        x = jnp.zeros((n,), jnp.float32) + (r0 - b)
        y = jnp.zeros((n,), jnp.float32)
        cf = jnp.zeros((n,), jnp.float32)
        done = jnp.zeros((n,), bool)
        for i in range(n_ex):
            z0, z1 = zdim(2 * i), zdim(2 * i + 1)
            e1, big_b, l11, l21, l22 = coeffs[i]
            # summation order mirrors _swaption_qmc_impl exactly, so
            # n_ex=1 is BITWISE the European QMC (y starts at 0; +0.0
            # is exact)
            y = y + b * dts[i] + x * big_b + l21 * z0 + l22 * z1
            r = b + x * e1 + l11 * z0
            x = x * e1 + l11 * z0
            ex = _swap_intrinsic(spec, a, b, sigma_r, r, i)
            if i < n_ex - 1:
                cont = _mm(_rate_basis(r, b, degree), betas[i])
                take = jnp.logical_and(ex > 0.0, ex > cont)
            else:
                take = ex > 0.0
            take = jnp.logical_and(take, jnp.logical_not(done))
            cf = jnp.where(take, ex * jnp.exp(-y), cf)
            done = jnp.logical_or(done, take)
        return jnp.mean(cf)

    return one_shift


@functools.partial(jax.jit,
                   static_argnames=("spec", "n", "n_shifts", "n_fit",
                                    "degree", "mesh"))
def _bermudan_qmc_sharded_impl(spec, a, b, sigma_r, r0, n, n_shifts,
                               n_fit, degree, zvec, shifts, key_fit,
                               mesh):
    """Shift-sharded frozen-policy QMC Bermudan: the pilot fit is
    REPLICATED (same key -> identical betas on every chip), the shift
    axis shards over the mesh, each chip runs the FULL point set for
    its shifts — so the per-shift means are mesh-size invariant and the
    construction scales the shift budget linearly like the European
    `_swaption_qmc_sharded_impl`."""
    from jax.sharding import PartitionSpec as P

    from mc_tpu.parallel.mesh import PATHS_AXIS

    n_ex = spec.n_payments
    r_grid, y_grid = _simulate_rate_grid(spec, a, b, sigma_r, r0,
                                         n_fit, n_ex, key_fit)
    _, betas = _fit_bermudan(spec, a, b, sigma_r, r_grid, y_grid,
                             degree)

    def shard_fn(zvec, shifts_local, a, b, sigma_r, r0, betas):
        one_shift = _bermudan_qmc_shift_fn(spec, a, b, sigma_r, r0, n,
                                           degree, zvec, betas)
        means_local = jax.vmap(one_shift)(shifts_local)
        return jax.lax.all_gather(means_local, PATHS_AXIS, tiled=True)

    means = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(PATHS_AXIS), P(), P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )(zvec, shifts, a, b, sigma_r, r0, betas)
    price = jnp.mean(means)
    stderr = jnp.std(means, ddof=1) / jnp.sqrt(jnp.float32(n_shifts))
    return PriceResult(price=price, stderr=stderr,
                       n_paths=jnp.float32(n * n_shifts),
                       payoff_mean=price, payoff_var=stderr * stderr)


def price_bermudan_swaption_qmc(spec: SwaptionSpec = DEMO_SWAPTION,
                                dyn: VasicekDynamics = DEMO_VASICEK,
                                sim: SimParams = SimParams(
                                    n_paths=1 << 14, n_steps=1),
                                *,
                                n_shifts: int = 16,
                                n_fit: int = 16384,
                                degree: int = 3,
                                r0: float = 0.05,
                                mesh=None,
                                seed: Optional[int] = None,
                                stream: int = STREAM_OUTER
                                ) -> PriceResult:
    """Randomized-QMC Bermudan swaption (frozen fitted policy).

    Two-pass: the exercise policy is fitted by the plain-MC LSMC on
    ``n_fit`` pilot paths (key convention of `price_bermudan_swaption`),
    then priced OUT-OF-SAMPLE on a digitally-shifted Sobol net over the
    full 2*n_payments-dimensional date grid.  Returns the policy's
    value — a Bermudan lower bound whose QMC stderr is typically an
    order of magnitude under the plain LSMC's at equal budget.

    ``mesh``: shard the SHIFT axis over a device mesh (n_shifts rounds
    up to a mesh multiple; the pilot fit replicates with identical
    betas, each chip runs the full point set for its shifts — the
    per-shift means are mesh-size invariant)."""
    import math as _math

    import numpy as _np

    from mc_tpu.qmc import sobol_directions

    spec = spec.validate()
    if n_shifts < 2:
        raise ValueError("n_shifts >= 2 required for an error estimate")
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}")
    d32 = dyn.as_f32()
    seed = sim.seed if seed is None else seed
    if mesh is not None:
        n_shards = mesh.devices.size
        n_shifts = -(-n_shifts // n_shards) * n_shards
    n = 1 << min(int(_math.log2(max(sim.n_paths, 2))), 20)
    d = 2 * spec.n_payments
    zvec = jnp.asarray(sobol_directions(d).reshape(-1).astype(_np.int32))
    key = rng.derive_key(seed, stream, 0x51AD)
    key_fit = jnp.asarray(rng.derive_key(seed, stream, 0x5A97),
                          jnp.uint32)
    sidx = jnp.arange(n_shifts * d, dtype=jnp.uint32)
    bits, _ = rng.threefry2x32(jnp.uint32(key[0]), jnp.uint32(key[1]),
                               sidx, jnp.zeros_like(sidx))
    shifts = jax.lax.shift_right_logical(
        bits, jnp.uint32(2)).astype(jnp.int32).reshape(n_shifts, d)
    if mesh is not None:
        return _bermudan_qmc_sharded_impl(
            spec, jnp.float32(d32.a), jnp.float32(d32.b),
            jnp.float32(d32.sigma_r), jnp.float32(r0), n, n_shifts,
            n_fit, degree, zvec, shifts, key_fit, mesh)
    return _bermudan_qmc_impl(spec, jnp.float32(d32.a),
                              jnp.float32(d32.b),
                              jnp.float32(d32.sigma_r), jnp.float32(r0),
                              n, n_shifts, n_fit, degree, zvec, shifts,
                              key_fit)


@functools.partial(jax.jit,
                   static_argnames=("spec", "n_paths", "degree",
                                    "n_branch"))
def _bermudan_bounds_impl(spec, a, b, sigma_r, r0, n_paths, degree,
                          n_branch, key, key_dual):
    """Andersen-Broadie bracket on the exact date grid.

    Lower: the LSMC cashflow estimate.  Upper: the duality gap of the
    SAME fitted policy — martingale increments V(X_{i}) - E[V(X_i)|
    X_{i-1}] from policy rollouts (fresh draws, n_branch one-step
    branches for the conditional), upper = E[max_i (Z_i - M_i)].
    Inner-noise only INFLATES the upper bound (conservative)."""
    n_ex = spec.n_payments
    r_grid, y_grid = _simulate_rate_grid(spec, a, b, sigma_r, r0,
                                         n_paths, n_ex, key)
    cf, betas = _fit_bermudan(spec, a, b, sigma_r, r_grid, y_grid,
                              degree)
    n = jnp.float32(n_paths)
    lower = summarize(jnp.sum(cf), jnp.sum(cf * cf), n, 1.0)

    step_tenor, draws, policy_value = _policy_machinery(
        spec, a, b, sigma_r, degree, betas, key_dual)

    def z_at(i):
        return (_swap_intrinsic(spec, a, b, sigma_r, r_grid[i], i)
                * jnp.exp(-y_grid[i]))

    def v_at(i, ids_b):
        # V(X_i): fresh rollouts from the realized state
        return policy_value(
            i, jnp.broadcast_to(r_grid[i], ids_b.shape),
            jnp.broadcast_to(y_grid[i], ids_b.shape), ids_b, tag=3 * i)

    def cond_at(i, ids_b):
        # E[V(X_i) | X_{i-1}]: one-step branches off date i-1
        zb0, zb1 = draws(ids_b, 3 * i + 1, 63)
        rb, yb = step_tenor(
            jnp.broadcast_to(r_grid[i - 1], ids_b.shape),
            jnp.broadcast_to(y_grid[i - 1], ids_b.shape), zb0, zb1)
        return policy_value(i, rb, yb, ids_b, tag=3 * i + 2)

    upper = _ab_bracket(n_ex, n_paths, n_branch, z_at, v_at, cond_at)
    return lower, upper


def bermudan_swaption_bounds(spec: SwaptionSpec = DEMO_SWAPTION,
                             dyn: VasicekDynamics = DEMO_VASICEK,
                             sim: SimParams = SimParams(n_paths=4096,
                                                        n_steps=1),
                             *,
                             r0: float = 0.05,
                             degree: int = 3,
                             n_branch: int = 32,
                             seed: Optional[int] = None,
                             stream: int = STREAM_OUTER):
    """(lower, upper) PriceResults bracketing the Bermudan swaption:
    LSMC lower bound + Andersen-Broadie dual upper bound from the SAME
    fitted policy (rates analogue of `lsmc.american_bounds_family`).
    The true price lies in [lower - 3se, upper + 3se]; the gap measures
    policy quality and shrinks with the basis degree."""
    spec = spec.validate()
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}")
    if n_branch < 2:
        raise ValueError(f"n_branch must be >= 2, got {n_branch}")
    if sim.n_paths > (1 << 22):
        raise ValueError(
            "bermudan_swaption_bounds shards branch streams by "
            f"id + branch * 2^22: n_paths must be <= 2^22, got "
            f"{sim.n_paths}")
    d32 = dyn.as_f32()
    seed = sim.seed if seed is None else seed
    key = jnp.asarray(rng.derive_key(seed, stream, 0x5A97), jnp.uint32)
    kd = jnp.asarray(rng.derive_key(seed, stream, 0x5A99), jnp.uint32)
    return _bermudan_bounds_impl(spec, jnp.float32(d32.a),
                                 jnp.float32(d32.b),
                                 jnp.float32(d32.sigma_r),
                                 jnp.float32(r0), sim.n_paths, degree,
                                 n_branch, key, kd)
