"""G2++ two-factor Gaussian rates, fitted to an input discount curve.

r(t) = x(t) + y(t) + phi(t);  dx = -a x dt + sigma dW1,
dy = -b y dt + eta dW2,  d<W1, W2> = rho dt;  phi(t) reprices the input
curve exactly (never materialized — the same r = factors + alpha
decomposition as `models.hullwhite`, one more factor).  Two factors buy
what one cannot express: IMPERFECTLY correlated forward rates, so
spread/curve exposures and Bermudans see de-correlation risk.

Everything is exact-in-law on the coupon date grid: (x, y, z = int x+y)
over a step is jointly Gaussian with closed-form conditional moments,
simulated through a host-f64 3x3 Cholesky per step size.  Bonds
reconstruct as P(t,S) = (P(0,S)/P(0,t)) exp(A(t,S) - B_a x - B_b y)
with A = (V(S-t) - V(S) + V(t))/2 — the FULL exponent (the one-factor
module documents what omitting its shift term costs); discounting is
P(0,t) exp(-z - V(t)/2), so E[discount] == P(0,t) identically.

Oracle: `oracle.g2_swaption` — conditional-Jamshidian semi-closed form
(root-find in y given x, kink-robust trapezoid over x), gated against
`hw_swaption` to ~3e-7 in the eta -> 0 limit and payer/receiver-parity
exact.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mc_tpu import rng
from mc_tpu.config import SimParams
from mc_tpu.engines import STREAM_OUTER
from mc_tpu.models.hullwhite import DEMO_CURVE, DiscountCurve
from mc_tpu.models.swaption import DEMO_SWAPTION, SwaptionSpec
from mc_tpu.oracle import PriceResult, summarize

__all__ = ["G2Dynamics", "price_g2_swaption",
           "price_bermudan_g2_swaption", "bermudan_g2_swaption_bounds",
           "bermudan_g2_swaption_exposure", "price_g2_swaption_sharded",
           "g2_swap_exposure", "g2_swap_book_exposure",
           "g2_swap_cva_greeks", "g2_swaption_greeks",
           "g2_swaption_bucket_dv01",
           "price_g2_swaption_qmc",
           "price_bermudan_g2_swaption_qmc", "DEMO_G2"]


def _mm(a, b):
    """float32 product at full precision: a GPU would otherwise run it in
    TF32, which keeps about three decimal digits."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


@dataclasses.dataclass(frozen=True)
class G2Dynamics:
    """Two-factor parameters (host floats; all grid quantities are
    precomputed in float64 and shipped as f32 constants)."""

    a: float = 0.5
    sigma: float = 0.01
    b_mr: float = 0.05
    eta: float = 0.008
    rho: float = -0.7

    def validate(self) -> "G2Dynamics":
        if not (self.a > 0.0 and self.b_mr > 0.0):
            raise ValueError(
                f"mean reversions must be > 0, got (a={self.a}, "
                f"b_mr={self.b_mr})")
        if self.sigma < 0.0 or self.eta < 0.0:
            raise ValueError(f"vols must be >= 0, got (sigma="
                             f"{self.sigma}, eta={self.eta})")
        if not -1.0 <= self.rho <= 1.0:
            raise ValueError(f"rho must be in [-1, 1], got {self.rho}")
        return self


DEMO_G2 = G2Dynamics()


def _bf(k, t):
    return -math.expm1(-k * t) / k


def _v_of(dyn: G2Dynamics, t: float) -> float:
    """Var[int_0^t (x + y)] (closed form)."""
    a, s, b, e, rho = dyn.a, dyn.sigma, dyn.b_mr, dyn.eta, dyn.rho
    return ((s * s / (a * a)) * (t - 2 * _bf(a, t)
                                 - math.expm1(-2 * a * t) / (2 * a))
            + (e * e / (b * b)) * (t - 2 * _bf(b, t)
                                   - math.expm1(-2 * b * t) / (2 * b))
            + (2 * rho * s * e / (a * b))
            * (t - _bf(a, t) - _bf(b, t)
               - math.expm1(-(a + b) * t) / (a + b)))


def _step_chol(dyn: G2Dynamics, dt: float):
    """Host-f64 step constants: decay factors, integration loads, and
    the 3x3 Cholesky of the (eps_x, eps_y, eps_z) noise covariance."""
    a, s, b, e, rho = dyn.a, dyn.sigma, dyn.b_mr, dyn.eta, dyn.rho
    ba, bb = _bf(a, dt), _bf(b, dt)
    bab = _bf(a + b, dt)
    cxx = s * s * (-math.expm1(-2 * a * dt)) / (2 * a)
    cyy = e * e * (-math.expm1(-2 * b * dt)) / (2 * b)
    cxy = rho * s * e * (-math.expm1(-(a + b) * dt)) / (a + b)
    cxz = (s * s / a) * (ba - (-math.expm1(-2 * a * dt)) / (2 * a)) \
        + (rho * s * e / b) * (ba - bab)
    cyz = (e * e / b) * (bb - (-math.expm1(-2 * b * dt)) / (2 * b)) \
        + (rho * s * e / a) * (bb - bab)
    czz = _v_of(dyn, dt)
    cov = np.array([[cxx, cxy, cxz],
                    [cxy, cyy, cyz],
                    [cxz, cyz, czz]], np.float64)
    cov += 1e-12 * np.trace(cov) / 3.0 * np.eye(3)
    chol = np.linalg.cholesky(cov)
    return (math.exp(-a * dt), math.exp(-b * dt), ba, bb, chol)


def _g2_tables(spec: SwaptionSpec, dyn: G2Dynamics,
               curve: DiscountCurve):
    """p0[i], vhalf[i] = V(t_i)/2, and per-(i, j) bond constants:
    amat[i, j] = (V(t_j - t_i) - V(t_j) + V(t_i))/2, ba/bb loads."""
    dyn.validate()
    n = spec.n_payments
    dates = [spec.expiry + i * spec.tenor for i in range(n + 1)]
    p0 = np.array([curve.df(t) for t in dates], np.float64)
    vhalf = np.array([0.5 * _v_of(dyn, t) for t in dates], np.float64)
    amat = np.zeros((n + 1, n + 1), np.float64)
    bamat = np.zeros((n + 1, n + 1), np.float64)
    bbmat = np.zeros((n + 1, n + 1), np.float64)
    for i in range(n + 1):
        for j in range(i + 1, n + 1):
            tau = dates[j] - dates[i]
            amat[i, j] = 0.5 * (_v_of(dyn, tau) - _v_of(dyn, dates[j])
                                + _v_of(dyn, dates[i]))
            bamat[i, j] = _bf(dyn.a, tau)
            bbmat[i, j] = _bf(dyn.b_mr, tau)
    return p0, vhalf, amat, bamat, bbmat


def _simulate_g2_grid(spec, dyn, n_paths, n_ex, key, path_offset=0):
    """(x, y, z) at the n_ex coupon dates — exact joint Gaussian steps.

    Draw convention: date u of GLOBAL path i consumes the threefry pair
    (i, 2u) plus one inverse-CDF normal at (i, 2u+1); ``path_offset``
    keys sharded entries by global id so sharding never changes the
    draws."""
    k0 = jnp.asarray(key[0], jnp.uint32)
    k1 = jnp.asarray(key[1], jnp.uint32)
    ids = (jnp.asarray(path_offset, jnp.uint32)
           + jnp.arange(n_paths, dtype=jnp.uint32))
    x = jnp.zeros((n_paths,), jnp.float32)
    y = jnp.zeros((n_paths,), jnp.float32)
    z = jnp.zeros((n_paths,), jnp.float32)
    outs = []
    for u in range(n_ex):
        dt = spec.expiry if u == 0 else spec.tenor
        e1, e2, ba, bb, ch = _step_chol(dyn, dt)
        c1 = jnp.full(ids.shape, 2 * u, jnp.uint32)
        w0, w1 = rng.normal_pair(k0, k1, ids, c1)
        bits, _ = rng.threefry2x32(k0, k1, ids, c1 + jnp.uint32(1),
                                   rounds=rng.DEFAULT_ROUNDS)
        w2 = rng.inv_normal_cdf(rng.bits_to_unit(bits))
        ex = jnp.float32(ch[0, 0]) * w0
        ey = jnp.float32(ch[1, 0]) * w0 + jnp.float32(ch[1, 1]) * w1
        ez = (jnp.float32(ch[2, 0]) * w0 + jnp.float32(ch[2, 1]) * w1
              + jnp.float32(ch[2, 2]) * w2)
        z = z + x * jnp.float32(ba) + y * jnp.float32(bb) + ez
        x = x * jnp.float32(e1) + ex
        y = y * jnp.float32(e2) + ey
        outs.append((x, y, z))
    return outs


def _g2_mtm(spec, i, x, y, p0, amat, bamat, bbmat):
    """SIGNED remaining-swap value at date i (payments i+1..N)."""
    n = spec.n_payments
    fixed = jnp.zeros_like(x)
    for j in range(i + 1, n + 1):
        p_ij = (jnp.float32(p0[j] / p0[i])
                * jnp.exp(jnp.float32(amat[i, j])
                          - jnp.float32(bamat[i, j]) * x
                          - jnp.float32(bbmat[i, j]) * y))
        fixed = fixed + jnp.float32(spec.k_rate * spec.tenor) * p_ij
        if j == n:
            fixed = fixed + p_ij
    mtm = 1.0 - fixed
    if not spec.payer:
        mtm = -mtm
    return mtm


def _g2_mtm_multicurve(spec, i, x, y, p0, amat, bamat, bbmat, const,
                       wvec):
    """SIGNED multi-curve remaining-swap value at date i (the
    hullwhite._hw_mc_weights algebra with two-factor bonds)."""
    n = spec.n_payments
    v = jnp.zeros_like(x) + jnp.float32(const[i])
    for j in range(i + 1, n + 1):
        p_ij = (jnp.float32(p0[j] / p0[i])
                * jnp.exp(jnp.float32(amat[i, j])
                          - jnp.float32(bamat[i, j]) * x
                          - jnp.float32(bbmat[i, j]) * y))
        v = v + jnp.float32(wvec[j]) * p_ij
    if not spec.payer:
        v = -v
    return v


@functools.partial(jax.jit, static_argnames=("spec", "dyn", "n_paths"))
def _g2_european_mc_impl(spec, dyn, n_paths, key, consts, weights):
    p0, vhalf, amat, bamat, bbmat = consts
    const, wvec = weights
    (x, y, z), = _simulate_g2_grid(spec, dyn, n_paths, 1, key)
    v = _g2_mtm_multicurve(spec, 0, x, y, p0, amat, bamat, bbmat,
                           const, wvec)
    pay = (jnp.maximum(v, 0.0) * jnp.float32(p0[0])
           * jnp.exp(-z - jnp.float32(vhalf[0])))
    n = jnp.float32(n_paths)
    return summarize(jnp.sum(pay), jnp.sum(pay * pay), n, 1.0)


@functools.partial(jax.jit, static_argnames=("spec", "dyn", "n_paths"))
def _g2_exposure_mc_impl(spec, dyn, n_paths, key, consts, weights):
    p0, vhalf, amat, bamat, bbmat = consts
    const, wvec = weights
    n_ex = spec.n_payments
    grid = _simulate_g2_grid(spec, dyn, n_paths, n_ex, key)
    vals = []
    for i, (x, y, z) in enumerate(grid):
        mtm = _g2_mtm_multicurve(spec, i, x, y, p0, amat, bamat, bbmat,
                                 const, wvec)
        vals.append(mtm * jnp.float32(p0[i])
                    * jnp.exp(-z - jnp.float32(vhalf[i])))
    return jnp.stack(vals, axis=1)


@functools.partial(jax.jit, static_argnames=("spec", "dyn", "n_paths"))
def _g2_european_impl(spec, dyn, n_paths, key, consts):
    p0, vhalf, amat, bamat, bbmat = consts
    (x, y, z), = _simulate_g2_grid(spec, dyn, n_paths, 1, key)
    pay = (jnp.maximum(_g2_mtm(spec, 0, x, y, p0, amat, bamat, bbmat),
                       0.0)
           * jnp.float32(p0[0]) * jnp.exp(-z - jnp.float32(vhalf[0])))
    n = jnp.float32(n_paths)
    return summarize(jnp.sum(pay), jnp.sum(pay * pay), n, 1.0)


def price_g2_swaption(spec: SwaptionSpec = DEMO_SWAPTION,
                      dyn: G2Dynamics = DEMO_G2,
                      curve: DiscountCurve = DEMO_CURVE,
                      sim: SimParams = SimParams(n_paths=1 << 20,
                                                 n_steps=1),
                      *,
                      projection_curve: Optional[DiscountCurve] = None,
                      seed: Optional[int] = None,
                      stream: int = STREAM_OUTER) -> PriceResult:
    """European payer/receiver swaption under curve-fitted G2++: ONE
    exact (x, y, int) draw at expiry, curve-reconstructed two-factor
    bonds, pathwise curve discounting.  Oracle: `oracle.g2_swaption`.

    ``projection_curve``: MULTI-CURVE — forwards off this curve,
    discounting off ``curve``; oracle `oracle.g2_swaption_multicurve`
    (direct 2-D quadrature)."""
    spec = spec.validate()
    consts = _g2_tables(spec, dyn, curve)
    seed = sim.seed if seed is None else seed
    key = jnp.asarray(rng.derive_key(seed, stream, 0x6270), jnp.uint32)
    if projection_curve is not None:
        from mc_tpu.models.hullwhite import _hw_mc_weights
        weights = _hw_mc_weights(spec, curve, projection_curve)
        return _g2_european_mc_impl(spec, dyn, sim.n_paths, key,
                                    consts, weights)
    return _g2_european_impl(spec, dyn, sim.n_paths, key, consts)


def _g2_basis(x, y, sx, sy, degree: int):
    """Two-factor continuation basis: monomials of x-hat up to
    ``degree`` augmented with the second factor's regressors
    (y-hat, y-hat^2, x-hat*y-hat) — the (S, v) Heston-LSMC design
    pattern applied to the rate factors."""
    xn, yn = x / sx, y / sy
    cols = [jnp.ones_like(x)]
    pw = xn
    for _ in range(degree):
        cols.append(pw)
        pw = pw * xn
    cols += [yn, yn * yn, xn * yn]
    return jnp.stack(cols, axis=-1)


def _fit_g2_bermudan(spec, dyn, grid, degree, consts):
    """Backward LSMC on the coupon grid under two-factor rates:
    realized discounted-to-0 cashflows AND per-date betas — the
    continuation regression runs on the (x, y) state (cross-augmented
    basis), date-i forward-value convention."""
    p0, vhalf, amat, bamat, bbmat = consts
    n_ex = spec.n_payments
    sx = dyn.sigma / math.sqrt(2.0 * dyn.a)    # stationary stds
    sy = dyn.eta / math.sqrt(2.0 * dyn.b_mr)

    def ex_at(i):
        x, y, _ = grid[i]
        return jnp.maximum(_g2_mtm(spec, i, x, y, p0, amat, bamat,
                                   bbmat), 0.0)

    def disc(i):
        return (jnp.float32(p0[i])
                * jnp.exp(-grid[i][2] - jnp.float32(vhalf[i])))

    cf = ex_at(n_ex - 1) * jnp.float32(p0[n_ex - 1]) * jnp.exp(
        -grid[n_ex - 1][2] - jnp.float32(vhalf[n_ex - 1]))
    betas = [None] * max(n_ex - 1, 0)
    for i in range(n_ex - 2, -1, -1):
        x, y, _ = grid[i]
        ex = ex_at(i)
        itm = ex > 0.0
        xb = _g2_basis(x, y, jnp.float32(sx), jnp.float32(sy), degree)
        w = jnp.where(itm, 1.0, 0.0)[:, None]
        xtx = _mm((xb * w).T, xb) + 1e-6 * jnp.eye(xb.shape[1],
                                               dtype=xb.dtype)
        xty = _mm((xb * w).T, cf / disc(i))
        beta = jax.lax.stop_gradient(jnp.linalg.solve(xtx, xty))
        betas[i] = beta
        cont = _mm(xb, beta)
        take = jnp.logical_and(itm, ex > cont)
        cf = jnp.where(take,
                       ex * jnp.float32(p0[i])
                       * jnp.exp(-grid[i][2] - jnp.float32(vhalf[i])),
                       cf)
    return cf, betas


@functools.partial(jax.jit, static_argnames=("spec", "dyn", "n_paths",
                                             "degree"))
def _g2_bermudan_impl(spec, dyn, n_paths, degree, key, consts):
    """n_payments = 1 is BITWISE the European pricer."""
    grid = _simulate_g2_grid(spec, dyn, n_paths, spec.n_payments, key)
    cf, _ = _fit_g2_bermudan(spec, dyn, grid, degree, consts)
    n = jnp.float32(n_paths)
    return summarize(jnp.sum(cf), jnp.sum(cf * cf), n, 1.0)


def _g2_swaption_sharded_impl(spec, dyn, n_paths, degree, style, mesh,
                              key, consts):
    from jax.sharding import PartitionSpec as P

    from mc_tpu.parallel.mesh import PATHS_AXIS

    p0, vhalf, amat, bamat, bbmat = consts
    n_shards = mesh.devices.size
    n_local = -(-n_paths // n_shards)
    n_ex = 1 if style == "european" else spec.n_payments
    sx = dyn.sigma / math.sqrt(2.0 * dyn.a)
    sy = dyn.eta / math.sqrt(2.0 * dyn.b_mr)

    def shard_fn(key):
        rank = jax.lax.axis_index(PATHS_AXIS).astype(jnp.uint32)
        off = rank * jnp.uint32(n_local)
        mask = (off + jnp.arange(n_local, dtype=jnp.uint32)
                < jnp.uint32(n_paths))
        grid = _simulate_g2_grid(spec, dyn, n_local, n_ex, key, off)

        def ex_at(i):
            x, y, _ = grid[i]
            return jnp.maximum(_g2_mtm(spec, i, x, y, p0, amat, bamat,
                                       bbmat), 0.0)

        def dfac(i):
            return (jnp.float32(p0[i])
                    * jnp.exp(-grid[i][2] - jnp.float32(vhalf[i])))

        cf = ex_at(n_ex - 1) * dfac(n_ex - 1)
        if style == "bermudan":
            for i in range(n_ex - 2, -1, -1):
                x, y, _ = grid[i]
                ex = ex_at(i)
                itm = jnp.logical_and(ex > 0.0, mask)
                xb = _g2_basis(x, y, jnp.float32(sx), jnp.float32(sy),
                               degree)
                w = jnp.where(itm, 1.0, 0.0)[:, None]
                xtx = (jax.lax.psum(_mm((xb * w).T, xb), PATHS_AXIS)
                       + 1e-6 * jnp.eye(xb.shape[1], dtype=xb.dtype))
                xty = jax.lax.psum(_mm((xb * w).T, cf / dfac(i)),
                                   PATHS_AXIS)
                beta = jax.lax.stop_gradient(
                    jnp.linalg.solve(xtx, xty))
                cont = _mm(xb, beta)
                take = jnp.logical_and(itm, ex > cont)
                cf = jnp.where(take, ex * dfac(i), cf)
        cf = jnp.where(mask, cf, 0.0)
        return (jax.lax.psum(jnp.sum(cf), PATHS_AXIS),
                jax.lax.psum(jnp.sum(cf * cf), PATHS_AXIS))

    s, sq = jax.shard_map(shard_fn, mesh=mesh, in_specs=(P(),),
                          out_specs=P(), check_vma=False)(key)
    return summarize(s, sq, jnp.float32(n_paths), 1.0)


def price_g2_swaption_sharded(spec: SwaptionSpec = DEMO_SWAPTION,
                              dyn: G2Dynamics = DEMO_G2,
                              curve: DiscountCurve = DEMO_CURVE,
                              sim: SimParams = SimParams(
                                  n_paths=1 << 20, n_steps=1),
                              *,
                              mesh=None,
                              style: str = "european",
                              degree: int = 3,
                              seed: Optional[int] = None,
                              stream: int = STREAM_OUTER
                              ) -> PriceResult:
    """European or Bermudan two-factor curve swaption sharded over the
    mesh: global-id streams, psum'd normal equations on the (x, y)
    basis.  A 1-device mesh simulates the identical path set; the mean
    agrees with the single-chip pricer up to XLA reduction order
    (gated <= 1e-5 relative — the two-factor per-path value chains
    more f32 ops than the one-factor model's ~3e-7)."""
    from mc_tpu.parallel.mesh import make_mesh

    spec = spec.validate()
    if style not in ("european", "bermudan"):
        raise ValueError(f"style must be european|bermudan, got {style!r}")
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}")
    mesh = make_mesh() if mesh is None else mesh
    consts = _g2_tables(spec, dyn, curve)
    seed = sim.seed if seed is None else seed
    key = jnp.asarray(rng.derive_key(seed, stream, 0x6270), jnp.uint32)
    return _g2_swaption_sharded_impl(spec, dyn, sim.n_paths, degree,
                                     style, mesh, key, consts)


def _g2_qmc_shift_fn(spec, dyn, n, zvec, consts):
    """shift -> per-shift sample mean for the 3-dim G2 Sobol net; the
    shared body of the single-chip and shift-sharded QMC programs."""

    from mc_tpu.qmc import _sobol_u

    p0, vhalf, amat, bamat, bbmat = consts
    ids = jnp.arange(n, dtype=jnp.uint32)
    _, _, _, _, ch = _step_chol(dyn, spec.expiry)

    def one_shift(shift):
        def zdim(j):
            return rng.inv_normal_cdf(
                _sobol_u(ids, zvec, shift, jnp.int32(j)))

        w0, w1, w2 = zdim(0), zdim(1), zdim(2)
        x = jnp.float32(ch[0, 0]) * w0
        y = jnp.float32(ch[1, 0]) * w0 + jnp.float32(ch[1, 1]) * w1
        z = (jnp.float32(ch[2, 0]) * w0 + jnp.float32(ch[2, 1]) * w1
             + jnp.float32(ch[2, 2]) * w2)
        pay = (jnp.maximum(_g2_mtm(spec, 0, x, y, p0, amat, bamat,
                                   bbmat), 0.0)
               * jnp.float32(p0[0]) * jnp.exp(-z - jnp.float32(vhalf[0])))
        return jnp.mean(pay)

    return one_shift


def _g2_qmc_result(means, n, n_shifts):
    price = jnp.mean(means)
    stderr = jnp.std(means, ddof=1) / jnp.sqrt(jnp.float32(n_shifts))
    return PriceResult(price=price, stderr=stderr,
                       n_paths=jnp.float32(n * n_shifts),
                       payoff_mean=price, payoff_var=stderr * stderr)


@functools.partial(jax.jit, static_argnames=("spec", "dyn", "n",
                                             "n_shifts"))
def _g2_qmc_impl(spec, dyn, n, n_shifts, zvec, shifts, consts):
    one_shift = _g2_qmc_shift_fn(spec, dyn, n, zvec, consts)
    return _g2_qmc_result(jax.vmap(one_shift)(shifts), n, n_shifts)


@functools.partial(jax.jit, static_argnames=("spec", "dyn", "n",
                                             "n_shifts", "mesh"))
def _g2_qmc_sharded_impl(spec, dyn, n, n_shifts, zvec, shifts, consts,
                         mesh):
    """Shift-sharded G2 QMC (the `parallel.price_qmc_sharded` layout):
    each chip runs the full point set for its shifts — per-shift means
    never depend on the mesh size, so the result is BITWISE
    mesh-invariant."""
    from jax.sharding import PartitionSpec as P

    from mc_tpu.parallel.mesh import PATHS_AXIS

    def shard_fn(zvec, shifts_local, consts):
        one_shift = _g2_qmc_shift_fn(spec, dyn, n, zvec, consts)
        means_local = jax.vmap(one_shift)(shifts_local)
        return jax.lax.all_gather(means_local, PATHS_AXIS, tiled=True)

    means = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(PATHS_AXIS), P()),
        out_specs=P(),
        check_vma=False,
    )(zvec, shifts, consts)
    return _g2_qmc_result(means, n, n_shifts)


def price_g2_swaption_qmc(spec: SwaptionSpec = DEMO_SWAPTION,
                          dyn: G2Dynamics = DEMO_G2,
                          curve: DiscountCurve = DEMO_CURVE,
                          sim: SimParams = SimParams(n_paths=1 << 16,
                                                     n_steps=1),
                          *,
                          n_shifts: int = 16,
                          mesh=None,
                          seed: Optional[int] = None,
                          stream: int = STREAM_OUTER) -> PriceResult:
    """Randomized-QMC two-factor European swaption: the exact draw is
    THREE dimensional ((x, y, int) at expiry via the step Cholesky) —
    still deep in the regime where Sobol nets earn their O(1/N) rate.
    Digital shifts give the unbiased error estimate.

    ``mesh``: shard the SHIFT axis over a device mesh (n_shifts rounds
    up to a mesh multiple; BITWISE mesh-invariant)."""
    import math as _math

    import numpy as _np

    from mc_tpu.qmc import sobol_directions

    spec = spec.validate()
    if n_shifts < 2:
        raise ValueError("n_shifts >= 2 required for an error estimate")
    if mesh is not None:
        n_shards = mesh.devices.size
        n_shifts = -(-n_shifts // n_shards) * n_shards
    consts = _g2_tables(spec, dyn, curve)
    seed = sim.seed if seed is None else seed
    n = 1 << min(int(_math.log2(max(sim.n_paths, 2))), 20)
    zvec = jnp.asarray(sobol_directions(3).reshape(-1).astype(_np.int32))
    key = rng.derive_key(seed, stream, 0x51AD)
    sidx = jnp.arange(n_shifts * 3, dtype=jnp.uint32)
    bits, _ = rng.threefry2x32(jnp.uint32(key[0]), jnp.uint32(key[1]),
                               sidx, jnp.zeros_like(sidx))
    shifts = jax.lax.shift_right_logical(
        bits, jnp.uint32(2)).astype(jnp.int32).reshape(n_shifts, 3)
    if mesh is not None:
        return _g2_qmc_sharded_impl(spec, dyn, n, n_shifts, zvec,
                                    shifts, consts, mesh)
    return _g2_qmc_impl(spec, dyn, n, n_shifts, zvec, shifts, consts)


@functools.partial(jax.jit,
                   static_argnames=("spec", "dyn", "n", "n_shifts",
                                    "n_fit", "degree"))
def _g2_bermudan_qmc_impl(spec, dyn, n, n_shifts, n_fit, degree, zvec,
                          shifts, key_fit, consts):
    """Frozen-policy randomized-QMC two-factor Bermudan: fit the LSMC
    policy on a plain-MC pilot (same key convention as the pricing
    LSMC), then price THAT policy on a 3*n_ex-dim Sobol net over the
    exact date grid.  n_ex = 1 is BITWISE `price_g2_swaption_qmc`
    (same net, same shift stream, matched arithmetic order)."""
    n_ex = spec.n_payments
    grid_fit = _simulate_g2_grid(spec, dyn, n_fit, n_ex, key_fit)
    _, betas = _fit_g2_bermudan(spec, dyn, grid_fit, degree, consts)
    one_shift = _g2_bermudan_qmc_shift_fn(spec, dyn, n, degree, zvec,
                                          betas, consts)
    means = jax.vmap(one_shift)(shifts)
    return _g2_qmc_result(means, n, n_shifts)


def _g2_bermudan_qmc_shift_fn(spec, dyn, n, degree, zvec, betas,
                              consts):
    """shift -> frozen-policy per-shift mean (two-factor Bermudan);
    shared by the single-chip and shift-sharded programs."""

    from mc_tpu.qmc import _sobol_u

    p0, vhalf, amat, bamat, bbmat = consts
    n_ex = spec.n_payments
    sx = jnp.float32(dyn.sigma / math.sqrt(2.0 * dyn.a))
    sy = jnp.float32(dyn.eta / math.sqrt(2.0 * dyn.b_mr))
    ids = jnp.arange(n, dtype=jnp.uint32)
    chols = [_step_chol(dyn, spec.expiry if i == 0 else spec.tenor)
             for i in range(n_ex)]

    def one_shift(shift):
        def zdim(j):
            return rng.inv_normal_cdf(
                _sobol_u(ids, zvec, shift, jnp.int32(j)))

        x = jnp.zeros((n,), jnp.float32)
        y = jnp.zeros((n,), jnp.float32)
        z = jnp.zeros((n,), jnp.float32)
        cf = jnp.zeros((n,), jnp.float32)
        done = jnp.zeros((n,), bool)
        for i in range(n_ex):
            w0, w1, w2 = zdim(3 * i), zdim(3 * i + 1), zdim(3 * i + 2)
            e1, e2, ba, bb, ch = chols[i]
            epx = jnp.float32(ch[0, 0]) * w0
            epy = jnp.float32(ch[1, 0]) * w0 + jnp.float32(ch[1, 1]) * w1
            epz = (jnp.float32(ch[2, 0]) * w0
                   + jnp.float32(ch[2, 1]) * w1
                   + jnp.float32(ch[2, 2]) * w2)
            # matched order with _g2_qmc_impl so n_ex=1 is bitwise:
            # x, y, z start at 0 so the decayed carries vanish exactly
            z = z + x * jnp.float32(ba) + y * jnp.float32(bb) + epz
            x = x * jnp.float32(e1) + epx
            y = y * jnp.float32(e2) + epy
            ex = jnp.maximum(_g2_mtm(spec, i, x, y, p0, amat, bamat,
                                     bbmat), 0.0)
            if i < n_ex - 1:
                cont = _mm(_g2_basis(x, y, sx, sy, degree), betas[i])
                take = jnp.logical_and(ex > 0.0, ex > cont)
            else:
                take = ex > 0.0
            take = jnp.logical_and(take, jnp.logical_not(done))
            cf = jnp.where(take,
                           ex * jnp.float32(p0[i])
                           * jnp.exp(-z - jnp.float32(vhalf[i])), cf)
            done = jnp.logical_or(done, take)
        return jnp.mean(cf)

    return one_shift


@functools.partial(jax.jit,
                   static_argnames=("spec", "dyn", "n", "n_shifts",
                                    "n_fit", "degree", "mesh"))
def _g2_bermudan_qmc_sharded_impl(spec, dyn, n, n_shifts, n_fit, degree,
                                  zvec, shifts, key_fit, consts, mesh):
    """Shift-sharded frozen-policy QMC two-factor Bermudan: replicated
    pilot fit (identical betas per chip), shift axis over the mesh,
    full point set per shift per chip — mesh-size-invariant per-shift
    means (the `_g2_qmc_sharded_impl` construction on the Bermudan)."""
    from jax.sharding import PartitionSpec as P

    from mc_tpu.parallel.mesh import PATHS_AXIS

    n_ex = spec.n_payments
    grid_fit = _simulate_g2_grid(spec, dyn, n_fit, n_ex, key_fit)
    _, betas = _fit_g2_bermudan(spec, dyn, grid_fit, degree, consts)

    def shard_fn(zvec, shifts_local, betas, consts):
        one_shift = _g2_bermudan_qmc_shift_fn(spec, dyn, n, degree,
                                              zvec, betas, consts)
        means_local = jax.vmap(one_shift)(shifts_local)
        return jax.lax.all_gather(means_local, PATHS_AXIS, tiled=True)

    means = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(PATHS_AXIS), P(), P()),
        out_specs=P(),
        check_vma=False,
    )(zvec, shifts, betas, consts)
    return _g2_qmc_result(means, n, n_shifts)


def price_bermudan_g2_swaption_qmc(spec: SwaptionSpec = DEMO_SWAPTION,
                                   dyn: G2Dynamics = DEMO_G2,
                                   curve: DiscountCurve = DEMO_CURVE,
                                   sim: SimParams = SimParams(
                                       n_paths=1 << 14, n_steps=1),
                                   *,
                                   n_shifts: int = 16,
                                   n_fit: int = 16384,
                                   degree: int = 3,
                                   mesh=None,
                                   seed: Optional[int] = None,
                                   stream: int = STREAM_OUTER
                                   ) -> PriceResult:
    """Frozen-policy QMC Bermudan under two-factor rates (the
    `price_bermudan_hw_swaption_qmc` construction with three Sobol
    dimensions per coupon date — (x, y, int) via the step Cholesky).
    ``mesh``: shard the shift axis (replicated pilot fit; mesh-size-
    invariant per-shift means)."""
    import math as _math

    import numpy as _np

    from mc_tpu.qmc import sobol_directions

    spec = spec.validate()
    if n_shifts < 2:
        raise ValueError("n_shifts >= 2 required for an error estimate")
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}")
    consts = _g2_tables(spec, dyn, curve)
    seed = sim.seed if seed is None else seed
    if mesh is not None:
        n_shards = mesh.devices.size
        n_shifts = -(-n_shifts // n_shards) * n_shards
    n = 1 << min(int(_math.log2(max(sim.n_paths, 2))), 20)
    d = 3 * spec.n_payments
    zvec = jnp.asarray(sobol_directions(d).reshape(-1).astype(_np.int32))
    key = rng.derive_key(seed, stream, 0x51AD)
    key_fit = jnp.asarray(rng.derive_key(seed, stream, 0x6270),
                          jnp.uint32)
    sidx = jnp.arange(n_shifts * d, dtype=jnp.uint32)
    bits, _ = rng.threefry2x32(jnp.uint32(key[0]), jnp.uint32(key[1]),
                               sidx, jnp.zeros_like(sidx))
    shifts = jax.lax.shift_right_logical(
        bits, jnp.uint32(2)).astype(jnp.int32).reshape(n_shifts, d)
    if mesh is not None:
        return _g2_bermudan_qmc_sharded_impl(
            spec, dyn, n, n_shifts, n_fit, degree, zvec, shifts,
            key_fit, consts, mesh)
    return _g2_bermudan_qmc_impl(spec, dyn, n, n_shifts, n_fit, degree,
                                 zvec, shifts, key_fit, consts)


def g2_swap_book_exposure(specs, dyn: G2Dynamics = DEMO_G2,
                          curve: DiscountCurve = DEMO_CURVE,
                          sim: SimParams = SimParams(n_paths=1 << 16,
                                                     n_steps=1),
                          *,
                          weights=None,
                          seed: Optional[int] = None,
                          stream: int = STREAM_OUTER):
    """NETTING SET of swaps under two-factor rates — the
    `hullwhite.hw_swap_book_exposure` construction on the G2++ grid
    (one shared (x, y, int) pass, affine per-swap MtMs, netted matrix
    BITWISE the weighted sum of standalones, netted EE subadditive)."""
    if not specs:
        raise ValueError("need at least one swap in the netting set")
    specs = [s.validate() for s in specs]
    e0, t0 = specs[0].expiry, specs[0].tenor
    for s in specs[1:]:
        if s.expiry != e0 or s.tenor != t0:
            raise ValueError(
                "netting-set swaps must share expiry and tenor (got "
                f"({s.expiry}, {s.tenor}) vs ({e0}, {t0}))")
    weights = ([1.0] * len(specs) if weights is None
               else [float(w) for w in weights])
    if len(weights) != len(specs):
        raise ValueError(f"{len(weights)} weights for {len(specs)} swaps")
    n_ex = max(s.n_payments for s in specs)
    seed = sim.seed if seed is None else seed

    net = None
    for s, w in zip(specs, weights):
        e = g2_swap_exposure(s, dyn, curve, sim, seed=seed,
                             stream=stream)
        v = e.values * jnp.float32(w)
        if v.shape[1] < n_ex:
            pad = jnp.zeros((v.shape[0], n_ex - v.shape[1]), v.dtype)
            v = jnp.concatenate([v, pad], axis=1)
        net = v if net is None else net + v
    from mc_tpu.xva import CollateralizedExposure, coupon_dates
    horizon = e0 + (n_ex - 1) * t0
    return CollateralizedExposure(values=net,
                                  t_horizon=jnp.float32(horizon),
                                  obs_dates=coupon_dates(e0, t0, n_ex))


G2_CVA_GREEK_FIELDS = ("curve_dv01", "vega_x", "vega_y")


def g2_swap_cva_greeks(spec: SwaptionSpec = DEMO_SWAPTION,
                       dyn: G2Dynamics = DEMO_G2,
                       curve: DiscountCurve = DEMO_CURVE,
                       sim: SimParams = SimParams(n_paths=1 << 16,
                                                  n_steps=1),
                       *,
                       hazard_rate: float,
                       recovery: float = 0.4,
                       which=("curve_dv01", "vega_x"),
                       projection_curve: Optional[DiscountCurve] = None,
                       seed: Optional[int] = None,
                       stream: int = STREAM_OUTER):
    """d(swap CVA)/d(market) under two-factor rates by CRN central
    differences (same construction and rationale as
    `hullwhite.hw_swap_cva_greeks`): ``curve_dv01`` per +1bp parallel
    curve shift, ``vega_x``/``vega_y`` the per-factor vol
    sensitivities."""
    bad = set(which) - set(G2_CVA_GREEK_FIELDS)
    if bad:
        raise ValueError(f"unknown greeks {sorted(bad)}; available: "
                         f"{list(G2_CVA_GREEK_FIELDS)}")
    seed = sim.seed if seed is None else seed

    def cva_at(curve_bump=0.0, dyn_=None):
        cv = (curve if curve_bump == 0.0 else
              DiscountCurve(curve.times,
                            np.asarray(curve.zeros) + curve_bump))
        pj = projection_curve
        if pj is not None and curve_bump != 0.0:
            pj = DiscountCurve(pj.times,
                               np.asarray(pj.zeros) + curve_bump)
        e = g2_swap_exposure(spec, dyn_ or dyn, cv, sim,
                             projection_curve=pj, seed=seed,
                             stream=stream)
        return float(e.cva(hazard_rate, recovery))

    out = {}
    for g in which:
        if g == "curve_dv01":
            h = 1e-4
            out[g] = (cva_at(curve_bump=h)
                      - cva_at(curve_bump=-h)) / (2 * h) * 1e-4
        elif g == "vega_x":
            h = 1e-4
            out[g] = (cva_at(dyn_=dataclasses.replace(
                dyn, sigma=dyn.sigma + h))
                - cva_at(dyn_=dataclasses.replace(
                    dyn, sigma=dyn.sigma - h))) / (2 * h)
        else:  # vega_y
            h = 1e-4
            out[g] = (cva_at(dyn_=dataclasses.replace(
                dyn, eta=dyn.eta + h))
                - cva_at(dyn_=dataclasses.replace(
                    dyn, eta=dyn.eta - h))) / (2 * h)
    return out


def g2_swaption_greeks(spec: SwaptionSpec = DEMO_SWAPTION,
                       dyn: G2Dynamics = DEMO_G2,
                       curve: DiscountCurve = DEMO_CURVE,
                       sim: SimParams = SimParams(n_paths=1 << 18,
                                                  n_steps=1),
                       *,
                       style: str = "european",
                       degree: int = 3,
                       which=("curve_dv01", "vega_x", "vega_y"),
                       seed: Optional[int] = None,
                       stream: int = STREAM_OUTER):
    """Two-factor swaption price sensitivities by CRN central
    differences (the `hullwhite.hw_swaption_greeks` construction):
    ``curve_dv01`` — price change per +1bp parallel zero-curve shift,
    ``vega_x``/``vega_y`` — per-factor vol sensitivities, ``rho_xy`` —
    d/d(factor correlation).  Works for the European AND the Bermudan
    (frozen-key bumps re-fit the policy on the same draws).  European
    gates vs FD of the conditional-Jamshidian oracle."""
    allowed = ("curve_dv01", "vega_x", "vega_y", "rho_xy")
    bad = set(which) - set(allowed)
    if bad:
        raise ValueError(f"unknown greeks {sorted(bad)}; available: "
                         f"{list(allowed)}")
    if style not in ("european", "bermudan"):
        raise ValueError(f"style must be european|bermudan, got {style!r}")
    seed = sim.seed if seed is None else seed

    def px(curve_bump=0.0, dyn_=None):
        cv = (curve if curve_bump == 0.0 else
              DiscountCurve(curve.times,
                            np.asarray(curve.zeros) + curve_bump))
        d = dyn_ or dyn
        if style == "european":
            r = price_g2_swaption(spec, d, cv, sim, seed=seed,
                                  stream=stream)
        else:
            r = price_bermudan_g2_swaption(spec, d, cv, sim,
                                           degree=degree, seed=seed,
                                           stream=stream)
        return float(r.price)

    # 5e-4 vol bumps: small enough that the conditional-Jamshidian FD
    # moves <0.1% (measured), large enough to clear the f32 CRN noise
    # floor that a 1e-4 bump amplifies 5x.
    bumps = {"vega_x": ("sigma", 5e-4), "vega_y": ("eta", 5e-4),
             "rho_xy": ("rho", 1e-2)}
    out = {}
    for g in which:
        if g == "curve_dv01":
            h = 1e-4
            out[g] = (px(curve_bump=h) - px(curve_bump=-h)) \
                / (2 * h) * 1e-4
        else:
            field, h = bumps[g]
            hi = dataclasses.replace(dyn, **{field: getattr(dyn, field)
                                             + h})
            lo = dataclasses.replace(dyn, **{field: getattr(dyn, field)
                                             - h})
            out[g] = (px(dyn_=hi) - px(dyn_=lo)) / (2 * h)
    return out


# ---------------------------------------------------------------------------
# Key-rate (bucketed) curve risk — the `hullwhite.hw_swaption_bucket_dv01`
# construction under two factors: the (x, y, int) draw is curve-free, so
# the whole knot-bump ladder shares ONE simulated draw set and runs as
# ONE batched device call (vmap over stacked p0 rows).
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("spec", "dyn", "n_paths"))
def _g2_ladder_impl(spec, dyn, n_paths, key, p0_mat, vhalf_0, amat,
                    bamat, bbmat):
    """Mean European price per row of ``p0_mat`` (m, n_payments+1) —
    the factor grid is simulated once and the two-factor payoff
    re-evaluates per bumped-curve row."""
    (x, y, z), = _simulate_g2_grid(spec, dyn, n_paths, 1, key)
    disc = jnp.exp(-z - vhalf_0)
    inv_n = jnp.float32(1.0) / jnp.float32(n_paths)

    def one(p0):
        pay = (jnp.maximum(
            _g2_mtm(spec, 0, x, y, p0, amat, bamat, bbmat), 0.0)
            * jnp.float32(p0[0]) * disc)
        return jnp.sum(pay) * inv_n

    return jax.vmap(one)(p0_mat)


def g2_swaption_bucket_dv01(spec: SwaptionSpec = DEMO_SWAPTION,
                            dyn: G2Dynamics = DEMO_G2,
                            curve: DiscountCurve = DEMO_CURVE,
                            sim: SimParams = SimParams(n_paths=1 << 18,
                                                       n_steps=1),
                            *,
                            style: str = "european",
                            degree: int = 3,
                            bump: float = 1e-4,
                            seed: Optional[int] = None,
                            stream: int = STREAM_OUTER) -> np.ndarray:
    """Key-rate DV01 ladder under G2++: price change per +1bp bump of
    EACH zero-curve knot (CRN central differences), one entry per
    ``curve.times`` pillar.  Same gates as the Hull-White ladder: sums
    to the parallel ``curve_dv01``, material buckets match per-knot FD
    of the conditional-Jamshidian oracle, unused pillars are exactly
    zero.  ``style="bermudan"`` re-fits the frozen-key policy per bump."""
    if style not in ("european", "bermudan"):
        raise ValueError(f"style must be european|bermudan, got {style!r}")
    spec = spec.validate()
    n_knots = len(curve.times)
    seed = sim.seed if seed is None else seed

    def bumped(k, h):
        zeros = np.array(curve.zeros, np.float64)
        zeros[k] += h
        return DiscountCurve(curve.times, zeros)

    if style == "bermudan":
        out = np.empty(n_knots, np.float64)
        for k in range(n_knots):
            up = price_bermudan_g2_swaption(spec, dyn, bumped(k, bump),
                                            sim, degree=degree,
                                            seed=seed, stream=stream)
            dn = price_bermudan_g2_swaption(spec, dyn, bumped(k, -bump),
                                            sim, degree=degree,
                                            seed=seed, stream=stream)
            out[k] = (float(up.price) - float(dn.price)) / (2 * bump) * 1e-4
        return out

    dates = [spec.expiry + i * spec.tenor for i in range(spec.n_payments + 1)]
    rows = []
    for h in (bump, -bump):
        for k in range(n_knots):
            cv = bumped(k, h)
            rows.append([cv.df(t) for t in dates])
    p0_mat = np.asarray(rows, np.float64)
    _, vhalf, amat, bamat, bbmat = _g2_tables(spec, dyn, curve)
    key = jnp.asarray(rng.derive_key(seed, stream, 0x6270), jnp.uint32)
    prices = np.asarray(_g2_ladder_impl(
        spec, dyn, sim.n_paths, key, p0_mat, jnp.float32(vhalf[0]),
        amat, bamat, bbmat), np.float64)
    return (prices[:n_knots] - prices[n_knots:]) / (2 * bump) * 1e-4


def _g2_policy_machinery(spec, dyn, degree, betas, key, consts):
    """(step_tenor, draws, policy_value) for frozen-policy rollouts
    under G2++: the `_policy_machinery` construction with the 3-draw
    (x, y, int) exact tenor step and curve discounting."""
    from mc_tpu.models.rates_policy import (check_rollout_dates,
                                            frozen_policy_value)
    p0, vhalf, amat, bamat, bbmat = consts
    n_ex = spec.n_payments
    check_rollout_dates(n_ex)
    sx = dyn.sigma / math.sqrt(2.0 * dyn.a)
    sy = dyn.eta / math.sqrt(2.0 * dyn.b_mr)
    k0 = jnp.asarray(key[0], jnp.uint32)
    k1 = jnp.asarray(key[1], jnp.uint32)
    e1, e2, ba, bb, ch = _step_chol(dyn, spec.tenor)

    def draws(ids, tag, u):
        base = (jnp.uint32(tag) * jnp.uint32(64)
                + jnp.uint32(u)) * jnp.uint32(2)
        c1 = jnp.full(ids.shape, 0, jnp.uint32) + base
        w0, w1 = rng.normal_pair(k0, k1, ids, c1)
        bits, _ = rng.threefry2x32(k0, k1, ids, c1 + jnp.uint32(1),
                                   rounds=rng.DEFAULT_ROUNDS)
        w2 = rng.inv_normal_cdf(rng.bits_to_unit(bits))
        return w0, w1, w2

    def step_tenor(x, y, z, w0, w1, w2):
        ex_ = jnp.float32(ch[0, 0]) * w0
        ey = jnp.float32(ch[1, 0]) * w0 + jnp.float32(ch[1, 1]) * w1
        ez = (jnp.float32(ch[2, 0]) * w0 + jnp.float32(ch[2, 1]) * w1
              + jnp.float32(ch[2, 2]) * w2)
        z = z + x * jnp.float32(ba) + y * jnp.float32(bb) + ez
        return x * jnp.float32(e1) + ex_, y * jnp.float32(e2) + ey, z

    def policy_value(i, x, y, z, ids, tag):
        return frozen_policy_value(
            n_ex, i, (x, y, z), ids, tag, draws=draws,
            step=lambda st, ws: step_tenor(st[0], st[1], st[2],
                                           ws[0], ws[1], ws[2]),
            exercise=lambda u, st: jnp.maximum(
                _g2_mtm(spec, u, st[0], st[1], p0, amat, bamat, bbmat),
                0.0),
            continuation=lambda u, st: _mm(
                _g2_basis(st[0], st[1], jnp.float32(sx),
                          jnp.float32(sy), degree), betas[u]),
            cashflow=lambda u, ex, st: (
                ex * jnp.float32(p0[u])
                * jnp.exp(-st[2] - jnp.float32(vhalf[u]))))

    return step_tenor, draws, policy_value


@functools.partial(jax.jit,
                   static_argnames=("spec", "dyn", "n_paths", "degree",
                                    "n_branch"))
def _g2_bounds_impl(spec, dyn, n_paths, degree, n_branch, key, key_dual,
                    consts):
    from mc_tpu.models.swaption import _ab_bracket
    p0, vhalf, amat, bamat, bbmat = consts
    n_ex = spec.n_payments
    grid = _simulate_g2_grid(spec, dyn, n_paths, n_ex, key)
    cf, betas = _fit_g2_bermudan(spec, dyn, grid, degree, consts)
    n = jnp.float32(n_paths)
    lower = summarize(jnp.sum(cf), jnp.sum(cf * cf), n, 1.0)

    step_tenor, draws, policy_value = _g2_policy_machinery(
        spec, dyn, degree, betas, key_dual, consts)

    def bcast(i, ids_b):
        x, y, z = grid[i]
        return (jnp.broadcast_to(x, ids_b.shape),
                jnp.broadcast_to(y, ids_b.shape),
                jnp.broadcast_to(z, ids_b.shape))

    def z_at(i):
        x, y, z = grid[i]
        return (jnp.maximum(_g2_mtm(spec, i, x, y, p0, amat, bamat,
                                    bbmat), 0.0)
                * jnp.float32(p0[i])
                * jnp.exp(-z - jnp.float32(vhalf[i])))

    def v_at(i, ids_b):
        x, y, z = bcast(i, ids_b)
        return policy_value(i, x, y, z, ids_b, tag=3 * i)

    def cond_at(i, ids_b):
        x, y, z = bcast(i - 1, ids_b)
        w0, w1, w2 = draws(ids_b, 3 * i + 1, 63)
        x, y, z = step_tenor(x, y, z, w0, w1, w2)
        return policy_value(i, x, y, z, ids_b, tag=3 * i + 2)

    upper = _ab_bracket(n_ex, n_paths, n_branch, z_at, v_at, cond_at)
    return lower, upper


@functools.partial(jax.jit,
                   static_argnames=("spec", "dyn", "n_paths", "n_inner",
                                    "n_fit", "degree"))
def _g2_bermudan_exposure_impl(spec, dyn, n_paths, n_inner, n_fit,
                               degree, key_fit, key_outer, key_inner,
                               consts):
    p0, vhalf, amat, bamat, bbmat = consts
    n_ex = spec.n_payments
    sx = dyn.sigma / math.sqrt(2.0 * dyn.a)
    sy = dyn.eta / math.sqrt(2.0 * dyn.b_mr)
    fit_grid = _simulate_g2_grid(spec, dyn, n_fit, n_ex, key_fit)
    _, betas = _fit_g2_bermudan(spec, dyn, fit_grid, degree, consts)
    grid = _simulate_g2_grid(spec, dyn, n_paths, n_ex, key_outer)
    _, _, policy_value = _g2_policy_machinery(
        spec, dyn, degree, betas, key_inner, consts)
    ids = jnp.arange(n_paths, dtype=jnp.uint32)
    ids_b = (ids[None, :]
             + (jnp.arange(n_inner, dtype=jnp.uint32)[:, None]
                + jnp.uint32(1)) * jnp.uint32(1 << 22))
    alive = jnp.ones((n_paths,), bool)
    vals = []
    for i in range(n_ex):
        x, y, z = grid[i]
        ex = jnp.maximum(_g2_mtm(spec, i, x, y, p0, amat, bamat, bbmat),
                         0.0)
        if i < n_ex - 1:
            cont = _mm(_g2_basis(x, y, jnp.float32(sx), jnp.float32(sy),
                                 degree), betas[i])
            take = jnp.logical_and(ex > 0.0, ex > cont)
        else:
            take = ex > 0.0
        v_i = jnp.mean(policy_value(
            i, jnp.broadcast_to(x, ids_b.shape),
            jnp.broadcast_to(y, ids_b.shape),
            jnp.broadcast_to(z, ids_b.shape), ids_b, tag=i), axis=0)
        vals.append(jnp.where(alive, v_i, 0.0))
        alive = jnp.logical_and(alive, jnp.logical_not(take))
    return jnp.stack(vals, axis=1)


def bermudan_g2_swaption_exposure(spec: SwaptionSpec = DEMO_SWAPTION,
                                  dyn: G2Dynamics = DEMO_G2,
                                  curve: DiscountCurve = DEMO_CURVE,
                                  sim: SimParams = SimParams(
                                      n_paths=4096, n_steps=1,
                                      n_paths_inner=16),
                                  *,
                                  degree: int = 3,
                                  n_fit: int = 16384,
                                  seed: Optional[int] = None,
                                  stream: int = STREAM_OUTER):
    """Exposure of a long Bermudan swaption under TWO-FACTOR rates:
    frozen-policy MtM per coupon date, exercise absorbs — the EE
    profile telescopes to the Bermudan policy price.  Full
    `CollateralizedExposure` metric set."""
    spec = spec.validate()
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}")
    if sim.n_paths > (1 << 22):
        raise ValueError(
            "bermudan_g2_swaption_exposure shards rollout streams by "
            f"id + branch * 2^22: n_paths must be <= 2^22, got "
            f"{sim.n_paths}")
    consts = _g2_tables(spec, dyn, curve)
    seed = sim.seed if seed is None else seed
    key_fit = jnp.asarray(rng.derive_key(seed, stream, 0x6270),
                          jnp.uint32)
    key_outer = jnp.asarray(rng.derive_key(seed, stream, 0x6274),
                            jnp.uint32)
    key_inner = jnp.asarray(rng.derive_key(seed, stream, 0x6275),
                            jnp.uint32)
    values = _g2_bermudan_exposure_impl(
        spec, dyn, sim.n_paths, sim.n_paths_inner, n_fit, degree,
        key_fit, key_outer, key_inner, consts)
    from mc_tpu.xva import CollateralizedExposure, coupon_dates
    horizon = spec.expiry + (spec.n_payments - 1) * spec.tenor
    return CollateralizedExposure(
        values=values, t_horizon=jnp.float32(horizon),
        obs_dates=coupon_dates(spec.expiry, spec.tenor, spec.n_payments))


def bermudan_g2_swaption_bounds(spec: SwaptionSpec = DEMO_SWAPTION,
                                dyn: G2Dynamics = DEMO_G2,
                                curve: DiscountCurve = DEMO_CURVE,
                                sim: SimParams = SimParams(
                                    n_paths=4096, n_steps=1),
                                *,
                                degree: int = 3,
                                n_branch: int = 32,
                                seed: Optional[int] = None,
                                stream: int = STREAM_OUTER):
    """(lower, upper) bracketing the two-factor curve Bermudan —
    Andersen-Broadie on the SAME fitted (x, y) policy via the shared
    `_ab_bracket` running max.  Lower is BITWISE
    `price_bermudan_g2_swaption` at the same sim."""
    spec = spec.validate()
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}")
    if n_branch < 2:
        raise ValueError(f"n_branch must be >= 2, got {n_branch}")
    if sim.n_paths > (1 << 22):
        raise ValueError(
            "bermudan_g2_swaption_bounds shards branch streams by "
            f"id + branch * 2^22: n_paths must be <= 2^22, got "
            f"{sim.n_paths}")
    consts = _g2_tables(spec, dyn, curve)
    seed = sim.seed if seed is None else seed
    key = jnp.asarray(rng.derive_key(seed, stream, 0x6270), jnp.uint32)
    kd = jnp.asarray(rng.derive_key(seed, stream, 0x6272), jnp.uint32)
    return _g2_bounds_impl(spec, dyn, sim.n_paths, degree, n_branch,
                           key, kd, consts)


def price_bermudan_g2_swaption(spec: SwaptionSpec = DEMO_SWAPTION,
                               dyn: G2Dynamics = DEMO_G2,
                               curve: DiscountCurve = DEMO_CURVE,
                               sim: SimParams = SimParams(
                                   n_paths=1 << 18, n_steps=1),
                               *,
                               degree: int = 3,
                               seed: Optional[int] = None,
                               stream: int = STREAM_OUTER
                               ) -> PriceResult:
    """Co-terminal Bermudan swaption under TWO-FACTOR rates: exercise
    decisions see both factors (an x-only policy under-exercises when
    the factors have moved apart — the de-correlation premium).  Gates:
    1-payment BITWISE == `price_g2_swaption`; dominates the European
    conditional-Jamshidian; eta -> 0 agrees with the one-factor
    `price_bermudan_hw_swaption` within joint stderr."""
    spec = spec.validate()
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}")
    consts = _g2_tables(spec, dyn, curve)
    seed = sim.seed if seed is None else seed
    key = jnp.asarray(rng.derive_key(seed, stream, 0x6270), jnp.uint32)
    return _g2_bermudan_impl(spec, dyn, sim.n_paths, degree, key,
                             consts)


@functools.partial(jax.jit, static_argnames=("spec", "dyn", "n_paths"))
def _g2_exposure_impl(spec, dyn, n_paths, key, consts):
    p0, vhalf, amat, bamat, bbmat = consts
    n_ex = spec.n_payments
    grid = _simulate_g2_grid(spec, dyn, n_paths, n_ex, key)
    vals = []
    for i, (x, y, z) in enumerate(grid):
        mtm = _g2_mtm(spec, i, x, y, p0, amat, bamat, bbmat)
        vals.append(mtm * jnp.float32(p0[i])
                    * jnp.exp(-z - jnp.float32(vhalf[i])))
    return jnp.stack(vals, axis=1)


def g2_swap_exposure(spec: SwaptionSpec = DEMO_SWAPTION,
                     dyn: G2Dynamics = DEMO_G2,
                     curve: DiscountCurve = DEMO_CURVE,
                     sim: SimParams = SimParams(n_paths=1 << 16,
                                                n_steps=1),
                     *,
                     projection_curve: Optional[DiscountCurve] = None,
                     seed: Optional[int] = None,
                     stream: int = STREAM_OUTER):
    """Counterparty exposure of the swap under two-factor rates: every
    EE point is gated against the `oracle.g2_swaption` strip (the
    multi-curve strip under ``projection_curve``); carries the full XVA
    metric surface (`CollateralizedExposure`)."""
    spec = spec.validate()
    consts = _g2_tables(spec, dyn, curve)
    seed = sim.seed if seed is None else seed
    key = jnp.asarray(rng.derive_key(seed, stream, 0x6270), jnp.uint32)
    if projection_curve is not None:
        from mc_tpu.models.hullwhite import _hw_mc_weights
        weights = _hw_mc_weights(spec, curve, projection_curve)
        values = _g2_exposure_mc_impl(spec, dyn, sim.n_paths, key,
                                      consts, weights)
    else:
        values = _g2_exposure_impl(spec, dyn, sim.n_paths, key, consts)
    from mc_tpu.xva import CollateralizedExposure, coupon_dates
    horizon = spec.expiry + (spec.n_payments - 1) * spec.tenor
    return CollateralizedExposure(
        values=values, t_horizon=jnp.float32(horizon),
        obs_dates=coupon_dates(spec.expiry, spec.tenor, spec.n_payments))
