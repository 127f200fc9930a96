"""Hull-White one-factor, fitted to an INPUT discount curve.

The reference prices everything off a single flat rate
(`/root/reference/inc/wrappers.cuh:51` discounts with one scalar
e^{-rT}); production rates desks price off the market curve.  Hull-White
dr = (theta(t) - a r) dt + sigma dW picks theta(t) so that TODAY'S curve
P(0, t) is repriced exactly — the standard decomposition r(t) = x(t) +
alpha(t) with x an OU factor started at 0 makes everything tractable
without ever materializing theta:

  - bonds:   P(t, S) = (P(0,S)/P(0,t)) exp(-B(S-t) x(t)
                       - (sigma^2/(4a)) (1 - e^{-2at}) B(S-t)^2)
  - cash:    e^{-int_0^t r} = P(0, t) exp(-int_0^t x - c(t)),
             c(t) = Var[int_0^t x]/2  (so E[e^{-int r}] == P(0,t))

(Brigo-Mercurio ch. 3.)  (x, int x) over a step has the SAME exact
Gaussian structure as the Vasicek machinery with b = 0, so the swaption
module's exact date-grid simulation is reused verbatim
(`_simulate_rate_grid(a, b=0, r0=0)` returns (x, int x) exactly).

Everything is gated against `oracle.hw_swaption` (curve-consistent
Jamshidian) plus two EXACT identities: the model reprices the input
curve (E[discount-to-0] == P(0, t_i) at every coupon date), and the
sigma -> 0 limit collapses to the curve's forward-swap intrinsic.
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
from mc_tpu.models.swaption import (DEMO_SWAPTION, SwaptionSpec,
                                    _simulate_rate_grid)
from mc_tpu.oracle import PriceResult, summarize

__all__ = ["DiscountCurve", "HullWhiteDynamics", "price_hw_swaption",
           "price_bermudan_hw_swaption", "bermudan_hw_swaption_bounds",
           "bermudan_hw_swaption_exposure", "price_hw_swaption_qmc",
           "price_hw_swaption_sharded", "price_hw_equity",
           "price_bermudan_hw_swaption_qmc",
           "hw_swap_exposure", "hw_swap_book_exposure",
           "hw_swap_cva_greeks", "hw_swaption_greeks",
           "hw_swaption_bucket_dv01",
           "DEMO_CURVE", "DEMO_HW"]


def _mm(a, b):
    """float32 product at full precision: a GPU would otherwise run it in
    TF32, which keeps about three decimal digits."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


class DiscountCurve:
    """P(0, t) from zero-rate knots (host-side, float64).

    Log-linear interpolation of the discount factor (= linear in t*z(t),
    the market-standard bootstrap convention); flat zero-rate
    extrapolation beyond the last knot.
    """

    def __init__(self, times, zeros):
        self.times = np.asarray(times, np.float64)
        self.zeros = np.asarray(zeros, np.float64)
        if self.times.ndim != 1 or self.times.shape != self.zeros.shape:
            raise ValueError("times/zeros must be matching 1-D arrays")
        if self.times.shape[0] < 1:
            raise ValueError("need at least one curve knot")
        if np.any(self.times <= 0.0):
            raise ValueError("knot times must be > 0")
        if np.any(np.diff(self.times) <= 0.0):
            raise ValueError("knot times must be strictly ascending")

    @staticmethod
    def flat(rate: float, horizon: float = 50.0) -> "DiscountCurve":
        return DiscountCurve([horizon], [rate])

    @staticmethod
    def from_par_swaps(maturities, par_rates,
                       tenor: float = 0.5) -> "DiscountCurve":
        """BOOTSTRAP the curve from par swap quotes — the actual market
        input (desks quote par rates, not zeros).

        ``par_rates[i]`` is the fixed rate making the spot-starting
        swap to ``maturities[i]`` worth zero:
            s_m * tau * sum_{j<=m} P(t_j) = 1 - P(t_m).
        Maturities must lie on the tenor grid and ascend; rates between
        quotes are interpolated linearly in the par rate (standard
        single-curve bootstrap).  Round-trip gate: par rates generated
        from a known curve are recovered and the bootstrapped curve
        reprices them to ~1e-12."""
        mats = np.asarray(maturities, np.float64)
        pars = np.asarray(par_rates, np.float64)
        if mats.shape != pars.shape or mats.ndim != 1:
            raise ValueError("maturities/par_rates must match, 1-D")
        if np.any(np.diff(mats) <= 0.0):
            raise ValueError("maturities must be strictly ascending")
        n_steps = np.round(mats / tenor).astype(int)
        if not np.allclose(n_steps * tenor, mats, atol=1e-9):
            raise ValueError("maturities must lie on the tenor grid")
        # par rate at every coupon date by linear interpolation
        grid = np.arange(1, n_steps[-1] + 1) * tenor
        s = np.interp(grid, mats, pars)
        dfs = np.empty(len(grid), np.float64)
        acc = 0.0  # running annuity sum_{j<m} P(t_j)
        for m in range(len(grid)):
            with np.errstate(divide="ignore", invalid="ignore"):
                dfs[m] = ((1.0 - s[m] * tenor * acc)
                          / (1.0 + s[m] * tenor))
            # Inconsistent/extreme quotes drive 1 - s*tau*acc <= 0; the
            # log below would then emit NaN zero rates that propagate
            # silently into every price.  Fail loudly instead, naming
            # the offending pillar.
            if not (0.0 < dfs[m] < np.inf) or np.isnan(dfs[m]):
                raise ValueError(
                    f"par-swap bootstrap failed at maturity "
                    f"{grid[m]:g} (par rate {s[m]:.6g}): implied "
                    f"discount factor {dfs[m]:.6g} is not a positive "
                    "finite number — the quotes are inconsistent with "
                    "positive rates")
            acc += dfs[m]
        zeros = -np.log(dfs) / grid
        return DiscountCurve(grid, zeros)

    def df(self, t) -> float:
        """P(0, t); t = 0 -> 1 exactly."""
        t = float(t)
        if t <= 0.0:
            return 1.0
        ts, zs = self.times, self.zeros
        tz = ts * zs  # integrated zero = t * z(t); linear interp in this
        v = np.interp(t, ts, tz)
        if t > ts[-1]:
            v = tz[-1] + zs[-1] * (t - ts[-1])
        if t < ts[0]:
            v = zs[0] * t  # flat short end
        return float(math.exp(-v))


DEMO_CURVE = DiscountCurve([0.5, 1.0, 2.0, 3.0, 5.0, 10.0],
                           [0.030, 0.035, 0.040, 0.043, 0.046, 0.048])


@dataclasses.dataclass(frozen=True)
class HullWhiteDynamics:
    """Mean-reversion speed + short-rate vol (host floats — the curve
    and date grid are static, so everything derived is precomputed in
    float64 and shipped as f32 constants)."""

    a: float = 0.3
    sigma_r: float = 0.015

    def validate(self) -> "HullWhiteDynamics":
        if not self.a > 0.0:
            raise ValueError(f"mean reversion a must be > 0, got "
                             f"{self.a} (every B(t), variance, and "
                             "correction divides by it)")
        if self.sigma_r < 0.0:
            raise ValueError(f"sigma_r must be >= 0, got {self.sigma_r}")
        return self


DEMO_HW = HullWhiteDynamics()


def _hw_tables(spec: SwaptionSpec, dyn: HullWhiteDynamics,
               curve: DiscountCurve):
    """Host-f64 precomputation for the coupon-date grid.

    Returns (p0, c, bmat, corr):
      p0[i]       P(0, t_i) at the n_payments+1 dates t_0..t_N
                  (t_i = expiry + i*tenor)
      c[i]        Var[int_0^{t_i} x]/2 — the discount-to-0 correction
      bmat[i, j]  B(t_j - t_i) for j > i (else 0)
      corr[i, j]  the full deterministic bond-reconstruction exponent,
                  (sigma^2/(4a)) (1 - e^{-2a t_i}) B_ij^2
                  + B_ij sigma^2/(2a^2) (1 - e^{-a t_i})^2.
                  The SECOND term is alpha(t_i) - f(0, t_i), equal to
                  B_ij * Cov[x(t_i), int_0^{t_i} x] — exactly what makes
                  E[D(0,t_i) P(t_i, t_j)] == P(0, t_j) (tower).
                  Omitting it leaves the Jamshidian strikes untouched
                  (it is a pure x-SHIFT of the bond family, and strikes
                  are shift-invariant) but biases every bond evaluated
                  at a SIMULATED x — a measured z ~ -10 swaption bias
                  before the fix.
    """
    dyn.validate()
    a, sig = float(dyn.a), float(dyn.sigma_r)
    n = spec.n_payments
    dates = [spec.expiry + i * spec.tenor for i in range(n + 1)]
    p0 = np.array([curve.df(t) for t in dates], np.float64)
    bt = lambda tau: -math.expm1(-a * tau) / a
    c = np.array([
        (sig * sig / (2.0 * a * a))
        * (t - 2.0 * bt(t) - math.expm1(-2.0 * a * t) / (2.0 * a))
        for t in dates], np.float64)
    bmat = np.zeros((n + 1, n + 1), np.float64)
    corr = np.zeros((n + 1, n + 1), np.float64)
    for i in range(n + 1):
        var_fac = (sig * sig / (4.0 * a)) * (-math.expm1(-2.0 * a
                                                         * dates[i]))
        shift = (sig * sig / (2.0 * a * a)) * math.expm1(
            -a * dates[i]) ** 2
        for j in range(i + 1, n + 1):
            bmat[i, j] = bt(dates[j] - dates[i])
            corr[i, j] = (var_fac * bmat[i, j] * bmat[i, j]
                          + bmat[i, j] * shift)
    return p0, c, bmat, corr


def _hw_mc_weights(spec: SwaptionSpec, curve: DiscountCurve,
                   proj: DiscountCurve):
    """Multi-curve weight algebra (host f64).

    With a deterministic multiplicative basis B(t) = P_proj/P_disc, the
    remaining swap at observation date t_i is
        V = const[i] + sum_{m > i} wvec[m] P_disc(t_i, t_m; x):
    the float leg telescopes to s_j P_d(t_{j-1}) - P_d(t_j) per period
    (s_j = B(t_{j-1})/B(t_j)), so only the FIRST period's bond is the
    trivial P_d(t_i, t_i) = 1 — its weight is the date-i constant."""
    n = spec.n_payments
    dates = [spec.expiry + i * spec.tenor for i in range(n + 1)]
    basis = np.array([proj.df(t) / curve.df(t) for t in dates],
                     np.float64)
    wvec = np.zeros(n + 1, np.float64)
    for m in range(1, n):
        wvec[m] = basis[m] / basis[m + 1] - 1.0 - spec.k_rate * spec.tenor
    wvec[n] = -1.0 - spec.k_rate * spec.tenor
    const = np.array([basis[i] / basis[i + 1] if i < n else 0.0
                      for i in range(n + 1)], np.float64)
    return const, wvec


def _hw_mtm_multicurve(spec, i: int, x, p0, bmat, corr, const, wvec):
    """SIGNED multi-curve remaining-swap value at date i."""
    n = spec.n_payments
    v = jnp.zeros_like(x) + jnp.float32(const[i])
    for j in range(i + 1, n + 1):
        p_ij = (jnp.float32(p0[j] / p0[i])
                * jnp.exp(-jnp.float32(bmat[i, j]) * x
                          - jnp.float32(corr[i, j])))
        v = v + jnp.float32(wvec[j]) * p_ij
    if not spec.payer:
        v = -v
    return v


def _hw_intrinsic(spec, i: int, x, p0, bmat, corr):
    """Payer/receiver intrinsic AT date i of the remaining swap
    (payments i+1..N), bonds reconstructed from the curve + OU factor."""
    n = spec.n_payments
    fixed = jnp.zeros_like(x)
    for j in range(i + 1, n + 1):
        p_ij = (jnp.float32(p0[j] / p0[i])
                * jnp.exp(-jnp.float32(bmat[i, j]) * x
                          - jnp.float32(corr[i, j])))
        fixed = fixed + jnp.float32(spec.k_rate * spec.tenor) * p_ij
        if j == n:
            fixed = fixed + p_ij  # principal rides the last bond
    swap = 1.0 - fixed
    if not spec.payer:
        swap = -swap
    return jnp.maximum(swap, 0.0)


@functools.partial(jax.jit, static_argnames=("spec", "n_paths"))
def _hw_european_impl(spec, a, sigma_r, n_paths, key, p0_0, c_0, consts):
    p0, bmat, corr = consts
    x_grid, y_grid = _simulate_rate_grid(
        spec, a, jnp.float32(0.0), sigma_r, jnp.float32(0.0), n_paths,
        1, key)
    x, y = x_grid[0], y_grid[0]
    pay = (_hw_intrinsic(spec, 0, x, p0, bmat, corr)
           * p0_0 * jnp.exp(-y - c_0))
    n = jnp.float32(n_paths)
    return summarize(jnp.sum(pay), jnp.sum(pay * pay), n, 1.0)


@functools.partial(jax.jit, static_argnames=("spec", "n_paths"))
def _hw_european_mc_impl(spec, a, sigma_r, n_paths, key, p0_0, c_0,
                         consts, weights):
    p0, bmat, corr = consts
    const, wvec = weights
    x_grid, y_grid = _simulate_rate_grid(
        spec, a, jnp.float32(0.0), sigma_r, jnp.float32(0.0), n_paths,
        1, key)
    x, y = x_grid[0], y_grid[0]
    v = _hw_mtm_multicurve(spec, 0, x, p0, bmat, corr, const, wvec)
    pay = jnp.maximum(v, 0.0) * p0_0 * jnp.exp(-y - c_0)
    n = jnp.float32(n_paths)
    return summarize(jnp.sum(pay), jnp.sum(pay * pay), n, 1.0)


def price_hw_swaption(spec: SwaptionSpec = DEMO_SWAPTION,
                      dyn: HullWhiteDynamics = DEMO_HW,
                      curve: DiscountCurve = DEMO_CURVE,
                      sim: SimParams = SimParams(n_paths=1 << 20,
                                                 n_steps=1),
                      *,
                      projection_curve: Optional[DiscountCurve] = None,
                      seed: Optional[int] = None,
                      stream: int = STREAM_OUTER) -> PriceResult:
    """European payer/receiver swaption under curve-fitted Hull-White:
    ONE exact (x, int x) draw at expiry, curve-reconstructed bonds,
    pathwise discounting through the curve.  Oracle gate:
    `oracle.hw_swaption` (curve-consistent Jamshidian).

    ``projection_curve``: MULTI-CURVE pricing — forwards read off this
    curve while cash flows discount off ``curve`` (OIS), linked by a
    deterministic multiplicative basis (one factor drives both).
    Oracle: `oracle.hw_swaption_multicurve` (direct quadrature — the
    mixed-sign bond weights break Jamshidian's monotonicity)."""
    spec = spec.validate()
    p0, c, bmat, corr = _hw_tables(spec, dyn, curve)
    seed = sim.seed if seed is None else seed
    key = jnp.asarray(rng.derive_key(seed, stream, 0x4877), jnp.uint32)
    if projection_curve is not None:
        weights = _hw_mc_weights(spec, curve, projection_curve)
        return _hw_european_mc_impl(
            spec, jnp.float32(dyn.a), jnp.float32(dyn.sigma_r),
            sim.n_paths, key, jnp.float32(p0[0]), jnp.float32(c[0]),
            (p0, bmat, corr), weights)
    return _hw_european_impl(spec, jnp.float32(dyn.a),
                             jnp.float32(dyn.sigma_r), sim.n_paths, key,
                             jnp.float32(p0[0]), jnp.float32(c[0]),
                             (p0, bmat, corr))


def _hw_qmc_shift_fn(spec, a, sigma_r, n, zvec, p0_0, c_0, consts):
    """shift -> per-shift sample mean for the 2-dim HW Sobol net; the
    shared body of the single-chip and shift-sharded QMC programs."""

    from mc_tpu.models.swaption import _exact_xy_coeffs
    from mc_tpu.qmc import _sobol_u

    p0, bmat, corr = consts
    ids = jnp.arange(n, dtype=jnp.uint32)
    e1, big_b, l11, l21, l22 = _exact_xy_coeffs(
        a, sigma_r, jnp.float32(spec.expiry))

    def one_shift(shift):
        u0 = _sobol_u(ids, zvec, shift, jnp.int32(0))
        u1 = _sobol_u(ids, zvec, shift, jnp.int32(1))
        z0 = rng.inv_normal_cdf(u0)
        z1 = rng.inv_normal_cdf(u1)
        x = l11 * z0          # x(0) = 0 under the theta(t) split
        y = l21 * z0 + l22 * z1
        pay = (_hw_intrinsic(spec, 0, x, p0, bmat, corr)
               * p0_0 * jnp.exp(-y - c_0))
        return jnp.mean(pay)

    return one_shift


def _qmc_result(means, n, n_shifts):
    price = jnp.mean(means)
    stderr = jnp.std(means, ddof=1) / jnp.sqrt(jnp.float32(n_shifts))
    return PriceResult(price=price, stderr=stderr,
                       n_paths=jnp.float32(n * n_shifts),
                       payoff_mean=price, payoff_var=stderr * stderr)


@functools.partial(jax.jit, static_argnames=("spec", "n", "n_shifts"))
def _hw_qmc_impl(spec, a, sigma_r, n, n_shifts, zvec, shifts, p0_0, c_0,
                 consts):
    one_shift = _hw_qmc_shift_fn(spec, a, sigma_r, n, zvec, p0_0, c_0,
                                 consts)
    return _qmc_result(jax.vmap(one_shift)(shifts), n, n_shifts)


@functools.partial(jax.jit, static_argnames=("spec", "n", "n_shifts",
                                             "mesh"))
def _hw_qmc_sharded_impl(spec, a, sigma_r, n, n_shifts, zvec, shifts,
                         p0_0, c_0, consts, mesh):
    """Shift-sharded HW QMC: each chip evaluates the FULL point set for
    its share of shifts (the `parallel.price_qmc_sharded` layout), so
    per-shift means never depend on the mesh size — the result is
    BITWISE mesh-invariant.  vs the single-chip `_hw_qmc_impl` the
    per-shift means can differ at the last ulp (vmap-batched vs mapped
    reductions fuse differently)."""
    from jax.sharding import PartitionSpec as P

    from mc_tpu.parallel.mesh import PATHS_AXIS

    def shard_fn(zvec, shifts_local, a, sigma_r, p0_0, c_0, consts):
        one_shift = _hw_qmc_shift_fn(spec, a, sigma_r, n, zvec, p0_0,
                                     c_0, consts)
        means_local = jax.vmap(one_shift)(shifts_local)
        return jax.lax.all_gather(means_local, PATHS_AXIS, tiled=True)

    means = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(PATHS_AXIS), P(), P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )(zvec, shifts, a, sigma_r, p0_0, c_0, consts)
    return _qmc_result(means, n, n_shifts)


def price_hw_swaption_qmc(spec: SwaptionSpec = DEMO_SWAPTION,
                          dyn: HullWhiteDynamics = DEMO_HW,
                          curve: DiscountCurve = DEMO_CURVE,
                          sim: SimParams = SimParams(n_paths=1 << 16,
                                                     n_steps=1),
                          *,
                          n_shifts: int = 16,
                          mesh=None,
                          seed: Optional[int] = None,
                          stream: int = STREAM_OUTER) -> PriceResult:
    """Randomized-QMC Hull-White European swaption: the exact draw is
    TWO dimensional ((x, int x) at expiry) — the regime where Sobol
    nets earn their full O(1/N) rate (same construction and measured
    ~order-of-magnitude stderr cut as `price_swaption_qmc`).

    ``mesh``: shard the SHIFT axis over a device mesh (n_shifts rounds
    up to a mesh multiple; each chip runs the full point set for its
    shifts, so the result is BITWISE mesh-invariant)."""
    import math as _math

    import numpy as _np

    from mc_tpu.qmc import sobol_directions

    spec = spec.validate()
    if n_shifts < 2:
        raise ValueError("n_shifts >= 2 required for an error estimate")
    if mesh is not None:
        n_shards = mesh.devices.size
        n_shifts = -(-n_shifts // n_shards) * n_shards
    p0, c, bmat, corr = _hw_tables(spec, dyn, curve)
    seed = sim.seed if seed is None else seed
    n = 1 << min(int(_math.log2(max(sim.n_paths, 2))), 20)
    zvec = jnp.asarray(sobol_directions(2).reshape(-1).astype(_np.int32))
    key = rng.derive_key(seed, stream, 0x51AD)
    sidx = jnp.arange(n_shifts * 2, dtype=jnp.uint32)
    bits, _ = rng.threefry2x32(jnp.uint32(key[0]), jnp.uint32(key[1]),
                               sidx, jnp.zeros_like(sidx))
    shifts = jax.lax.shift_right_logical(
        bits, jnp.uint32(2)).astype(jnp.int32).reshape(n_shifts, 2)
    if mesh is not None:
        return _hw_qmc_sharded_impl(
            spec, jnp.float32(dyn.a), jnp.float32(dyn.sigma_r), n,
            n_shifts, zvec, shifts, jnp.float32(p0[0]),
            jnp.float32(c[0]), (p0, bmat, corr), mesh)
    return _hw_qmc_impl(spec, jnp.float32(dyn.a),
                        jnp.float32(dyn.sigma_r), n, n_shifts, zvec,
                        shifts, jnp.float32(p0[0]), jnp.float32(c[0]),
                        (p0, bmat, corr))


@functools.partial(jax.jit,
                   static_argnames=("spec", "n", "n_shifts", "n_fit",
                                    "degree"))
def _hw_bermudan_qmc_impl(spec, a, sigma_r, n, n_shifts, n_fit, degree,
                          zvec, shifts, key_fit, p0_f, c_f, consts):
    """Frozen-policy randomized-QMC curve Bermudan: fit the LSMC policy
    on a plain-MC pilot (same key convention as the pricing LSMC), then
    price THAT policy on a 2*n_ex-dim Sobol net over the exact date
    grid.  n_ex = 1 is BITWISE `price_hw_swaption_qmc` (same net, same
    shift stream, matched arithmetic order)."""
    n_ex = spec.n_payments
    xf, yf = _simulate_rate_grid(spec, a, jnp.float32(0.0), sigma_r,
                                 jnp.float32(0.0), n_fit, n_ex, key_fit)
    scale = sigma_r / jnp.sqrt(2.0 * a)
    _, betas = _fit_hw_bermudan(spec, xf, yf, degree, scale, p0_f, c_f,
                                consts)
    one_shift = _hw_bermudan_qmc_shift_fn(spec, a, sigma_r, n, degree,
                                          zvec, betas, scale, p0_f,
                                          c_f, consts)
    means = jax.vmap(one_shift)(shifts)
    price = jnp.mean(means)
    stderr = jnp.std(means, ddof=1) / jnp.sqrt(jnp.float32(n_shifts))
    return PriceResult(price=price, stderr=stderr,
                       n_paths=jnp.float32(n * n_shifts),
                       payoff_mean=price, payoff_var=stderr * stderr)


def _hw_bermudan_qmc_shift_fn(spec, a, sigma_r, n, degree, zvec, betas,
                              scale, p0_f, c_f, consts):
    """shift -> frozen-policy per-shift mean (curve Bermudan); shared by
    the single-chip and shift-sharded programs."""

    from mc_tpu.models.swaption import _exact_xy_coeffs
    from mc_tpu.qmc import _sobol_u

    p0, bmat, corr = consts
    n_ex = spec.n_payments
    ids = jnp.arange(n, dtype=jnp.uint32)
    coeffs = [_exact_xy_coeffs(a, sigma_r,
                               jnp.float32(spec.expiry if i == 0
                                           else spec.tenor))
              for i in range(n_ex)]

    def one_shift(shift):
        def zdim(j):
            return rng.inv_normal_cdf(
                _sobol_u(ids, zvec, shift, jnp.int32(j)))

        x = jnp.zeros((n,), jnp.float32)
        y = jnp.zeros((n,), jnp.float32)
        cf = jnp.zeros((n,), jnp.float32)
        done = jnp.zeros((n,), bool)
        for i in range(n_ex):
            z0, z1 = zdim(2 * i), zdim(2 * i + 1)
            e1, big_b, l11, l21, l22 = coeffs[i]
            # matched order with _hw_qmc_impl so n_ex=1 is bitwise:
            # x starts at 0 -> x*e1 + l11 z0 == l11 z0 exactly; y
            # starts at 0 -> +0.0 is exact
            y = y + x * big_b + l21 * z0 + l22 * z1
            x = x * e1 + l11 * z0
            ex = _hw_intrinsic(spec, i, x, p0, bmat, corr)
            if i < n_ex - 1:
                cont = _mm(_hw_basis(x, scale, degree), betas[i])
                take = jnp.logical_and(ex > 0.0, ex > cont)
            else:
                take = ex > 0.0
            take = jnp.logical_and(take, jnp.logical_not(done))
            cf = jnp.where(take, ex * p0_f[i] * jnp.exp(-y - c_f[i]),
                           cf)
            done = jnp.logical_or(done, take)
        return jnp.mean(cf)

    return one_shift


@functools.partial(jax.jit,
                   static_argnames=("spec", "n", "n_shifts", "n_fit",
                                    "degree", "mesh"))
def _hw_bermudan_qmc_sharded_impl(spec, a, sigma_r, n, n_shifts, n_fit,
                                  degree, zvec, shifts, key_fit, p0_f,
                                  c_f, consts, mesh):
    """Shift-sharded frozen-policy QMC curve Bermudan: replicated pilot
    fit (identical betas per chip), shift axis over the mesh, full
    point set per shift per chip — mesh-size-invariant per-shift means
    (the `_hw_qmc_sharded_impl` construction on the Bermudan)."""
    from jax.sharding import PartitionSpec as P

    from mc_tpu.parallel.mesh import PATHS_AXIS

    n_ex = spec.n_payments
    xf, yf = _simulate_rate_grid(spec, a, jnp.float32(0.0), sigma_r,
                                 jnp.float32(0.0), n_fit, n_ex, key_fit)
    scale = sigma_r / jnp.sqrt(2.0 * a)
    _, betas = _fit_hw_bermudan(spec, xf, yf, degree, scale, p0_f, c_f,
                                consts)

    def shard_fn(zvec, shifts_local, a, sigma_r, betas, scale, p0_f,
                 c_f, consts):
        one_shift = _hw_bermudan_qmc_shift_fn(
            spec, a, sigma_r, n, degree, zvec, betas, scale, p0_f, c_f,
            consts)
        means_local = jax.vmap(one_shift)(shifts_local)
        return jax.lax.all_gather(means_local, PATHS_AXIS, tiled=True)

    means = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(PATHS_AXIS), P(), P(), P(), P(), P(), P(),
                  P()),
        out_specs=P(),
        check_vma=False,
    )(zvec, shifts, a, sigma_r, betas, scale, p0_f, c_f, consts)
    price = jnp.mean(means)
    stderr = jnp.std(means, ddof=1) / jnp.sqrt(jnp.float32(n_shifts))
    return PriceResult(price=price, stderr=stderr,
                       n_paths=jnp.float32(n * n_shifts),
                       payoff_mean=price, payoff_var=stderr * stderr)


def price_bermudan_hw_swaption_qmc(spec: SwaptionSpec = DEMO_SWAPTION,
                                   dyn: HullWhiteDynamics = DEMO_HW,
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
    """Frozen-policy QMC Bermudan on the market curve (the
    `price_bermudan_swaption_qmc` construction with curve intrinsics
    and curve discounting).  ``mesh``: shard the shift axis (replicated
    pilot fit; mesh-size-invariant per-shift means)."""
    import math as _math

    import numpy as _np

    from mc_tpu.qmc import sobol_directions

    spec = spec.validate()
    if n_shifts < 2:
        raise ValueError("n_shifts >= 2 required for an error estimate")
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}")
    p0, c, bmat, corr = _hw_tables(spec, dyn, curve)
    seed = sim.seed if seed is None else seed
    if mesh is not None:
        n_shards = mesh.devices.size
        n_shifts = -(-n_shifts // n_shards) * n_shards
    n = 1 << min(int(_math.log2(max(sim.n_paths, 2))), 20)
    d = 2 * spec.n_payments
    zvec = jnp.asarray(sobol_directions(d).reshape(-1).astype(_np.int32))
    key = rng.derive_key(seed, stream, 0x51AD)
    key_fit = jnp.asarray(rng.derive_key(seed, stream, 0x4877),
                          jnp.uint32)
    sidx = jnp.arange(n_shifts * d, dtype=jnp.uint32)
    bits, _ = rng.threefry2x32(jnp.uint32(key[0]), jnp.uint32(key[1]),
                               sidx, jnp.zeros_like(sidx))
    shifts = jax.lax.shift_right_logical(
        bits, jnp.uint32(2)).astype(jnp.int32).reshape(n_shifts, d)
    if mesh is not None:
        return _hw_bermudan_qmc_sharded_impl(
            spec, jnp.float32(dyn.a), jnp.float32(dyn.sigma_r), n,
            n_shifts, n_fit, degree, zvec, shifts, key_fit,
            jnp.asarray(p0, jnp.float32), jnp.asarray(c, jnp.float32),
            (p0, bmat, corr), mesh)
    return _hw_bermudan_qmc_impl(
        spec, jnp.float32(dyn.a), jnp.float32(dyn.sigma_r), n, n_shifts,
        n_fit, degree, zvec, shifts, key_fit,
        jnp.asarray(p0, jnp.float32), jnp.asarray(c, jnp.float32),
        (p0, bmat, corr))


def _hw_basis(x, scale, degree: int):
    """Monomials of the OU factor normalized by its stationary std."""
    cols = [jnp.ones_like(x)]
    xn = x / scale
    pw = xn
    for _ in range(degree):
        cols.append(pw)
        pw = pw * xn
    return jnp.stack(cols, axis=-1)


def _fit_hw_bermudan(spec, x_grid, y_grid, degree, scale, p0_f, c_f,
                     consts):
    """Backward Longstaff-Schwartz on the coupon grid under curve-fitted
    Hull-White: realized discounted-to-0 cashflows AND the per-date
    betas.  Regression in DATE-i FORWARD terms (cashflow divided by the
    path's own discount-to-0) against an x-only basis — the same
    convention as the Vasicek Bermudan (`swaption._fit_bermudan`), so
    the fitted policy is a function of the Markov state alone."""
    p0, bmat, corr = consts
    n_ex = spec.n_payments

    def disc(i):
        return p0_f[i] * jnp.exp(-y_grid[i] - c_f[i])

    cf = (_hw_intrinsic(spec, n_ex - 1, x_grid[n_ex - 1], p0, bmat,
                        corr) * p0_f[n_ex - 1]
          * jnp.exp(-y_grid[n_ex - 1] - c_f[n_ex - 1]))
    betas = [None] * max(n_ex - 1, 0)
    for i in range(n_ex - 2, -1, -1):
        ex = _hw_intrinsic(spec, i, x_grid[i], p0, bmat, corr)
        itm = ex > 0.0
        xb = _hw_basis(x_grid[i], scale, degree)
        w = jnp.where(itm, 1.0, 0.0)[:, None]
        xtx = _mm((xb * w).T, xb) + 1e-6 * jnp.eye(xb.shape[1],
                                               dtype=xb.dtype)
        xty = _mm((xb * w).T, cf / disc(i))
        beta = jax.lax.stop_gradient(jnp.linalg.solve(xtx, xty))
        betas[i] = beta
        cont = _mm(xb, beta)
        take = jnp.logical_and(itm, ex > cont)
        cf = jnp.where(take,
                       ex * p0_f[i] * jnp.exp(-y_grid[i] - c_f[i]), cf)
    return cf, betas


@functools.partial(jax.jit, static_argnames=("spec", "n_paths",
                                             "degree"))
def _hw_bermudan_impl(spec, a, sigma_r, n_paths, degree, key, p0_f, c_f,
                      consts):
    """n_payments = 1 is BITWISE the European (same key, same
    arithmetic order, no regression)."""
    n_ex = spec.n_payments
    x_grid, y_grid = _simulate_rate_grid(
        spec, a, jnp.float32(0.0), sigma_r, jnp.float32(0.0), n_paths,
        n_ex, key)
    scale = sigma_r / jnp.sqrt(2.0 * a)  # stationary OU std
    cf, _ = _fit_hw_bermudan(spec, x_grid, y_grid, degree, scale, p0_f,
                             c_f, consts)
    n = jnp.float32(n_paths)
    return summarize(jnp.sum(cf), jnp.sum(cf * cf), n, 1.0)


def _hw_swaption_sharded_impl(spec, a, sigma_r, n_paths, degree, style,
                              mesh, key, p0_f, c_f, consts):
    from jax.sharding import PartitionSpec as P

    from mc_tpu.parallel.mesh import PATHS_AXIS

    p0, bmat, corr = consts
    n_shards = mesh.devices.size
    n_local = -(-n_paths // n_shards)  # ceil; overhang masked below
    n_ex = 1 if style == "european" else spec.n_payments
    scale = sigma_r / jnp.sqrt(2.0 * a)

    def shard_fn(key):
        rank = jax.lax.axis_index(PATHS_AXIS).astype(jnp.uint32)
        off = rank * jnp.uint32(n_local)
        mask = (off + jnp.arange(n_local, dtype=jnp.uint32)
                < jnp.uint32(n_paths))
        x_grid, y_grid = _simulate_rate_grid(
            spec, a, jnp.float32(0.0), sigma_r, jnp.float32(0.0),
            n_local, n_ex, key, off)

        def disc(i):
            return p0_f[i] * jnp.exp(-y_grid[i] - c_f[i])

        if style == "european":
            cf = (_hw_intrinsic(spec, 0, x_grid[0], p0, bmat, corr)
                  * p0_f[0] * jnp.exp(-y_grid[0] - c_f[0]))
        else:
            cf = (_hw_intrinsic(spec, n_ex - 1, x_grid[n_ex - 1], p0,
                                bmat, corr) * p0_f[n_ex - 1]
                  * jnp.exp(-y_grid[n_ex - 1] - c_f[n_ex - 1]))
            for i in range(n_ex - 2, -1, -1):
                # date-i FORWARD regression, psum'd normal equations ->
                # every chip fits the IDENTICAL policy
                ex = _hw_intrinsic(spec, i, x_grid[i], p0, bmat, corr)
                itm = jnp.logical_and(ex > 0.0, mask)
                xb = _hw_basis(x_grid[i], scale, degree)
                w = jnp.where(itm, 1.0, 0.0)[:, None]
                xtx = (jax.lax.psum(_mm((xb * w).T, xb), PATHS_AXIS)
                       + 1e-6 * jnp.eye(xb.shape[1], dtype=xb.dtype))
                xty = jax.lax.psum(_mm((xb * w).T, cf / disc(i)),
                                   PATHS_AXIS)
                beta = jax.lax.stop_gradient(jnp.linalg.solve(xtx, xty))
                cont = _mm(xb, beta)
                take = jnp.logical_and(itm, ex > cont)
                cf = jnp.where(take,
                               ex * p0_f[i]
                               * jnp.exp(-y_grid[i] - c_f[i]), cf)
        cf = jnp.where(mask, cf, 0.0)
        return (jax.lax.psum(jnp.sum(cf), PATHS_AXIS),
                jax.lax.psum(jnp.sum(cf * cf), PATHS_AXIS))

    s, sq = jax.shard_map(shard_fn, mesh=mesh, in_specs=(P(),),
                          out_specs=P(), check_vma=False)(key)
    return summarize(s, sq, jnp.float32(n_paths), 1.0)


def price_hw_swaption_sharded(spec: SwaptionSpec = DEMO_SWAPTION,
                              dyn: HullWhiteDynamics = DEMO_HW,
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
    """European or Bermudan curve swaption with paths sharded over the
    mesh (global-id streams; the Bermudan's normal equations psum so
    every chip fits the identical policy).  A 1-device mesh simulates
    the IDENTICAL path set (same streams, same per-path cashflows);
    the final mean can differ from the single-chip pricer by XLA
    reduction-order at the last ulp (the single-chip program fuses its
    reduction differently), gated <= 3e-7 relative."""
    from mc_tpu.parallel.mesh import make_mesh

    spec = spec.validate()
    if style not in ("european", "bermudan"):
        raise ValueError(f"style must be european|bermudan, got {style!r}")
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}")
    mesh = make_mesh() if mesh is None else mesh
    p0, c, bmat, corr = _hw_tables(spec, dyn, curve)
    seed = sim.seed if seed is None else seed
    key = jnp.asarray(rng.derive_key(seed, stream, 0x4877), jnp.uint32)
    return _hw_swaption_sharded_impl(
        spec, jnp.float32(dyn.a), jnp.float32(dyn.sigma_r), sim.n_paths,
        degree, style, mesh, key, jnp.asarray(p0, jnp.float32),
        jnp.asarray(c, jnp.float32), (p0, bmat, corr))


@functools.partial(jax.jit, static_argnames=("n_paths", "payoff"))
def _hw_equity_impl(n_paths, payoff, s0, k, q, sigma_s, chol, dalpha,
                    p0t, cT, t, key):
    ko0 = jnp.asarray(key[0], jnp.uint32)
    ko1 = jnp.asarray(key[1], jnp.uint32)
    ids = jnp.arange(n_paths, dtype=jnp.uint32)
    z0, z1 = rng.normal_pair(ko0, ko1, ids, jnp.zeros_like(ids))
    y = chol[0, 0] * z0                       # int_0^T x
    g = chol[1, 0] * z0 + chol[1, 1] * z1     # sigma_s W_T
    # log S_T = ln S0 + int r - qT - sigma^2 T/2 + g,
    # int r = y + int alpha  (dalpha = -ln P(0,T) + c(T))
    s_t = s0 * jnp.exp(dalpha + y - q * t
                       - 0.5 * sigma_s * sigma_s * t + g)
    disc = p0t * jnp.exp(-y - cT)             # pathwise e^{-int r}
    if payoff == "call":
        pay = jnp.maximum(s_t - k, 0.0) * disc
    else:
        pay = jnp.maximum(k - s_t, 0.0) * disc
    n = jnp.float32(n_paths)
    return summarize(jnp.sum(pay), jnp.sum(pay * pay), n, 1.0)


def price_hw_equity(option=None,
                    dyn: HullWhiteDynamics = DEMO_HW,
                    curve: DiscountCurve = DEMO_CURVE,
                    sim: SimParams = SimParams(n_paths=1 << 20,
                                               n_steps=1),
                    payoff: str = "call",
                    *,
                    rho: float = -0.3,
                    seed: Optional[int] = None,
                    stream: int = STREAM_OUTER) -> PriceResult:
    """European equity option under GBM + CURVE-FITTED stochastic rates
    — the hybrid-desk model (the flat-b Vasicek hybrid `price_vasicek`
    generalized to an input discount curve).

    ONE exact joint draw of (int x, equity Brownian) at expiry (their
    covariance rho sigma_s (sigma_r/a)(T - B) is closed-form), pathwise
    curve discounting P(0,T) e^{-int x - Var/2}.  Oracle:
    `oracle.hw_equity_call` (Merton-73 on the curve — the integrated
    variance never involves the rate drift, so it is `bsv_call` with
    the curve bond).  Pathwise put-call parity is exact: call - put =
    S0 e^{-qT} - K P(0,T) on the same draws (gated)."""
    from mc_tpu.config import DEMO_OPTION
    option = (DEMO_OPTION if option is None else option).as_f32()
    dyn.validate()
    if payoff not in ("call", "put"):
        raise ValueError(f"payoff must be call|put, got {payoff!r}")
    if not -1.0 <= rho <= 1.0:
        raise ValueError(f"rho must be in [-1, 1], got {rho}")
    a, sig_r = float(dyn.a), float(dyn.sigma_r)
    t = float(option.t)
    sigma_s = float(option.sigma)
    bt = -math.expm1(-a * t) / a
    c2 = -math.expm1(-2.0 * a * t) / (2.0 * a)
    var_y = (sig_r * sig_r / (a * a)) * (t - 2.0 * bt + c2)
    var_g = sigma_s * sigma_s * t
    cov = rho * sigma_s * (sig_r / a) * (t - bt)
    m = np.array([[var_y, cov], [cov, var_g]], np.float64)
    m += 1e-12 * np.trace(m) / 2.0 * np.eye(2)
    chol = jnp.asarray(np.linalg.cholesky(m), jnp.float32)
    p0t = curve.df(t)
    c_t = 0.5 * var_y                     # Var[int x]/2
    dalpha = -math.log(p0t) + c_t         # int_0^T alpha
    seed = sim.seed if seed is None else seed
    key = jnp.asarray(rng.derive_key(seed, stream, 0x48EB), jnp.uint32)
    return _hw_equity_impl(sim.n_paths, payoff,
                           jnp.float32(option.s0), jnp.float32(option.k),
                           jnp.float32(option.q), jnp.float32(sigma_s),
                           chol, jnp.float32(dalpha), jnp.float32(p0t),
                           jnp.float32(c_t), jnp.float32(t), key)


def hw_swap_book_exposure(specs, dyn: HullWhiteDynamics = DEMO_HW,
                          curve: DiscountCurve = DEMO_CURVE,
                          sim: SimParams = SimParams(n_paths=1 << 16,
                                                     n_steps=1),
                          *,
                          weights=None,
                          seed: Optional[int] = None,
                          stream: int = STREAM_OUTER):
    """NETTING SET of swaps under curve-fitted Hull-White.

    ``specs``: SwaptionSpecs sharing expiry and tenor (the coupon
    grid); per-swap fixed rates, payer/receiver sides, and payment
    counts may differ (shorter swaps contribute zero MtM past their
    last coupon).  All swaps ride ONE rate grid (common random
    numbers), and each swap's MtM is affine in the same bonds — so the
    netted value matrix is BITWISE the weighted sum of the standalone
    `hw_swap_exposure` matrices (gated), while the netted EE is
    subadditive: EE_net <= sum of standalone EEs, the portfolio effect
    netting exists to capture.  Returns a `CollateralizedExposure`
    of the netted values (full XVA metric set at the counterparty
    level)."""
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
        e = hw_swap_exposure(s, dyn, curve, sim, seed=seed,
                             stream=stream)
        v = e.values * jnp.float32(w)
        if v.shape[1] < n_ex:  # shorter swap: zero MtM past its end
            pad = jnp.zeros((v.shape[0], n_ex - v.shape[1]), v.dtype)
            v = jnp.concatenate([v, pad], axis=1)
        net = v if net is None else net + v
    from mc_tpu.xva import CollateralizedExposure, coupon_dates
    horizon = e0 + (n_ex - 1) * t0
    return CollateralizedExposure(values=net,
                                  t_horizon=jnp.float32(horizon),
                                  obs_dates=coupon_dates(e0, t0, n_ex))


def hw_swaption_greeks(spec: SwaptionSpec = DEMO_SWAPTION,
                       dyn: HullWhiteDynamics = DEMO_HW,
                       curve: DiscountCurve = DEMO_CURVE,
                       sim: SimParams = SimParams(n_paths=1 << 18,
                                                  n_steps=1),
                       *,
                       style: str = "european",
                       degree: int = 3,
                       which=("curve_dv01", "vega_r"),
                       seed: Optional[int] = None,
                       stream: int = STREAM_OUTER):
    """Swaption price sensitivities on the curve by CRN central
    differences: ``curve_dv01`` — price change per +1bp parallel shift
    of the zero curve (the rates greek desks hedge with), ``vega_r`` —
    d/d sigma_r, ``kappa`` — d/d a.  Works for the European AND the
    Bermudan (the frozen-key bumps re-fit the policy on the same
    draws, the standard CRN construction).  European gates vs FD of
    the Jamshidian oracle."""
    allowed = ("curve_dv01", "vega_r", "kappa")
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
            r = price_hw_swaption(spec, d, cv, sim, seed=seed,
                                  stream=stream)
        else:
            r = price_bermudan_hw_swaption(spec, d, cv, sim,
                                           degree=degree, seed=seed,
                                           stream=stream)
        return float(r.price)

    out = {}
    for g in which:
        if g == "curve_dv01":
            h = 1e-4
            out[g] = (px(curve_bump=h) - px(curve_bump=-h)) \
                / (2 * h) * 1e-4
        elif g == "vega_r":
            h = 1e-4
            out[g] = (px(dyn_=HullWhiteDynamics(dyn.a, dyn.sigma_r + h))
                      - px(dyn_=HullWhiteDynamics(
                          dyn.a, dyn.sigma_r - h))) / (2 * h)
        else:
            h = 1e-3
            out[g] = (px(dyn_=HullWhiteDynamics(dyn.a + h, dyn.sigma_r))
                      - px(dyn_=HullWhiteDynamics(
                          dyn.a - h, dyn.sigma_r))) / (2 * h)
    return out


# ---------------------------------------------------------------------------
# Key-rate (bucketed) curve risk.  `curve_dv01` above is the PARALLEL
# aggregate; the hedging desk needs the per-pillar ladder (which swap
# quotes to trade).  Under Hull-White the OU factor is curve-free —
# only the p0 table depends on the curve — so the whole ladder of
# knot-bumped repricings shares ONE simulated draw set and runs as ONE
# batched device call (vmap over stacked p0 rows).  The reference has
# no greeks at all (/root/reference/hello.cu prints prices only).
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("spec", "n_paths"))
def _hw_ladder_impl(spec, a, sigma_r, n_paths, key, p0_mat, c_0, bmat,
                    corr):
    """Mean European price per row of ``p0_mat`` (m, n_payments+1) —
    the rate grid is simulated once (it does not depend on the curve)
    and the affine payoff re-evaluates per bumped-curve row."""
    x_grid, y_grid = _simulate_rate_grid(
        spec, a, jnp.float32(0.0), sigma_r, jnp.float32(0.0), n_paths,
        1, key)
    x, y = x_grid[0], y_grid[0]
    disc = jnp.exp(-y - c_0)
    inv_n = jnp.float32(1.0) / jnp.float32(n_paths)

    def one(p0):
        pay = (_hw_intrinsic(spec, 0, x, p0, bmat, corr)
               * jnp.float32(p0[0]) * disc)
        return jnp.sum(pay) * inv_n

    return jax.vmap(one)(p0_mat)


def hw_swaption_bucket_dv01(spec: SwaptionSpec = DEMO_SWAPTION,
                            dyn: HullWhiteDynamics = DEMO_HW,
                            curve: DiscountCurve = DEMO_CURVE,
                            sim: SimParams = SimParams(n_paths=1 << 18,
                                                       n_steps=1),
                            *,
                            style: str = "european",
                            degree: int = 3,
                            bump: float = 1e-4,
                            seed: Optional[int] = None,
                            stream: int = STREAM_OUTER) -> np.ndarray:
    """Key-rate DV01 ladder: price change per +1bp bump of EACH
    zero-curve knot (CRN central differences at ``bump``), one entry
    per ``curve.times`` pillar.

    Gates: the ladder SUMS to `hw_swaption_greeks`'s parallel
    ``curve_dv01`` (a +1bp parallel shift is the sum of the knot bumps
    to first order), each material bucket matches per-knot FD of the
    Jamshidian oracle, and pillars no coupon date interpolates through
    carry EXACTLY zero (risk localizes).  For ``style="bermudan"`` the
    frozen-key bumps re-fit the policy on the same draws (the
    `hw_swaption_greeks` CRN convention)."""
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
            up = price_bermudan_hw_swaption(spec, dyn, bumped(k, bump),
                                            sim, degree=degree,
                                            seed=seed, stream=stream)
            dn = price_bermudan_hw_swaption(spec, dyn, bumped(k, -bump),
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
    _, c, bmat, corr = _hw_tables(spec, dyn, curve)
    key = jnp.asarray(rng.derive_key(seed, stream, 0x4877), jnp.uint32)
    prices = np.asarray(_hw_ladder_impl(
        spec, jnp.float32(dyn.a), jnp.float32(dyn.sigma_r), sim.n_paths,
        key, p0_mat, jnp.float32(c[0]), bmat, corr), np.float64)
    return (prices[:n_knots] - prices[n_knots:]) / (2 * bump) * 1e-4


HW_CVA_GREEK_FIELDS = ("curve_dv01", "vega_r", "kappa")


def hw_swap_cva_greeks(spec: SwaptionSpec = DEMO_SWAPTION,
                       dyn: HullWhiteDynamics = DEMO_HW,
                       curve: DiscountCurve = DEMO_CURVE,
                       sim: SimParams = SimParams(n_paths=1 << 16,
                                                  n_steps=1),
                       *,
                       hazard_rate: float,
                       recovery: float = 0.4,
                       which=("curve_dv01", "vega_r"),
                       projection_curve: Optional[DiscountCurve] = None,
                       seed: Optional[int] = None,
                       stream: int = STREAM_OUTER):
    """d(swap CVA)/d(market) under curve-fitted Hull-White by CRN
    central differences (the curve/vol tables are host-f64 precomputed,
    so AD cannot flow through them; common random numbers make the FD
    exact up to second order, the `merton_greeks` pattern).

    Greeks: ``curve_dv01`` — a +1bp PARALLEL shift of the zero curve
    (the desk's curve-delta aggregate); ``vega_r`` — d/d sigma_r;
    ``kappa`` — d/d a.  Every EE point is an `oracle.hw_swaption`
    price, so the test gates curve_dv01/vega_r against FD of the
    closed-form strip CVA."""
    bad = set(which) - set(HW_CVA_GREEK_FIELDS)
    if bad:
        raise ValueError(f"unknown greeks {sorted(bad)}; available: "
                         f"{list(HW_CVA_GREEK_FIELDS)}")
    seed = sim.seed if seed is None else seed

    def cva_at(curve_bump=0.0, dyn_=None):
        cv = (curve if curve_bump == 0.0 else
              DiscountCurve(curve.times,
                            np.asarray(curve.zeros) + curve_bump))
        pj = projection_curve
        if pj is not None and curve_bump != 0.0:
            pj = DiscountCurve(pj.times,
                               np.asarray(pj.zeros) + curve_bump)
        e = hw_swap_exposure(spec, dyn_ or dyn, cv, sim,
                             projection_curve=pj, seed=seed,
                             stream=stream)
        return float(e.cva(hazard_rate, recovery))

    out = {}
    for g in which:
        if g == "curve_dv01":
            h = 1e-4  # 1bp
            out[g] = (cva_at(curve_bump=h)
                      - cva_at(curve_bump=-h)) / (2 * h) * 1e-4
        elif g == "vega_r":
            h = 1e-4
            out[g] = (cva_at(dyn_=HullWhiteDynamics(dyn.a,
                                                    dyn.sigma_r + h))
                      - cva_at(dyn_=HullWhiteDynamics(
                          dyn.a, dyn.sigma_r - h))) / (2 * h)
        else:  # kappa
            h = 1e-3
            out[g] = (cva_at(dyn_=HullWhiteDynamics(dyn.a + h,
                                                    dyn.sigma_r))
                      - cva_at(dyn_=HullWhiteDynamics(
                          dyn.a - h, dyn.sigma_r))) / (2 * h)
    return out


def _hw_policy_machinery(spec, a, sigma_r, degree, betas, key, scale,
                         p0_f, c_f, consts):
    """(step_tenor, draws, policy_value) for frozen-policy rollouts
    under curve-fitted Hull-White — the `swaption._policy_machinery`
    construction with curve intrinsics and curve discounting (value at
    exercise date u is ex * P(0,t_u) e^{-y - c_u}, y the rollout's own
    accumulated int x)."""
    from mc_tpu.models.rates_policy import (check_rollout_dates,
                                            frozen_policy_value)
    from mc_tpu.models.swaption import _exact_xy_coeffs
    p0, bmat, corr = consts
    n_ex = spec.n_payments
    check_rollout_dates(n_ex)
    k0 = jnp.asarray(key[0], jnp.uint32)
    k1 = jnp.asarray(key[1], jnp.uint32)
    e1, big_b, l11, l21, l22 = _exact_xy_coeffs(
        a, sigma_r, jnp.float32(spec.tenor))

    def step_tenor(x, y, z0, z1):
        y = y + x * big_b + (l21 * z0 + l22 * z1)
        return x * e1 + l11 * z0, y

    def draws(ids, tag, u):
        c1 = (jnp.full(ids.shape, 0, jnp.uint32)
              + jnp.uint32(tag) * jnp.uint32(64) + jnp.uint32(u))
        return rng.normal_pair(k0, k1, ids, c1)

    def policy_value(i, x, y, ids, tag):
        return frozen_policy_value(
            n_ex, i, (x, y), ids, tag, draws=draws,
            step=lambda st, zs: step_tenor(st[0], st[1], zs[0], zs[1]),
            exercise=lambda u, st: _hw_intrinsic(spec, u, st[0], p0,
                                                 bmat, corr),
            continuation=lambda u, st: _mm(_hw_basis(st[0], scale, degree),
                                           betas[u]),
            cashflow=lambda u, ex, st: (ex * p0_f[u]
                                        * jnp.exp(-st[1] - c_f[u])))

    return step_tenor, draws, policy_value


@functools.partial(jax.jit,
                   static_argnames=("spec", "n_paths", "degree",
                                    "n_branch"))
def _hw_bounds_impl(spec, a, sigma_r, n_paths, degree, n_branch, key,
                    key_dual, p0_f, c_f, consts):
    from mc_tpu.models.swaption import _ab_bracket
    n_ex = spec.n_payments
    x_grid, y_grid = _simulate_rate_grid(
        spec, a, jnp.float32(0.0), sigma_r, jnp.float32(0.0), n_paths,
        n_ex, key)
    scale = sigma_r / jnp.sqrt(2.0 * a)
    cf, betas = _fit_hw_bermudan(spec, x_grid, y_grid, degree, scale,
                                 p0_f, c_f, consts)
    n = jnp.float32(n_paths)
    lower = summarize(jnp.sum(cf), jnp.sum(cf * cf), n, 1.0)

    step_tenor, draws, policy_value = _hw_policy_machinery(
        spec, a, sigma_r, degree, betas, key_dual, scale, p0_f, c_f,
        consts)
    p0, bmat, corr = consts

    def z_at(i):
        return (_hw_intrinsic(spec, i, x_grid[i], p0, bmat, corr)
                * p0_f[i] * jnp.exp(-y_grid[i] - c_f[i]))

    def v_at(i, ids_b):
        return policy_value(
            i, jnp.broadcast_to(x_grid[i], ids_b.shape),
            jnp.broadcast_to(y_grid[i], ids_b.shape), ids_b, tag=3 * i)

    def cond_at(i, ids_b):
        zb0, zb1 = draws(ids_b, 3 * i + 1, 63)
        xb, yb = step_tenor(
            jnp.broadcast_to(x_grid[i - 1], ids_b.shape),
            jnp.broadcast_to(y_grid[i - 1], ids_b.shape), zb0, zb1)
        return policy_value(i, xb, yb, ids_b, tag=3 * i + 2)

    upper = _ab_bracket(n_ex, n_paths, n_branch, z_at, v_at, cond_at)
    return lower, upper


def bermudan_hw_swaption_bounds(spec: SwaptionSpec = DEMO_SWAPTION,
                                dyn: HullWhiteDynamics = DEMO_HW,
                                curve: DiscountCurve = DEMO_CURVE,
                                sim: SimParams = SimParams(
                                    n_paths=4096, n_steps=1),
                                *,
                                degree: int = 3,
                                n_branch: int = 32,
                                seed: Optional[int] = None,
                                stream: int = STREAM_OUTER):
    """(lower, upper) bracketing the curve Bermudan: LSMC lower bound
    plus the Andersen-Broadie dual of the SAME fitted policy (the
    shared `_ab_bracket` running max; both value legs branch-averaged).
    Lower is BITWISE `price_bermudan_hw_swaption` at the same sim."""
    spec = spec.validate()
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}")
    if n_branch < 2:
        raise ValueError(f"n_branch must be >= 2, got {n_branch}")
    if sim.n_paths > (1 << 22):
        raise ValueError(
            "bermudan_hw_swaption_bounds shards branch streams by "
            f"id + branch * 2^22: n_paths must be <= 2^22, got "
            f"{sim.n_paths}")
    p0, c, bmat, corr = _hw_tables(spec, dyn, curve)
    seed = sim.seed if seed is None else seed
    key = jnp.asarray(rng.derive_key(seed, stream, 0x4877), jnp.uint32)
    kd = jnp.asarray(rng.derive_key(seed, stream, 0x4879), jnp.uint32)
    return _hw_bounds_impl(spec, jnp.float32(dyn.a),
                           jnp.float32(dyn.sigma_r), sim.n_paths,
                           degree, n_branch, key, kd,
                           jnp.asarray(p0, jnp.float32),
                           jnp.asarray(c, jnp.float32),
                           (p0, bmat, corr))


@functools.partial(jax.jit,
                   static_argnames=("spec", "n_paths", "n_inner",
                                    "n_fit", "degree"))
def _hw_bermudan_exposure_impl(spec, a, sigma_r, n_paths, n_inner,
                               n_fit, degree, key_fit, key_outer,
                               key_inner, p0_f, c_f, consts):
    n_ex = spec.n_payments
    scale = sigma_r / jnp.sqrt(2.0 * a)
    xf, yf = _simulate_rate_grid(spec, a, jnp.float32(0.0), sigma_r,
                                 jnp.float32(0.0), n_fit, n_ex, key_fit)
    _, betas = _fit_hw_bermudan(spec, xf, yf, degree, scale, p0_f, c_f,
                                consts)
    x_grid, y_grid = _simulate_rate_grid(
        spec, a, jnp.float32(0.0), sigma_r, jnp.float32(0.0), n_paths,
        n_ex, key_outer)
    _, _, policy_value = _hw_policy_machinery(
        spec, a, sigma_r, degree, betas, key_inner, scale, p0_f, c_f,
        consts)
    p0, bmat, corr = consts
    ids = jnp.arange(n_paths, dtype=jnp.uint32)
    ids_b = (ids[None, :]
             + (jnp.arange(n_inner, dtype=jnp.uint32)[:, None]
                + jnp.uint32(1)) * jnp.uint32(1 << 22))
    alive = jnp.ones((n_paths,), bool)
    vals = []
    for i in range(n_ex):
        ex = _hw_intrinsic(spec, i, x_grid[i], p0, bmat, corr)
        if i < n_ex - 1:
            cont = _mm(_hw_basis(x_grid[i], scale, degree), betas[i])
            take = jnp.logical_and(ex > 0.0, ex > cont)
        else:
            take = ex > 0.0
        v_i = jnp.mean(policy_value(
            i, jnp.broadcast_to(x_grid[i], ids_b.shape),
            jnp.broadcast_to(y_grid[i], ids_b.shape), ids_b, tag=i),
            axis=0)
        vals.append(jnp.where(alive, v_i, 0.0))
        alive = jnp.logical_and(alive, jnp.logical_not(take))
    return jnp.stack(vals, axis=1)


def bermudan_hw_swaption_exposure(spec: SwaptionSpec = DEMO_SWAPTION,
                                  dyn: HullWhiteDynamics = DEMO_HW,
                                  curve: DiscountCurve = DEMO_CURVE,
                                  sim: SimParams = SimParams(
                                      n_paths=4096, n_steps=1,
                                      n_paths_inner=16),
                                  *,
                                  degree: int = 3,
                                  n_fit: int = 16384,
                                  seed: Optional[int] = None,
                                  stream: int = STREAM_OUTER):
    """Exposure of a long Bermudan swaption ON THE MARKET CURVE: MtM at
    every coupon date by frozen-policy rollouts (the shared machinery
    of the AB dual), exercise ABSORBS — so the EE profile telescopes,
    nonincreasing with EE(t_0) at the Bermudan (policy) price.
    Returns a `CollateralizedExposure` (full XVA metric set)."""
    spec = spec.validate()
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}")
    if sim.n_paths > (1 << 22):
        raise ValueError(
            "bermudan_hw_swaption_exposure shards rollout streams by "
            f"id + branch * 2^22: n_paths must be <= 2^22, got "
            f"{sim.n_paths}")
    p0, c, bmat, corr = _hw_tables(spec, dyn, curve)
    seed = sim.seed if seed is None else seed
    key_fit = jnp.asarray(rng.derive_key(seed, stream, 0x4877),
                          jnp.uint32)
    key_outer = jnp.asarray(rng.derive_key(seed, stream, 0x487A),
                            jnp.uint32)
    key_inner = jnp.asarray(rng.derive_key(seed, stream, 0x487B),
                            jnp.uint32)
    values = _hw_bermudan_exposure_impl(
        spec, jnp.float32(dyn.a), jnp.float32(dyn.sigma_r), sim.n_paths,
        sim.n_paths_inner, n_fit, degree, key_fit, key_outer, key_inner,
        jnp.asarray(p0, jnp.float32), jnp.asarray(c, jnp.float32),
        (p0, bmat, corr))
    from mc_tpu.xva import CollateralizedExposure, coupon_dates
    horizon = spec.expiry + (spec.n_payments - 1) * spec.tenor
    return CollateralizedExposure(
        values=values, t_horizon=jnp.float32(horizon),
        obs_dates=coupon_dates(spec.expiry, spec.tenor, spec.n_payments))


def price_bermudan_hw_swaption(spec: SwaptionSpec = DEMO_SWAPTION,
                               dyn: HullWhiteDynamics = DEMO_HW,
                               curve: DiscountCurve = DEMO_CURVE,
                               sim: SimParams = SimParams(
                                   n_paths=1 << 18, n_steps=1),
                               *,
                               degree: int = 3,
                               seed: Optional[int] = None,
                               stream: int = STREAM_OUTER
                               ) -> PriceResult:
    """Co-terminal Bermudan swaption on the MARKET CURVE: exercise at
    every coupon date into the remaining swap, closed-form curve
    intrinsics, LSMC continuation in the OU state.  Gates: 1-payment
    BITWISE == `price_hw_swaption`; sigma -> 0 collapses exactly to the
    max over dates of the curve's discounted forward-swap intrinsics;
    dominates the European Jamshidian price."""
    spec = spec.validate()
    if degree < 1:
        raise ValueError(f"degree must be >= 1, got {degree}")
    p0, c, bmat, corr = _hw_tables(spec, dyn, curve)
    seed = sim.seed if seed is None else seed
    key = jnp.asarray(rng.derive_key(seed, stream, 0x4877), jnp.uint32)
    return _hw_bermudan_impl(spec, jnp.float32(dyn.a),
                             jnp.float32(dyn.sigma_r), sim.n_paths,
                             degree, key, jnp.asarray(p0, jnp.float32),
                             jnp.asarray(c, jnp.float32),
                             (p0, bmat, corr))


@functools.partial(jax.jit, static_argnames=("spec", "n_paths"))
def _hw_exposure_impl(spec, a, sigma_r, n_paths, key, p0_f, c_f, consts):
    p0, bmat, corr = consts
    n_ex = spec.n_payments
    x_grid, y_grid = _simulate_rate_grid(
        spec, a, jnp.float32(0.0), sigma_r, jnp.float32(0.0), n_paths,
        n_ex, key)
    vals = []
    for i in range(n_ex):
        # SIGNED swap MtM (the metrics layer takes the positive part)
        fixed = jnp.zeros_like(x_grid[i])
        for j in range(i + 1, n_ex + 1):
            p_ij = (jnp.float32(p0[j] / p0[i])
                    * jnp.exp(-jnp.float32(bmat[i, j]) * x_grid[i]
                              - jnp.float32(corr[i, j])))
            fixed = fixed + jnp.float32(spec.k_rate * spec.tenor) * p_ij
            if j == n_ex:
                fixed = fixed + p_ij
        mtm = 1.0 - fixed
        if not spec.payer:
            mtm = -mtm
        vals.append(mtm * p0_f[i] * jnp.exp(-y_grid[i] - c_f[i]))
    return jnp.stack(vals, axis=1)


@functools.partial(jax.jit, static_argnames=("spec", "n_paths"))
def _hw_exposure_mc_impl(spec, a, sigma_r, n_paths, key, p0_f, c_f,
                         consts, weights):
    p0, bmat, corr = consts
    const, wvec = weights
    n_ex = spec.n_payments
    x_grid, y_grid = _simulate_rate_grid(
        spec, a, jnp.float32(0.0), sigma_r, jnp.float32(0.0), n_paths,
        n_ex, key)
    vals = []
    for i in range(n_ex):
        mtm = _hw_mtm_multicurve(spec, i, x_grid[i], p0, bmat, corr,
                                 const, wvec)
        vals.append(mtm * p0_f[i] * jnp.exp(-y_grid[i] - c_f[i]))
    return jnp.stack(vals, axis=1)


def hw_swap_exposure(spec: SwaptionSpec = DEMO_SWAPTION,
                     dyn: HullWhiteDynamics = DEMO_HW,
                     curve: DiscountCurve = DEMO_CURVE,
                     sim: SimParams = SimParams(n_paths=1 << 16,
                                                n_steps=1),
                     *,
                     projection_curve: Optional[DiscountCurve] = None,
                     seed: Optional[int] = None,
                     stream: int = STREAM_OUTER):
    """Counterparty exposure of the swap under curve-fitted Hull-White.

    Same construction as `swap_exposure` (closed-form affine MtM at
    every coupon date, pathwise discounting), with curve bonds — so
    every EE point equals the curve-consistent Jamshidian swaption
    expiring at that date (`oracle.hw_swaption`), the gate the tests
    apply.  Returns a `CollateralizedExposure` with the full XVA metric
    surface.
    """
    spec = spec.validate()
    p0, c, bmat, corr = _hw_tables(spec, dyn, curve)
    seed = sim.seed if seed is None else seed
    key = jnp.asarray(rng.derive_key(seed, stream, 0x4877), jnp.uint32)
    if projection_curve is not None:
        weights = _hw_mc_weights(spec, curve, projection_curve)
        values = _hw_exposure_mc_impl(
            spec, jnp.float32(dyn.a), jnp.float32(dyn.sigma_r),
            sim.n_paths, key, jnp.asarray(p0, jnp.float32),
            jnp.asarray(c, jnp.float32), (p0, bmat, corr), weights)
    else:
        values = _hw_exposure_impl(spec, jnp.float32(dyn.a),
                                   jnp.float32(dyn.sigma_r), sim.n_paths,
                                   key, jnp.asarray(p0, jnp.float32),
                                   jnp.asarray(c, jnp.float32),
                                   (p0, bmat, corr))
    from mc_tpu.xva import CollateralizedExposure, coupon_dates
    horizon = spec.expiry + (spec.n_payments - 1) * spec.tenor
    return CollateralizedExposure(
        values=values, t_horizon=jnp.float32(horizon),
        obs_dates=coupon_dates(spec.expiry, spec.tenor, spec.n_payments))
