"""Randomized quasi-Monte Carlo: rank-1 lattices + Sobol digital nets.

Beyond the reference (pure pseudo-random MC): for smooth integrands a
randomized-QMC estimator converges ~O(N^-1) instead of O(N^-1/2) — at 1M
points that is orders of magnitude less error for the same path budget
(see tests/test_qmc.py for the measured gap).  Two point-set families:
rank-1 lattices with Cranley-Patterson shifts (default) and Joe-Kuo
Sobol nets with random digital shifts (`family="sobol"`); both generate
points IN-KERNEL from the path id (modular product / direct Gray-code
formula) — no point matrix ever exists in memory.

* Generating vectors come from a fast component-by-component (CBC)
  construction (Nuyens-Cools FFT form, O(n log n) per dimension) for the
  weighted Korobov space with the Bernoulli-B2 kernel — computed on the
  host once per (n, d) and cached.  No external direction-number tables.
* Normals via the inverse CDF (`rng.inv_normal_cdf`) — Box-Muller would
  scramble the low-discrepancy structure.
* Error estimation: R independent random shifts (threefry-derived);
  stderr = std of the R shift-estimates / sqrt(R) — unbiased, honest, and
  it inherits the QMC rate.

`price_qmc` mirrors `price`; the same `_payoff_leg` step loop runs, only
the draw source differs, so every payoff/method combination works.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mc_tpu import rng
from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.engines import STREAM_OUTER, _payoff_namespace
from mc_tpu.oracle import PriceResult
from mc_tpu.ops import path_kernels as pk
from mc_tpu.ops._pallas import LANES, SUBLANES
from mc_tpu.ops.payoffs import get_payoff

__all__ = ["price_qmc", "price_qmc_model", "price_qmc_model_sharded",
           "lattice_vector", "prev_prime", "sobol_directions",
           "SOBOL_BITS"]

MAX_LATTICE_N = 1 << 20  # uint32 10-bit-split modmul validity bound


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in range(2, int(math.isqrt(n)) + 1):
        if n % p == 0:
            return False
    return True


def prev_prime(n: int) -> int:
    """Largest prime <= n."""
    n = min(n, MAX_LATTICE_N - 1)
    while not _is_prime(n):
        n -= 1
    return n


def _primitive_root(n: int) -> int:
    """Smallest primitive root modulo prime n."""
    phi = n - 1
    factors = []
    m = phi
    p = 2
    while p * p <= m:
        if m % p == 0:
            factors.append(p)
            while m % p == 0:
                m //= p
        p += 1
    if m > 1:
        factors.append(m)
    for g in range(2, n):
        if all(pow(g, phi // f, n) != 1 for f in factors):
            return g
    raise ValueError(f"no primitive root for {n}")


@functools.lru_cache(maxsize=16)
def lattice_vector(n: int, d: int, gamma: float = 0.1) -> np.ndarray:
    """CBC-constructed generating vector z (d,) for a rank-1 lattice mod n.

    Fast CBC (Nuyens-Cools): candidates are enumerated as powers of a
    primitive root g, turning the per-dimension error evaluation
    E(z=g^j) = sum_i p_i * omega({i g^j / n}) into one circular
    correlation, done with FFTs in O(n log n).  omega is the Bernoulli-B2
    (Korobov alpha=2) kernel; `gamma` the product weight per dimension.
    """
    if not _is_prime(n):
        raise ValueError(f"lattice size must be prime, got {n}")
    if d < 1:
        raise ValueError("d must be >= 1")
    g = _primitive_root(n)
    m = n - 1
    perm = np.empty(m, np.int64)
    perm[0] = 1
    for j in range(1, m):
        perm[j] = perm[j - 1] * g % n

    def omega(x):
        return 2.0 * math.pi ** 2 * (x * x - x + 1.0 / 6.0)

    psi = omega(perm / n)                       # psi[l] = omega({g^l / n})
    fft_psi = np.fft.rfft(psi)
    prod = np.ones(n)                           # running product over points
    z = np.empty(d, np.int64)
    for s in range(d):
        q = prod[perm]                          # product at points i = g^l
        # errors[j] = sum_l q[l] psi[(l + j) mod m]  (circular correlation)
        errors = np.fft.irfft(np.conj(np.fft.rfft(q)) * fft_psi, m)
        j_star = int(np.argmin(errors))
        z[s] = perm[j_star]
        upd = 1.0 + gamma * np.roll(psi, -j_star)  # omega({g^{l+j*} / n})
        prod[perm] *= upd
        prod[0] *= 1.0 + gamma * omega(0.0)
    return z.astype(np.uint32)


def _mod_int(x, n: int):
    """x mod n for int32 x in [0, 2^31), via float-assisted Barrett
    reduction: q = floor(x/n) computed in f32 is off by at most 1, fixed
    with two conditional corrections."""
    xf = x.astype(jnp.float32)
    q = jnp.floor(xf * jnp.float32(1.0 / n)).astype(jnp.int32)
    r = x - q * jnp.int32(n)
    r = jnp.where(r < 0, r + jnp.int32(n), r)
    return jnp.where(r >= jnp.int32(n), r - jnp.int32(n), r)


def _lattice_u(ids, z_j, shift_j, n: int):
    """u = frac(i * z_j / n + shift_j), exact int32 modular arithmetic.

    The 10-bit split keeps every intermediate below 2^31 for n <= 2^20.
    """
    # values < 2^20: the same value as int32
    ids_i = jax.lax.bitcast_convert_type(ids, jnp.int32)
    z = jnp.asarray(z_j, jnp.int32)           # zvec is passed as int32
    z1 = jax.lax.shift_right_logical(z, jnp.int32(10))
    z0 = jnp.bitwise_and(z, jnp.int32(1023))
    t = _mod_int(ids_i * z1, n)
    t = _mod_int(jax.lax.shift_left(t, jnp.int32(10)) + ids_i * z0, n)
    u = t.astype(jnp.float32) * jnp.float32(1.0 / n) + shift_j
    return u - jnp.floor(u)


@functools.lru_cache(maxsize=32)
def bridge_schedule(n_steps: int):
    """Brownian-bridge construction order (BFS bisection).

    Returns (idx, coef): idx[k] = (m, l, r) node indices into the W buffer
    (0..n_steps, W[0] = 0 at time 0), coef[k] = (c_l, c_r, s) with
    W[m] = c_l W[l] + c_r W[r] + s Z_k.  Entry 0 sets the terminal node
    W[n] = sqrt(n) Z_0.  Consuming lattice dimension k at entry k maps the
    best-distributed QMC dimensions to the coarsest bridge levels — the
    standard fix that makes path-dependent payoffs nearly as QMC-friendly
    as terminal ones.
    """
    from collections import deque
    n = n_steps
    idx = [(n, 0, 0)]
    coef = [(0.0, 0.0, math.sqrt(n))]
    dq = deque([(0, n)])
    while dq:
        l, r = dq.popleft()
        if r - l <= 1:
            continue
        m = (l + r) // 2
        span = r - l
        idx.append((m, l, r))
        coef.append(((r - m) / span, (m - l) / span,
                     math.sqrt((m - l) * (r - m) / span)))
        dq.append((l, m))
        dq.append((m, r))
    assert len(idx) == n, (len(idx), n)
    return (np.asarray(idx, np.int32), np.asarray(coef, np.float32))


SOBOL_BITS = 30  # scipy's Joe-Kuo direction numbers are scaled to 2^30


@functools.lru_cache(maxsize=8)
def sobol_directions(d: int) -> np.ndarray:
    """(d, 30) uint32 Joe-Kuo direction numbers (values < 2^30).

    Sourced from scipy.stats.qmc.Sobol's initialized direction-number
    matrix (the new-Joe-Kuo-6 table, up to 21201 dimensions) — the same
    numbers every production Sobol implementation ships.  Host-side only;
    the pricers receive the flattened table.
    """
    from scipy.stats import qmc as _sqmc
    sv = np.asarray(_sqmc.Sobol(d=d, scramble=False)._sv, np.uint32)
    if sv.shape != (d, SOBOL_BITS):
        raise RuntimeError(f"unexpected scipy Sobol table {sv.shape}")
    return sv


def _sobol_u(ids, sv_ref, dshift_ref, j):
    """Digitally-shifted Sobol coordinate u_{i,j} in [0, 1).

    Direct (non-iterative) Gray-code formula, so point i is a pure
    function of the path id exactly like the lattice / threefry paths:
    x_{i,j} = XOR_k bit_k(i ^ (i >> 1)) * v_{j,k}, then XOR the per-dim
    30-bit random digital shift (the digital-net analogue of the lattice
    Cranley-Patterson rotation - unbiased, preserves the net structure).
    All arithmetic in int32: values stay < 2^30.
    """
    ids_i = jax.lax.bitcast_convert_type(ids, jnp.int32)
    gray = jax.lax.bitwise_xor(
        ids_i, jax.lax.shift_right_logical(ids_i, jnp.int32(1)))
    acc = jnp.zeros_like(ids_i)
    base = jnp.asarray(j, jnp.int32) * jnp.int32(SOBOL_BITS)
    for k in range(SOBOL_BITS):
        bit = jax.lax.bitwise_and(
            jax.lax.shift_right_logical(gray, jnp.int32(k)), jnp.int32(1))
        acc = jax.lax.bitwise_xor(acc, sv_ref[base + jnp.int32(k)] * bit)
    acc = jax.lax.bitwise_xor(acc, dshift_ref[j])
    bits32 = jax.lax.bitcast_convert_type(
        jax.lax.shift_left(acc, jnp.int32(2)), jnp.uint32)
    return rng.bits_to_unit(bits32)


def _point_u_factory(family: str, zvec_ref, shift_ref, n: int):
    """u(ids, j): coordinate j of point-set ``family`` for path-id tile.

    lattice: zvec_ref = generating vector, shift_ref = f32 uniform shifts.
    sobol:   zvec_ref = flattened (d*30,) direction table, shift_ref =
             (d,) int32 digital shifts.
    """
    if family == "lattice":
        return lambda ids, j: _lattice_u(ids, zvec_ref[j], shift_ref[j], n)
    if family == "sobol":
        return lambda ids, j: _sobol_u(ids, zvec_ref, shift_ref, j)
    raise ValueError(f"unknown QMC family {family!r}")


def _qmc_draw_pair_factory(ids, zvec_ref, shift_ref, n: int, method: str,
                           family: str = "lattice"):
    """draw_pair(m) -> inverse-CDF normals for dimensions (2m, 2m+1)."""
    u_fn = _point_u_factory(family, zvec_ref, shift_ref, n)

    def draw_pair(m):
        m2 = jnp.asarray(m, jnp.int32) * 2
        if method == "terminal":
            u0 = u_fn(ids, jnp.int32(0))
            return rng.inv_normal_cdf(u0), jnp.zeros_like(u0)
        u0 = u_fn(ids, m2)
        u1 = u_fn(ids, m2 + 1)
        return rng.inv_normal_cdf(u0), rng.inv_normal_cdf(u1)

    # raw (0,1) point coordinate of dimension d — jump models feed these
    # to discrete inverse CDFs (Poisson counts) instead of normals
    draw_pair.unit = lambda d: u_fn(ids, jnp.asarray(d, jnp.int32))
    return draw_pair


def _xla_qmc_shift_sum(payoff, cfg: pk.KernelConfig, option, zvec, shifts,
                       n: int, family: str = "lattice"):
    """Payoff sum over the n QMC points for ONE random shift."""
    p = _payoff_namespace(option, cfg.n_steps)
    shape = (cfg.tile_rows, LANES)
    flat = (jax.lax.broadcasted_iota(jnp.uint32, shape, 0) * LANES
            + jax.lax.broadcasted_iota(jnp.uint32, shape, 1))

    def one_tile(carry, i):
        acc, comp = carry
        ids = jnp.uint32(i * cfg.paths_per_tile) + flat
        valid = ids < jnp.uint32(n)
        draw_pair = _qmc_draw_pair_factory(ids, zvec, shifts, n, cfg.method,
                                           family=family)
        s0 = jnp.full(shape, p.s0, jnp.float32)
        pay, _ = pk._payoff_leg(payoff, cfg, p, s0, draw_pair)
        pay = jnp.where(valid, pay, 0.0)
        p8 = pk.fold_to_sublanes(pay, cfg.tile_rows)
        y = p8 - comp
        t = acc + y
        return (t, (t - acc) - y), None

    zeros = jnp.zeros((SUBLANES, LANES), jnp.float32)
    (acc, _), _ = jax.lax.scan(
        one_tile, (zeros, zeros), jnp.arange(cfg.n_tiles, dtype=jnp.uint32))
    return jnp.sum(acc.astype(jnp.float32))


def _bridge_normals_xla(ids, zvec, shifts, n, n_steps, bidx, bcoef,
                        family: str = "lattice"):
    """W-buffer construction (functional): returns per-step z array
    (n_steps, *ids.shape) with z_j = W[j+1] - W[j]."""
    shape = ids.shape
    w = jnp.zeros((n_steps + 1,) + shape, jnp.float32)
    u_fn = _point_u_factory(family, zvec, shifts, n)

    def entry(k, w):
        z = rng.inv_normal_cdf(u_fn(ids, k))
        m, l, r = bidx[k, 0], bidx[k, 1], bidx[k, 2]
        val = (bcoef[k, 0] * w[l] + bcoef[k, 1] * w[r] + bcoef[k, 2] * z)
        return w.at[m].set(val)

    w = jax.lax.fori_loop(0, n_steps, entry, w)
    return w[1:] - w[:-1]


def _xla_qmc_bridge_shift_sum(payoff, cfg, option, zvec, shifts, n, bidx,
                              bcoef, family: str = "lattice"):
    p = _payoff_namespace(option, cfg.n_steps)
    shape = (cfg.tile_rows, LANES)
    flat = (jax.lax.broadcasted_iota(jnp.uint32, shape, 0) * LANES
            + jax.lax.broadcasted_iota(jnp.uint32, shape, 1))

    def one_tile(carry, i):
        acc, comp = carry
        ids = jnp.uint32(i * cfg.paths_per_tile) + flat
        valid = ids < jnp.uint32(n)
        zs = _bridge_normals_xla(ids, zvec, shifts, n, cfg.n_steps, bidx,
                                 bcoef, family)
        # same index clamp as the kernel (odd-n_steps epilogue)
        draw_pair = lambda m: (zs[2 * m],
                               zs[jnp.minimum(2 * m + 1, cfg.n_steps - 1)])
        s0 = jnp.full(shape, p.s0, jnp.float32)
        pay, _ = pk._payoff_leg(payoff, cfg, p, s0, draw_pair)
        pay = jnp.where(valid, pay, 0.0)
        p8 = pk.fold_to_sublanes(pay, cfg.tile_rows)
        y = p8 - comp
        t = acc + y
        return (t, (t - acc) - y), None

    zeros = jnp.zeros((SUBLANES, LANES), jnp.float32)
    (acc, _), _ = jax.lax.scan(
        one_tile, (zeros, zeros), jnp.arange(cfg.n_tiles, dtype=jnp.uint32))
    return jnp.sum(acc.astype(jnp.float32))


def _shift_mean_fn(payoff, cfg, option, zvec, n, bridge, family):
    """one_shift(shift) -> per-shift payoff mean; the ONE dispatch shared
    by the single-chip impl and the shift-sharded multi-chip impl."""
    if bridge:
        bidx_np, bcoef_np = bridge_schedule(cfg.n_steps)
        bidx = jnp.asarray(bidx_np)
        bcoef = jnp.asarray(bcoef_np)

    def one_shift(shift):
        if bridge:
            s = _xla_qmc_bridge_shift_sum(payoff, cfg, option, zvec, shift,
                                          n, bidx, bcoef, family)
        else:
            s = _xla_qmc_shift_sum(payoff, cfg, option, zvec, shift, n,
                                   family)
        return s / jnp.float32(n)

    return one_shift


@functools.partial(
    jax.jit,
    static_argnames=("payoff", "n", "n_steps", "method", "tile_rows",
                     "bridge", "family"))
def _price_qmc_impl(option, payoff, n, n_steps, method, tile_rows, bridge,
                    zvec, shifts, family="lattice"):
    cfg = pk.KernelConfig(n_paths=n, n_steps=n_steps, tile_rows=tile_rows,
                          method=method)
    one_shift = _shift_mean_fn(payoff, cfg, option, zvec, n, bridge, family)
    means = jax.lax.map(one_shift, shifts)          # (R,) per-shift means
    r_reps = shifts.shape[0]
    mean = jnp.mean(means)
    var = jnp.sum((means - mean) ** 2) / jnp.float32(max(r_reps - 1, 1))
    r = jnp.asarray(option.r, jnp.float32)
    t = jnp.asarray(option.t, jnp.float32)
    discount = jnp.exp(-r * t)
    return PriceResult(
        price=discount * mean,
        stderr=discount * jnp.sqrt(var / r_reps),
        n_paths=jnp.float32(n * r_reps),
        payoff_mean=mean,
        payoff_var=var,
    )


def _qmc_pointset(po, sim, n_shifts, method, family, bridge, tile_rows,
                  gamma, stream, seed):
    """Validated point-set construction shared by price_qmc and the
    sharded API (one code path keeps their bitwise-equality contract
    safe): returns (n, method, tile_rows, zvec, shifts)."""
    if family not in ("lattice", "sobol"):
        raise ValueError(f"unknown QMC family {family!r}")
    if method is None:
        method = "terminal" if po.terminal_only else "euler"
    if po.n_state > 0 and method == "terminal":
        raise ValueError(f"{po.name} is path-dependent; "
                         "method='terminal' invalid")
    if n_shifts < 2:
        raise ValueError("n_shifts >= 2 required for an error estimate")
    if bridge and method != "euler":
        raise ValueError("bridge=True requires method='euler'")
    if family == "sobol":
        n = 1 << min(int(math.log2(max(sim.n_paths, 2))), 20)
    else:
        n = prev_prime(sim.n_paths)
    d = 1 if method == "terminal" else sim.n_steps
    if bridge:
        # The bridge holds a (n_steps+1, tile_rows, 128) f32 buffer per
        # tile; cap tile_rows at a ~4 MB budget.
        cap = (8192 // (sim.n_steps + 1)) // 8 * 8
        tile_rows = max(8, min(tile_rows, cap))

    key = rng.derive_key(seed, stream, 0x51AC)
    sidx = jnp.arange(n_shifts * d, dtype=jnp.uint32)
    bits, _ = rng.threefry2x32(jnp.uint32(key[0]), jnp.uint32(key[1]),
                               sidx, jnp.zeros_like(sidx))
    if family == "sobol":
        # flattened (d*30,) direction table + (R, d) 30-bit digital shifts
        # — int32 throughout (values < 2^30).
        zvec = jnp.asarray(sobol_directions(d).reshape(-1).astype(np.int32))
        shifts = jax.lax.shift_right_logical(
            bits, jnp.uint32(2)).astype(jnp.int32).reshape(n_shifts, d)
    else:
        # int32 (values < 2^20)
        zvec = jnp.asarray(lattice_vector(n, d, gamma).astype(np.int32))
        shifts = rng.bits_to_unit(bits).reshape(n_shifts, d)
    return n, method, tile_rows, zvec, shifts


def price_qmc(option: OptionParams = DEMO_OPTION,
              sim: SimParams = DEMO_SIM,
              payoff="vanilla_call",
              *,
              n_shifts: int = 16,
              method: Optional[str] = None,
              family: str = "lattice",
              tile_rows: int = 128,
              gamma: float = 0.1,
              bridge: bool = False,
              stream: int = STREAM_OUTER) -> PriceResult:
    """Randomized-QMC price with `n_shifts` independent randomizations.

    family="lattice" (default): rank-1 lattice of the largest prime
    <= sim.n_paths (capped at 2^20), Cranley-Patterson random shifts.
    family="sobol": Joe-Kuo Sobol digital net of the largest power of two
    <= sim.n_paths (capped at 2^20), random 30-bit DIGITAL shifts (XOR) —
    the digital-net analogue of the rotation, equally unbiased.
    Raise n_shifts rather than n for bigger budgets — total samples =
    n * n_shifts.  stderr comes from the spread of the independent
    randomized estimates.  Points are generated from the path id for
    both families (direct Gray-code formula for Sobol — no point
    matrix in memory).
    """
    po = get_payoff(payoff)
    n, method, tile_rows, zvec, shifts = _qmc_pointset(
        po, sim, n_shifts, method, family, bridge, tile_rows, gamma,
        stream, sim.seed)
    return _price_qmc_impl(option.as_f32(), po, n, sim.n_steps, method,
                           tile_rows, bridge, zvec, shifts, family)


# ---------------------------------------------------------------------------
# QMC over model families (round 3): the same randomized point sets drive
# the Heston and correlated-basket legs.  The model legs already consume a
# generic draw_pair(m) -> normals for dimensions (2m, 2m+1), so the QMC
# low-discrepancy structure slots in where the threefry stream was — the
# variance win compounds with the families' higher per-path cost.
# ---------------------------------------------------------------------------


def _model_qmc_hooks(model: str, dyn, n_steps: int, t: float = 1.0,
                     kmax: int = 0):
    """(pack, leg, n_dims) for a QMC-capable model family; ``leg``
    takes the PACKED params vector."""
    if model == "heston":
        from mc_tpu.models.heston import (_heston_leg, _pack_heston,
                                          _unpack_heston)

        def leg(payoff, params, ids, draw_pair):
            p = _unpack_heston(params)
            s0 = jnp.full(ids.shape, p.s0, jnp.float32)
            return _heston_leg(payoff, n_steps, p, s0, draw_pair)

        return _pack_heston, leg, 2 * n_steps
    if model == "basket":
        from mc_tpu.models.basket import (_basket_leg, _basket_namespace,
                                          _pack_basket, _unpack_basket)
        d = int(dyn.s0s.shape[0])

        def pack(option, dyn, n_steps):
            return _pack_basket(_basket_namespace(option, dyn, n_steps), d)

        def leg(payoff, params, ids, draw_pair):
            p = _unpack_basket(params, d)
            return _basket_leg(payoff, d, n_steps, p, draw_pair)

        return pack, leg, 2 * ((d + 1) // 2) * n_steps
    if model == "cev":
        from mc_tpu.models.cev import _cev_leg, _pack_cev, _unpack_cev

        def leg(payoff, params, ids, draw_pair):
            p = _unpack_cev(params)
            s0 = jnp.full(ids.shape, 1.0, jnp.float32) * p.s0
            return _cev_leg(payoff, n_steps, p, s0, draw_pair)

        return _pack_cev, leg, n_steps  # 2 steps per pair
    if model == "sabr":
        from mc_tpu.models.sabr import _pack_sabr, _sabr_leg, _unpack_sabr

        def leg(payoff, params, ids, draw_pair):
            p = _unpack_sabr(params)
            f0 = jnp.full(ids.shape, 1.0, jnp.float32) * p.f0
            return _sabr_leg(payoff, n_steps, p, f0, draw_pair)

        return _pack_sabr, leg, 2 * n_steps
    if model == "localvol":
        from mc_tpu.models.localvol import (_localvol_leg, _make_sigma_at,
                                            _pack_localvol,
                                            _unpack_localvol_head)
        n_knots = int(dyn.x_knots.shape[0])

        def leg(payoff, params, ids, draw_pair):
            p = _unpack_localvol_head(params)
            sigma_at = _make_sigma_at(params, n_steps, n_knots)
            s0 = jnp.full(ids.shape, 1.0, jnp.float32) * p.s0
            return _localvol_leg(payoff, n_steps, p, s0, draw_pair,
                                 sigma_at)

        return _pack_localvol, leg, n_steps  # one pair per 2 steps
    if model == "vasicek":
        from mc_tpu.models.vasicek import (_pack_vasicek, _unpack_vasicek,
                                           _vasicek_leg)

        def leg(payoff, params, ids, draw_pair):
            p = _unpack_vasicek(params)
            s0 = jnp.full(ids.shape, 1.0, jnp.float32) * p.s0
            return _vasicek_leg(payoff, n_steps, p, s0, draw_pair)

        return _pack_vasicek, leg, 3 * n_steps  # 3 pairs per 2 steps
    if model == "merton":
        from mc_tpu.models.merton import (_merton_leg, _pack_merton,
                                          _unpack_merton, poisson_kmax)
        if not kmax:  # traced dyn (jitted impls) must pass it statically
            kmax = poisson_kmax(float(dyn.lam) * float(t) / n_steps)

        def leg(payoff, params, ids, draw_pair):
            p = _unpack_merton(params)
            s0 = jnp.full(ids.shape, 1.0, jnp.float32) * p.s0

            def draw3(m):
                # dims per step pair m: 6m..6m+3 -> the two diffusion
                # and two jump-size normals (via draw_pair's inverse
                # CDF), 6m+4/6m+5 -> RAW uniforms for the Poisson
                # counts (draw_pair.unit)
                z0, z1 = draw_pair(3 * m)
                e0, e1 = draw_pair(3 * m + 1)
                u0 = draw_pair.unit(6 * m + 4)
                u1 = draw_pair.unit(6 * m + 5)
                return z0, z1, e0, e1, u0, u1

            return _merton_leg(payoff, n_steps, kmax, p, s0, draw3)

        return _pack_merton, leg, 3 * n_steps
    if model == "bates":
        from mc_tpu.models.bates import (_bates_euler_leg, _pack_bates,
                                         _unpack_bates)
        from mc_tpu.models.merton import poisson_kmax
        if not kmax:  # traced dyn (jitted impls) must pass it statically
            kmax = poisson_kmax(float(dyn.lam) * float(t) / n_steps)

        def leg(payoff, params, ids, draw_pair):
            p = _unpack_bates(params)
            s0 = jnp.full(ids.shape, 1.0, jnp.float32) * p.s0

            # Packed 4-dims-per-step layout (round-4 advisor finding —
            # the old 6-per-step one left dim 6j+5 unconsumed and
            # discarded the normal at 6j+3, inflating the effective
            # dimension by half).  Step j: dims (4j, 4j+1) = diffusion
            # pair 2j; dim 4j+2 = jump-size normal (first of pair
            # 2j+1); dim 4j+3 = RAW uniform for the Poisson count
            # (discrete inverse CDF on the raw point, same rationale
            # as Merton's).  The leg indexes draws by its MC counter
            # layout (pairs 3j/3j+1, unit 3j+2, traced j), remapped
            # arithmetically here.
            def qmc_pair(m):  # m in {3j, 3j+1} -> pairs {2j, 2j+1}
                j = m // 3
                return draw_pair(2 * j + (m - 3 * j))

            def qmc_unit(c):  # c = 3j+2 -> raw dim 4j+3
                return draw_pair.unit(4 * (c // 3) + 3)

            return _bates_euler_leg(payoff, n_steps, kmax, p, s0,
                                    qmc_pair, qmc_unit)

        return _pack_bates, leg, 4 * n_steps
    if model == "term":
        from mc_tpu.models.term import (_HDR, _pack_term,
                                        _term_leg, _unpack_term_head)

        def leg(payoff, params, ids, draw_pair):
            p = _unpack_term_head(params)
            drift_at = lambda j: params[_HDR + j]
            vol_at = lambda j: params[_HDR + n_steps + j]
            s0 = jnp.full(ids.shape, 1.0, jnp.float32) * p.s0
            return _term_leg(payoff, n_steps, p, s0, draw_pair,
                             drift_at, vol_at)

        return _pack_term, leg, n_steps  # one pair per 2 steps
    raise ValueError(f"QMC model must be one of 'heston', 'bates', "
                     f"'basket', 'cev', 'sabr', 'localvol', 'vasicek', "
                     f"'merton', 'term'; got {model!r}")


def _model_qmc_discount(model, option, dyn):
    """Date-0 discount of the model's payoff mean: vasicek discounts
    PATHWISE inside its leg (exp(-int r) rides the carry), term uses the
    integrated curve exp(-mean(rates)*T); everything else the scalar
    e^{-rT}."""
    t = jnp.asarray(option.t, jnp.float32)
    if model == "vasicek":
        return jnp.float32(1.0)
    if model == "term":
        return jnp.exp(-jnp.mean(jnp.asarray(dyn.rates, jnp.float32)) * t)
    return jnp.exp(-jnp.asarray(option.r, jnp.float32) * t)


def _model_shift_mean_fn(model, payoff, cfg, params, leg, zvec, n,
                         family):
    """one_shift(shift) -> per-shift payoff mean for a model family —
    shared by the single-device impl and the shift-sharded multi-device
    impl (one code path keeps their bitwise-equality contract safe)."""
    shape = (cfg.tile_rows, LANES)
    flat = (jax.lax.broadcasted_iota(jnp.uint32, shape, 0) * LANES
            + jax.lax.broadcasted_iota(jnp.uint32, shape, 1))

    def one_shift(shift):
        def one_tile(carry, i):
            acc, comp = carry
            ids = jnp.uint32(i * cfg.paths_per_tile) + flat
            valid = ids < jnp.uint32(n)
            draw_pair = _qmc_draw_pair_factory(ids, zvec, shift, n,
                                               "euler", family=family)
            pay = jnp.where(valid, leg(payoff, params, ids, draw_pair),
                            0.0)
            p8 = pk.fold_to_sublanes(pay, cfg.tile_rows)
            y = p8 - comp
            t = acc + y
            return (t, (t - acc) - y), None

        zeros = jnp.zeros((SUBLANES, LANES), jnp.float32)
        (acc, _), _ = jax.lax.scan(
            one_tile, (zeros, zeros),
            jnp.arange(cfg.n_tiles, dtype=jnp.uint32))
        return jnp.sum(acc.astype(jnp.float32)) / jnp.float32(n)

    return one_shift


@functools.partial(
    jax.jit,
    static_argnames=("model", "payoff", "n", "n_steps", "d_assets",
                     "tile_rows", "family", "t_static", "kmax_static"))
def _price_qmc_model_impl(model, option, dyn, payoff, n, n_steps,
                          d_assets, tile_rows, zvec, shifts, family,
                          t_static=1.0, kmax_static=0):
    pack, leg, n_dims = _model_qmc_hooks(model, dyn, n_steps, t_static,
                                         kmax_static)
    cfg = pk.KernelConfig(n_paths=n, n_steps=n_steps, tile_rows=tile_rows)
    params = pack(option, dyn, n_steps)
    one_shift = _model_shift_mean_fn(model, payoff, cfg, params, leg,
                                     zvec, n, family)
    means = jax.lax.map(one_shift, shifts)
    r_reps = shifts.shape[0]
    mean = jnp.mean(means)
    var = jnp.sum((means - mean) ** 2) / jnp.float32(max(r_reps - 1, 1))
    discount = _model_qmc_discount(model, option, dyn)
    return PriceResult(price=discount * mean,
                       stderr=discount * jnp.sqrt(var / r_reps),
                       n_paths=jnp.float32(n * r_reps),
                       payoff_mean=mean, payoff_var=var)


def price_qmc_model(model: str,
                    option: OptionParams = DEMO_OPTION,
                    dyn=None,
                    sim: SimParams = DEMO_SIM,
                    payoff="vanilla_call",
                    *,
                    n_shifts: int = 16,
                    family: str = "sobol",
                    tile_rows: int = 128,
                    gamma: float = 0.1,
                    stream: int = STREAM_OUTER) -> PriceResult:
    """Randomized-QMC price under a model family ("heston" | "bates" |
    "basket" | "cev" | "sabr" | "localvol" | "vasicek" | "merton" |
    "term").

    Dimension layout: QMC pair m supplies the normals the model leg
    draws as pair m — Heston uses 2*n_steps dimensions (z_v, z_perp per
    step), a d-asset basket 2*ceil(d/2)*n_steps.  Default
    family="sobol": digital nets hold their rate better in the hundreds
    of dimensions the step loops produce than rank-1 lattices tuned for
    low dimension.  stderr from n_shifts independent randomizations, as
    in `price_qmc`.
    """
    po, dyn32, d_assets, n, zvec, shifts = _qmc_model_pointset(
        model, option, dyn, sim, payoff=payoff, n_shifts=n_shifts, family=family, tile_rows=tile_rows, gamma=gamma,
        stream=stream)
    kmax = 0
    if model in ("merton", "bates"):
        from mc_tpu.models.merton import poisson_kmax
        kmax = poisson_kmax(float(dyn32.lam) * float(option.t)
                            / sim.n_steps)
    return _price_qmc_model_impl(model, option.as_f32(), dyn32, po, n,
                                 sim.n_steps, d_assets, tile_rows,
                                 zvec, shifts, family,
                                 t_static=float(option.t),
                                 kmax_static=kmax)


def _qmc_model_pointset(model, option, dyn, sim, *, payoff, n_shifts,
                        family, tile_rows, gamma, stream):
    """Validated model point-set construction shared by the single-chip
    and shift-sharded entries (one code path keeps their per-shift
    bitwise-equality contract safe)."""
    po = get_payoff(payoff)
    po.validate(option, sim.n_steps)
    if model == "heston":
        from mc_tpu.models.heston import DEMO_HESTON
        dyn = (DEMO_HESTON if dyn is None else dyn).as_f32()
        d_assets = 0
    elif model == "basket":
        from mc_tpu.models.basket import DEMO_BASKET
        dyn = (DEMO_BASKET if dyn is None else dyn).as_f32()
        d_assets = int(dyn.s0s.shape[0])
    elif model == "cev":
        from mc_tpu.models.cev import DEMO_CEV
        dyn = (DEMO_CEV if dyn is None else dyn).as_f32()
        d_assets = 0
        if sim.n_steps % 2:
            raise ValueError("CEV requires an even n_steps "
                             "(pair-consuming step loop)")
    elif model == "sabr":
        from mc_tpu.models.sabr import DEMO_SABR
        dyn = (DEMO_SABR if dyn is None else dyn).as_f32()
        d_assets = 0
    elif model == "localvol":
        from mc_tpu.models.localvol import LocalVolSurface, \
            validate_surface
        if dyn is None:
            dyn = LocalVolSurface.demo(sim.n_steps)
        dyn = validate_surface(dyn, sim.n_steps)
        d_assets = 0
        if sim.n_steps % 2:
            raise ValueError("localvol requires an even n_steps "
                             "(pair-consuming step loop)")
    elif model == "vasicek":
        from mc_tpu.models.vasicek import DEMO_VASICEK
        dyn = (DEMO_VASICEK if dyn is None else dyn).as_f32()
        d_assets = 0
        if sim.n_steps % 2:
            raise ValueError("vasicek requires an even n_steps "
                             "(pair-consuming step loop)")
    elif model == "merton":
        from mc_tpu.models.merton import DEMO_MERTON
        dyn = (DEMO_MERTON if dyn is None else dyn).as_f32()
        d_assets = 0
        if sim.n_steps % 2:
            raise ValueError("merton requires an even n_steps "
                             "(pair-consuming step loop)")
    elif model == "bates":
        from mc_tpu.models.bates import DEMO_BATES
        dyn = (DEMO_BATES if dyn is None else dyn).as_f32()
        d_assets = 0
    elif model == "term":
        from mc_tpu.models.term import TermStructure
        if dyn is None:
            dyn = TermStructure.from_knots([0.10, 0.05], [0.15, 0.30],
                                           sim.n_steps)
        dyn = dyn.as_f32()
        if int(dyn.rates.shape[0]) != sim.n_steps:
            raise ValueError("term structure must carry one knot per "
                             "step")
        d_assets = 0
        if sim.n_steps % 2:
            raise ValueError("term requires an even n_steps "
                             "(pair-consuming step loop)")
    else:
        raise ValueError(f"QMC model must be one of 'heston', 'bates', "
                         f"'basket', 'cev', 'sabr', 'localvol', "
                         f"'vasicek', 'merton', 'term'; got {model!r}")
    if family not in ("lattice", "sobol"):
        raise ValueError(f"unknown QMC family {family!r}")
    if n_shifts < 2:
        raise ValueError("n_shifts >= 2 required for an error estimate")
    _, _, n_dims = _model_qmc_hooks(model, dyn, sim.n_steps,
                                    float(option.t))
    if family == "sobol":
        n = 1 << min(int(math.log2(max(sim.n_paths, 2))), 20)
    else:
        n = prev_prime(sim.n_paths)
    key = rng.derive_key(sim.seed, stream, 0x51AC)
    sidx = jnp.arange(n_shifts * n_dims, dtype=jnp.uint32)
    bits, _ = rng.threefry2x32(jnp.uint32(key[0]), jnp.uint32(key[1]),
                               sidx, jnp.zeros_like(sidx))
    if family == "sobol":
        zvec = jnp.asarray(
            sobol_directions(n_dims).reshape(-1).astype(np.int32))
        shifts = jax.lax.shift_right_logical(
            bits, jnp.uint32(2)).astype(jnp.int32).reshape(n_shifts,
                                                           n_dims)
    else:
        zvec = jnp.asarray(lattice_vector(n, n_dims, gamma).astype(
            np.int32))
        shifts = rng.bits_to_unit(bits).reshape(n_shifts, n_dims)
    return po, dyn, d_assets, n, zvec, shifts


@functools.partial(
    jax.jit,
    static_argnames=("model", "payoff", "n", "n_steps",
                     "tile_rows", "family", "mesh",
                     "t_static", "kmax_static"))
def _qmc_model_sharded_impl(model, option, dyn, payoff, n, n_steps,
                            tile_rows, mesh, zvec,
                            shifts, family, t_static=1.0, kmax_static=0):
    from jax.sharding import PartitionSpec as P

    from mc_tpu.parallel.mesh import PATHS_AXIS

    pack, leg, n_dims = _model_qmc_hooks(model, dyn, n_steps, t_static,
                                         kmax_static)
    cfg = pk.KernelConfig(n_paths=n, n_steps=n_steps, tile_rows=tile_rows)
    params = pack(option, dyn, n_steps)

    def shard_fn(zvec, shifts_local, params):
        one_shift = _model_shift_mean_fn(model, payoff, cfg, params, leg,
                                         zvec, n, family)
        means_local = jax.lax.map(one_shift, shifts_local)
        return jax.lax.all_gather(means_local, PATHS_AXIS, tiled=True)

    means = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(PATHS_AXIS), P()),
        out_specs=P(),
        check_vma=False,
    )(zvec, shifts, params)

    r_reps = shifts.shape[0]
    mean = jnp.mean(means)
    var = jnp.sum((means - mean) ** 2) / jnp.float32(max(r_reps - 1, 1))
    discount = _model_qmc_discount(model, option, dyn)
    return PriceResult(price=discount * mean,
                       stderr=discount * jnp.sqrt(var / r_reps),
                       n_paths=jnp.float32(n * r_reps),
                       payoff_mean=mean, payoff_var=var)


def price_qmc_model_sharded(model: str,
                            option: OptionParams = DEMO_OPTION,
                            dyn=None,
                            sim: SimParams = DEMO_SIM,
                            payoff="vanilla_call",
                            *,
                            mesh=None,
                            n_shifts: int = 16,
                            family: str = "sobol",
                            tile_rows: int = 128,
                            gamma: float = 0.1,
                            stream: int = STREAM_OUTER
                            ) -> PriceResult:
    """Model-family randomized QMC with shifts sharded over the mesh.

    ``n_shifts`` is rounded up to a multiple of the mesh size; per-shift
    means are BIT-identical to `price_qmc_model`'s, so at equal n_shifts
    the two APIs agree exactly regardless of mesh size.
    """
    from mc_tpu.ops._pallas import cdiv as _cdiv
    from mc_tpu.parallel.mesh import make_mesh

    mesh = mesh if mesh is not None else make_mesh()
    n_shifts = _cdiv(n_shifts, mesh.devices.size) * mesh.devices.size
    # reuse the single-chip entry's validation + point-set construction
    # by building it at the rounded shift count, then dispatch sharded
    kwargs = dict(payoff=payoff, n_shifts=n_shifts,
                  family=family, tile_rows=tile_rows, gamma=gamma,
                  stream=stream)
    po, dyn32, d_assets, n, zvec, shifts = _qmc_model_pointset(
        model, option, dyn, sim, **kwargs)
    kmax = 0
    if model in ("merton", "bates"):
        from mc_tpu.models.merton import poisson_kmax
        kmax = poisson_kmax(float(dyn32.lam) * float(option.t)
                            / sim.n_steps)
    return _qmc_model_sharded_impl(model, option.as_f32(), dyn32, po, n,
                                   sim.n_steps, tile_rows,
                                   mesh, zvec, shifts, family,
                                   t_static=float(option.t),
                                   kmax_static=kmax)
