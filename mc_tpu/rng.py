"""Counter-based RNG: threefry2x32 keyed per (path, draw).

JAX replacement for the reference's RNG subsystem (SURVEY.md C3):

* reference: a ``curandState`` array in global memory, one mutable state per
  CUDA thread, seeded ``curand_init(seed, tid, 0, ...)`` (``inc/tool.cuh:192-195``)
  and drawn with ``curand_normal`` inside kernels — stateful, memory-capped
  (``inc/tool.cuh:176-188`` sizes the grid by free memory / sizeof(curandState)),
  and tied to launch geometry.

* here: a pure counter-based generator.  The normal draw for (path ``i``,
  draw ``j``) is a deterministic function ``N(key, i, j)`` — no state arrays,
  no memory cap, bit-identical regardless of tiling, sharding, or backend
  (verified: interpreted Triton kernel == XLA engine == pure-numpy host,
  see tests/test_rng.py and tests/test_triton_parity.py).  This is what
  makes checkpoint/resume and multi-chip sharding trivially reproducible.

The same functions run inside the Triton-route Pallas kernels and in plain
jitted XLA code (every operation here lowers on both routes), so the XLA
engines and the Pallas kernels consume an identical stream — the
framework's version of the reference's
"same random array through CPU and GPU pricers" fixture
(``inc/testing.cuh:17-42``, SURVEY.md section 4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "threefry2x32",
    "derive_key",
    "fold_key",
    "bits_to_unit",
    "normal_pair",
    "normals",
    "TWO_PI",
]

TWO_PI = 6.283185307179586

# Default round count for the framework's NORMAL-DRAW streams: 13 is the
# smallest count that passes all of TestU01 BigCrush (Salmon et al. 2011,
# table 5) and is ~35% cheaper in the hot step loops than the Random123
# safety-margin default of 20.  Key DERIVATION (derive_key/fold_key) stays
# at 20 rounds — it runs once per stream, so the margin is free there.
# The native C++ mirror (native/src/mc_native.cpp) carries the same value.
DEFAULT_ROUNDS = 13

# Threefry2x32 rotation schedule (Salmon et al. 2011, table 2).
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _rotl(x, d: int):
    return jax.lax.bitwise_or(
        jax.lax.shift_left(x, jnp.uint32(d)),
        jax.lax.shift_right_logical(x, jnp.uint32(32 - d)),
    )


def threefry2x32(k0, k1, x0, x1, rounds: int = 20):
    """Threefry-2x32. All args uint32 arrays of one shape.

    Pure adds/xors/rotates — lowers in a Triton kernel, in Pallas interpret
    mode, and in XLA identically.  Returns two uint32 arrays (64 random bits per
    counter).

    ``rounds``: 20 is the Random123 default (large safety margin); 13 is
    the smallest count that passes all of BigCrush (Salmon et al. 2011,
    table 5) — ~35% fewer hot-loop ops for statistically sound streams.
    Streams with different round counts are unrelated.
    """
    if not 1 <= rounds <= 32:
        raise ValueError("rounds must be in [1, 32]")
    k0 = jnp.asarray(k0, jnp.uint32)
    k1 = jnp.asarray(k1, jnp.uint32)
    x0 = jnp.asarray(x0, jnp.uint32)
    x1 = jnp.asarray(x1, jnp.uint32)
    ks2 = jax.lax.bitwise_xor(jax.lax.bitwise_xor(k0, k1), jnp.uint32(_PARITY))
    ks = (k0, k1, ks2)
    x0 = x0 + k0
    x1 = x1 + k1
    for r in range(rounds):
        x0 = x0 + x1
        x1 = _rotl(x1, _ROTATIONS[r % 8])
        x1 = jax.lax.bitwise_xor(x0, x1)
        if (r + 1) % 4 == 0:  # key injection after every 4th round (R123)
            inj = (r + 1) // 4
            x0 = x0 + ks[inj % 3]
            x1 = x1 + ks[(inj + 1) % 3] + jnp.uint32(inj)
    return x0, x1


def derive_key(seed: int, *tags: int) -> tuple[np.uint32, np.uint32]:
    """Derive a (k0, k1) stream key from an integer seed + stream tags.

    Host-side, returns concrete numpy uint32 scalars (safe to close over in
    jitted code or pack into a kernel parameter vector).  Replaces the reference's hard-coded seed
    constants 1234/1235 (``inc/wrappers.cuh:41,151``) with a proper key
    hierarchy: ``derive_key(seed)`` is the root, ``derive_key(seed, tag)``
    an independent stream (outer vs inner NMC paths, antithetic pairs, ...).
    """
    seed = int(seed) % (1 << 64)  # accept negative / arbitrary-width ints
    k0 = np.uint32(np.uint64(seed) & np.uint64(0xFFFFFFFF))
    k1 = np.uint32((np.uint64(seed) >> np.uint64(32)) & np.uint64(0xFFFFFFFF))
    for tag in tags:
        tag = int(tag) % (1 << 64)
        t0 = np.uint32(np.uint64(tag) & np.uint64(0xFFFFFFFF))
        t1 = np.uint32((np.uint64(tag) >> np.uint64(32)) & np.uint64(0xFFFFFFFF))
        a, b = _threefry_scalar_np(k0, k1, t0, t1)
        k0, k1 = a, b
    return k0, k1


def fold_key(k0, k1, tag0, tag1=0):
    """Traced variant of `derive_key`: fold traced tags into a key."""
    t0 = jnp.asarray(tag0, jnp.uint32)
    t1 = jnp.asarray(tag1, jnp.uint32)
    return threefry2x32(k0, k1, t0, t1)


def _threefry_scalar_np(k0, k1, x0, x1):
    """Concrete numpy mirror of `threefry2x32` for host key derivation."""
    m = np.uint64(0xFFFFFFFF)

    def rotl(x, d):
        x = np.uint64(x)
        return np.uint32(((x << np.uint64(d)) | (x >> np.uint64(32 - d))) & m)

    k0 = np.uint32(k0); k1 = np.uint32(k1)
    ks2 = np.uint32(np.uint32(k0 ^ k1) ^ np.uint32(_PARITY))
    x0 = np.uint32((np.uint64(x0) + np.uint64(k0)) & m)
    x1 = np.uint32((np.uint64(x1) + np.uint64(k1)) & m)
    key_sched = ((k1, ks2), (ks2, k0), (k0, k1), (k1, ks2), (ks2, k0))
    for r in range(5):
        for i in range(4):
            x0 = np.uint32((np.uint64(x0) + np.uint64(x1)) & m)
            x1 = rotl(x1, _ROTATIONS[(r % 2) * 4 + i])
            x1 = np.uint32(x0 ^ x1)
        ka, kb = key_sched[r]
        x0 = np.uint32((np.uint64(x0) + np.uint64(ka)) & m)
        x1 = np.uint32((np.uint64(x1) + np.uint64(kb) + np.uint64(r + 1)) & m)
    return x0, x1


def bits_to_unit(bits):
    """uint32 random bits -> float32 uniform in [0, 1).

    Sets the exponent to 0 (value in [1, 2)) and subtracts 1 — exact, branch
    free, and identical across backends (no rounding ambiguity).
    """
    mant = jax.lax.shift_right_logical(bits, jnp.uint32(9))
    as_float = jax.lax.bitcast_convert_type(
        jax.lax.bitwise_or(mant, jnp.uint32(0x3F800000)), jnp.float32)
    return as_float - jnp.float32(1.0)


def normal_pair(k0, k1, c0, c1,
                rounds: int = DEFAULT_ROUNDS):
    """Two independent N(0,1) arrays from counter arrays (c0, c1).

    Full Box-Muller: one threefry call yields 64 bits -> (u1, u2) -> the
    (cos, sin) pair, so no randomness is wasted (the reference draws one
    normal per curand call; curand internally does the same pairing).
    """
    b0, b1 = threefry2x32(k0, k1, c0, c1, rounds=rounds)
    u1 = bits_to_unit(b0)
    u2 = bits_to_unit(b1)
    # 1 - u1 in (0, 1]: log is finite; r = 0 when u1 == 0.
    rad = jnp.sqrt(jnp.float32(-2.0) * jnp.log1p(-u1))
    theta = jnp.float32(TWO_PI) * u2
    return rad * jnp.cos(theta), rad * jnp.sin(theta)


def normals(key: tuple, ids, n_draws: int, draw_offset: int = 0):
    """Stack of `n_draws` N(0,1) arrays for element-id array `ids`.

    Returns shape ``(n_draws,) + ids.shape``.  Draw ``j`` for element ``i``
    uses counter ``(i, draw_offset + j)`` with pairs ``(2m, 2m+1)`` sharing
    one threefry evaluation.  `draw_offset` must be even.
    """
    assert draw_offset % 2 == 0, "draw_offset must be even (pair alignment)"
    ids = jnp.asarray(ids, jnp.uint32)
    k0 = jnp.asarray(key[0], jnp.uint32)
    k1 = jnp.asarray(key[1], jnp.uint32)
    n_pairs = (n_draws + 1) // 2
    outs = []
    for m in range(n_pairs):
        c1 = jnp.full(ids.shape, draw_offset // 2 + m, jnp.uint32)
        z0, z1 = normal_pair(k0, k1, ids, c1)
        outs.append(z0)
        outs.append(z1)
    return jnp.stack(outs[:n_draws], axis=0)


# ---------------------------------------------------------------------------
# Inverse normal CDF (Acklam's rational approximation) — the QMC map.
# Box-Muller cannot consume low-discrepancy points (it scrambles their
# structure); quasi-Monte Carlo needs the direct inverse transform.
# ---------------------------------------------------------------------------

_ACKLAM_A = (-3.969683028665376e+01, 2.209460984245205e+02,
             -2.759285104469687e+02, 1.383577518672690e+02,
             -3.066479806614716e+01, 2.506628277459239e+00)
_ACKLAM_B = (-5.447609879822406e+01, 1.615858368580409e+02,
             -1.556989798598866e+02, 6.680131188771972e+01,
             -1.328068155288572e+01)
_ACKLAM_C = (-7.784894002430293e-03, -3.223964580411365e-01,
             -2.400758277161838e+00, -2.549732539343734e+00,
             4.374664141464968e+00, 2.938163982698783e+00)
_ACKLAM_D = (7.784695709041462e-03, 3.224671290700398e-01,
             2.445134137142996e+00, 3.754408661907416e+00)


def _erf_as(x):
    """erf via Abramowitz-Stegun 7.1.26 (|abs err| <= 1.5e-7), f32,
    branch-free — usable inside Pallas kernels (no erf primitive)."""
    x = jnp.asarray(x, jnp.float32)
    ax = jnp.abs(x)
    t = 1.0 / (1.0 + jnp.float32(0.3275911) * ax)
    a = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
    poly = t * (a[0] + t * (a[1] + t * (a[2] + t * (a[3] + t * a[4]))))
    e = 1.0 - poly * jnp.exp(-ax * ax)
    return jnp.sign(x) * e


def inv_normal_cdf(u):
    """Phi^{-1}(u) for u in (0,1), branch-free f32 (Acklam's algorithm).

    Max relative error ~1.15e-9 in f64; f32 rounding dominates here.
    Inputs are clamped to [1e-6, 1-1e-6] (|z| <~ 4.75) — QMC points land
    on a shifted lattice, so the clamp affects ~2e-6 of the mass at most.
    """
    u = jnp.clip(jnp.asarray(u, jnp.float32), 1e-6, 1.0 - 1e-6)
    a, b, c, d = _ACKLAM_A, _ACKLAM_B, _ACKLAM_C, _ACKLAM_D
    p_low = jnp.float32(0.02425)

    # central region
    q = u - jnp.float32(0.5)
    r = q * q
    num = ((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]
    den = ((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1.0
    central = q * num / den

    # tails (evaluated on a safe argument, selected by mask)
    u_tail = jnp.minimum(u, 1.0 - u)
    qt = jnp.sqrt(-2.0 * jnp.log(u_tail))
    num_t = ((((c[0] * qt + c[1]) * qt + c[2]) * qt + c[3]) * qt + c[4]) * qt + c[5]
    den_t = (((d[0] * qt + d[1]) * qt + d[2]) * qt + d[3]) * qt + 1.0
    tail = num_t / den_t
    tail = jnp.where(u < jnp.float32(0.5), tail, -tail)

    lower = u < p_low
    upper = u > 1.0 - p_low
    x = jnp.where(jnp.logical_or(lower, upper), tail, central)

    # One Newton step against the CDF recovers ~f32-limited accuracy in
    # the body (|x| < 3, where Phi is computable to ~1e-7 absolute); the
    # tails keep the raw rational value (phi there is too small for a
    # stable residual correction).  erf via the A&S 7.1.26 polynomial
    # (|err| <= 1.5e-7), so kernels need no erf primitive.
    sqrt2 = jnp.float32(1.4142135623730951)
    inv_sqrt2pi = jnp.float32(0.3989422804014327)
    cdf = 0.5 * (1.0 + _erf_as(x / sqrt2))
    pdf = inv_sqrt2pi * jnp.exp(-0.5 * x * x)
    step = (cdf - u) / jnp.maximum(pdf, 1e-10)
    return jnp.where(jnp.abs(x) < 3.0, x - step, x)
