"""Native C++ host-layer tests: threefry bit-parity, oracle parity, and the
multithreaded CPU reference pricers (C4/C5/C16 equivalents)."""

import numpy as np
import pytest

from mc_tpu.native import lib as native
from mc_tpu import rng
from mc_tpu.oracle import bs_call, cnd_as

pytestmark = pytest.mark.skipif(not native.available,
                                reason="native build unavailable")


def test_threefry_bit_parity():
    for ctr, key, expected in [
        ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
        ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
         (0x1CB996FC, 0xBB002BE7)),
        ((0x243F6A88, 0x85A308D3), (0x13198A2E, 0x03707344),
         (0xC4923A9C, 0x483DF7A0)),
    ]:
        assert native.threefry2x32(key[0], key[1], ctr[0], ctr[1]) == expected


def test_normals_stream_parity():
    """Native normal stream == jax stream.

    The threefry BITS are bit-exact (test_threefry_bit_parity); the floats
    differ only by libm-vs-XLA transcendental rounding in Box-Muller
    (~1e-5 absolute), so the check is a tight tolerance plus exact match
    of the sign pattern.
    """
    import jax.numpy as jnp
    key = rng.derive_key(1234, 0)
    ids = jnp.arange(4096, dtype=jnp.uint32)
    for j in (0, 1, 5):
        z_jax = np.asarray(rng.normals(key, ids, n_draws=j + 1))[j]
        z_nat = native.fill_normals(key, j, 4096)
        np.testing.assert_allclose(z_jax, z_nat, atol=2e-4)
        # same stream, not merely same distribution:
        assert np.mean(np.sign(z_jax) == np.sign(z_nat)) > 0.999


def test_black_scholes_parity():
    want = float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2))
    got = native.black_scholes_call(100.0, 100.0, 1.0, 0.1, 0.2, exact=True)
    assert got == pytest.approx(want, rel=1e-6)
    got_as = native.black_scholes_call(100.0, 100.0, 1.0, 0.1, 0.2,
                                       exact=False)
    assert got_as == pytest.approx(want, abs=1e-4)


def test_cnd_parity():
    xs = np.linspace(-5, 5, 101)
    ours = np.asarray(cnd_as(xs.astype(np.float32)))
    theirs = np.array([native.cnd_as(float(x)) for x in xs])
    np.testing.assert_allclose(ours, theirs, atol=2e-7)


def test_cpu_pricer_matches_engines():
    """Native CPU pricer on the same stream == XLA engine within fp noise."""
    from mc_tpu import SimParams, price
    key = rng.derive_key(1234, 0)
    sim = SimParams(n_paths=50_000, n_steps=20)
    px, se = native.price_cpu("vanilla_call", key, sim.n_paths, sim.n_steps)
    # method pinned: the native stream twin rides the classic per-path
    # counter stream (the round-5 default would pick terminal_pair here).
    ours = price(sim=sim, tile_rows=8, method="terminal")
    # Same draws; expf/exp rounding differs per element, so ~1e-5 relative.
    assert px == pytest.approx(float(ours.price), rel=5e-5)
    assert se == pytest.approx(float(ours.stderr), rel=1e-3)

    pb, seb = native.price_cpu("bullet_call", key, sim.n_paths, sim.n_steps,
                               p1=2.0, p2=12.0)
    from mc_tpu import OptionParams
    oursb = price(option=OptionParams(p1=2.0, p2=12.0), sim=sim,
                  payoff="bullet_call", tile_rows=8)
    assert pb == pytest.approx(float(oursb.price), rel=1e-3, abs=2e-3)


def test_csv_writer(tmp_path):
    mat = np.arange(12, dtype=np.float32).reshape(3, 4)  # 3 paths, 4 steps
    out = tmp_path / "t.csv"
    native.write_traj_csv(str(out), mat)
    lines = out.read_text().strip().splitlines()
    assert lines[0] == "time,trajectory,value"
    assert len(lines) == 1 + 12
    assert lines[1] == "0,0,0.000000"
    # step-major tidy order: next row is path 1 at time 0 (value 4.0)
    assert lines[2] == "0,1,4.000000"


def test_native_rounds_parity():
    """The native mirror must track rng.DEFAULT_ROUNDS and reproduce both
    the 13- and 20-round streams bit-for-bit."""
    import ctypes

    import jax.numpy as jnp

    from mc_tpu import rng as R
    from mc_tpu.native import lib
    assert lib.DEFAULT_ROUNDS == R.DEFAULT_ROUNDS
    key = R.derive_key(99, 1)
    for rounds in (13, 20):
        o0, o1 = ctypes.c_uint32(), ctypes.c_uint32()
        lib._load().threefry2x32_r(int(key[0]), int(key[1]), 5, 7, rounds,
                                   ctypes.byref(o0), ctypes.byref(o1))
        j = R.threefry2x32(jnp.uint32(key[0]), jnp.uint32(key[1]),
                           jnp.uint32(5), jnp.uint32(7), rounds=rounds)
        assert (o0.value, o1.value) == (int(j[0]), int(j[1])), rounds


def test_cpu_pair_pricer_matches_engines():
    """Native paired-terminal pricer on the same stream == the XLA
    method='terminal_pair' engine within fp noise."""
    from mc_tpu import SimParams, price
    from mc_tpu import rng as _rng
    key = _rng.derive_key(1234, 0)
    n = 100_000
    px, se = native.price_cpu("vanilla_call_pair", key, n, 10)
    ours = price(sim=SimParams(n_paths=n, n_steps=10),
                 method="terminal_pair", tile_rows=8)
    assert px == pytest.approx(float(ours.price), rel=5e-5)
    assert se == pytest.approx(float(ours.stderr), rel=1e-3)
