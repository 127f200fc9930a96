#!/usr/bin/env python
"""Main path on one NVIDIA GPU at the reference's sizes.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --four     # four cards: the sharded phases only

Phases (one card), each through the public API:

* compile: every Triton kernel of the main path at its real widths, with
  ``compiled.memory_analysis()``;
* european: 1M-path call (terminal_pair and terminal) against Black-Scholes
  and against the XLA engine on the same stream;
* bullet: 1M paths x 100 steps (B=120, window [10, 50], hello.cu:5-19)
  against the XLA engine, and the native C++ twin at 100k paths;
* trajectories: the 100k x 100 outer grid (C9) against the XLA engine;
* nmc: the reference demo, 100k outer x 100 steps x 1,000 inner paths: the
  outer price against `price`, the step-0 surface mean against the outer
  price, and one outer tile (all steps) against the XLA engine;
* gpu-tests: the ``gpu``-marked tier under ``tests_gpu/``, in this process
  (one process holds the card).

``--four`` runs only ``price_sharded`` at 1B paths and ``price_nmc_sharded``
at the demo size on a 4-card mesh, each against the one-card result.

Tolerances.  The kernels and the XLA engine draw the same counter-based
stream and sum in the same order, but on the GPU the kernel's exp/log/
sin/cos are libdevice calls while XLA emits its own, and either compiler
may fuse a multiply-add.  Smooth payoffs therefore agree to a few float32
ulps.  The bullet payoff counts barrier crossings: a last-ulp difference
in S_t next to the barrier can flip one path's count, which moves a price
by one path's payoff over n, far below the Monte Carlo error.  So prices
are held to ``PRICE_TOL`` standard errors, and NMC surface points, each
the mean of n_inner paths, to a few such flips.

Every phase failure makes the exit code nonzero; the last line of stdout
is one JSON object only when every phase passed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

# Kernel vs XLA engine, same stream: |a - b| <= PRICE_TOL * stderr.
PRICE_TOL = 1e-3
# Per-path grids (S_t of the trajectory grid): relative, ~8 float32 ulps.
GRID_REL = 1e-6
# NMC point estimates: at most FLIPS_PER_POINT inner paths whose barrier
# count differs, each worth at most (max payoff) / n_inner, and no more
# than FLIPPED_SHARE of the points off by more than POINT_ABS.
FLIPS_PER_POINT = 2
POINT_ABS = 1e-4
FLIPPED_SHARE = 1e-3


PATHS = 1_000_000          # European and bullet calls
STEPS = 100
NATIVE_PATHS = 100_000
TRAJ_PATHS = 100_000
NMC_PATHS = 100_000        # hello.cu:14-16
NMC_INNER = 1_000
BILLION = 1_000_000_000    # --four: BASELINE.json config 5
REPS = 9                   # warm repetitions per timing


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def timed(fn, reps):
    """(result, first-call seconds, median warm seconds)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return out, first, ts[len(ts) // 2]


def check(ok, what):
    log(("  PASS " if ok else "  FAIL ") + what)
    if not ok:
        raise AssertionError(what)


def same_price(a, b, what):
    """Kernel result ``a`` vs XLA result ``b`` on one stream."""
    d = abs(float(a.price) - float(b.price))
    tol = PRICE_TOL * float(b.stderr)
    check(d <= tol, f"{what}: kernel {float(a.price)!r} xla "
          f"{float(b.price)!r} |diff| {d:.3e} <= {PRICE_TOL} stderr "
          f"= {tol:.3e} (bitwise: {float(a.price) == float(b.price)})")


class Smoke:
    def __init__(self):
        from mc_tpu import OptionParams, SimParams
        self.opt = OptionParams()
        self.sim = SimParams(n_paths=PATHS, n_steps=STEPS)

    # -- phases -----------------------------------------------------------

    def compile(self):
        """Compile each kernel at its real widths; print its memory."""
        import jax
        import jax.numpy as jnp

        from mc_tpu.ops import nmc_kernels as nk
        from mc_tpu.ops import path_kernels as pk
        from mc_tpu.ops._pallas import kahan_tiles_kernel
        from mc_tpu.ops.payoffs import get_payoff

        tr = pk.default_tile_rows("pallas")
        key = jnp.array([1234, 0], jnp.uint32)
        params = pk.pack_params(self.opt.as_f32(), STEPS)
        bullet, call = get_payoff("bullet_call"), get_payoff("vanilla_call")
        euler = pk.KernelConfig(n_paths=PATHS, n_steps=STEPS, tile_rows=tr)
        term = dataclasses.replace(euler, method="terminal")
        pair = pk.KernelConfig(n_paths=(PATHS + 1) // 2, n_steps=STEPS,
                               tile_rows=tr)
        traj = pk.KernelConfig(n_paths=TRAJ_PATHS, n_steps=STEPS,
                               tile_rows=8)
        ncfg = nk.NMCConfig(n_paths=NMC_PATHS, n_steps=STEPS,
                            n_inner=NMC_INNER, tile_rows=8)
        grid = jax.ShapeDtypeStruct(
            (STEPS, ncfg.n_tiles * ncfg.tile_rows, 128), jnp.float32)
        cases = {
            "mc_paths_euler (bullet)": (
                lambda k, p: pk.simulate_partials(bullet, euler, k, p),
                (key, params)),
            "mc_paths_terminal": (
                lambda k, p: pk.simulate_partials(call, term, k, p),
                (key, params)),
            "mc_terminal_pair": (
                lambda k, p: pk.terminal_pair_partials(
                    call, pair, k, p, jnp.uint32(PATHS),
                    engine="pallas"), (key, params)),
            "mc_trajectories": (
                lambda k, p: pk.simulate_trajectories_kernel(
                    bullet, traj, k, p), (key, params)),
            "mc_nmc_inner": (
                lambda k, p, s, c: nk.nmc_inner_kernel(
                    bullet, ncfg, k, p, s, c),
                (key, params, grid, grid)),
            "mc_kahan_tiles": (
                kahan_tiles_kernel,
                (jax.ShapeDtypeStruct((2, euler.n_tiles, 8, 128),
                                      jnp.float32),)),
        }
        for name, (fn, args) in cases.items():
            t0 = time.perf_counter()
            compiled = jax.jit(fn).lower(*args).compile()
            log(f"  {name}: compiled in {time.perf_counter() - t0:.2f} s; "
                f"memory_analysis: {compiled.memory_analysis()}")

    def european(self):
        from mc_tpu import price
        from mc_tpu.oracle import bs_call
        o = self.opt
        bs = float(bs_call(o.s0, o.k, o.t, o.r, o.sigma))
        for method in ("terminal_pair", "terminal"):
            run = lambda engine, tile_rows=None: price(  # noqa: E731
                o, self.sim, method=method, engine=engine,
                tile_rows=tile_rows)
            k, k_first, k_warm = timed(lambda: run("pallas"), REPS)
            x, _, x_warm = timed(lambda: run("xla", 32), REPS)
            _, _, x_own = timed(lambda: run("xla"), REPS)
            log(f"  {method}: kernel {k_warm * 1e3:.3f} ms (first call "
                f"{k_first:.2f} s); xla {x_own * 1e3:.3f} ms at its own "
                f"tile, {x_warm * 1e3:.3f} ms at the kernel's")
            z = (float(k.price) - bs) / float(k.stderr)
            check(abs(z) <= 3.0, f"{method}: {float(k.price)!r} vs BS {bs!r}"
                  f", z = {z:+.3f} (|z| <= 3)")
            same_price(k, x, f"{method} kernel vs xla")

    def bullet(self):
        from mc_tpu import SimParams, price, rng
        from mc_tpu.native import lib as native
        o = self.opt
        run = lambda engine, sim, tile_rows=None: price(  # noqa: E731
            o, sim, "bullet_call", engine=engine, tile_rows=tile_rows)
        k, k_first, k_warm = timed(lambda: run("pallas", self.sim), REPS)
        x, _, x_warm = timed(lambda: run("xla", self.sim, 32), REPS)
        _, _, x_own = timed(lambda: run("xla", self.sim), REPS)
        log(f"  bullet {self.sim.n_paths} x {self.sim.n_steps}: kernel "
            f"{k_warm * 1e3:.3f} ms (first call {k_first:.2f} s); xla "
            f"{x_own * 1e3:.3f} ms at its own tile, {x_warm * 1e3:.3f} ms "
            f"at the kernel's; price {float(k.price)!r} +- "
            f"{float(k.stderr)!r}")
        check(float(k.stderr) > 0.0, "bullet stderr > 0")
        same_price(k, x, "bullet kernel vs xla")

        small = SimParams(n_paths=NATIVE_PATHS, n_steps=STEPS)
        ks = run("pallas", small)
        key = rng.derive_key(small.seed, 0)
        pn, sen = native.price_cpu(
            "bullet_call", key, small.n_paths, small.n_steps,
            s0=float(o.s0), k=float(o.k), r=float(o.r), sigma=float(o.sigma),
            t=float(o.t), barrier=float(o.barrier), p1=float(o.p1),
            p2=float(o.p2))
        # The C++ twin draws the same threefry-13 stream in double: the
        # same barrier-flip argument as above, at 100k paths.
        tol = 1e-3 * abs(pn) + 2e-3
        d = abs(float(ks.price) - pn)
        check(d <= tol, f"bullet {small.n_paths} paths: kernel "
              f"{float(ks.price)!r} native C++ {pn!r} |diff| {d:.3e} <= "
              f"1e-3 rel + 2e-3 = {tol:.3e}")

    def trajectories(self):
        import jax.numpy as jnp

        from mc_tpu import SimParams, simulate_trajectories
        sim = SimParams(n_paths=TRAJ_PATHS, n_steps=STEPS)
        run = lambda engine: simulate_trajectories(  # noqa: E731
            self.opt, sim, engine=engine)
        k, k_first, k_warm = timed(lambda: run("pallas"), REPS)
        x, _, x_warm = timed(lambda: run("xla"), REPS)
        log(f"  trajectories {sim.n_paths} x {sim.n_steps}: kernel "
            f"{k_warm * 1e3:.3f} ms (first call {k_first:.2f} s); xla "
            f"{x_warm * 1e3:.3f} ms")
        check(k.s.shape == x.s.shape, f"grid shape {k.s.shape}")
        rel = float(jnp.max(jnp.abs(k.s - x.s) / jnp.abs(x.s)))
        check(rel <= GRID_REL, f"S grid max relative diff {rel:.3e} <= "
              f"{GRID_REL} (bitwise: {bool(jnp.all(k.s == x.s))})")
        n_state = int(jnp.sum(k.state != x.state))
        check(n_state <= 1e-6 * k.state.size,
              f"barrier-count grid: {n_state} of {k.state.size} differ "
              f"(<= 1e-6 of them)")

    def nmc(self):
        import jax.numpy as jnp

        from mc_tpu import SimParams, price
        from mc_tpu.nmc import price_nmc
        sim = SimParams(n_paths=NMC_PATHS, n_steps=STEPS,
                        n_paths_inner=NMC_INNER)
        t0 = time.perf_counter()
        k = price_nmc(self.opt, sim, engine="pallas")
        k.surface.block_until_ready()
        first = time.perf_counter() - t0
        _, _, warm = timed(lambda: price_nmc(self.opt, sim, engine="pallas"),
                           1)
        log(f"  nmc {sim.n_paths} x {sim.n_steps} x {sim.n_paths_inner}: "
            f"kernel {warm:.3f} s (first call {first:.2f} s); outer "
            f"{float(k.outer.price)!r} +- {float(k.outer.stderr)!r}; "
            f"surface mean {float(k.surface_mean)!r}")
        surf = k.surface_matrix()
        check(bool(jnp.all(jnp.isfinite(surf))), "surface finite, shape "
              f"{tuple(surf.shape)}")

        p = price(self.opt, sim, "bullet_call", engine="pallas",
                  tile_rows=8)
        same_price(k.outer, p, "outer price vs price(bullet_call)")
        step0 = float(jnp.mean(surf[:, 0]))
        zz = (step0 - float(k.outer.price)) / float(k.outer.stderr)
        # Tower property: E[V(S_1)] = V(S_0).  The step-0 points and the
        # outer payoffs share their outer paths, so 3 outer stderr bound
        # the difference with room to spare.
        check(abs(zz) <= 3.0, f"step-0 surface mean {step0!r} vs outer "
              f"price: {zz:+.3f} outer stderr (|.| <= 3)")

        # One outer tile, all steps, against the XLA engine.
        one = SimParams(n_paths=8 * 128, n_steps=STEPS,
                        n_paths_inner=NMC_INNER)
        t0 = time.perf_counter()
        x = price_nmc(self.opt, one, engine="xla")
        xs = x.surface_matrix().block_until_ready()
        x_s = time.perf_counter() - t0
        _, k_first, k_one = timed(lambda: price_nmc(
            self.opt, one, engine="pallas"), 1)
        log(f"  nmc one tile ({one.n_paths} outer paths), first calls with "
            f"compilation: xla {x_s:.3f} s, kernel {k_first:.3f} s; kernel "
            f"warm {k_one:.3f} s")
        ks = surf[: one.n_paths]
        diff = jnp.abs(ks - xs)
        unit = (float(jnp.max(x.spot_matrix())) * float(jnp.exp(
            -self.opt.r * self.opt.t)) / NMC_INNER)
        tol = FLIPS_PER_POINT * unit
        n_eq = int(jnp.sum(ks == xs))
        n_far = int(jnp.sum(diff > POINT_ABS))
        check(float(jnp.max(diff)) <= tol and n_far <= FLIPPED_SHARE * ks.size,
              f"surface slice vs xla: max |diff| {float(jnp.max(diff)):.3e} "
              f"<= {FLIPS_PER_POINT} inner-path payoffs = {tol:.3e}; "
              f"{n_far} points off by > {POINT_ABS} (<= {FLIPPED_SHARE} of "
              f"{ks.size}); mean |diff| {float(jnp.mean(diff)):.3e}; {n_eq} "
              f"points bitwise equal")

    def gpu_tests(self):
        import pytest
        rc = pytest.main(["-q", "-p", "no:cacheprovider",
                          os.path.join(HERE, "tests_gpu")])
        check(rc == 0, f"pytest tests_gpu exit code {int(rc)}")

    def four(self):
        import jax
        import jax.numpy as jnp

        from mc_tpu import SimParams, price
        from mc_tpu.nmc import price_nmc
        from mc_tpu.parallel import make_mesh, price_nmc_sharded, \
            price_sharded
        mesh = make_mesh(jax.devices()[:4])
        check(mesh.devices.size == 4, f"mesh of {mesh.devices.size} devices")
        big = SimParams(n_paths=BILLION, n_steps=STEPS)
        for payoff, method in (("vanilla_call", "terminal"),
                               ("bullet_call", "euler")):
            s, s_first, s_warm = timed(lambda: price_sharded(
                self.opt, big, payoff, mesh=mesh, method=method,
                engine="pallas"), REPS)
            o, o_first, o_warm = timed(lambda: price(
                self.opt, big, payoff, method=method, engine="pallas"), REPS)
            log(f"  {payoff} {big.n_paths} paths: 4 cards {s_warm:.4f} s, "
                f"1 card {o_warm:.4f} s (first calls {s_first:.2f} s, "
                f"{o_first:.2f} s); price {float(s.price)!r} vs "
                f"{float(o.price)!r}")
            # Mesh-size invariance (parallel/mesh.py): the same draws,
            # summed per device then psum'd, so the means agree to float32
            # rounding of the sum.
            dm = abs(float(s.payoff_mean) / float(o.payoff_mean) - 1.0)
            ds = abs(float(s.stderr) / float(o.stderr) - 1.0)
            check(dm <= 1e-6 and ds <= 1e-5,
                  f"{payoff}: 4-card vs 1-card mean rel {dm:.3e} (<= 1e-6),"
                  f" stderr rel {ds:.3e} (<= 1e-5)")

        sim = SimParams(n_paths=NMC_PATHS, n_steps=STEPS,
                        n_paths_inner=NMC_INNER)
        s, s_first, s_warm = timed(lambda: price_nmc_sharded(
            self.opt, sim, mesh=mesh, engine="pallas"), 1)
        o, o_first, o_warm = timed(lambda: price_nmc(
            self.opt, sim, engine="pallas"), 1)
        log(f"  nmc {sim.n_paths} x {sim.n_steps} x {sim.n_paths_inner}: 4 "
            f"cards {s_warm:.3f} s, 1 card {o_warm:.3f} s (first calls "
            f"{s_first:.2f} s, {o_first:.2f} s)")
        sa, oa = s.surface_matrix(), o.surface_matrix()
        check(sa.shape == oa.shape and bool(jnp.all(sa == oa)),
              f"nmc surface {tuple(sa.shape)}: 4-card == 1-card bitwise "
              "(every point's inner draws depend on its global path id only)")
        dm = abs(float(s.outer.price) / float(o.outer.price) - 1.0)
        check(dm <= 1e-6, f"nmc outer price {float(s.outer.price)!r} vs "
              f"{float(o.outer.price)!r}: rel {dm:.3e} (<= 1e-6)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="sharded phases on a 4-card mesh, nothing else")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    from mc_tpu.utils.platform import start
    backend = start()
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX reports {backend!r}",
              file=sys.stderr)
        return 2
    want = 4 if args.four else 1
    if args.four and len(devices) < want:
        print(f"--four needs 4 devices; JAX reports {len(devices)}",
              file=sys.stderr)
        return 2
    log(card_line())
    log(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")

    smoke = Smoke()
    if args.four:
        phases = [smoke.four]
    else:
        phases = [smoke.compile, smoke.european, smoke.bullet,
                  smoke.trajectories, smoke.nmc, smoke.gpu_tests]
    failed = []
    for phase in phases:
        name = phase.__name__.replace("_", "-")
        log(f"[{name}]")
        t0 = time.perf_counter()
        try:
            phase()
        except Exception:
            traceback.print_exc()
            failed.append(name)
        log(f"[{name}] {time.perf_counter() - t0:.1f} s")
    if failed:
        print(f"chip_smoke.py: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
