#!/usr/bin/env python
"""Benchmark harness: the reference workloads through the public API.

Rows (the reference demo, hello.cu:5-19, scaled to 1M paths per
BASELINE.json):

* European call, 1M paths, ``method="terminal_pair"`` and ``"terminal"``;
* bullet call, 1M paths x 100 steps (log-Euler step loop);
* ``simulate_trajectories``, 100k x 100 (the C9 grid);
* nested MC at the reference demo, 100k outer x 100 steps x 1,000 inner
  paths.

Each row is the median wall time of repeated calls that end in
``block_until_ready``, after one warm-up call (compilation is reported
separately as set-up time).  The harness needs a GPU: without one it
exits with code 2 and prints no result.  One JSON line on stdout names the
device (platform, kind, count) and carries every row.
"""

import json
import subprocess
import sys
import time

N_PATHS = 1_000_000
N_STEPS = 100


def _median(samples):
    m = len(samples)
    return samples[m // 2] if m % 2 else 0.5 * (samples[m // 2 - 1]
                                                + samples[m // 2])


def median_of(fn, m=5):
    """Repeat a measurement m times; return (median, rel_spread) with
    rel_spread = (max - min) / median over the m samples."""
    samples = sorted(fn() for _ in range(m))
    med = _median(samples)
    return med, ((samples[-1] - samples[0]) / med if med > 0 else 0.0)


def _timed_row(call, reps):
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(call())
    setup = time.perf_counter() - t0

    def once():
        t = time.perf_counter()
        jax.block_until_ready(call())
        return time.perf_counter() - t

    med, spread = median_of(once, reps)
    return {"seconds": med, "rel_spread": spread,
            "setup_seconds": setup, "reps": reps}


def rows():
    """(name, zero-argument call, repetitions, work units, unit)."""
    from mc_tpu import OptionParams, SimParams, price, simulate_trajectories
    from mc_tpu.nmc import price_nmc

    opt = OptionParams()
    sim = SimParams(n_paths=N_PATHS, n_steps=N_STEPS)
    traj_sim = SimParams(n_paths=100_000, n_steps=N_STEPS)
    nmc_sim = SimParams(n_paths=100_000, n_steps=N_STEPS,
                        n_paths_inner=1_000)
    inner_steps = nmc_sim.n_paths * nmc_sim.n_paths_inner * sum(
        N_STEPS - 1 - j for j in range(N_STEPS))
    return [
        ("european_terminal_pair",
         lambda: price(opt, sim, method="terminal_pair"), 9, N_PATHS,
         "paths"),
        ("european_terminal",
         lambda: price(opt, sim, method="terminal"), 9, N_PATHS, "paths"),
        ("bullet_euler", lambda: price(opt, sim, payoff="bullet_call"), 9,
         N_PATHS * N_STEPS, "path_steps"),
        ("trajectories", lambda: simulate_trajectories(opt, traj_sim), 9,
         traj_sim.n_paths * N_STEPS, "path_steps"),
        ("nmc", lambda: price_nmc(opt, nmc_sim), 3, inner_steps,
         "inner_path_steps"),
    ]


def main(argv=None):
    from mc_tpu.utils.platform import start

    del argv
    if start() != "gpu":
        print("bench.py needs a GPU; JAX found none", file=sys.stderr)
        return 2
    import jax

    dev = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())},
           "card": card.strip().splitlines()[0] if card.strip() else None,
           "rows": {}}
    for name, call, reps, work, unit in rows():
        row = _timed_row(call, reps)
        row[f"{unit}_per_sec"] = work / row["seconds"]
        out["rows"][name] = row
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
