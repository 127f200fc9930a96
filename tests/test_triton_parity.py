"""Triton-route path kernels, interpreted on the CPU, against the XLA engine.

Both engines draw the same counter-based stream, fold each tile to one
(8, 128) slab in row order and Kahan-sum the slabs in tile order, so on the
CPU (where the interpreter runs the kernel body through XLA) they agree bit
for bit.  Cases cover every variant the kernels fuse: terminal and Euler
legs, path offsets, antithetic pairs, control-variate moments, importance
sampling, both threefry round counts, resumed paths, and path counts that
leave a ragged last tile.
"""

import jax.numpy as jnp
import pytest

from mc_tpu import OptionParams, SimParams, price, simulate_trajectories
from mc_tpu.engines import _payoff_namespace
from mc_tpu.ops import path_kernels as pk
from mc_tpu.ops._pallas import xla_moment_scan
from mc_tpu.ops.payoffs import get_payoff
from mc_tpu.rng import derive_key

# Barrier window reachable within the short test paths.
OPT = OptionParams(p1=1.0, p2=4.0)
N_STEPS = 5  # odd: exercises the half-pair epilogue of the step loop

PRICE_CASES = [
    ("vanilla_call", "terminal", {}),
    ("vanilla_call", "terminal", {"antithetic": True}),
    ("vanilla_call", "terminal", {"control_variate": True}),
    ("vanilla_call", "terminal", {"importance_shift": 0.5}),
    ("digital_call", "terminal", {"rng_source": "threefry"}),
    ("vanilla_call", "euler", {}),
    ("vanilla_call", "euler", {"path_offset": 4097}),
    ("bullet_call", "euler", {}),
    ("bullet_call", "euler", {"antithetic": True, "control_variate": True}),
    ("bullet_call", "euler", {"path_offset": 777}),
    ("asian_call", "euler", {"control_variate": True}),
    ("lookback_call", "euler", {"antithetic": True}),
    ("up_out_call", "euler", {"importance_shift": 0.3}),
    ("asian_call_geo_cv", "euler", {"control_variate": True}),
]


def _ids(cases):
    return ["-".join([p, m] + sorted(kw)) for p, m, kw in cases]


@pytest.mark.parametrize("n_paths", [1000, 2300])
@pytest.mark.parametrize("payoff,method,kw", PRICE_CASES,
                         ids=_ids(PRICE_CASES))
def test_price_kernel_matches_xla(payoff, method, kw, n_paths):
    sim = SimParams(n_paths=n_paths, n_steps=N_STEPS)
    common = dict(method=method, tile_rows=8, **kw)
    k = price(OPT, sim, payoff, engine="pallas", interpret=True, **common)
    x = price(OPT, sim, payoff, engine="xla", **common)
    assert float(k.price) == float(x.price)
    assert float(k.stderr) == float(x.stderr)
    assert float(k.stderr) > 0.0


@pytest.mark.parametrize("tile_rows", [8, 16])
@pytest.mark.parametrize("n_paths", [1001, 4600])
@pytest.mark.parametrize("payoff", ["vanilla_call", "vanilla_put",
                                    "digital_call"])
def test_terminal_pair_kernel_matches_xla(payoff, n_paths, tile_rows):
    """Both Box-Muller halves become paths; an odd count masks the last."""
    sim = SimParams(n_paths=n_paths, n_steps=1)
    k = price(OPT, sim, payoff, method="terminal_pair", engine="pallas",
              interpret=True, tile_rows=tile_rows)
    x = price(OPT, sim, payoff, method="terminal_pair", engine="xla",
              tile_rows=tile_rows)
    assert float(k.price) == float(x.price)
    assert float(k.stderr) == float(x.stderr)


def _xla_resumed(payoff, cfg, key, option, s_init, state_init):
    """Plain reference for a resumed run: the per-path start values are
    gathered by path id (offset 0), then the shared moment body."""
    p = _payoff_namespace(option, cfg.n_steps)
    k0, k1 = (jnp.asarray(key[i], jnp.uint32) for i in (0, 1))
    flat_s = s_init.reshape(-1)
    flat_st = tuple(x.reshape(-1) for x in state_init)

    def tile_fn(ids, valid):
        return pk.path_moments(payoff, cfg, p, k0, k1, ids, valid,
                               flat_s[ids], tuple(x[ids] for x in flat_st))

    return xla_moment_scan(tile_fn, cfg.n_paths, cfg.tile_rows, 2)


@pytest.mark.parametrize("start_step", [2, 3])
@pytest.mark.parametrize("payoff", ["bullet_call", "asian_call"])
def test_resumed_kernel_matches_xla(payoff, start_step):
    """The reference's (Sk, Ik, Tk) resume (trajectories.cuh:116-117):
    the kernel restarts every path from a stored (S, state) at an even
    or odd step and matches the plain reference."""
    po = get_payoff(payoff)
    sim = SimParams(n_paths=2300, n_steps=N_STEPS)
    traj = simulate_trajectories(OPT, sim, payoff, tile_rows=8)
    s_k, c_k = traj.s[start_step - 1], traj.state[start_step - 1]
    key = jnp.asarray(derive_key(sim.seed, 0), jnp.uint32)
    opt = OPT.as_f32()
    cfg = pk.KernelConfig(n_paths=sim.n_paths, n_steps=N_STEPS, tile_rows=8,
                          start_step=start_step)
    k = pk.simulate_partials(po, cfg, key, pk.pack_params(opt, N_STEPS),
                             s_init=s_k, state_init=(c_k,), interpret=True)
    x = _xla_resumed(po, cfg, key, opt, s_k, (c_k,))
    assert bool(jnp.all(k[0] == x[0]))
    # The reference's gather changes how XLA fuses pay * pay into the
    # Kahan update (it may contract them into one FMA), so the second
    # moment is held to two float32 ulps per cell.
    assert bool(jnp.all(jnp.abs(k[1] - x[1]) <= 2.4e-7 * jnp.abs(x[1])))
