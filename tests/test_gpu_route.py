"""What the CPU can say about the GPU route without a card.

* Every Triton kernel lowers for CUDA here (``lowering_platforms``), which
  is as far as a machine without a card can take it: Pallas emits the
  Triton custom call, the GPU's compiler is asked only on the card.
* The engine a pricer runs is chosen by platform, and asking for the
  kernels off the GPU without the interpreter raises.
* The compile cache follows ``JAX_COMPILATION_CACHE_DIR`` and falls back to
  the checkout's ``.jax_cache``.
"""

import os

import jax
import jax.numpy as jnp
import pytest

from mc_tpu import OptionParams, SimParams, price, simulate_trajectories
from mc_tpu.engines import _price_impl
from mc_tpu.ops import _pallas
from mc_tpu.ops import nmc_kernels as nk
from mc_tpu.ops import path_kernels as pk
from mc_tpu.ops.payoffs import get_payoff
from mc_tpu.utils import platform

OPT = OptionParams().as_f32()
KEY = jnp.array([1234, 0], jnp.uint32)
N_STEPS = 7
PARAMS = pk.pack_params(OPT, N_STEPS)
BULLET = get_payoff("bullet_call")
CALL = get_payoff("vanilla_call")
EULER = pk.KernelConfig(n_paths=5000, n_steps=N_STEPS, tile_rows=8)
ROWS = EULER.n_tiles * EULER.tile_rows
GRID = jax.ShapeDtypeStruct((N_STEPS, ROWS, 128), jnp.float32)
NMC = nk.NMCConfig(n_paths=5000, n_steps=N_STEPS, n_inner=16)

KERNELS = {
    "mc_paths_euler": (
        lambda k, p: pk.simulate_partials(BULLET, EULER, k, p),
        (KEY, PARAMS)),
    "mc_paths_terminal": (
        lambda k, p: pk.simulate_partials(
            CALL, pk.KernelConfig(n_paths=5000, n_steps=1, tile_rows=32,
                                  method="terminal", antithetic=True,
                                  with_cv=True), k, p),
        (KEY, PARAMS)),
    "mc_paths_euler_resume": (
        lambda k, p, s, c: pk.simulate_partials(
            BULLET, pk.KernelConfig(n_paths=5000, n_steps=N_STEPS,
                                    tile_rows=8, start_step=3), k, p,
            s_init=s, state_init=(c,)),
        (KEY, PARAMS, GRID.update(shape=(ROWS, 128)),
         GRID.update(shape=(ROWS, 128)))),
    "mc_terminal_pair": (
        lambda k, p: pk.terminal_pair_partials(
            CALL, pk.KernelConfig(n_paths=2500, n_steps=1, tile_rows=16),
            k, p, jnp.uint32(5000), engine="pallas"),
        (KEY, PARAMS)),
    "mc_trajectories": (
        lambda k, p: pk.simulate_trajectories_kernel(BULLET, EULER, k, p),
        (KEY, PARAMS)),
    "mc_nmc_inner": (
        lambda k, p, s, c: nk.nmc_inner_kernel(BULLET, NMC, k, p, s, c),
        (KEY, PARAMS, GRID, GRID)),
    "mc_kahan_tiles": (
        _pallas.kahan_tiles_kernel,
        (jax.ShapeDtypeStruct((2, 37, 8, 128), jnp.float32),)),
}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_lowers_for_cuda(name):
    fn, args = KERNELS[name]
    text = jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert name.replace("_resume", "") in text


def test_public_price_program_lowers_for_cuda():
    """The jitted program behind `price(engine="pallas")`, kernel and
    finish together."""
    sim = SimParams(n_paths=5000, n_steps=N_STEPS)
    fn = jax.jit(lambda o, k: _price_impl(
        o, BULLET, sim, "euler", "pallas", False, False, 32, "threefry13",
        False, k, jnp.uint32(0), None))
    text = fn.trace(OPT, KEY).lower(lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") >= 2  # paths + Kahan


def test_engine_defaults_by_platform(monkeypatch):
    assert _pallas.resolve_engine(None) == "xla"  # this suite runs on CPU
    monkeypatch.setattr(_pallas.jax, "default_backend", lambda: "gpu")
    assert _pallas.resolve_engine(None) == "pallas"
    assert _pallas.resolve_engine("pallas") == "pallas"
    assert _pallas.resolve_engine("xla") == "xla"


def test_engine_choice_validation():
    assert _pallas.resolve_engine("pallas", interpret=True) == "pallas"
    with pytest.raises(ValueError, match="unknown engine"):
        _pallas.resolve_engine("mosaic")
    with pytest.raises(ValueError, match="interpret=True"):
        _pallas.resolve_engine("pallas")


def test_default_tile_rows_follow_the_engine():
    assert pk.default_tile_rows("pallas") == 32
    assert pk.default_tile_rows("xla") == 128


def _entry_points():
    from mc_tpu.checkpoint import chunked_price
    from mc_tpu.greeks import greeks
    from mc_tpu.nmc import price_nmc
    from mc_tpu.parallel import price_nmc_sharded, price_sharded
    sim = SimParams(n_paths=1024, n_steps=4, n_paths_inner=2)
    return {
        "price": lambda: price(sim=sim, engine="pallas"),
        "simulate_trajectories": lambda: simulate_trajectories(
            sim=sim, engine="pallas"),
        "price_nmc": lambda: price_nmc(sim=sim, engine="pallas"),
        "price_sharded": lambda: price_sharded(sim=sim, engine="pallas"),
        "price_nmc_sharded": lambda: price_nmc_sharded(sim=sim,
                                                       engine="pallas"),
        "greeks": lambda: greeks(sim=sim, engine="pallas"),
        "chunked_price": lambda: chunked_price(sim=sim, chunk_paths=1024,
                                               engine="pallas"),
    }


@pytest.mark.parametrize("entry", sorted(_entry_points()))
def test_kernels_off_the_gpu_need_the_interpreter(entry):
    with pytest.raises(ValueError, match="interpret=True"):
        _entry_points()[entry]()


def _recorded_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(platform.jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_compile_cache_follows_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert platform.compile_cache_dir() == str(tmp_path)
    calls = _recorded_updates(monkeypatch)
    platform.start()
    # JAX reads the variable itself; nothing is set over it in code.
    assert not [c for c in calls if c[0] == "jax_compilation_cache_dir"]


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(checkout, ".jax_cache")
    assert platform.compile_cache_dir() == want
    calls = _recorded_updates(monkeypatch)
    platform.start()
    assert ("jax_compilation_cache_dir", want) in calls


def test_start_pins_only_known_platforms(monkeypatch):
    calls = _recorded_updates(monkeypatch)
    platform.start("gpu")
    assert ("jax_platforms", "cuda") in calls
    with pytest.raises(ValueError, match="unknown platform"):
        platform.start("rocm")


@pytest.mark.parametrize("command", ["price", "traj", "greeks"])
def test_cli_kernels_off_the_gpu_need_the_interpreter(command):
    from mc_tpu.cli import main
    with pytest.raises(ValueError, match="interpret=True"):
        main([command, "-N", "1024", "--n-steps", "4", "--engine",
              "pallas", "--platform", "cpu"])


@pytest.mark.parametrize("command", ["heston", "qmc", "ladder"])
def test_cli_engine_flag_only_where_kernels_exist(command, capsys):
    from mc_tpu.cli import main
    with pytest.raises(SystemExit):
        main([command, "--engine", "xla"])
    assert "unrecognized arguments: --engine" in capsys.readouterr().err
