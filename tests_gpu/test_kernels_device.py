"""Compiled Triton kernels == the XLA engine, on the card.

Both engines draw the same counter-based stream and sum in the same order
(per-tile (8, 128) fold, Kahan across tiles in tile order), so the prices
agree bit for bit on the CPU.  On the GPU the kernel's exp/log/sin/cos are
libdevice calls while XLA lowers its own, and either compiler may contract
a multiply-add into an FMA: the gates below allow a few float32 ulps.

Also here: the LSMC-vs-CRR American put gate, at a size that the XLA
CPU suite cannot afford (its float32 regression runs in TF32-free HIGHEST
precision, see lsmc.py).
"""

import jax.numpy as jnp
import pytest

from mc_tpu import OptionParams, SimParams, price, simulate_trajectories
from mc_tpu.lsmc import binomial_american, price_american
from mc_tpu.nmc import price_nmc

pytestmark = pytest.mark.gpu

OPT = OptionParams()
REL = 5e-7  # ~4 float32 ulps


@pytest.mark.parametrize("payoff,method", [
    ("vanilla_call", "terminal_pair"),
    ("vanilla_call", "terminal"),
    ("bullet_call", "euler"),
    ("asian_call", "euler"),
])
@pytest.mark.parametrize("tile_rows", [8, 32])
def test_price_kernel_matches_xla(payoff, method, tile_rows):
    sim = SimParams(n_paths=1 << 20, n_steps=100)
    k = price(OPT, sim, payoff, method=method, engine="pallas",
              tile_rows=tile_rows)
    x = price(OPT, sim, payoff, method=method, engine="xla",
              tile_rows=tile_rows)
    assert float(k.price) == pytest.approx(float(x.price), rel=REL)
    assert float(k.stderr) == pytest.approx(float(x.stderr), rel=REL)


def test_price_kernel_variance_reduction_and_offset():
    sim = SimParams(n_paths=300_001, n_steps=100)
    kw = dict(payoff="bullet_call", antithetic=True, control_variate=True,
              path_offset=12_345, tile_rows=16)
    k = price(OPT, sim, engine="pallas", **kw)
    x = price(OPT, sim, engine="xla", **kw)
    assert float(k.price) == pytest.approx(float(x.price), rel=REL)


def test_trajectories_kernel_matches_xla():
    sim = SimParams(n_paths=100_000, n_steps=100)
    k = simulate_trajectories(OPT, sim, engine="pallas")
    x = simulate_trajectories(OPT, sim, engine="xla")
    assert float(jnp.max(jnp.abs(k.s - x.s))) <= 1e-4
    assert bool(jnp.all(k.state == x.state))


def test_nmc_kernel_matches_xla_on_one_tile():
    sim = SimParams(n_paths=1024, n_steps=100, n_paths_inner=100)
    k = price_nmc(OPT, sim, engine="pallas")
    x = price_nmc(OPT, sim, engine="xla")
    assert float(jnp.max(jnp.abs(k.surface - x.surface))) <= 1e-4
    assert float(k.outer.price) == pytest.approx(float(x.outer.price),
                                                 rel=REL)


def test_lsmc_put_matches_crr():
    ref = binomial_american(100.0, 100.0, 1.0, 0.1, 0.2, kind="put")
    res = price_american(OptionParams(), SimParams(n_paths=1 << 18,
                                                   n_steps=50),
                         "vanilla_put")
    assert abs(float(res.price) - ref) <= 4.0 * float(res.stderr) + 0.02
