"""Brownian-bridge barrier correction vs the reflection-principle oracle.

Two independent constructions must meet: the closed form integrates the
reflected terminal density (oracle.bs_up_out_call/bs_down_out_call), the MC
estimator weights each path by the product of conditional bridge survival
probabilities (payoffs.UpOutCallBB/DownOutCallBB).  Agreement within MC
noise at a COARSE step count validates both at once — the plain discrete
payoff needs n -> inf to converge to the same number.
"""

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams, price
from mc_tpu.oracle import bs_call, bs_down_out_call, bs_up_out_call

S0, K, T, R, SIG, Q = 100.0, 100.0, 1.0, 0.1, 0.2, 0.0
SIM = SimParams(n_paths=200_000, n_steps=50)


# --- closed form sanity ----------------------------------------------------

def test_up_out_limits():
    # Barrier far away: knock-out is irrelevant
    far = bs_up_out_call(S0, K, T, R, SIG, b=10_000.0)
    assert far == pytest.approx(float(bs_call(S0, K, T, R, SIG)), rel=1e-5)
    # Barrier at the strike: worthless (payoff region is knocked out)
    assert bs_up_out_call(S0, K, T, R, SIG, b=K) == 0.0
    # Already knocked
    assert bs_up_out_call(130.0, K, T, R, SIG, b=120.0) == 0.0
    # Monotone increasing in the barrier level
    vals = [bs_up_out_call(S0, K, T, R, SIG, b=b)
            for b in (110.0, 120.0, 140.0, 180.0)]
    assert all(a < b for a, b in zip(vals, vals[1:]))


def test_down_out_limits():
    # Barrier near zero: knock-out is irrelevant
    low = bs_down_out_call(S0, K, T, R, SIG, b=1e-6)
    assert low == pytest.approx(float(bs_call(S0, K, T, R, SIG)), rel=1e-5)
    # Already knocked
    assert bs_down_out_call(70.0, K, T, R, SIG, b=80.0) == 0.0
    # Monotone decreasing in the barrier level
    vals = [bs_down_out_call(S0, K, T, R, SIG, b=b)
            for b in (60.0, 80.0, 90.0, 99.0)]
    assert all(a > b for a, b in zip(vals, vals[1:]))
    # k < b branch continuity at k == b (the two formulas meet)
    lo = bs_down_out_call(S0, 89.999, T, R, SIG, b=90.0)
    hi = bs_down_out_call(S0, 90.001, T, R, SIG, b=90.0)
    assert lo == pytest.approx(hi, rel=1e-3)


# --- bridge-corrected MC vs closed form ------------------------------------

def test_up_out_bb_unbiased_at_coarse_steps():
    opt = OptionParams(barrier=120.0)
    ref = bs_up_out_call(S0, K, T, R, SIG, b=120.0)
    res = price(opt, SIM, payoff="up_out_call_bb", method="euler", tile_rows=64)
    assert abs(float(res.price) - ref) <= 3.5 * float(res.stderr), (
        float(res.price), ref, float(res.stderr))


def test_down_out_bb_unbiased_at_coarse_steps():
    opt = OptionParams(barrier=90.0)
    ref = bs_down_out_call(S0, K, T, R, SIG, b=90.0)
    res = price(opt, SIM, payoff="down_out_call_bb", method="euler", tile_rows=64)
    assert abs(float(res.price) - ref) <= 3.5 * float(res.stderr), (
        float(res.price), ref, float(res.stderr))


def test_discrete_monitoring_bias_is_real_and_removed():
    """Plain discrete up-and-out at 50 steps is biased HIGH vs the
    continuous price by many stderr; the BB weight removes it."""
    opt = OptionParams(barrier=120.0)
    ref = bs_up_out_call(S0, K, T, R, SIG, b=120.0)
    disc = price(opt, SIM, payoff="up_out_call", method="euler", tile_rows=64)
    bb = price(opt, SIM, payoff="up_out_call_bb", method="euler", tile_rows=64)
    assert float(disc.price) - ref > 10.0 * float(disc.stderr)
    assert abs(float(bb.price) - ref) <= 3.5 * float(bb.stderr)
    assert float(bb.price) < float(disc.price)


def test_bb_pallas_xla_bitwise():
    opt = OptionParams(barrier=120.0)
    sim = SimParams(n_paths=16_384, n_steps=10)
    for payoff in ("up_out_call_bb", "down_out_call_bb"):
        a = price(opt, sim, payoff=payoff, method="euler",
                  engine="pallas", interpret=True, tile_rows=8)
        b = price(opt, sim, payoff=payoff, method="euler", tile_rows=8)
        assert float(a.price) == float(b.price), payoff
        assert float(a.stderr) == float(b.stderr), payoff


def test_in_out_parity_discrete():
    """down_in + down_out = vanilla, path by path under CRN."""
    opt = OptionParams(barrier=90.0)
    sim = SimParams(n_paths=50_000, n_steps=20)
    kw = dict(method="euler", tile_rows=64)
    din = price(opt, sim, payoff="down_in_call", **kw)
    dout = price(opt, sim, payoff="down_out_call", **kw)
    van = price(opt, sim, payoff="vanilla_call", **kw)
    assert float(din.price) + float(dout.price) == pytest.approx(
        float(van.price), rel=1e-5)


def test_bb_antithetic_unbiased():
    opt = OptionParams(barrier=120.0)
    ref = bs_up_out_call(S0, K, T, R, SIG, b=120.0)
    res = price(opt, SIM, payoff="up_out_call_bb", method="euler", antithetic=True, tile_rows=64)
    assert abs(float(res.price) - ref) <= 3.5 * float(res.stderr)


def test_bb_survival_weight_in_unit_interval():
    """Direct state-machine check on a hand path."""
    from types import SimpleNamespace

    import jax.numpy as jnp

    from mc_tpu.ops.payoffs import get_payoff
    po = get_payoff("up_out_call_bb")
    p = SimpleNamespace(s0=jnp.float32(100.0), k=jnp.float32(100.0),
                        barrier=jnp.float32(120.0),
                        sigma=jnp.float32(0.2), dt=jnp.float32(0.01))
    state = po.init(p, jnp.zeros((1,), jnp.float32))
    for s in (105.0, 119.0, 110.0):
        state = po.update(state, jnp.full((1,), s, jnp.float32), p)
        surv = float(state[1][0])
        assert 0.0 < surv <= 1.0
    # crossing the barrier kills the weight entirely
    state = po.update(state, jnp.full((1,), 125.0, jnp.float32), p)
    assert float(state[1][0]) == 0.0
    state = po.update(state, jnp.full((1,), 110.0, jnp.float32), p)
    assert float(state[1][0]) == 0.0
