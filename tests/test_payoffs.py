"""Payoff-registry unit tests against hand-computed paths.

The reference hard-codes the vanilla payoff (trajectories.cuh:76) and the
bullet barrier-window logic (trajectories.cuh:144-153); these tests pin the
same semantics on the pluggable registry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from types import SimpleNamespace

from mc_tpu.ops.payoffs import PAYOFFS, get_payoff


def params(**kw):
    base = dict(s0=100.0, k=100.0, r=0.1, sigma=0.2, t=1.0,
                barrier=120.0, p1=1.0, p2=3.0, inv_n_steps=0.25)
    base.update(kw)
    return SimpleNamespace(**{k: jnp.float32(v) for k, v in base.items()})


def run_path(payoff, prices, p):
    payoff = get_payoff(payoff)
    s0 = jnp.float32(np.asarray(prices[0]))
    state = payoff.init(p, jnp.zeros_like(s0))
    s = s0
    for v in prices:
        s = jnp.float32(np.asarray(v))
        state = payoff.update(state, s, p)
    return float(payoff.terminal(state, s, p))


def test_get_payoff_unknown():
    with pytest.raises(KeyError):
        get_payoff("nope")


def test_vanilla_call_put():
    p = params()
    vc = get_payoff("vanilla_call")
    vp = get_payoff("vanilla_put")
    assert float(vc.terminal((), jnp.float32(113.0), p)) == pytest.approx(13.0)
    assert float(vc.terminal((), jnp.float32(90.0), p)) == 0.0
    assert float(vp.terminal((), jnp.float32(90.0), p)) == pytest.approx(10.0)
    assert float(vp.terminal((), jnp.float32(113.0), p)) == 0.0


def test_bullet_window_semantics():
    # barrier=120, window [1,3] steps below barrier.
    p = params()
    # 2 steps below barrier -> in window -> pays S_T - K
    assert run_path("bullet_call", [110.0, 130.0, 115.0, 125.0], p) == \
        pytest.approx(25.0)
    # 0 steps below -> out of window -> 0
    assert run_path("bullet_call", [130.0, 130.0, 130.0, 130.0], p) == 0.0
    # 4 steps below barrier -> count above window [1,3] -> 0 even though
    # S_T=110 > K would pay 10 if the window check passed
    assert run_path("bullet_call", [110.0, 110.0, 110.0, 110.0], p) == 0.0
    # boundary: exactly p2 steps below counts as in-window (<=, cuh:149)
    assert run_path("bullet_call", [110.0, 110.0, 110.0, 125.0], p) == \
        pytest.approx(25.0)


def test_asian_call_mean():
    p = params(k=100.0, inv_n_steps=0.25)
    # mean of [100,110,120,130] = 115 -> pays 15
    assert run_path("asian_call", [100.0, 110.0, 120.0, 130.0], p) == \
        pytest.approx(15.0)
    assert run_path("asian_call", [80.0, 90.0, 90.0, 80.0], p) == 0.0


def test_up_out_call():
    p = params(barrier=120.0)
    # never touches 120 -> alive, pays S_T - K
    assert run_path("up_out_call", [105.0, 110.0, 115.0], p) == \
        pytest.approx(15.0)
    # touches barrier -> knocked out
    assert run_path("up_out_call", [105.0, 125.0, 115.0], p) == 0.0


def test_down_in_call():
    p = params(barrier=90.0)
    # never below 90 -> not knocked in -> 0
    assert run_path("down_in_call", [95.0, 110.0, 115.0], p) == 0.0
    # dips below 90 then recovers -> knocked in, pays
    assert run_path("down_in_call", [85.0, 110.0, 115.0], p) == \
        pytest.approx(15.0)


def test_lookback_call():
    p = params(k=100.0)
    assert run_path("lookback_call", [100.0, 140.0, 110.0], p) == \
        pytest.approx(40.0)


def test_registry_complete():
    assert set(PAYOFFS) >= {"vanilla_call", "vanilla_put", "bullet_call",
                            "asian_call", "up_out_call", "down_in_call",
                            "lookback_call"}
    for po in PAYOFFS.values():
        assert hash(po) == hash(type(po)())  # static singletons


def test_digital_call_vs_closed_form():
    """Cash-or-nothing digital: price within noise of e^{-rT} N(d2) on
    both engines (bitwise pair), terminal and euler methods."""
    import numpy as np

    from mc_tpu import SimParams, price
    from mc_tpu.oracle import bs_digital_call
    cf = float(bs_digital_call(100.0, 100.0, 1.0, 0.1, 0.2))
    sim = SimParams(n_paths=1 << 20, n_steps=10)
    a = price(sim=sim, payoff="digital_call", engine="pallas", interpret=True, tile_rows=8)
    b = price(sim=sim, payoff="digital_call", tile_rows=8)
    assert float(a.price) == float(b.price)
    assert abs(float(a.price) - cf) <= 4.0 * float(a.stderr), (
        float(a.price), cf)


def test_digital_lrm_delta_vs_closed_form():
    """The digital is the canonical LRM showcase (pathwise derivative is
    a.e. zero): LRM delta must match the closed form
    e^{-rT} phi(d2) / (S0 sigma sqrt(T))."""
    import math

    import numpy as np

    from mc_tpu import SimParams
    from mc_tpu.greeks import greeks
    s0, k, t, r, sig = 100.0, 100.0, 1.0, 0.1, 0.2
    d2 = (math.log(s0 / k) + (r - 0.5 * sig**2) * t) / (sig * math.sqrt(t))
    want = (math.exp(-r * t) * math.exp(-0.5 * d2 * d2)
            / math.sqrt(2 * math.pi) / (s0 * sig * math.sqrt(t)))
    g = greeks(sim=SimParams(n_paths=1 << 20, n_steps=1),
               payoff="digital_call", method="lrm", which=("delta",))
    assert abs(float(g["delta"]) - want) <= 4.0 * float(g["delta_stderr"])
    # pathwise must refuse
    import pytest
    with pytest.raises(ValueError, match="lrm"):
        greeks(payoff="digital_call", method="pathwise")


def test_digital_put_parity_and_closed_form():
    """digital_put == e^{-rT} N(-d2), and put + call on the SAME key sum
    to the discount bond exactly (pathwise complement)."""
    import numpy as np

    from mc_tpu import SimParams, price
    from mc_tpu.oracle import bs_digital_put
    cf = float(bs_digital_put(100.0, 100.0, 1.0, 0.1, 0.2))
    sim = SimParams(n_paths=1 << 20, n_steps=10)
    p = price(sim=sim, payoff="digital_put", engine="pallas", interpret=True, tile_rows=8)
    c = price(sim=sim, payoff="digital_call", engine="pallas", interpret=True, tile_rows=8)
    x = price(sim=sim, payoff="digital_put", tile_rows=8)
    assert float(p.price) == float(x.price)
    assert abs(float(p.price) - cf) <= 4.0 * float(p.stderr), (
        float(p.price), cf)
    # pathwise complement (P(S_T == K) = 0 a.s. in f32 here)
    import math
    bond = math.exp(-0.1)
    assert float(p.price) + float(c.price) == pytest.approx(bond,
                                                            rel=2e-6)


def test_best_of_cash_identity():
    """max(S,K) = K + max(S-K,0) pathwise: on the SAME terminal draws
    the best-of-cash price is the discount-bond-on-K plus the call,
    exactly (shared stream, identical accumulation order up to fp)."""
    import math

    from mc_tpu import OptionParams, SimParams, price
    opt, sim = OptionParams(), SimParams(n_paths=65536, n_steps=8)
    boc = price(opt, sim, payoff="best_of_cash", method="terminal")
    call = price(opt, sim, payoff="vanilla_call", method="terminal")
    want = 100.0 * math.exp(-0.1) + float(call.price)
    assert abs(float(boc.price) - want) < 1e-3


def test_best_of_cash_rainbow_nmc():
    """Best-of-assets-or-cash exposure on the d-asset engine (the last
    RAINBOW_PAYOFFS contract to join NMC): EE flat at the t=0 price
    (martingale under full discounting)."""
    import numpy as np

    from mc_tpu import OptionParams, SimParams
    from mc_tpu.nmc_rainbow import price_nmc_rainbow
    sim = SimParams(n_paths=4096, n_steps=8, n_paths_inner=16)
    res = price_nmc_rainbow(OptionParams(), sim=sim,
                            payoff="best_of_cash")
    ee, _ = res.exposure_profile()
    np.testing.assert_allclose(np.asarray(ee), float(res.outer.price),
                               rtol=0.05)
