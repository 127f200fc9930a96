"""End-to-end pricing tests: the three pillars of the reference's test
strategy (SURVEY.md section 4) made quantitative:

1. analytic-oracle tolerance: |MC - BS| <= 3 stderr (hello.cu:43-45);
2. engine duals on the same RNG stream: Pallas kernel vs XLA reference,
   bit-for-bit (inc/testing.cuh shared-random-array fixture);
3. variance-reduction contracts (new scope, BASELINE.json config 3).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from mc_tpu import DEMO_OPTION, OptionParams, SimParams, price
from mc_tpu.oracle import bs_call

SIM = SimParams(n_paths=200_000, n_steps=50)
SIM_SMALL = SimParams(n_paths=50_000, n_steps=20)
BS = float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2))


def check_vs_bs(res, n_se=3.5):
    assert float(res.stderr) > 0
    assert abs(float(res.price) - BS) <= n_se * float(res.stderr), (
        f"price {float(res.price)} vs BS {BS} "
        f"({abs(float(res.price)-BS)/float(res.stderr):.2f} se)")


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_vanilla_terminal_within_3se(engine):
    check_vs_bs(price(engine=engine, interpret=engine == "pallas", sim=SIM))


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_vanilla_euler_within_3se(engine):
    # log-Euler is exact in distribution under GBM, so no discretization bias
    check_vs_bs(price(engine=engine, interpret=engine == "pallas", sim=SIM,
                      method="euler"))


def test_engines_bitwise_identical():
    """Pallas kernel and XLA dual share draws AND summation order."""
    for payoff in ("vanilla_call", "bullet_call", "asian_call"):
        a = price(engine="pallas", interpret=True, payoff=payoff,
                  sim=SIM_SMALL, tile_rows=8)
        b = price(payoff=payoff, sim=SIM_SMALL, tile_rows=8)
        assert float(a.price) == float(b.price), payoff
        assert float(a.stderr) == float(b.stderr), payoff


def test_tiling_invariance():
    """Counter-based RNG: the price must not depend on the tile size."""
    a = price(engine="pallas", interpret=True, sim=SIM_SMALL, tile_rows=8,
              method="euler")
    b = price(engine="pallas", interpret=True, sim=SIM_SMALL, tile_rows=32,
              method="euler")
    # Same draws, different summation grouping: equal to f32 round-off.
    assert float(a.price) == pytest.approx(float(b.price), rel=1e-6)


def test_path_offset_extends_stream():
    """Path offset shifts RNG counters — the sharding/checkpoint hook.

    Pins method="terminal": the offset chunks always ride the classic
    per-path counter stream, so the unchunked base must too (the
    round-5 default would pick terminal_pair for it, a different
    stream by design).
    """
    full = price(sim=SIM_SMALL, n_paths=4096, tile_rows=8,
                 method="terminal")
    lo = price(sim=SIM_SMALL, n_paths=2048, tile_rows=8,
               method="terminal")
    hi = price(sim=SIM_SMALL, n_paths=2048, tile_rows=8,
               path_offset=2048)
    combined = 0.5 * (float(lo.payoff_mean) + float(hi.payoff_mean))
    assert combined == pytest.approx(float(full.payoff_mean), rel=1e-5)


def test_antithetic_reduces_stderr():
    plain = price(sim=SIM_SMALL)
    anti = price(sim=SIM_SMALL, antithetic=True)
    assert float(anti.stderr) < float(plain.stderr)
    check_vs_bs(anti)


def test_control_variate_reduces_stderr():
    plain = price(sim=SIM_SMALL, method="euler")
    cv = price(sim=SIM_SMALL, method="euler",
               control_variate=True)
    # S_T is a strong control for the call payoff: big variance reduction.
    assert float(cv.stderr) < 0.7 * float(plain.stderr)
    check_vs_bs(cv)


def test_bullet_price_sane():
    """Bullet <= vanilla (it's the vanilla payoff gated by a window)."""
    vanilla = price(sim=SIM_SMALL, method="euler")
    bullet = price(payoff="bullet_call", sim=SIM_SMALL)
    assert 0.0 < float(bullet.price) < float(vanilla.price)


def test_barrier_payoffs_bounded_by_vanilla():
    vanilla = price(sim=SIM_SMALL, method="euler")
    up_out = price(payoff="up_out_call", sim=SIM_SMALL)
    down_in = price(payoff="down_in_call", sim=SIM_SMALL,
                    option=OptionParams(barrier=90.0))
    assert float(up_out.price) < float(vanilla.price)
    assert float(down_in.price) < float(vanilla.price)


def test_lookback_above_vanilla():
    vanilla = price(sim=SIM_SMALL, method="euler")
    lb = price(payoff="lookback_call", sim=SIM_SMALL)
    assert float(lb.price) > float(vanilla.price)


def test_asian_below_vanilla():
    vanilla = price(sim=SIM_SMALL, method="euler")
    asian = price(payoff="asian_call", sim=SIM_SMALL)
    assert 0.0 < float(asian.price) < float(vanilla.price)


def test_put_call_parity_mc():
    c = price(sim=SIM, antithetic=True)
    p = price(payoff="vanilla_put", sim=SIM, antithetic=True)
    parity = 100.0 - 100.0 * np.exp(-0.1)
    got = float(c.price) - float(p.price)
    tol = 3.5 * (float(c.stderr) + float(p.stderr))
    assert abs(got - parity) <= tol


def test_market_params_traced_no_recompile():
    """OptionParams are traced leaves: re-pricing at new market data must
    reuse the compiled program (the reference required a recompile —
    hello.cu hard-codes everything)."""
    import jax
    prices = []
    with jax.log_compiles(False):
        for s0 in (95.0, 100.0, 105.0):
            res = price(option=OptionParams(s0=s0),
                        sim=SIM_SMALL)
            prices.append(float(res.price))
    assert prices == sorted(prices)  # call price increasing in spot


def test_no_systematic_cv_bias():
    """Regression: the multiplicative step form compounded the accelerator's
    exp rounding bias (~-1e-6 per call on an accelerator) into a +5-se CV-estimator bias at
    200k paths; the log-space form must keep the mean deviation ~0."""
    from mc_tpu.oracle import bs_call
    bs = float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2))
    devs = []
    for seed in range(1, 9):
        sim = SimParams(n_paths=100_000, n_steps=100, seed=seed)
        r = price(sim=sim, method="euler", antithetic=True,
                  control_variate=True, tile_rows=64)
        devs.append((float(r.price) - bs) / float(r.stderr))
    mean_dev = sum(devs) / len(devs)
    # 8 seeds: |mean| should be ~< 1/sqrt(8) se; 2.0 allows noise, fails
    # decisively on the former +5 se systematic bias.
    assert abs(mean_dev) < 2.0, devs


def test_invalid_configs_raise():
    with pytest.raises(ValueError):
        price(payoff="bullet_call", method="terminal")
    with pytest.raises(ValueError):
        price(rng_source="hw", antithetic=True)
    with pytest.raises(ValueError):
        price(rng_source="hw")
    with pytest.raises(ValueError):
        price(engine="bogus")


def test_threefry13_source():
    """13-round threefry (the default): valid prices, engine-bitwise,
    distinct from the 20-round safety-margin stream."""
    sim = SimParams(n_paths=100_000, n_steps=20)
    a = price(sim=sim, engine="pallas", interpret=True,
              rng_source="threefry13", tile_rows=8)
    b = price(sim=sim, rng_source="threefry13", tile_rows=8)
    default = price(sim=sim, tile_rows=8)
    full = price(sim=sim, rng_source="threefry", tile_rows=8)
    assert float(a.price) == float(b.price)
    assert float(a.price) == float(default.price)  # 13 IS the default
    assert float(a.price) != float(full.price)     # 20-round differs
    check_vs_bs(a)
    check_vs_bs(full)


def test_extreme_params_stay_finite():
    """Numerical robustness at parameter extremes (checks module contract)."""
    from mc_tpu.utils.checks import validate_result
    sim = SimParams(n_paths=20_000, n_steps=10)
    cases = [
        OptionParams(sigma=2.0),               # huge vol
        OptionParams(sigma=1e-4),              # near-zero vol
        OptionParams(t=1e-3),                  # tiny maturity
        OptionParams(t=10.0, r=0.0),           # long horizon, zero rate
        OptionParams(r=-0.02),                 # negative rate
        OptionParams(s0=1e-3, k=1e-3),         # tiny prices
        OptionParams(s0=1e5, k=1e5),           # large prices
    ]
    for opt in cases:
        res = price(opt, sim, method="euler", tile_rows=8)
        validate_result(res, context=str(opt))


def test_single_path_and_single_step():
    r1 = price(sim=SimParams(n_paths=1, n_steps=1),
               method="euler", tile_rows=8)
    assert float(r1.price) >= 0.0
    r2 = price(sim=SimParams(n_paths=1024, n_steps=1),
               method="euler", tile_rows=8)
    assert abs(float(r2.price) - BS) < 10.0  # 1-step euler == exact GBM


def test_geometric_asian_control_variate():
    """The classic Asian VR: geometric-average control with exact closed
    form. Must agree with the plain Asian estimate and slash the stderr."""
    sim = SimParams(n_paths=100_000, n_steps=32)
    plain = price(sim=sim, payoff="asian_call", tile_rows=8)
    cv = price(sim=sim, payoff="asian_call_geo_cv",
               control_variate=True, tile_rows=8)
    # >10x variance reduction is typical for ATM arithmetic-vs-geometric
    assert float(cv.stderr) < 0.1 * float(plain.stderr)
    tol = 4.0 * (float(plain.stderr) + float(cv.stderr))
    assert abs(float(cv.price) - float(plain.price)) <= tol
    # engines bitwise
    cvp = price(sim=sim, payoff="asian_call_geo_cv", engine="pallas", interpret=True,
                control_variate=True, tile_rows=8)
    assert float(cvp.price) == float(cv.price)


def test_engine_duality_fuzz():
    """Property sweep: random (payoff, geometry, market, flags) configs —
    the pallas/xla bitwise duality must hold on every one of them, not
    just the hand-picked test points."""
    import numpy as np

    from mc_tpu.ops.payoffs import PAYOFFS
    rng_np = np.random.default_rng(42)
    names = sorted(PAYOFFS)
    for trial in range(12):
        name = names[int(rng_np.integers(len(names)))]
        po_obj = PAYOFFS[name]
        n_steps = int(rng_np.integers(1, 13))
        method = ("terminal" if (po_obj.terminal_only
                                 and rng_np.random() < 0.5) else "euler")
        opt = OptionParams(
            s0=float(rng_np.uniform(50, 150)),
            k=float(rng_np.uniform(50, 150)),
            t=float(rng_np.uniform(0.1, 3.0)),
            r=float(rng_np.uniform(-0.02, 0.15)),
            sigma=float(rng_np.uniform(0.05, 0.8)),
            barrier=float(rng_np.uniform(80, 160)),
            p1=float(rng_np.integers(0, max(n_steps // 2, 1) + 1)),
            p2=float(rng_np.integers(n_steps // 2, n_steps + 1)),
            q=float(rng_np.uniform(0.0, 0.05)))
        if name == "cliquet":
            # k/p1/p2 are repurposed (period length / floor / cap) and
            # validated — draw them from their own legal ranges
            opt = dataclasses.replace(
                opt, k=float(rng_np.integers(1, n_steps + 1)),
                p1=float(rng_np.uniform(-0.1, 0.0)),
                p2=float(rng_np.uniform(0.0, 0.1)))
        elif name == "forward_start_call":
            opt = dataclasses.replace(
                opt, k=float(rng_np.uniform(0.8, 1.2)),
                p1=float(rng_np.integers(0, n_steps + 1)))
        sim = SimParams(n_paths=int(rng_np.integers(1, 4)) * 2048,
                        n_steps=n_steps, seed=int(rng_np.integers(1e6)))
        kw = dict(method=method, tile_rows=8,
                  antithetic=bool(rng_np.random() < 0.3))
        a = price(opt, sim, name, engine="pallas", interpret=True, **kw)
        b = price(opt, sim, name, **kw)
        assert float(a.price) == float(b.price), (trial, name, kw)
        assert float(a.stderr) == float(b.stderr), (trial, name, kw)
        assert np.isfinite(float(a.price)), (trial, name)


# --- paired terminal kernel (round 3) -------------------------------------

def test_terminal_pair_matches_bs():
    """Both-halves terminal kernel: same estimator quality, BS gate."""
    from mc_tpu.oracle import bs_call
    sim = SimParams(n_paths=1_000_000, n_steps=100)
    r = price(sim=sim, method="terminal_pair")
    bs = float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2))
    assert abs(float(r.price) - bs) <= 3.5 * float(r.stderr)
    # stderr magnitude matches the classic kernel's (same n, same law)
    c = price(sim=sim, method="terminal")
    assert 0.7 < float(r.stderr) / float(c.stderr) < 1.4


def test_terminal_pair_engines_bitwise():
    sim = SimParams(n_paths=100_000, n_steps=10)
    a = price(sim=sim, method="terminal_pair", engine="pallas", interpret=True,
              tile_rows=8)
    b = price(sim=sim, method="terminal_pair", tile_rows=8)
    assert float(a.price) == float(b.price)
    assert float(a.stderr) == float(b.stderr)


def test_terminal_pair_odd_path_count():
    """The trailing odd path is masked, not silently priced twice."""
    a = price(sim=SimParams(n_paths=99_999, n_steps=10),
              method="terminal_pair")
    from mc_tpu.oracle import bs_call
    bs = float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2))
    assert abs(float(a.price) - bs) <= 4.0 * float(a.stderr)
    assert float(a.n_paths) == 99_999.0


def test_terminal_pair_validation():
    with pytest.raises(ValueError, match="path-dependent"):
        price(payoff="asian_call", method="terminal_pair",
              sim=SimParams(n_paths=1024, n_steps=4))
    with pytest.raises(ValueError, match="fast path"):
        price(method="terminal_pair", antithetic=True,
              sim=SimParams(n_paths=1024, n_steps=4))
    with pytest.raises(ValueError, match="path_offset"):
        price(method="terminal_pair", path_offset=128,
              sim=SimParams(n_paths=1024, n_steps=4))
    with pytest.raises(ValueError, match="rng_source"):
        price(method="terminal_pair", rng_source="philox",
              sim=SimParams(n_paths=1024, n_steps=4))
