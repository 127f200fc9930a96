"""Longstaff-Schwartz American pricing vs the CRR binomial oracle."""

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.lsmc import binomial_american, price_american
from mc_tpu.oracle import bs_call, bs_put

# Standard American-put test config (early exercise premium is material
# at high r): S0=100, K=100, r=0.1, sigma=0.2, T=1.
OPT = OptionParams()
SIM = SimParams(n_paths=100_000, n_steps=50)


def test_binomial_oracle_european_limit():
    """American call (no dividends) == European call; binomial converges
    to BS."""
    bs = float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2))
    bin_call = binomial_american(100.0, 100.0, 1.0, 0.1, 0.2, kind="call")
    assert bin_call == pytest.approx(bs, rel=2e-3)


def test_binomial_put_above_european():
    eur = float(bs_put(100.0, 100.0, 1.0, 0.1, 0.2))
    amer = binomial_american(100.0, 100.0, 1.0, 0.1, 0.2, kind="put")
    assert amer > eur + 0.05


def test_lsmc_put_matches_binomial():
    ref = binomial_american(100.0, 100.0, 1.0, 0.1, 0.2, kind="put")
    res = price_american(OPT, SIM, payoff="vanilla_put")
    # LSMC carries a small low bias (suboptimal fitted policy) plus the
    # discrete exercise dates; 1% relative + 3.5 se tolerance.
    tol = 3.5 * float(res.stderr) + 0.012 * ref
    assert abs(float(res.price) - ref) <= tol, (float(res.price), ref)


def test_lsmc_put_above_european():
    eur = float(bs_put(100.0, 100.0, 1.0, 0.1, 0.2))
    res = price_american(OPT, SIM, payoff="vanilla_put")
    assert float(res.price) > eur


def test_lsmc_call_equals_european():
    """American call without dividends should not be exercised early."""
    bs = float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2))
    res = price_american(OPT, SIM, payoff="vanilla_call")
    assert float(res.price) == pytest.approx(bs, rel=0.02)


def test_lsmc_deep_itm_put():
    """Deep ITM American put: immediate exercise dominates, price ~= K-S."""
    opt = OptionParams(s0=60.0)
    ref = binomial_american(60.0, 100.0, 1.0, 0.1, 0.2, kind="put")
    res = price_american(opt, SIM, payoff="vanilla_put")
    assert float(res.price) == pytest.approx(ref, rel=0.02)
    assert float(res.price) >= 39.5  # >= K - S0 - eps


def test_lsmc_degree_insensitivity():
    a = price_american(OPT, SIM, payoff="vanilla_put", degree=2)
    b = price_american(OPT, SIM, payoff="vanilla_put", degree=4)
    assert abs(float(a.price) - float(b.price)) < 0.05


def test_lsmc_guard():
    with pytest.raises(KeyError):
        price_american(payoff="nope")


def test_two_pass_removes_foresight_bias():
    """Longstaff-Schwartz protocol check at a deliberately overfit config:
    a DEEP-OTM put leaves only a handful of in-the-money paths per date,
    so a degree-7 regression on 2k paths overfits badly — the one-pass
    estimator inflates (regression foresight) while the two-pass
    estimator prices an independent set with the frozen policy.  The
    seed-averaged paired ordering one-pass > two-pass must be
    significant (measured t ~ 4 at this config)."""
    import numpy as np
    opt = OptionParams(k=80.0)
    one, two = [], []
    for s in range(16):
        sim = SimParams(n_paths=2048, n_steps=50, seed=s)
        one.append(float(price_american(opt, sim, two_pass=False,
                                        degree=7).price))
        two.append(float(price_american(opt, sim, two_pass=True,
                                        degree=7).price))
    diff = np.asarray(one) - np.asarray(two)
    sem = diff.std(ddof=1) / np.sqrt(len(diff))
    assert diff.mean() > 2.0 * sem, (diff.mean(), sem)   # one >= two

    # On the reference put config the two-pass estimate stays a valid
    # lower bound bracketing the binomial oracle within noise.
    oracle = binomial_american(100.0, 100.0, 1.0, 0.1, 0.2, kind="put")
    r = price_american(sim=SimParams(n_paths=100_000, n_steps=50))
    assert float(r.price) <= oracle + 3.0 * float(r.stderr)


# --- American exercise under Heston (model-family x engine composition) --

def test_heston_american_degenerate_limit():
    """xi -> 0 with v0 = theta collapses Heston to GBM with
    sigma = sqrt(v0): the stochastic-vol LSMC price must match the CRR
    binomial American oracle (up to MC noise + the Bermudan-at-50-dates
    discretization gap, which biases LSMC slightly LOW)."""
    from mc_tpu.lsmc import price_american_heston
    from mc_tpu.models.heston import HestonDynamics
    h0 = HestonDynamics(v0=0.04, kappa=1.0, theta=0.04, xi=1e-4, rho=0.0)
    sim = SimParams(n_paths=100_000, n_steps=50)
    r = price_american_heston(heston=h0, sim=sim)
    oracle = binomial_american(100.0, 100.0, 1.0, 0.1, 0.2, kind="put")
    assert float(r.price) <= oracle + 3.0 * float(r.stderr)
    assert float(r.price) >= oracle - 4.0 * float(r.stderr) - 0.05


def test_heston_american_premium():
    """General Heston config: American put dominates the European put
    (computed from the CF call via put-call parity) with a clearly
    positive early-exercise premium at r=0.1."""
    from mc_tpu.lsmc import price_american_heston
    from mc_tpu.models.heston import DEMO_HESTON, heston_call_cf
    sim = SimParams(n_paths=100_000, n_steps=50)
    r = price_american_heston(sim=sim)
    c = heston_call_cf(100.0, 100.0, 1.0, 0.1, *DEMO_HESTON.astuple())
    euro_put = c - 100.0 + 100.0 * np.exp(-0.1)
    assert float(r.price) > euro_put + 10.0 * float(r.stderr), (
        float(r.price), euro_put)


def test_heston_american_two_pass_ordering():
    """The two-pass protocol applies under stochastic vol too: the
    in-sample estimate dominates the independent-set estimate on
    average (weak check at one seed pair: within noise)."""
    from mc_tpu.lsmc import price_american_heston
    sim = SimParams(n_paths=50_000, n_steps=50)
    one = price_american_heston(sim=sim, two_pass=False)
    two = price_american_heston(sim=sim, two_pass=True)
    tol = 4.0 * (float(one.stderr) + float(two.stderr))
    assert float(one.price) >= float(two.price) - tol


def test_heston_trajectories_grids():
    """Grid self-consistency: the Heston family's trajectory grids carry
    the same terminal-payoff moments as the Heston pricer on the same
    stream (same step loop, same fold/Kahan order: bit for bit), and the
    (S, v) grids match an eager recomputation to f32 rounding."""
    import jax.numpy as jnp

    from mc_tpu import rng
    from mc_tpu.models.heston import (DEMO_HESTON, _heston_partials,
                                      _pack_heston, _unpack_heston,
                                      heston_euler_step)
    from mc_tpu.nmc_heston import HestonNMC
    from mc_tpu.ops import path_kernels as pk
    from mc_tpu.ops.payoffs import get_payoff

    opt = OptionParams().as_f32()
    hes = DEMO_HESTON.as_f32()
    n_paths, n_steps = 2048, 8
    cfg = pk.KernelConfig(n_paths=n_paths, n_steps=n_steps, tile_rows=8)
    params = _pack_heston(opt, hes, n_steps)
    key = jnp.asarray(rng.derive_key(7, 0), jnp.uint32)
    po = get_payoff("vanilla_put")
    s_g, v_g, c_g, pay_sum, _ = HestonNMC().trajectories(po, cfg, key,
                                                         params)
    ref_sum, _ = _heston_partials(po, cfg, key, params, 0, None)
    np.testing.assert_array_equal(np.asarray(pay_sum), np.asarray(ref_sum))

    # eager recomputation of the same stream (rounding-tolerant)
    p = _unpack_heston(params)
    ids = jnp.arange(s_g.shape[1] * 128, dtype=jnp.uint32).reshape(
        s_g.shape[1], 128)

    def draw(j):
        c1 = jnp.full(ids.shape, 0, jnp.uint32) + jnp.asarray(j, jnp.uint32)
        return rng.normal_pair(jnp.uint32(key[0]), jnp.uint32(key[1]),
                               ids, c1)

    w = jnp.zeros(ids.shape, jnp.float32)
    v = jnp.full(ids.shape, p.v0, jnp.float32)
    for j in range(n_steps):
        z_v, z_p = draw(j)
        w, v = heston_euler_step(p, w, v, z_v, z_p, p.dt, p.sqrt_dt)
        s = jnp.float32(p.s0) * jnp.exp(w)
        np.testing.assert_allclose(np.asarray(s_g[j]).ravel(),
                                   np.asarray(s).ravel(), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(v_g[j]).ravel(),
                                   np.asarray(v).ravel(),
                                   rtol=1e-4, atol=1e-7)


def test_two_pass_key_follows_explicit_key():
    """Regression (review): the pricing-pass key must be folded from the
    ACTUAL regression key, so distinct explicit keys give decorrelated
    two-pass estimates (previously key_b depended only on seed/stream)."""
    import jax.numpy as jnp

    from mc_tpu import rng
    sim = SimParams(n_paths=8192, n_steps=10)
    k1 = jnp.asarray(rng.derive_key(111, 0), jnp.uint32)
    k2 = jnp.asarray(rng.derive_key(222, 0), jnp.uint32)
    a = price_american(sim=sim, key=k1)
    b = price_american(sim=sim, key=k2)
    assert float(a.price) != float(b.price)
    # default path unchanged: key=None reproduces derive_key chaining
    c = price_american(sim=sim)
    d = price_american(sim=sim,
                       key=jnp.asarray(rng.derive_key(sim.seed, 0),
                                       jnp.uint32))
    assert float(c.price) == float(d.price)


def test_american_bounds_bracket_oracle():
    """Andersen-Broadie duality: [lower-3se, upper+3se] must contain the
    Bermudan value (<= the CRR American oracle, within a small
    exercise-grid gap), with a tight measured gap at N=10/J=128."""
    from mc_tpu.lsmc import american_bounds
    lo, up = american_bounds(sim=SimParams(n_paths=50_000, n_steps=10),
                             n_outer=2048, n_inner=128)
    oracle = binomial_american(100.0, 100.0, 1.0, 0.1, 0.2, kind="put")
    assert float(up.price) + 3 * float(up.stderr) >= oracle - 0.06
    assert float(lo.price) - 3 * float(lo.stderr) <= oracle
    gap = float(up.price) - float(lo.price)
    assert -0.05 < gap < 0.35, gap
    # upper must dominate lower beyond joint noise going the wrong way
    assert float(up.price) >= float(lo.price) - 2 * (
        float(up.stderr) + float(lo.stderr))


def test_american_bounds_guard():
    from mc_tpu.lsmc import american_bounds
    with pytest.raises(ValueError, match="terminal"):
        american_bounds(payoff="asian_call")


def test_american_bounds_bermudan_schedule():
    """exercise_every decouples the exercise grid from the simulation
    grid: on a 50-step grid with 10 exercise dates the AB bracket stays
    tight (the martingale conditions on the previous EXERCISE date, not
    the previous sim step) and contains the oracle."""
    from mc_tpu.lsmc import american_bounds
    lo, up = american_bounds(sim=SimParams(n_paths=50_000, n_steps=50),
                             n_outer=2048, n_inner=128, exercise_every=5)
    oracle = binomial_american(100.0, 100.0, 1.0, 0.1, 0.2, kind="put")
    assert float(up.price) + 3 * float(up.stderr) >= oracle - 0.06
    assert float(lo.price) - 3 * float(lo.stderr) <= oracle
    assert 0.0 < float(up.price) - float(lo.price) < 0.4


def test_american_bounds_maturity_always_included():
    """Regression (review): with n_steps not divisible by exercise_every
    the maturity date dropped out of the dual's pathwise max, letting the
    'upper' bound fall below the true price.  10 steps / every=3 (dates
    3,6,9 + maturity): the bracket must still contain the oracle."""
    from mc_tpu.lsmc import american_bounds
    lo, up = american_bounds(sim=SimParams(n_paths=30_000, n_steps=10),
                             n_outer=2048, n_inner=96, exercise_every=3)
    oracle = binomial_american(100.0, 100.0, 1.0, 0.1, 0.2, kind="put")
    assert float(up.price) >= float(lo.price) - 2 * (
        float(up.stderr) + float(lo.stderr))
    # Bermudan-4-dates <= American oracle; upper must not sit below the
    # Bermudan value, which the lower bound estimates
    assert float(up.price) + 3 * float(up.stderr) >= \
        float(lo.price) - 3 * float(lo.stderr)
    assert float(lo.price) - 3 * float(lo.stderr) <= oracle


def test_american_bounds_counter_guard():
    from mc_tpu.lsmc import american_bounds
    with pytest.raises(ValueError, match="counter"):
        american_bounds(sim=SimParams(n_paths=1024, n_steps=2048),
                        n_inner=1024)


def test_heston_bermudan_schedule():
    """exercise_every under Heston: Bermudan <= American (same noise
    budget, paired keys), default unchanged."""
    from mc_tpu.lsmc import price_american_heston
    sim = SimParams(n_paths=50_000, n_steps=20)
    amer = price_american_heston(sim=sim)
    berm = price_american_heston(sim=sim, exercise_every=4)
    tol = 3.0 * (float(amer.stderr) + float(berm.stderr))
    assert float(berm.price) <= float(amer.price) + tol
    d = price_american_heston(sim=sim, exercise_every=1)
    assert float(d.price) == float(amer.price)


# --- American exercise on a correlated basket ----------------------------

def test_basket_american_d1_degenerate():
    """d=1 basket == single GBM asset: the basket LSMC price must sit in
    the same place as the plain GBM LSMC relative to the CRR oracle."""
    from mc_tpu.lsmc import price_american_basket
    from mc_tpu.models.basket import BasketDynamics
    b1 = BasketDynamics(s0s=np.array([100.0], np.float32),
                        sigmas=np.array([0.2], np.float32),
                        weights=np.array([1.0], np.float32),
                        corr=np.array([[1.0]], np.float32))
    sim = SimParams(n_paths=100_000, n_steps=50)
    r = price_american_basket(basket=b1, sim=sim)
    oracle = binomial_american(100.0, 100.0, 1.0, 0.1, 0.2, kind="put")
    assert float(r.price) <= oracle + 3.0 * float(r.stderr)
    assert float(r.price) >= oracle - 4.0 * float(r.stderr) - 0.06


def test_basket_american_premium():
    """4-asset basket: American put dominates the European basket put."""
    from mc_tpu.lsmc import price_american_basket
    from mc_tpu.models.basket import price_basket
    sim = SimParams(n_paths=100_000, n_steps=50)
    amer = price_american_basket(sim=sim)
    euro = price_basket(sim=sim, payoff="vanilla_put",
                        tile_rows=8)
    assert float(amer.price) > float(euro.price) + 5.0 * (
        float(amer.stderr) + float(euro.stderr))


def test_heston_american_bounds_bracket():
    """AB duality under stochastic vol: in the degenerate (xi->0,
    v0=theta) limit the [lower-3se, upper+3se] bracket must contain the
    CRR American oracle; in the general model upper >= lower."""
    from mc_tpu.lsmc import american_bounds
    from mc_tpu.models.heston import DEMO_HESTON, HestonDynamics
    h0 = HestonDynamics(v0=0.04, kappa=1.0, theta=0.04, xi=1e-4, rho=0.0)
    sim = SimParams(n_paths=30_000, n_steps=10)
    lo, up = american_bounds(sim=sim, heston=h0, n_outer=2048, n_inner=96)
    oracle = binomial_american(100.0, 100.0, 1.0, 0.1, 0.2, kind="put")
    assert float(lo.price) - 3 * float(lo.stderr) <= oracle
    assert float(up.price) + 3 * float(up.stderr) >= oracle - 0.06
    lo2, up2 = american_bounds(sim=sim, heston=DEMO_HESTON, n_outer=2048,
                               n_inner=96)
    assert float(up2.price) >= float(lo2.price) - 2 * (
        float(up2.stderr) + float(lo2.stderr))


# --- American Greeks (round 3): frozen-policy pathwise -------------------

def test_american_greeks_match_crr_fd():
    """Frozen-policy pathwise delta/vega vs CRR binomial central
    differences on the reference put config."""
    from mc_tpu.lsmc import american_greeks, binomial_american
    g = american_greeks(sim=SimParams(n_paths=200_000, n_steps=50))
    h, hv = 0.5, 0.005

    def f(s):
        return binomial_american(s, 100.0, 1.0, 0.1, 0.2, kind="put")

    def fv(sg):
        return binomial_american(100.0, 100.0, 1.0, 0.1, sg, kind="put")

    crr_delta = (f(100 + h) - f(100 - h)) / (2 * h)
    crr_vega = (fv(0.2 + hv) - fv(0.2 - hv)) / (2 * hv)
    assert g["delta"] == pytest.approx(crr_delta, abs=0.025)
    assert g["vega"] == pytest.approx(crr_vega, rel=0.04)
    assert g["price"] == pytest.approx(f(100.0), rel=0.02)


def test_american_greeks_heston_delta():
    """Heston-American delta smoke: negative for a put, in (-1, 0);
    the flat-vol vega is ~0 (vol risk lives in the v-process)."""
    from mc_tpu.lsmc import american_greeks
    g = american_greeks(sim=SimParams(n_paths=100_000, n_steps=50),
                        model="heston")
    assert -1.0 < g["delta"] < -0.05
    assert abs(g["vega"]) < 1e-6
    assert g["price"] > 0.0


def test_american_greeks_call_delta_positive():
    from mc_tpu.lsmc import american_greeks
    g = american_greeks(sim=SimParams(n_paths=50_000, n_steps=20),
                        payoff="vanilla_call")
    assert 0.05 < g["delta"] < 1.0


def test_american_greeks_validation():
    from mc_tpu.lsmc import american_greeks
    with pytest.raises(ValueError, match="model"):
        american_greeks(model="bachelier")
    with pytest.raises(ValueError, match="exercise_every"):
        american_greeks(exercise_every=0)


def test_american_greeks_all_families():
    """The frozen-policy construction runs under every family with LSMC
    hooks; deltas are put-shaped and family vega is ~0 by construction."""
    from mc_tpu.lsmc import american_greeks
    sim = SimParams(n_paths=20_000, n_steps=10)
    for model in ("vasicek", "cev", "sabr", "localvol"):
        g = american_greeks(sim=sim, model=model)
        assert -1.0 < g["delta"] < -0.02, (model, g)
        assert g["price"] > 0.0, model
        assert abs(g["vega"]) < 1e-6, model


def test_american_bounds_family_brackets():
    """Generic AB dual: every scalar-discount family brackets its
    two-pass lower bound (upper >= lower within joint noise)."""
    from mc_tpu.lsmc import american_bounds_family
    sim = SimParams(n_paths=20_000, n_steps=10)
    for model in ("merton", "cev", "localvol", "sabr", "vasicek"):
        lo, up = american_bounds_family(model, sim=sim, n_outer=1024,
                                        n_inner=64)
        assert (float(up.price) + 3 * float(up.stderr)
                >= float(lo.price) - 3 * float(lo.stderr)), model
        assert float(up.price) - float(lo.price) < 1.0, model
        assert float(lo.stderr) > 0 and float(up.stderr) > 0, model


def test_american_bounds_family_validation():
    from mc_tpu.lsmc import american_bounds_family
    # basket/rainbow joined the dual families in round 3 — "term" is the
    # one registered family without rollout duals
    with pytest.raises(ValueError, match="supports"):
        american_bounds_family("term")
    with pytest.raises(ValueError, match="terminal payoffs"):
        american_bounds_family("heston", payoff="asian_call",
                               sim=SimParams(n_paths=1024, n_steps=4))


def test_american_bounds_vasicek_degenerate_crr():
    """sigma_r -> 0, b = r0: constant rates — the pathwise-discount dual
    must bracket the CRR binomial American."""
    from mc_tpu.lsmc import american_bounds_family
    from mc_tpu.models.vasicek import VasicekDynamics
    dyn0 = VasicekDynamics(a=0.3, b=0.1, sigma_r=1e-6, rho=0.0)
    lo, up = american_bounds_family(
        "vasicek", dyn=dyn0, sim=SimParams(n_paths=40_000, n_steps=10),
        n_outer=2048, n_inner=128)
    crr = binomial_american(100.0, 100.0, 1.0, 0.1, 0.2, kind="put")
    assert float(lo.price) - 3 * float(lo.stderr) <= crr
    assert crr <= float(up.price) + 3 * float(up.stderr)
