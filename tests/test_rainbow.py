"""Rainbow options: bivariate-normal oracle + Margrabe/Stulz gates.

The closed forms (oracle.bvn_cdf via Genz's BVND quadrature, Margrabe
1978, Stulz 1982) gate the correlated terminal-draw kernels of
models/rainbow.py; pathwise multiset identities pin the payoffs to each
other on the SAME draws (exact, not statistical).
"""

import math

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.models.rainbow import BasketDynamics, price_rainbow
from mc_tpu.oracle import (bs_call, bvn_cdf, margrabe, stulz_max_call,
                           stulz_max_put, stulz_min_call, stulz_min_put)

SIM = SimParams(n_paths=200_000, n_steps=1)
RHO = 0.5
S1, S2, SIG1, SIG2 = 100.0, 105.0, 0.2, 0.25


def two_asset(rho=RHO):
    return BasketDynamics(
        s0s=np.array([S1, S2], np.float32),
        sigmas=np.array([SIG1, SIG2], np.float32),
        weights=np.array([0.5, 0.5], np.float32),
        corr=np.array([[1.0, rho], [rho, 1.0]], np.float32))


# ---------------------------------------------------------------------------
# Bivariate normal CDF oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rho", [-0.99, -0.95, -0.6, 0.0, 0.3, 0.74,
                                 0.9, 0.93, 0.99])
def test_bvn_center_identity(rho):
    """M(0,0,rho) = 1/4 + asin(rho)/(2 pi), exact."""
    want = 0.25 + math.asin(rho) / (2.0 * math.pi)
    assert bvn_cdf(0.0, 0.0, rho) == pytest.approx(want, abs=5e-15)


def test_bvn_limits_and_marginals():
    phi = lambda z: 0.5 * math.erfc(-z / math.sqrt(2.0))
    for x, y in ((0.3, -1.1), (-0.5, 0.9), (1.7, 2.1)):
        # independence factorizes
        assert bvn_cdf(x, y, 0.0) == pytest.approx(phi(x) * phi(y),
                                                   abs=1e-14)
        # comonotone / antimonotone limits
        assert bvn_cdf(x, y, 1.0) == pytest.approx(phi(min(x, y)),
                                                   abs=1e-12)
        assert bvn_cdf(x, y, -1.0) == pytest.approx(
            max(phi(x) + phi(y) - 1.0, 0.0), abs=1e-12)
        # symmetry and marginal consistency (y -> +inf)
        assert bvn_cdf(x, y, 0.77) == pytest.approx(bvn_cdf(y, x, 0.77),
                                                    abs=1e-14)
        assert bvn_cdf(x, 37.0, 0.77) == pytest.approx(phi(x), abs=1e-14)


def test_bvn_vs_scipy():
    scipy_stats = pytest.importorskip("scipy.stats")
    rng = np.random.default_rng(7)
    for rho in (-0.99, -0.8, 0.5, 0.95, 0.99):  # both Genz branches
        for _ in range(5):
            x, y = rng.normal(size=2) * 1.5
            want = scipy_stats.multivariate_normal.cdf(
                [x, y], cov=[[1.0, rho], [rho, 1.0]])
            assert bvn_cdf(x, y, rho) == pytest.approx(want, abs=5e-10)


# ---------------------------------------------------------------------------
# Closed-form gates on the MC kernels
# ---------------------------------------------------------------------------


def _gate(res, want, n_se=3.5):
    assert abs(float(res.price) - want) <= n_se * float(res.stderr), (
        float(res.price), want, float(res.stderr))


def test_exchange_margrabe_gate():
    res = price_rainbow(OptionParams(), two_asset(), SIM, "exchange", antithetic=True, tile_rows=8)
    _gate(res, margrabe(S1, S2, 1.0, SIG1, SIG2, RHO))


@pytest.mark.parametrize("payoff,oracle", [
    ("call_on_min", stulz_min_call), ("call_on_max", stulz_max_call),
    ("put_on_min", stulz_min_put), ("put_on_max", stulz_max_put)])
def test_stulz_gates(payoff, oracle):
    opt = OptionParams(k=98.0)
    res = price_rainbow(opt, two_asset(), SIM, payoff,
                        antithetic=True, tile_rows=8)
    _gate(res, oracle(S1, S2, 98.0, 1.0, 0.1, SIG1, SIG2, RHO))


def test_negative_correlation_gate():
    """rho < 0 splits min and max hard; also exercises chol off-diag < 0."""
    opt = OptionParams(k=100.0)
    res = price_rainbow(opt, two_asset(rho=-0.6), SIM, "call_on_max", antithetic=True, tile_rows=8)
    _gate(res, stulz_max_call(S1, S2, 100.0, 1.0, 0.1, SIG1, SIG2, -0.6))


def test_min_max_multiset_identity():
    """max(M-K,0)+max(m-K,0) == max(S1-K,0)+max(S2-K,0) pathwise, so the
    MC estimates on the SAME key agree to rounding — and the closed
    forms satisfy the same identity exactly."""
    opt = OptionParams(k=98.0)
    kw = dict(sim=SIM, tile_rows=8)
    tot_mc = (float(price_rainbow(opt, two_asset(), payoff="call_on_max",
                                  **kw).price)
              + float(price_rainbow(opt, two_asset(), payoff="call_on_min",
                                    **kw).price))
    c1 = float(bs_call(S1, 98.0, 1.0, 0.1, SIG1))
    c2 = float(bs_call(S2, 98.0, 1.0, 0.1, SIG2))
    cf = (stulz_max_call(S1, S2, 98.0, 1.0, 0.1, SIG1, SIG2, RHO)
          + stulz_min_call(S1, S2, 98.0, 1.0, 0.1, SIG1, SIG2, RHO))
    assert cf == pytest.approx(c1 + c2, abs=1e-12)
    # MC sum is a plain 2-vanilla MC on the same draws: gate vs closed form
    se = 2.0 * float(price_rainbow(opt, two_asset(), payoff="call_on_max",
                                   **kw).stderr)
    assert abs(tot_mc - (c1 + c2)) <= 3.5 * se


def test_best_of_cash_identity():
    """max(M, K) = max(M-K, 0) + K pathwise: same-key MC estimates differ
    by exactly the discounted cash leg (up to f32 rounding)."""
    opt = OptionParams(k=110.0)
    kw = dict(sim=SimParams(n_paths=50_000, n_steps=1),
              tile_rows=8)
    boc = float(price_rainbow(opt, two_asset(), payoff="best_of_cash",
                              **kw).price)
    com = float(price_rainbow(opt, two_asset(), payoff="call_on_max",
                              **kw).price)
    cash = 110.0 * math.exp(-0.1)
    assert boc == pytest.approx(com + cash, rel=2e-5)


def test_single_asset_reduces_to_bs():
    one = BasketDynamics(s0s=np.array([100.0], np.float32),
                         sigmas=np.array([0.2], np.float32),
                         weights=np.array([1.0], np.float32),
                         corr=np.eye(1, dtype=np.float32))
    res = price_rainbow(OptionParams(), one, SIM, "call_on_max", antithetic=True, tile_rows=8)
    _gate(res, float(bs_call(100.0, 100.0, 1.0, 0.1, 0.2)))


def test_more_assets_raise_max_call():
    """c_max is increasing in the asset count (adding an iid asset only
    improves the best draw)."""
    def iid(d):
        return BasketDynamics(s0s=np.full(d, 100.0, np.float32),
                              sigmas=np.full(d, 0.2, np.float32),
                              weights=np.full(d, 1.0 / d, np.float32),
                              corr=np.eye(d, dtype=np.float32))
    kw = dict(sim=SIM, antithetic=True, tile_rows=8)
    p2 = float(price_rainbow(OptionParams(), iid(2),
                             payoff="call_on_max", **kw).price)
    p4 = float(price_rainbow(OptionParams(), iid(4),
                             payoff="call_on_max", **kw).price)
    assert p4 > p2 + 1.0


def test_validation():
    with pytest.raises(KeyError, match="unknown rainbow payoff"):
        price_rainbow(payoff="nope")
    one = BasketDynamics(s0s=np.array([100.0], np.float32),
                         sigmas=np.array([0.2], np.float32),
                         weights=np.array([1.0], np.float32),
                         corr=np.eye(1, dtype=np.float32))
    with pytest.raises(ValueError, match="needs >= 2 assets"):
        price_rainbow(basket=one, payoff="exchange")


def test_antithetic_reduces_stderr():
    kw = dict(sim=SIM, tile_rows=8)
    plain = price_rainbow(OptionParams(), two_asset(),
                          payoff="call_on_max", **kw)
    anti = price_rainbow(OptionParams(), two_asset(),
                         payoff="call_on_max", antithetic=True, **kw)
    assert float(anti.stderr) < float(plain.stderr)
