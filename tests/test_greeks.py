"""Greeks vs Black-Scholes closed forms."""

import numpy as np
import pytest
from jax.scipy.stats import norm

from mc_tpu import OptionParams, SimParams
from mc_tpu.greeks import greeks
from mc_tpu.oracle import bs_delta_call

S0, K, T, R, SIG = 100.0, 100.0, 1.0, 0.1, 0.2
SIM = SimParams(n_paths=200_000, n_steps=20)


def bs_closed_forms():
    import math
    sqrt_t = math.sqrt(T)
    d1 = (math.log(S0 / K) + (R + 0.5 * SIG**2) * T) / (SIG * sqrt_t)
    d2 = d1 - SIG * sqrt_t
    nd1 = float(norm.cdf(d1))
    nd2 = float(norm.cdf(d2))
    phi_d1 = math.exp(-0.5 * d1 * d1) / math.sqrt(2 * math.pi)
    return dict(
        delta=nd1,
        gamma=phi_d1 / (S0 * SIG * sqrt_t),
        vega=S0 * phi_d1 * sqrt_t,
        rho=K * T * math.exp(-R * T) * nd2,
        theta=-(S0 * phi_d1 * SIG / (2 * sqrt_t)) - R * K * math.exp(-R * T) * nd2,
    )


@pytest.fixture(scope="module")
def bs():
    return bs_closed_forms()


def test_pathwise_first_order(bs):
    g = greeks(sim=SIM, antithetic=True,
               which=("delta", "vega", "rho", "theta"))
    assert float(g["delta"]) == pytest.approx(bs["delta"], rel=0.01)
    assert float(g["vega"]) == pytest.approx(bs["vega"], rel=0.03)
    assert float(g["rho"]) == pytest.approx(bs["rho"], rel=0.02)
    assert float(g["theta"]) == pytest.approx(bs["theta"], rel=0.03)


def test_pathwise_gamma_via_crn(bs):
    g = greeks(sim=SIM, antithetic=True, which=("gamma",))
    assert float(g["gamma"]) == pytest.approx(bs["gamma"], rel=0.1)


def test_fd_matches_pathwise(bs):
    fd = greeks(sim=SIM, method="fd", which=("delta", "vega"))
    assert float(fd["delta"]) == pytest.approx(bs["delta"], rel=0.02)
    assert float(fd["vega"]) == pytest.approx(bs["vega"], rel=0.05)


def test_bullet_requires_fd():
    with pytest.raises(ValueError, match="discontinuous"):
        greeks(payoff="bullet_call", sim=SIM)
    g = greeks(OptionParams(p1=2.0, p2=12.0),
               SimParams(n_paths=100_000, n_steps=20),
               payoff="bullet_call", method="fd", which=("delta",))
    assert 0.0 < float(g["delta"]) < 1.5


def test_unknown_greek():
    with pytest.raises(ValueError, match="unknown greeks"):
        greeks(which=("charm",))


def test_delta_consistent_with_oracle_fn():
    g = greeks(sim=SIM, antithetic=True, which=("delta",))
    assert float(g["delta"]) == pytest.approx(
        float(bs_delta_call(S0, K, T, R, SIG)), rel=0.01)


def test_heston_greeks():
    """Sanity + CF-oracle cross-check for the Heston sensitivities."""
    from mc_tpu.greeks import heston_greeks
    from mc_tpu.models.heston import DEMO_HESTON, heston_call_cf

    sim = SimParams(n_paths=100_000, n_steps=50)
    g = heston_greeks(sim=sim, antithetic=True,
                      which=("delta", "vega_v0", "vega_xi", "rho"))
    assert 0.5 < float(g["delta"]) < 1.0
    assert float(g["vega_v0"]) > 0.0       # more variance -> pricier call

    # FD of the CF oracle as ground truth for vega_v0
    h = 1e-4
    base = dict(s0=100.0, k=100.0, t=1.0, r=0.1)
    hp = DEMO_HESTON.astuple()
    up = heston_call_cf(**base, v0=float(hp[0]) + h, kappa=hp[1],
                        theta=hp[2], xi=hp[3], rho=hp[4])
    dn = heston_call_cf(**base, v0=float(hp[0]) - h, kappa=hp[1],
                        theta=hp[2], xi=hp[3], rho=hp[4])
    want = (up - dn) / (2 * h)
    assert float(g["vega_v0"]) == pytest.approx(want, rel=0.1)


def test_heston_greeks_guard():
    from mc_tpu.greeks import heston_greeks
    with pytest.raises(ValueError, match="unknown heston greeks"):
        heston_greeks(which=("vega",))


# --- likelihood-ratio method (discontinuous payoffs) ---------------------

def test_lrm_vanilla_vs_closed_forms():
    """Terminal-method LRM on the vanilla call vs BS closed forms —
    unbiasedness of every score."""
    cf = bs_closed_forms()
    sim = SimParams(n_paths=1 << 20, n_steps=1)
    g = greeks(sim=sim, method="lrm",
               which=("delta", "vega", "rho", "epsilon"))
    for k in ("delta", "vega", "rho"):
        se = float(g[f"{k}_stderr"])
        assert abs(float(g[k]) - cf[k]) <= 4.0 * se, (
            k, float(g[k]), cf[k], se)
    # epsilon (dP/dq) closed form: -S0 T e^{-qT} N(d1) = -S0 T delta at q=0
    want_eps = -S0 * T * cf["delta"]
    assert abs(float(g["epsilon"]) - want_eps) <= \
        4.0 * float(g["epsilon_stderr"])


def test_lrm_bullet_vs_crn_fd():
    """The flagship discontinuous payoff (trajectories.cuh:149-153):
    LRM must agree with a big-bump CRN central difference within joint
    noise (the FD bump must be LARGE for a discontinuous payoff — its
    variance scales like 1/h — which is exactly why LRM exists)."""
    opt = OptionParams(p1=2.0, p2=10.0)
    sim = SimParams(n_paths=1 << 19, n_steps=20)
    gl = greeks(opt, sim, "bullet_call", method="lrm",
                which=("delta", "vega", "rho"))
    gf = greeks(opt, sim, "bullet_call", method="fd",
                which=("delta", "vega", "rho"), rel_bump=5e-2)
    for k in ("delta", "vega", "rho"):
        se = float(gl[f"{k}_stderr"])
        tol = 5.0 * se + 0.05 * abs(float(gl[k]))  # FD noise + O(h^2) bias
        assert abs(float(gl[k]) - float(gf[k])) <= tol, (
            k, float(gl[k]), float(gf[k]), tol)


def test_lrm_gamma_vanilla_vs_closed_form():
    """Second-order score at the terminal method vs BS gamma."""
    from mc_tpu.oracle import bs_gamma
    sim = SimParams(n_paths=1 << 21, n_steps=1)
    g = greeks(sim=sim, method="lrm", which=("gamma",))
    cf = float(bs_gamma(S0, K, T, R, SIG))
    se = float(g["gamma_stderr"])
    assert abs(float(g["gamma"]) - cf) <= 4.0 * se, (
        float(g["gamma"]), cf, se)


def test_lrm_gamma_digital_vs_closed_form():
    """Unbiased gamma on a DISCONTINUOUS payoff — the estimator pathwise
    and plain FD cannot deliver.  Digital-call gamma closed form:
    e^{-rT} d/ds0[phi(d2)/(s0 sigma sqrt(T))]."""
    import math
    sim = SimParams(n_paths=1 << 21, n_steps=1)
    g = greeks(sim=sim, payoff="digital_call", method="lrm",
               which=("gamma",))
    st = SIG * math.sqrt(T)
    d2 = (math.log(S0 / K) + (R - 0.5 * SIG ** 2) * T) / st
    phi = math.exp(-0.5 * d2 * d2) / math.sqrt(2.0 * math.pi)
    # d2P/ds0^2 = -e^{-rT} phi(d2) (d2 + st) / (s0^2 st^2) ... via
    # P = e^{-rT} N(d2), dP/ds0 = e^{-rT} phi(d2)/(s0 st),
    # d2P/ds0^2 = e^{-rT} [-phi d2 / (s0 st) * 1/(s0 st) - phi/(s0^2 st)]
    cf = math.exp(-R * T) * phi * (-d2 / st - 1.0) / (S0 * S0 * st)
    se = float(g["gamma_stderr"])
    assert abs(float(g["gamma"]) - cf) <= 4.0 * se, (
        float(g["gamma"]), cf, se)


def test_lrm_gamma_bullet_euler_sane():
    """Path-method LRM gamma on the bullet payoff: finite, and consistent
    with a big-bump CRN second difference within joint noise."""
    opt = OptionParams(p1=2.0, p2=10.0)
    sim = SimParams(n_paths=1 << 19, n_steps=20)
    gl = greeks(opt, sim, "bullet_call", method="lrm", which=("gamma",))
    gf = greeks(opt, sim, "bullet_call", method="fd", which=("gamma",),
                rel_bump=8e-2)
    se = float(gl["gamma_stderr"])
    tol = 5.0 * se + 0.15 * abs(float(gl["gamma"])) + 1e-4
    assert abs(float(gl["gamma"]) - float(gf["gamma"])) <= tol, (
        float(gl["gamma"]), float(gf["gamma"]), tol)


def test_lrm_price_bitwise_with_engine():
    """The LRM pass consumes the identical threefry stream as the XLA
    engine: its implied price must be bit-identical to price()."""
    from mc_tpu import price
    opt = OptionParams(p1=2.0, p2=10.0)
    sim = SimParams(n_paths=1 << 16, n_steps=20)
    g = greeks(opt, sim, "bullet_call", method="lrm", which=("delta",),
               tile_rows=256)
    r = price(opt, sim, "bullet_call", method="euler",
              tile_rows=256)
    assert float(g["price"]) == float(r.price)
    assert float(g["price_stderr"]) == float(r.stderr)


def test_lrm_guards():
    with pytest.raises(ValueError, match="LRM supports"):
        greeks(method="lrm", which=("theta",))
    with pytest.raises(ValueError, match="antithetic"):
        greeks(method="lrm", which=("delta",), antithetic=True)
    # pathwise rejection now points at lrm
    with pytest.raises(ValueError, match="lrm"):
        greeks(payoff="bullet_call", method="pathwise")


def test_lrm_odd_step_count():
    """Odd n_steps exercises the epilogue half-draw bookkeeping."""
    opt = OptionParams(p1=1.0, p2=4.0)
    g = greeks(opt, SimParams(n_paths=1 << 16, n_steps=5), "bullet_call",
               method="lrm", which=("delta",))
    assert np.isfinite(float(g["delta"]))


# --- pathwise greeks through the kernel's custom VJP ----------------------

def test_pathwise_kernel_fallthrough():
    """Pathwise greeks with the kernel as the forward pass differentiate
    through the custom VJP (the XLA engine is the backward program), so
    they match engine='xla' bitwise."""
    sim = SimParams(n_paths=20_000, n_steps=8)
    for kw in ({"which": ("theta",)},
               {"which": ("delta",), "antithetic": True}):
        gp = greeks(sim=sim, method="pathwise", engine="pallas",
                    interpret=True, tile_rows=8, **kw)
        gx = greeks(sim=sim, method="pathwise", engine="xla", tile_rows=8,
                    **kw)
        (k,) = kw["which"]
        assert float(gp[k]) == float(gx[k]), kw
