"""XVA metric layer: DVA/BCVA/FVA and collateralized exposure (CSA with
threshold, MTA, margin period of risk) on the NMC value surfaces."""

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.nmc import price_nmc
from mc_tpu.nmc_book import price_nmc_book

SIM = SimParams(n_paths=2048, n_steps=8, n_paths_inner=32)


@pytest.fixture(scope="module")
def res():
    # vanilla_call explicitly: price_nmc's default bullet payoff is
    # identically zero at 8 steps (window > n_steps), which would make
    # every metric gate below pass vacuously
    return price_nmc(OptionParams(), SIM, "vanilla_call")


def test_long_call_has_no_negative_exposure(res):
    ene, npfe = res.ene_profile()
    assert float(np.max(np.asarray(ene))) == 0.0
    assert float(res.dva(0.02)) == 0.0
    # bilateral collapses to unilateral when ENE = 0
    assert float(res.bilateral_cva(0.02, 0.03)) == pytest.approx(
        float(res.cva(0.02)))


def test_fva_hand_integral(res):
    ee, _ = res.exposure_profile()
    fca, fba = res.fva(0.01)
    dt = 1.0 / SIM.n_steps
    assert float(fca) == pytest.approx(
        0.01 * float(np.sum(np.asarray(ee))) * dt, rel=1e-6)
    assert float(fba) == 0.0


def test_full_collateralization_kills_exposure(res):
    c = res.collateralized(threshold=0.0, mta=0.0, mpor_steps=0)
    ee, pfe = c.exposure_profile()
    assert float(np.max(np.asarray(ee))) == 0.0
    assert float(c.cva(0.02)) == 0.0


def test_infinite_threshold_is_uncollateralized(res):
    c = res.collateralized(threshold=1e9)
    assert float(c.cva(0.02)) == pytest.approx(float(res.cva(0.02)),
                                               rel=1e-6)


def test_mpor_between_extremes_and_threshold_monotone(res):
    cva_un = float(res.cva(0.02))
    cva_mpor = float(res.collateralized(0.0, mpor_steps=2).cva(0.02))
    assert 0.0 <= cva_mpor <= cva_un
    # residual risk grows with the threshold
    prev = cva_mpor
    for h in (1.0, 5.0, 20.0):
        cur = float(res.collateralized(h, mpor_steps=2).cva(0.02))
        assert cur >= prev - 1e-7
        prev = cur
    # first mpor dates are uncollateralized: exposure there matches the
    # raw surface exactly
    c = res.collateralized(0.0, mpor_steps=2)
    raw = np.maximum(np.asarray(res.surface_matrix()), 0.0)
    col = np.maximum(np.asarray(c.surface_matrix()), 0.0)
    np.testing.assert_array_equal(col[:, :2], raw[:, :2])


def test_mta_stub_survives(res):
    """With an MTA, calls below it are not made — residual exposure is
    bounded by the MTA (plus nothing else at H=0, m=0)."""
    mta = 3.0
    c = res.collateralized(0.0, mta=mta, mpor_steps=0)
    assert float(np.max(np.asarray(c.surface_matrix()))) <= mta + 1e-5
    assert float(c.cva(0.02)) <= float(res.cva(0.02))


def test_short_book_dva_mirrors_long_cva():
    """A short position's DVA is the long position's CVA on the same
    (CRN) scenarios — the surfaces are exact negations."""
    opt = OptionParams(k=np.array([100.0], np.float32))
    long_b = price_nmc_book(opt, SIM, weights=[1.0])
    short_b = price_nmc_book(opt, SIM, weights=[-1.0])
    assert float(short_b.cva(0.02)) == 0.0
    assert float(short_b.dva(0.02)) == pytest.approx(
        float(long_b.cva(0.02)), rel=1e-6)
    # net FVA flips sides
    fca_l, fba_l = long_b.fva(0.01)
    fca_s, fba_s = short_b.fva(0.01)
    assert float(fca_s) == pytest.approx(float(fba_l), rel=1e-6)
    assert float(fba_s) == pytest.approx(float(fca_l), rel=1e-6)


def test_two_way_csa_own_threshold():
    """Short book + two-way CSA: WE post collateral, so the
    counterparty's exposure (our DVA side) collapses."""
    opt = OptionParams(k=np.array([100.0], np.float32))
    short_b = price_nmc_book(opt, SIM, weights=[-1.0])
    c = short_b.collateralized(threshold=0.0, own_threshold=0.0,
                               mta=0.0, mpor_steps=0)
    assert float(c.dva(0.02)) == 0.0


def test_validation(res):
    with pytest.raises(ValueError, match="mpor_steps"):
        res.collateralized(mpor_steps=-1)
    with pytest.raises(ValueError, match="mta"):
        res.collateralized(mta=-1.0)


def test_cva_greeks_match_crn_fd():
    """Forward-mode AD through the ENTIRE nested pipeline (outer paths,
    inner conditional re-pricing, positive part, default-leg integral)
    vs central differences with the same derived keys (CRN)."""
    import dataclasses

    from mc_tpu.greeks import cva_greeks
    g = cva_greeks(OptionParams(), SIM, "vanilla_call",
                   hazard_rate=0.02)

    def cva_at(**kw):
        o = dataclasses.replace(OptionParams().as_f32(), **kw)
        return float(price_nmc(o, SIM, "vanilla_call").cva(0.02, t_horizon=1.0))

    h = 0.05
    fd_delta = (cva_at(s0=100 + h) - cva_at(s0=100 - h)) / (2 * h)
    hs = 1e-3
    fd_vega = (cva_at(sigma=0.2 + hs) - cva_at(sigma=0.2 - hs)) / (2 * hs)
    assert float(g["delta"]) == pytest.approx(fd_delta, rel=1e-3)
    assert float(g["vega"]) == pytest.approx(fd_vega, rel=2e-3)
    assert float(g["delta"]) > 0.0 and float(g["vega"]) > 0.0

    with pytest.raises(ValueError, match="unknown greeks"):
        cva_greeks(which=("charm",), hazard_rate=0.02)


def test_cva_wwr_spot_sign_flips_with_position():
    """Spot-linked WWR (intensity rides the UNDERLYING level): beta > 0
    raises a long call's CVA but LOWERS a long put's — the right-way
    case the exposure-linked model cannot express (it loads default
    weight onto high-exposure states regardless of position)."""
    sim = SimParams(n_paths=2048, n_steps=8, n_paths_inner=16)
    call = price_nmc(OptionParams(), sim, "vanilla_call")
    put = price_nmc(OptionParams(), sim, "vanilla_put")
    for res in (call, put):
        flat = float(res.cva(0.02))
        # f32: per-path accumulation vs the EE-profile closed form
        # differ by association only
        assert float(res.cva_wwr_spot(0.02, 0.0)) == pytest.approx(
            flat, rel=1e-4)
    assert float(call.cva_wwr_spot(0.02, 2.0)) > float(call.cva(0.02))
    assert float(put.cva_wwr_spot(0.02, 2.0)) < float(put.cva(0.02))
    # the exposure link marks BOTH positions up — spot link disagrees
    # on the put, which is the point
    assert float(put.cva_wwr(0.02, 2.0)) > float(put.cva(0.02))


def test_cva_wwr_spot_needs_the_grid_strategy():
    """The spot link reads the outer spot grid: `price_nmc` always
    carries it, and a result without it refuses."""
    import dataclasses
    res = price_nmc(OptionParams(), SIM, "vanilla_call")
    assert res.spot_matrix().shape == res.surface_matrix().shape
    with pytest.raises(ValueError, match="spot grid"):
        dataclasses.replace(res, spot_surface=None).cva_wwr_spot(0.02, 1.0)


def test_cva_wwr_spot_family_surface():
    """The family engine's grid strategy rides its spot grid onto the
    result too (grid 0 is the market spot for every family)."""
    from mc_tpu.nmc_heston import price_nmc_heston
    sim = SimParams(n_paths=1024, n_steps=8, n_paths_inner=8)
    res = price_nmc_heston(sim=sim, payoff="vanilla_call")
    assert float(res.cva_wwr_spot(0.02, 2.0)) > float(res.cva(0.02))


def test_family_cva_greeks_heston_crn_fd():
    """model="heston": forward-mode AD flows through the FAMILY engine's
    nested pipeline too — delta (option.s0) and v0 (a dynamics leaf) are
    gated against CRN central differences of the same pipeline."""
    import dataclasses

    from mc_tpu.greeks import cva_greeks
    from mc_tpu.models.heston import DEMO_HESTON
    from mc_tpu.nmc_heston import price_nmc_heston

    sim = SimParams(n_paths=512, n_steps=8, n_paths_inner=16)
    g = cva_greeks(OptionParams(), sim, "vanilla_call",
                   hazard_rate=0.02, model="heston",
                   which=("delta", "v0"))

    def cva_at(opt_kw=None, dyn_kw=None):
        o = dataclasses.replace(OptionParams().as_f32(), **(opt_kw or {}))
        d = dataclasses.replace(DEMO_HESTON.as_f32(), **(dyn_kw or {}))
        return float(price_nmc_heston(o, d, sim, "vanilla_call").cva(0.02,
                                                        t_horizon=1.0))

    h = 0.05
    fd_delta = (cva_at({"s0": 100 + h}) - cva_at({"s0": 100 - h})) / (2 * h)
    # v0's CVA response is curved (truncation-kink crossings shift with
    # the bump): FD sweeps 0.489->0.501 over h 2e-3->2.5e-4 around the
    # AD value — h=5e-4 sits within 1%
    hv = 5e-4
    fd_v0 = (cva_at(dyn_kw={"v0": 0.04 + hv})
             - cva_at(dyn_kw={"v0": 0.04 - hv})) / (2 * hv)
    assert float(g["delta"]) == pytest.approx(fd_delta, rel=2e-3)
    assert float(g["v0"]) == pytest.approx(fd_v0, rel=1e-2)
    assert float(g["delta"]) > 0.0 and float(g["v0"]) > 0.0


def test_family_cva_greeks_merton_jump_risk():
    """d(CVA)/d(lam) under Merton: more jumps -> fatter exposure tail ->
    a LARGER credit reserve (the sign the desk expects)."""
    from mc_tpu.greeks import cva_greeks
    sim = SimParams(n_paths=512, n_steps=8, n_paths_inner=16)
    g = cva_greeks(OptionParams(), sim, "vanilla_call",
                   hazard_rate=0.02, model="merton",
                   which=("delta", "lam"))
    assert float(g["lam"]) > 0.0
    assert float(g["delta"]) > 0.0


def test_family_cva_greeks_dyn_prefix_and_validation():
    from mc_tpu.greeks import cva_greeks
    sim = SimParams(n_paths=256, n_steps=8, n_paths_inner=8)
    # "rho" stays the rate greek; "dyn.rho" reaches the Heston leaf
    g = cva_greeks(OptionParams(), sim, "vanilla_call",
                   hazard_rate=0.02, model="heston",
                   which=("rho", "dyn.rho"))
    assert float(g["rho"]) != float(g["dyn.rho"])
    with pytest.raises(ValueError, match="dynamics field"):
        cva_greeks(OptionParams(), sim, hazard_rate=0.02,
                   model="heston", which=("vega",))
    with pytest.raises(ValueError, match="unknown greek"):
        cva_greeks(OptionParams(), sim, hazard_rate=0.02,
                   model="heston", which=("zzz",))


def test_mpor_beyond_horizon_is_uncollateralized(res):
    """mpor >= n_steps: no margin call settles inside the horizon, so
    the profile equals the raw exposure (previously a shape error)."""
    c = res.collateralized(0.0, mpor_steps=100)
    assert float(c.cva(0.02)) == pytest.approx(float(res.cva(0.02)),
                                               rel=1e-6)


def test_im_profile_and_mva(res):
    """IM is a nonneg quantile of the MPoR value move; MVA is its
    funding integral (hand-checked)."""
    im = np.asarray(res.im_profile(0.99, mpor_steps=2))
    assert im.shape == (SIM.n_steps,)
    assert np.all(im >= 0.0)
    assert im[-1] == im[-2] == im[-3]  # last-2 padded with final value
    mva = float(res.mva(0.01, 0.99, mpor_steps=2))
    assert mva == pytest.approx(0.01 * float(np.sum(im)) / SIM.n_steps,
                                rel=1e-6)
    with pytest.raises(ValueError, match="mpor_steps"):
        res.im_profile(mpor_steps=0)


def test_im_zero_for_constant_surface():
    """A surface with no MPoR moves needs no initial margin."""
    from mc_tpu.xva import CollateralizedExposure
    import jax.numpy as jnp
    flat = CollateralizedExposure(values=jnp.ones((64, 8)), t_horizon=1.0)
    assert float(np.max(np.asarray(flat.im_profile(0.99, 2)))) == 0.0
    assert float(flat.mva(0.01)) == 0.0


def test_cva_wwr_brackets_flat_hazard(res):
    """Wrong-way risk: beta=0 reproduces the flat-hazard CVA; positive
    exposure-intensity correlation raises it, negative lowers it."""
    flat = float(res.cva(0.02))
    w0 = float(res.cva_wwr(0.02, beta=0.0))
    up = float(res.cva_wwr(0.02, beta=0.05))
    dn = float(res.cva_wwr(0.02, beta=-0.05))
    assert w0 == pytest.approx(flat, rel=1e-5)
    assert up > w0 > dn


class TestObservationDates:
    """Round-4 fix (ADVICE r03, medium): the rates exposure matrices
    observe at COUPON dates expiry + i*tenor, non-uniform from 0 when
    expiry != tenor — every time integral must use the true intervals,
    not the uniform grid j*T/n."""

    @pytest.fixture(scope="class")
    def swap_exp(self):
        from mc_tpu.models.swaption import DEMO_SWAPTION, swap_exposure
        # DEMO: expiry 1.0, tenor 0.5 -> dates 1.0, 1.5, ... (the
        # uniform grid would put t_1 at horizon/n != 1.0)
        return swap_exposure(DEMO_SWAPTION,
                             sim=SimParams(n_paths=4096, n_steps=1))

    def test_carries_coupon_dates(self, swap_exp):
        from mc_tpu.models.swaption import DEMO_SWAPTION as S
        t = np.asarray(swap_exp.observation_dates())
        want = S.expiry + np.arange(S.n_payments) * S.tenor
        np.testing.assert_allclose(t, want, rtol=1e-6)

    def test_cva_integrates_over_true_intervals(self, swap_exp):
        lam, rec = 0.02, 0.4
        ee = np.asarray(swap_exp.exposure_profile()[0])
        t = np.asarray(swap_exp.observation_dates())
        tp = np.concatenate([[0.0], t[:-1]])
        dpd = np.exp(-lam * tp) - np.exp(-lam * t)
        want = (1 - rec) * float(np.sum(ee * dpd))
        assert float(swap_exp.cva(lam, rec)) == pytest.approx(
            want, rel=1e-5)
        # ... and the uniform-grid weights are measurably different
        n = len(t)
        tu = np.arange(1, n + 1) * float(swap_exp.t_horizon) / n
        tup = np.concatenate([[0.0], tu[:-1]])
        wrong = (1 - rec) * float(np.sum(
            ee * (np.exp(-lam * tup) - np.exp(-lam * tu))))
        assert abs(want - wrong) > 1e-4 * abs(want)

    def test_fva_mva_weight_by_true_intervals(self, swap_exp):
        sp = 0.01
        ee = np.asarray(swap_exp.exposure_profile()[0])
        t = np.asarray(swap_exp.observation_dates())
        dt = np.diff(np.concatenate([[0.0], t]))
        fca, _ = swap_exp.fva(sp)
        assert float(fca) == pytest.approx(sp * float(np.sum(ee * dt)),
                                           rel=1e-5)
        im = np.asarray(swap_exp.im_profile(0.99, 1))
        assert float(swap_exp.mva(sp, 0.99, 1)) == pytest.approx(
            sp * float(np.sum(im * dt)), rel=1e-5)

    def test_wwr_beta0_matches_flat_on_coupon_dates(self, swap_exp):
        flat = float(swap_exp.cva(0.02))
        assert float(swap_exp.cva_wwr(0.02, beta=0.0)) == pytest.approx(
            flat, rel=1e-5)

    def test_collateralized_keeps_dates(self, swap_exp):
        c = swap_exp.collateralized(threshold=0.01, mpor_steps=1)
        np.testing.assert_allclose(np.asarray(c.observation_dates()),
                                   np.asarray(swap_exp.observation_dates()))
