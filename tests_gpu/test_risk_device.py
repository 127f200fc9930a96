"""Compiled-device gate for the risk/XVA stack: every risk entry point
exercised on the GPU and
cross-gated against its f64 oracle twin — book scenario VaR, the
Heston/generic-family revaluation ladders, the curve-scenario desks,
key-rate DV01 ladders, and CVA greeks.

The reference has no risk layer (hello.cu prices one contract); these
gates pin the desk tier's numerics on the production backend, where
the f32 transcendental implementations differ from XLA:CPU.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

from mc_tpu import OptionParams, SimParams
from mc_tpu.risk import (CurveScenarioSet, ScenarioSet, book_scenario_pnl,
                         heston_scenario_pnl, model_scenario_pnl)

BOOK = OptionParams(k=np.array([95.0, 105.0]))
W = np.array([1.0, -2.0])
SCEN = ScenarioSet.gbm(32, horizon_days=10, spot_vol=0.2,
                       vol_of_vol=0.05, rate_vol=0.004, seed=11)


def test_book_scenario_pnl_mc_vs_oracle_on_chip():
    """GBM book VaR: the batched portfolio revaluation under CRN tracks
    the exact f64 BS twin on the compiled backend."""
    sim = SimParams(n_paths=1 << 18, n_steps=1)
    mc = book_scenario_pnl(BOOK, sim, scenarios=SCEN, weights=W,
                           method="mc")
    ora = book_scenario_pnl(BOOK, scenarios=SCEN, weights=W,
                            method="oracle")
    scale = max(np.abs(ora.pnl).max(), 1e-9)
    assert np.abs(mc.pnl - ora.pnl).max() <= 0.02 * scale
    assert mc.var() == pytest.approx(ora.var(), rel=0.05)
    assert mc.es() >= mc.var() - 1e-12


def test_heston_scenario_ladder_on_chip():
    """The heston ladder kernel (risk.py _heston_ladder_impl: vmapped
    XLA dual on shared draws) vs the CF oracle on the chip."""
    sim = SimParams(n_paths=1 << 15, n_steps=32)
    mc = heston_scenario_pnl(BOOK, None, sim, scenarios=SCEN, weights=W,
                             method="mc")
    ora = heston_scenario_pnl(BOOK, None, sim, scenarios=SCEN,
                              weights=W, method="oracle")
    scale = max(np.abs(ora.pnl).max(), 1e-9)
    assert np.abs(mc.pnl - ora.pnl).max() <= 0.03 * scale


@pytest.mark.parametrize("model,rel", [("bates", 0.06), ("merton", 0.04)])
def test_model_scenario_ladder_on_chip(model, rel):
    """Generic family ladder (round 5) on the chip, oracle-gated."""
    sim = SimParams(n_paths=1 << 15, n_steps=16)
    mc = model_scenario_pnl(model, BOOK, sim=sim, scenarios=SCEN,
                            weights=W, method="mc")
    ora = model_scenario_pnl(model, BOOK, sim=sim, scenarios=SCEN,
                             weights=W, method="oracle")
    scale = max(np.abs(ora.pnl).max(), 1e-9)
    assert np.abs(mc.pnl - ora.pnl).max() <= rel * scale


def test_hw_and_g2_curve_pnl_on_chip():
    """Curve-scenario desks: one batched revaluation per spec under
    level/slope/curvature shocks vs the f64 curve-consistent closed
    forms, on the chip."""
    from mc_tpu.models.hullwhite import DEMO_CURVE, DEMO_HW
    from mc_tpu.models.swaption import SwaptionSpec
    from mc_tpu.risk import g2_swaption_curve_pnl, hw_swaption_curve_pnl
    sc = CurveScenarioSet.factor(32, DEMO_CURVE.times, seed=5)
    specs = [SwaptionSpec(k_rate=0.04),
             SwaptionSpec(k_rate=0.04, payer=False)]
    w2 = np.array([1.0, -1.0])
    sim = SimParams(n_paths=1 << 16, n_steps=1)
    for curve_pnl in (hw_swaption_curve_pnl, g2_swaption_curve_pnl):
        mc = curve_pnl(specs, None, None, sim, scenarios=sc, weights=w2,
                       method="mc")
        ora = curve_pnl(specs, None, None, sim, scenarios=sc,
                        weights=w2, method="oracle")
        scale = max(np.abs(ora.pnl).max(), 1e-9)
        assert np.abs(mc.pnl - ora.pnl).max() <= 0.02 * scale, curve_pnl


def test_bucket_dv01_ladders_on_chip():
    """Key-rate DV01 ladders on the chip: sum-to-parallel and
    localization hold on the compiled backend."""
    from mc_tpu.models.g2pp import g2_swaption_bucket_dv01
    from mc_tpu.models.hullwhite import (DEMO_CURVE, DEMO_HW,
                                         hw_swaption_bucket_dv01,
                                         hw_swaption_greeks)
    from mc_tpu.models.swaption import SwaptionSpec
    spec = SwaptionSpec(k_rate=0.04)
    sim = SimParams(n_paths=1 << 16, n_steps=1)
    b = hw_swaption_bucket_dv01(spec, DEMO_HW, DEMO_CURVE, sim)
    g = hw_swaption_greeks(spec, DEMO_HW, DEMO_CURVE, sim,
                           which=("curve_dv01",))
    assert b.sum() == pytest.approx(float(g["curve_dv01"]), rel=2e-2)
    # the 0.5y pillar carries EXACTLY zero: every coupon date is >= the
    # 1y knot and log-linear df interpolation never reads through it
    # (the CPU suite's localization rule, on the compiled backend)
    assert b[0] == 0.0
    b2 = g2_swaption_bucket_dv01(spec, sim=sim)
    assert b2.shape == b.shape
    assert np.isfinite(b2).all() and abs(b2.sum()) > 0.0


def test_cva_greeks_on_chip():
    """XVA sensitivities: forward-mode AD through the nested pipeline
    runs compiled; the vega sign and the hazard monotonicity hold."""
    from mc_tpu.greeks import cva_greeks
    res = cva_greeks(sim=SimParams(n_paths=512, n_steps=8,
                                   n_paths_inner=16),
                     hazard_rate=0.02, which=("vega",))
    assert float(res["vega"]) > 0.0  # more vol -> fatter EE -> more CVA


def test_xva_exposure_metrics_on_chip():
    """ExposureMetrics on a compiled NMC surface: CVA/FVA/MVA finite
    and ordered (collateral reduces CVA)."""
    from mc_tpu.nmc import price_nmc
    # barrier window scaled into the 8-step grid so the payoff is live
    res = price_nmc(OptionParams(p1=1.0, p2=6.0),
                    SimParams(n_paths=2048, n_steps=8, n_paths_inner=64),
                    engine="pallas")
    cva = float(res.cva(hazard_rate=0.02, recovery=0.4))
    assert cva > 0.0
    coll = res.collateralized(threshold=1.0, mta=0.1)
    assert float(coll.cva(hazard_rate=0.02, recovery=0.4)) <= cva
