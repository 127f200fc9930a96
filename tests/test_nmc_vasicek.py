"""Nested MC under stochastic (Vasicek) rates: martingale exposure gates.

The sharpest check of pathwise two-leg discounting: a `zcb` payoff's
time-0-discounted conditional value is E[D(0,T)|F_t] — a martingale — so
the expected exposure profile must be FLAT at the closed-form P(0,T) at
EVERY step, and the surface mean must equal it.
"""

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams
from mc_tpu.models.vasicek import DEMO_VASICEK, VasicekDynamics
from mc_tpu.nmc_vasicek import price_nmc_vasicek
from mc_tpu.oracle import bsv_call, vasicek_zcb

SIM = SimParams(n_paths=4096, n_steps=8, n_paths_inner=16)
OPT = OptionParams()


def test_zcb_exposure_flat_at_closed_form():
    res = price_nmc_vasicek(OPT, DEMO_VASICEK, SIM, payoff="zcb")
    want = vasicek_zcb(0.1, 0.3, 0.05, 0.015, 1.0)
    ee, _ = res.exposure_profile()
    ee = np.asarray(ee)
    # martingale: every step's EE is P(0,T); inner/outer MC noise only
    assert np.max(np.abs(ee - want)) < 5e-4, (ee, want)
    assert float(res.surface_mean) == pytest.approx(want, abs=5e-4)


def test_tower_property_vanilla():
    """Surface mean == outer price == Merton-73 closed form (tower)."""
    sim = SimParams(n_paths=16_384, n_steps=8, n_paths_inner=32)
    res = price_nmc_vasicek(OPT, DEMO_VASICEK, sim)
    want = bsv_call(100.0, 100.0, 1.0, 0.1, 0.2, 0.3, 0.05, 0.015, -0.3)
    assert abs(float(res.outer.price) - want) <= 4 * float(res.outer.stderr)
    # surface mean carries inner noise too; gate loosely vs closed form
    assert float(res.surface_mean) == pytest.approx(want, rel=0.05)


def test_rate_vol_fattens_exposure_tail():
    """More rate volatility widens the discounted-value distribution:
    the zcb PFE-EE gap grows with sigma_r."""
    lo = price_nmc_vasicek(OPT, VasicekDynamics(sigma_r=0.002), SIM,
                           payoff="zcb")
    hi = price_nmc_vasicek(OPT, VasicekDynamics(sigma_r=0.05), SIM,
                           payoff="zcb")
    def gap(r):
        ee, pfe = r.exposure_profile()
        return float(np.max(np.asarray(pfe) - np.asarray(ee)))
    assert gap(hi) > 4 * gap(lo)


def test_cva_under_stochastic_discounting():
    res = price_nmc_vasicek(OPT, DEMO_VASICEK, SIM)
    cva = float(res.cva(hazard_rate=0.02, recovery=0.4))
    # order of magnitude: (1-R) * lambda * T * E[V+] with V+ ~ price
    assert 0.0 < cva < 0.6 * 0.02 * 1.0 * 25.0
    assert float(res.t_horizon) == 1.0


def test_path_dependent_state_resumes():
    """Bullet payoff: the barrier count resumes from the stored state —
    conditional values at the last step equal the realized payoff
    discounted (no steps remain)."""
    sim = SimParams(n_paths=2048, n_steps=8, n_paths_inner=4)
    res = price_nmc_vasicek(OptionParams(p1=1.0, p2=6.0), DEMO_VASICEK,
                            sim, payoff="bullet_call")
    assert float(res.outer.stderr) > 0
    sm = res.surface_matrix()
    assert np.all(np.isfinite(np.asarray(sm)))


def test_validation():
    with pytest.raises(ValueError, match="even n_steps"):
        price_nmc_vasicek(sim=SimParams(n_paths=256, n_steps=3,
                                        n_paths_inner=4))
    with pytest.raises(ValueError, match="counter"):
        price_nmc_vasicek(sim=SimParams(n_paths=256, n_steps=4096,
                                        n_paths_inner=256))
