"""Compiled-device gate for the curve-rates stack: swaption (Vasicek),
Hull-White, and G2++ entry points executed on the GPU.

The rates models are plain XLA (few exact date-grid draws, not
step-loop bound).  The device gate is:

* statistical agreement with the f64 HOST oracles (Jamshidian /
  conditional-Jamshidian), |z| < 4 — the compiled-f32 device program
  prices the right thing;
* the stack's exact WITHIN-DEVICE identities re-asserted on the chip:
  1-payment Bermudan == European bitwise (LSMC collapse), AB lower ==
  LSMC bitwise (shared stream + fit), 1-payment Bermudan QMC ==
  European QMC bitwise (frozen-policy collapse);
* the exposure matrices' strip anchor (every EE point is a swaption).

Reference analogue: the CPU<->GPU agreement harness
/root/reference/inc/testing.cuh:17-42 — one stream, independent
execution paths, agreement required; here host-f64 oracle vs device-f32
program (statistical) plus device-internal bitwise identities.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

from mc_tpu import SimParams, oracle
from mc_tpu.models.hullwhite import DEMO_CURVE, DEMO_HW
from mc_tpu.models.swaption import SwaptionSpec
from mc_tpu.models.vasicek import VasicekDynamics

SPEC = SwaptionSpec(expiry=1.0, tenor=0.5, n_payments=10, k_rate=0.04)
SPEC1 = SwaptionSpec(expiry=1.0, tenor=0.5, n_payments=1, k_rate=0.04)
VDYN = VasicekDynamics(a=0.3, b=0.05, sigma_r=0.015)
R0 = 0.05
SIM = SimParams(n_paths=1 << 18, n_steps=1)
SIM_B = SimParams(n_paths=1 << 13, n_steps=1)   # Bermudan/bounds tier


def _z(res, ref):
    return (float(res.price) - ref) / float(res.stderr)


# --- Vasicek swaption (models/swaption.py) --------------------------------

def test_vasicek_swaption_oracle():
    from mc_tpu.models.swaption import price_swaption
    r = price_swaption(SPEC, VDYN, SIM, r0=R0)
    ref = oracle.vasicek_swaption(R0, VDYN.a, VDYN.b, VDYN.sigma_r,
                                  SPEC.expiry, SPEC.tenor,
                                  SPEC.n_payments, SPEC.k_rate)
    assert abs(_z(r, ref)) < 4.0, (float(r.price), ref)


def test_vasicek_bermudan_identities():
    from mc_tpu.models.swaption import (bermudan_swaption_bounds,
                                        price_bermudan_swaption,
                                        price_swaption)
    eur = price_swaption(SPEC1, VDYN, SIM_B, r0=R0)
    ber1 = price_bermudan_swaption(SPEC1, VDYN, SIM_B, r0=R0)
    assert float(ber1.price) == float(eur.price)   # 1-pay collapse
    lo, up = bermudan_swaption_bounds(SPEC, VDYN, SIM_B, r0=R0,
                                      n_branch=8)
    ber = price_bermudan_swaption(SPEC, VDYN, SIM_B, r0=R0)
    assert float(lo.price) == float(ber.price)      # AB lower == LSMC
    assert float(up.price) >= float(lo.price)


def test_vasicek_swaption_qmc():
    from mc_tpu.models.swaption import (price_bermudan_swaption_qmc,
                                        price_swaption_qmc)
    q = price_swaption_qmc(SPEC, VDYN, SimParams(n_paths=1 << 13,
                                                 n_steps=1), r0=R0)
    ref = oracle.vasicek_swaption(R0, VDYN.a, VDYN.b, VDYN.sigma_r,
                                  SPEC.expiry, SPEC.tenor,
                                  SPEC.n_payments, SPEC.k_rate)
    assert abs(float(q.price) - ref) <= 5.0 * float(q.stderr) + 1e-6
    qb1 = price_bermudan_swaption_qmc(SPEC1, VDYN,
                                      SimParams(n_paths=1 << 12,
                                                n_steps=1),
                                      r0=R0, n_fit=2048)
    qe1 = price_swaption_qmc(SPEC1, VDYN, SimParams(n_paths=1 << 12,
                                                    n_steps=1), r0=R0)
    assert float(qb1.price) == float(qe1.price)     # frozen-policy collapse


# --- Hull-White on the curve (models/hullwhite.py) ------------------------

def _hw_ref(spec, payer=True):
    return oracle.hw_swaption(DEMO_HW.a, DEMO_HW.sigma_r, DEMO_CURVE.df,
                              spec.expiry, spec.tenor, spec.n_payments,
                              spec.k_rate, payer=payer)


def test_hw_european_oracle():
    from mc_tpu.models.hullwhite import price_hw_swaption
    r = price_hw_swaption(SPEC, DEMO_HW, DEMO_CURVE, SIM)
    assert abs(_z(r, _hw_ref(SPEC))) < 4.0, (float(r.price),
                                             _hw_ref(SPEC))


def test_hw_bermudan_identities():
    from mc_tpu.models.hullwhite import (bermudan_hw_swaption_bounds,
                                         price_bermudan_hw_swaption,
                                         price_hw_swaption)
    eur = price_hw_swaption(SPEC1, DEMO_HW, DEMO_CURVE, SIM_B)
    ber1 = price_bermudan_hw_swaption(SPEC1, DEMO_HW, DEMO_CURVE, SIM_B)
    assert float(ber1.price) == float(eur.price)
    lo, up = bermudan_hw_swaption_bounds(SPEC, DEMO_HW, DEMO_CURVE,
                                         SIM_B, n_branch=8)
    ber = price_bermudan_hw_swaption(SPEC, DEMO_HW, DEMO_CURVE, SIM_B)
    assert float(lo.price) == float(ber.price)
    assert float(up.price) >= float(lo.price)
    assert float(ber.price) >= _hw_ref(SPEC) - 3.0 * float(ber.stderr)


def test_hw_qmc():
    from mc_tpu.models.hullwhite import (price_bermudan_hw_swaption_qmc,
                                         price_hw_swaption_qmc)
    q = price_hw_swaption_qmc(SPEC, DEMO_HW, DEMO_CURVE,
                              SimParams(n_paths=1 << 13, n_steps=1))
    assert abs(float(q.price) - _hw_ref(SPEC)) <= (5.0 * float(q.stderr)
                                                   + 1e-6)
    qb1 = price_bermudan_hw_swaption_qmc(
        SPEC1, DEMO_HW, DEMO_CURVE,
        SimParams(n_paths=1 << 12, n_steps=1), n_fit=2048)
    qe1 = price_hw_swaption_qmc(SPEC1, DEMO_HW, DEMO_CURVE,
                                SimParams(n_paths=1 << 12, n_steps=1))
    assert float(qb1.price) == float(qe1.price)


def test_hw_swap_exposure_strip_anchor():
    """EE(t_0) of the swap exposure equals the Jamshidian swaption
    expiring at t_0 (the strip identity, gated statistically on the
    compiled program), and the booked CVA integrates over the COUPON
    dates (round-4 obs_dates fix) — both on the chip."""
    from mc_tpu.models.hullwhite import hw_swap_exposure
    e = hw_swap_exposure(SPEC, DEMO_HW, DEMO_CURVE,
                         SimParams(n_paths=1 << 16, n_steps=1))
    ee = np.asarray(e.exposure_profile()[0])
    ref0 = _hw_ref(SPEC)
    se0 = float(e.values.std(axis=0)[0]) / np.sqrt(e.values.shape[0])
    assert abs(ee[0] - ref0) < 5.0 * se0 + 1e-5
    t = np.asarray(e.observation_dates())
    np.testing.assert_allclose(
        t, SPEC.expiry + np.arange(SPEC.n_payments) * SPEC.tenor,
        rtol=1e-6)
    assert float(e.cva(0.02)) > 0.0


def test_hw_equity_hybrid():
    from mc_tpu.models.hullwhite import price_hw_equity
    r = price_hw_equity(sim=SimParams(n_paths=1 << 18, n_steps=1),
                        rho=-0.3)
    ref = oracle.hw_equity_call(100.0, 100.0, 1.0, 0.2, DEMO_HW.a,
                                DEMO_HW.sigma_r, -0.3, DEMO_CURVE.df)
    assert abs(_z(r, ref)) < 4.0


# --- G2++ two-factor on the curve (models/g2pp.py) ------------------------

def _g2_ref(spec):
    from mc_tpu.models.g2pp import DEMO_G2
    return oracle.g2_swaption(DEMO_G2.a, DEMO_G2.sigma, DEMO_G2.b_mr,
                              DEMO_G2.eta, DEMO_G2.rho, DEMO_CURVE.df,
                              spec.expiry, spec.tenor, spec.n_payments,
                              spec.k_rate)


def test_g2_european_oracle():
    from mc_tpu.models.g2pp import DEMO_G2, price_g2_swaption
    r = price_g2_swaption(SPEC, DEMO_G2, DEMO_CURVE, SIM)
    assert abs(_z(r, _g2_ref(SPEC))) < 4.0, (float(r.price),
                                             _g2_ref(SPEC))


def test_g2_bermudan_identities():
    from mc_tpu.models.g2pp import (DEMO_G2, bermudan_g2_swaption_bounds,
                                    price_bermudan_g2_swaption,
                                    price_g2_swaption)
    eur = price_g2_swaption(SPEC1, DEMO_G2, DEMO_CURVE, SIM_B)
    ber1 = price_bermudan_g2_swaption(SPEC1, DEMO_G2, DEMO_CURVE, SIM_B)
    assert float(ber1.price) == float(eur.price)
    lo, up = bermudan_g2_swaption_bounds(SPEC, DEMO_G2, DEMO_CURVE,
                                         SIM_B, n_branch=8)
    ber = price_bermudan_g2_swaption(SPEC, DEMO_G2, DEMO_CURVE, SIM_B)
    assert float(lo.price) == float(ber.price)
    assert float(up.price) >= float(lo.price)


def test_g2_qmc():
    from mc_tpu.models.g2pp import (DEMO_G2,
                                    price_bermudan_g2_swaption_qmc,
                                    price_g2_swaption_qmc)
    q = price_g2_swaption_qmc(SPEC, DEMO_G2, DEMO_CURVE,
                              SimParams(n_paths=1 << 13, n_steps=1))
    assert abs(float(q.price) - _g2_ref(SPEC)) <= (5.0 * float(q.stderr)
                                                   + 1e-6)
    qb1 = price_bermudan_g2_swaption_qmc(
        SPEC1, DEMO_G2, DEMO_CURVE,
        SimParams(n_paths=1 << 12, n_steps=1), n_fit=2048)
    qe1 = price_g2_swaption_qmc(SPEC1, DEMO_G2, DEMO_CURVE,
                                SimParams(n_paths=1 << 12, n_steps=1))
    assert float(qb1.price) == float(qe1.price)


def test_g2_swap_exposure_strip_anchor():
    from mc_tpu.models.g2pp import DEMO_G2, g2_swap_exposure
    e = g2_swap_exposure(SPEC, DEMO_G2, DEMO_CURVE,
                         SimParams(n_paths=1 << 16, n_steps=1))
    ee = np.asarray(e.exposure_profile()[0])
    ref0 = _g2_ref(SPEC)
    se0 = float(e.values.std(axis=0)[0]) / np.sqrt(e.values.shape[0])
    assert abs(ee[0] - ref0) < 5.0 * se0 + 1e-5
    assert float(e.cva(0.02)) > 0.0
