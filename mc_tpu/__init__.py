"""mc_tpu — Monte Carlo option pricing framework on JAX, for NVIDIA GPUs.

A from-scratch JAX / XLA / Pallas re-design of the capabilities of the CUDA
reference ``amauryrlm/Monte-Carlo-Project-CUDA`` (see SURVEY.md): European
and path-dependent option pricing under GBM, nested Monte Carlo, an on-chip
reduction hierarchy, counter-based RNG, variance reduction, Greeks,
checkpoint/resume, and multi-chip scaling over a `jax.sharding.Mesh`.
"""

from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.engines import price, simulate_trajectories, Trajectories
from mc_tpu.oracle import (PriceResult, bs_call, bs_call_as, bs_delta_call,
                           bs_put, cnd_as)
from mc_tpu.ops.payoffs import PAYOFFS, get_payoff

__version__ = "0.1.0"

__all__ = [
    "OptionParams", "SimParams", "DEMO_OPTION", "DEMO_SIM",
    "price", "simulate_trajectories", "Trajectories",
    "PriceResult", "bs_call", "bs_put", "bs_call_as", "bs_delta_call",
    "cnd_as", "PAYOFFS", "get_payoff",
]


def __getattr__(name):
    # Heavier subsystems load lazily to keep `import mc_tpu` fast.
    if name in ("price_nmc", "NMCResult"):
        from mc_tpu import nmc
        return getattr(nmc, name)
    if name == "greeks":
        from mc_tpu.greeks import greeks
        return greeks
    if name == "chunked_price":
        from mc_tpu.checkpoint import chunked_price
        return chunked_price
    if name == "price_ladder":
        from mc_tpu.engines import price_ladder
        return price_ladder
    if name == "price_qmc":
        from mc_tpu.qmc import price_qmc
        return price_qmc
    if name in ("price_heston", "HestonDynamics", "heston_call_cf"):
        from mc_tpu.models import heston
        return getattr(heston, name)
    if name in ("price_bates", "BatesDynamics", "bates_call_cf"):
        from mc_tpu.models import bates
        return getattr(bates, name)
    if name in ("price_basket", "BasketDynamics"):
        from mc_tpu.models import basket
        return getattr(basket, name)
    if name in ("price_fx", "FXDynamics", "quanto_option_params",
                "FX_CONTRACTS"):
        from mc_tpu.models import fx
        return getattr(fx, name)
    if name == "price_portfolio":
        from mc_tpu.engines import price_portfolio
        return price_portfolio
    if name in ("price_heston_mlmc", "price_mlmc_family"):
        from mc_tpu import mlmc
        return getattr(mlmc, name)
    if name in ("price_american", "binomial_american"):
        from mc_tpu import lsmc
        return getattr(lsmc, name)
    if name in ("price_merton", "MertonDynamics", "merton_call_closed_form"):
        from mc_tpu.models import merton
        return getattr(merton, name)
    if name in ("price_sabr", "SABRDynamics", "sabr_implied_vol",
                "sabr_call_hagan"):
        from mc_tpu.models import sabr
        return getattr(sabr, name)
    if name in ("price_cev", "CEVDynamics", "cev_call_closed_form"):
        from mc_tpu.models import cev
        return getattr(cev, name)
    if name in ("price_swaption", "price_bermudan_swaption",
                "price_swaption_sharded", "price_swaption_qmc",
                "swaption_greeks", "swap_exposure", "SwaptionSpec",
                "bermudan_swaption_bounds",
                "price_bermudan_swaption_qmc", "swap_cva_greeks",
                "bermudan_swaption_exposure"):
        from mc_tpu.models import swaption
        return getattr(swaption, name)
    if name in ("price_hw_swaption", "price_bermudan_hw_swaption",
                "bermudan_hw_swaption_bounds",
                "bermudan_hw_swaption_exposure", "price_hw_swaption_qmc",
                "price_hw_swaption_sharded", "price_hw_equity",
                "price_bermudan_hw_swaption_qmc",
                "hw_swap_exposure", "hw_swap_book_exposure",
                "hw_swap_cva_greeks", "hw_swaption_greeks",
                "DiscountCurve",
                "HullWhiteDynamics"):
        from mc_tpu.models import hullwhite
        return getattr(hullwhite, name)
    if name in ("price_g2_swaption", "price_bermudan_g2_swaption",
                "bermudan_g2_swaption_bounds",
                "bermudan_g2_swaption_exposure",
                "price_g2_swaption_sharded", "g2_swap_exposure",
                "g2_swap_book_exposure", "g2_swap_cva_greeks",
                "g2_swaption_greeks",
                "price_g2_swaption_qmc",
                "price_bermudan_g2_swaption_qmc", "G2Dynamics"):
        from mc_tpu.models import g2pp
        return getattr(g2pp, name)
    if name in ("calibrate_sabr", "hagan_iv"):
        from mc_tpu import calibrate
        return getattr(calibrate, name)
    if name in ("bs_implied_vol", "bs_vega", "bs_gamma", "bs_digital_call",
                "bs_up_out_call", "bs_down_out_call"):
        from mc_tpu import oracle
        return getattr(oracle, name)
    raise AttributeError(f"module 'mc_tpu' has no attribute {name!r}")
