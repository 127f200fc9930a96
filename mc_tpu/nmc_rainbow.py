"""Rainbow NMC: exposure of order-statistic contracts under correlation.

Extends the flagship NMC capability (``/root/reference/inc/nmc.cuh``,
single-asset GBM) to rainbow contracts: conditional values / EE / PFE /
CVA of best-of and worst-of positions on d correlated assets.  The
physics IS the correlated log-Euler scheme of `nmc_basket.BasketNMC`
(same grids, same stream layout, same resume-from-(S_1..S_d) inner
legs); the only change is the LEVEL the payoff reads — the running
order statistic ``max_i S_i`` / ``min_i S_i`` instead of the weighted
sum.  ``RainbowNMC`` therefore subclasses ``BasketNMC`` and overrides
the level fold alone; the single-device and sharded engines and every
registered payoff come for free from the generic `nmc_engine`
machinery.

Payoff mapping: a rainbow contract is a VANILLA payoff on the order
statistic — ``call_on_max = vanilla_call(max_i S_i)``, ``put_on_min =
vanilla_put(min_i S_i)`` etc. (`models/rainbow.RAINBOW_PAYOFFS`
folds identically at the terminal date).  `price_nmc_rainbow` accepts
the rainbow names and maps them; generic consumers (sharded /
book engines) use the standard payoff registry on the aggregated level
directly.

Gates (tests/test_nmc_rainbow.py): EE of the fully-discounted
call-on-max is a martingale, flat at the Stulz (1982) closed form
(`oracle.stulz_max_call`) at every step; d=1 max/min/sum levels agree
bitwise; pallas/XLA parity bitwise as everywhere else.
"""

from __future__ import annotations


import jax.numpy as jnp

from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.models.basket import DEMO_BASKET, BasketDynamics
from mc_tpu.nmc import NMCResult
from mc_tpu.nmc_basket import BasketNMC
from mc_tpu.nmc_engine import price_nmc_family, register_nmc_family

__all__ = ["price_nmc_rainbow", "RainbowNMC", "RAINBOW_NMC_PAYOFFS"]

# rainbow contract name -> (order-statistic aggregator, vanilla payoff)
RAINBOW_NMC_PAYOFFS = {
    "call_on_max": ("max", "vanilla_call"),
    "call_on_min": ("min", "vanilla_call"),
    "put_on_max": ("max", "vanilla_put"),
    "put_on_min": ("min", "vanilla_put"),
    "best_of_cash": ("max", "best_of_cash"),
}


class RainbowNMC(BasketNMC):
    """d-asset correlated-GBM physics with an order-statistic level:
    ``extras = (d, agg)`` with agg in ("max", "min")."""

    name = "rainbow"
    tag = 0x4A13

    @property
    def agg(self):
        return self.extras[1]

    def _basket_of(self, p, d, ws):
        """The payoff level: the running best-of / worst-of price
        (overrides BasketNMC's weighted sum; weights are ignored)."""
        fold = jnp.maximum if self.agg == "max" else jnp.minimum
        lvl = None
        for i in range(d):
            s = p.s0s[i] * jnp.exp(ws[i])
            lvl = s if lvl is None else fold(lvl, s)
        return lvl

    def lsmc_level(self, p, grids_flat):
        """Exercise level for the generic LSMC client: the order
        statistic folded over the stored per-asset price grids (the
        cross basis is inherited from BasketNMC — the continuation
        value of a best-of depends on all asset levels)."""
        fold = jnp.maximum if self.agg == "max" else jnp.minimum
        lvl = None
        for i in range(self.d):
            g = grids_flat[i]
            lvl = g if lvl is None else fold(lvl, g)
        return lvl


def price_nmc_rainbow(option: OptionParams = DEMO_OPTION,
                      basket: BasketDynamics = DEMO_BASKET,
                      sim: SimParams = DEMO_SIM,
                      payoff: str = "call_on_max",
                      *,
                      tile_rows: int = 8,
                      stream_outer: int = 0,
                      stream_inner: int = 1) -> NMCResult:
    """Nested MC price surface of a rainbow contract on d correlated
    assets: exposure profiles and CVA of best-of / worst-of positions.

    ``payoff`` takes the rainbow names (`RAINBOW_NMC_PAYOFFS`); the
    standard path-payoff names also work and then read the ``"max"``
    order statistic (e.g. ``asian_call`` = Asian on the running best-of
    level).
    """
    agg, po = RAINBOW_NMC_PAYOFFS.get(payoff, ("max", payoff))
    b32 = basket.as_f32()
    return price_nmc_family(RainbowNMC(extras=(b32.d, agg)), option,
                            b32, sim, po, tile_rows=tile_rows,
                            stream_outer=stream_outer,
                            stream_inner=stream_inner)


def _rainbow_builder(option, dyn, sim):
    b32 = (DEMO_BASKET if dyn is None else dyn).as_f32()
    return RainbowNMC(extras=(b32.d, "max")), b32


register_nmc_family("rainbow", price_nmc_rainbow, _rainbow_builder)
