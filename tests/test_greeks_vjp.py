"""Custom VJP on the Pallas primal: jax.grad flows through
price(engine="pallas") and the gradients are EXACT for the production
price (backward = the XLA engine, engines._pallas_partials_diff).  The
kernel runs interpreted here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams, price
from mc_tpu.greeks import greeks

OPT = OptionParams()
SIM = SimParams(n_paths=4096, n_steps=8)


def _price_s0(engine):
    def f(s0):
        o = dataclasses.replace(OPT.as_f32(), s0=s0)
        return price(o, SIM, payoff="vanilla_call", method="euler",
                     engine=engine, interpret=engine == "pallas",
                     tile_rows=8).price
    return f


def test_grad_through_pallas_price():
    """jax.grad(price(engine='pallas')) no longer errors, and equals
    the XLA-engine gradient bitwise (same backward program)."""
    s0 = jnp.float32(100.0)
    vp, gp = jax.value_and_grad(_price_s0("pallas"))(s0)
    vx, gx = jax.value_and_grad(_price_s0("xla"))(s0)
    assert float(vp) == float(vx)       # engine parity (primal)
    assert float(gp) == float(gx)       # identical backward program
    assert 0.3 < float(gp) < 1.0        # a call delta


def test_grad_pallas_antithetic_and_terminal():
    def f(engine, **kw):
        def g(s0):
            o = dataclasses.replace(OPT.as_f32(), s0=s0)
            return price(o, SIM, payoff="vanilla_call", engine=engine,
                         interpret=engine == "pallas", tile_rows=8,
                         **kw).price
        return g

    for kw in ({"method": "terminal"}, {"method": "euler",
                                        "antithetic": True}):
        gp = jax.grad(f("pallas", **kw))(jnp.float32(100.0))
        gx = jax.grad(f("xla", **kw))(jnp.float32(100.0))
        assert float(gp) == float(gx), kw


def test_greeks_pallas_full_which():
    """Every greek works under engine='pallas' through the custom VJP,
    equal to engine='xla'."""
    which = ("delta", "vega", "rho", "theta")
    gp = greeks(OPT, SIM, "vanilla_call", which=which, engine="pallas",
                interpret=True, tile_rows=8)
    gx = greeks(OPT, SIM, "vanilla_call", which=which, engine="xla",
                tile_rows=8)
    for k in which:
        assert float(gp[k]) == float(gx[k]), k


def test_primal_value_unchanged():
    """Attaching the VJP must not move the primal: price(engine='pallas')
    is bitwise what it was (== engine='xla' on the shared stream)."""
    a = price(OPT, SIM, payoff="asian_call", method="euler",
              engine="pallas", interpret=True, tile_rows=8)
    b = price(OPT, SIM, payoff="asian_call", method="euler", tile_rows=8)
    assert float(a.price) == float(b.price)
    assert float(a.stderr) == float(b.stderr)
