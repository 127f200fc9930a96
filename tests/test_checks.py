"""Sanitizer-tier tests (utils/checks)."""

import jax.numpy as jnp
import pytest

from mc_tpu import SimParams, price
from mc_tpu.oracle import PriceResult
from mc_tpu.utils.checks import CheckError, checked, validate_result


def test_validate_healthy():
    res = price(sim=SimParams(n_paths=10_000, n_steps=10),
                tile_rows=8)
    validate_result(res)  # no raise


def test_validate_nan():
    bad = PriceResult(price=jnp.float32(float("nan")),
                      stderr=jnp.float32(0.1), n_paths=1,
                      payoff_mean=0.0, payoff_var=jnp.float32(0.0))
    with pytest.raises(CheckError, match="price is nan"):
        validate_result(bad)


def test_validate_negative_var():
    bad = PriceResult(price=jnp.float32(1.0), stderr=jnp.float32(0.1),
                      n_paths=1, payoff_mean=0.0,
                      payoff_var=jnp.float32(-1.0))
    with pytest.raises(CheckError, match="negative payoff variance"):
        validate_result(bad)


def test_checked_catches_nan():
    import jax

    @checked
    def f(x):
        return jnp.log(x) / x

    assert float(f(jnp.float32(1.0))) == 0.0
    with pytest.raises(Exception):
        f(jnp.float32(-1.0))  # log of negative -> NaN -> raised
