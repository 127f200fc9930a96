"""Runtime validation: the sanitizer tier (SURVEY.md section 5).

The reference relies on `testCUDA` exit-on-error and unchecked atomics
(``tool.cuh:92-100``); here the race classes are gone by construction
(per-tile partials summed in tile order, no atomics), so what remains worth
checking is *numerical* health: NaN/Inf payoffs, negative variances,
impossible prices.  `validate_result` is a cheap post-hoc gate; `checked`
wraps a jitted pricer with `jax.experimental.checkify` for hard in-graph
NaN/div checks when debugging.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import checkify

__all__ = ["validate_result", "checked", "CheckError"]


class CheckError(RuntimeError):
    pass


def validate_result(res, *, context: str = "price") -> None:
    """Raise CheckError if a PriceResult is numerically unhealthy."""
    problems = []
    price = float(res.price)
    stderr = float(res.stderr)
    if not jnp.isfinite(price):
        problems.append(f"price is {price}")
    if not jnp.isfinite(stderr) or stderr < 0.0:
        problems.append(f"stderr is {stderr}")
    if float(res.payoff_var) < 0.0:
        problems.append(f"negative payoff variance {float(res.payoff_var)}")
    if price < -1e-6:
        problems.append(f"negative option price {price}")
    if problems:
        raise CheckError(f"{context}: " + "; ".join(problems))


def checked(fn):
    """Wrap a jittable function with checkify NaN/div error functionalization.

    Returns a callable that raises on the first NaN/Inf produced inside
    the traced computation (use on the XLA engine while debugging; the
    error tracking costs throughput, so it is opt-in).
    """
    cfn = checkify.checkify(
        fn, errors=checkify.float_checks)

    def wrapper(*args, **kwargs):
        err, out = cfn(*args, **kwargs)
        checkify.check_error(err)
        return out

    return wrapper
