"""Option contract + simulation configuration.

JAX equivalent of the reference's ``OptionData`` struct
(``inc/tool.cuh:13-26``) and its constant-memory broadcast
(``inc/trajectories.cuh:12``, ``hello.cu:22``).  Instead of a mutable C struct
copied to ``__constant__`` memory, the contract parameters live in a frozen
dataclass registered as a JAX pytree: float fields are traced leaves (so a
jitted pricer can be re-priced at new market data with zero recompiles), while
the simulation geometry (`SimParams`) is hashable/static so XLA sees fixed
shapes and loop bounds.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

__all__ = [
    "OptionParams",
    "SimParams",
    "DEMO_OPTION",
    "DEMO_SIM",
]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class OptionParams:
    """Contract + market parameters (traced pytree leaves).

    Mirrors the market fields of ``OptionData`` (``inc/tool.cuh:13-26``):
    ``S0, T, K, r, v, B, P1, P2``.  The barrier-window bounds ``p1``/``p2``
    are kept as floats so the whole record is a homogeneous traced pytree;
    they are integer step counts semantically (compared with ``>=``/``<=``
    exactly as the reference does in ``inc/trajectories.cuh:149``).
    """

    s0: Any = 100.0     # spot                  (tool.cuh:14)
    t: Any = 1.0        # maturity, years       (tool.cuh:15)
    k: Any = 100.0      # strike                (tool.cuh:16)
    r: Any = 0.1        # risk-free rate        (tool.cuh:17)
    sigma: Any = 0.2    # volatility            (tool.cuh:18 `v`)
    barrier: Any = 120.0  # bullet barrier B    (tool.cuh:19)
    p1: Any = 10.0      # barrier-window lower  (tool.cuh:20)
    p2: Any = 50.0      # barrier-window upper  (tool.cuh:21)
    q: Any = 0.0        # continuous dividend yield (beyond the reference)

    def astuple(self):
        return (self.s0, self.t, self.k, self.r, self.sigma,
                self.barrier, self.p1, self.p2, self.q)

    def as_f32(self) -> "OptionParams":
        return OptionParams(*(jnp.float32(x) for x in self.astuple()))


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Simulation geometry — static (hashable) jit arguments.

    Mirrors the geometry fields of ``OptionData``: ``N_PATHS``,
    ``N_PATHS_INNER``, ``N_STEPS``, ``step`` (``inc/tool.cuh:22-25``).  ``dt``
    is derived (= t / n_steps) rather than stored, removing the reference's
    redundant ``step`` field which callers had to keep in sync by hand
    (``hello.cu:18``).
    """

    n_paths: int = 100_000        # hello.cu:14
    n_steps: int = 100            # hello.cu:16
    n_paths_inner: int = 1_000    # hello.cu:15
    seed: int = 1234              # wrappers.cuh:41 (outer RNG seed)

    def dt(self, t: float) -> float:
        return t / float(self.n_steps)

    def replace(self, **kw) -> "SimParams":
        return dataclasses.replace(self, **kw)


# The reference demo configuration (hello.cu:5-19): BS call ~= 13.2697.
DEMO_OPTION = OptionParams()
DEMO_SIM = SimParams()
