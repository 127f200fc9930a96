"""Cross-currency model family: quanto / composite / FX options.

Beyond the reference (single-currency GBM): a foreign equity S (foreign
currency units) and the FX rate X (DOMESTIC units per foreign unit)
follow correlated GBMs under the DOMESTIC risk-neutral measure

    dS/S = (r_f - q - rho sigma_s sigma_x) dt + sigma_s dW_s
    dX/X = (r_d - r_f) dt + sigma_x dW_x,     d<W_s, W_x> = rho dt

(the -rho sigma_s sigma_x drift tilt is the quanto adjustment: S alone
is NOT a domestic tradable, S*X is).  Both terminal laws are exact, so
every contract prices from ONE threefry Box-Muller pair per path — the
`terminal_pair`-class exact draw (trajectories.cuh:74-75 analogue), no
step loop, with z_x = rho z_s + sqrt(1-rho^2) z_perp mixed in-register.

Contracts (all settle in domestic currency, discounted at r_d):

    gk_call/put      max(+-(X_T - kx), 0)          Garman-Kohlhagen
    quanto_call/put  x_bar * max(+-(S_T - K), 0)   fixed conversion x_bar
    compo_call/put   max(+-(S_T X_T - K), 0)       composite (domestic K)
    flexo_call/put   X_T * max(+-(S_T - K), 0)     converted at realized FX

Each has an exact closed form (oracle.gk_call / quanto_call / compo_call
/ flexo_call): GK is Black-Scholes with q = r_f; the quanto forward is
S0 e^{(r_f - q - rho sigma_s sigma_x)T}; the compo spot S*X is GBM with
vol sqrt(sigma_s^2 + sigma_x^2 + 2 rho sigma_s sigma_x); flexo equals
x0 * foreign-measure Black-Scholes (change of numeraire) — so the MC
cross-gates pin the drift tilt, the correlation mixing, AND the measure
change independently.

`quanto_option_params` maps a quanto contract onto the single-asset GBM
engine via an effective dividend yield q_eff = r_d - r_f + q +
rho sigma_s sigma_x — the ENTIRE existing payoff surface (Asian,
barrier, cliquet, QMC, greeks, checkpointed, sharded) then prices
quanto variants by composition.
"""

from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace
from typing import Any, Optional

import jax
import jax.numpy as jnp

from mc_tpu import rng
from mc_tpu.config import DEMO_OPTION, DEMO_SIM, OptionParams, SimParams
from mc_tpu.engines import STREAM_OUTER
from mc_tpu.oracle import PriceResult, summarize
from mc_tpu.ops import path_kernels as pk
from mc_tpu.ops._pallas import xla_moment_scan
from mc_tpu.ops.reduce import finish_sum

__all__ = ["FXDynamics", "price_fx", "quanto_option_params",
           "FX_CONTRACTS", "DEMO_FX"]

# Stream tag (single source; parallel/models_sharded mirrors it).
FX_TAG = 0xF0E8


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FXDynamics:
    """FX-leg parameters (traced pytree leaves).

    ``x0``: FX spot, domestic per foreign; ``sigma_x``: FX lognormal
    vol; ``r_f``: foreign short rate; ``rho``: corr(dW_s, dW_x) of the
    asset and FX log returns; ``kx``: FX-option strike (gk contracts;
    None = x0); ``x_bar``: fixed quanto conversion rate (None = x0).
    The asset leg (s0, sigma, domestic r, dividend q, T, K) rides in
    `OptionParams`.
    """

    x0: Any = 1.0
    sigma_x: Any = 0.15
    r_f: Any = 0.03
    rho: Any = -0.35
    kx: Optional[Any] = None
    x_bar: Optional[Any] = None

    def as_f32(self) -> "FXDynamics":
        x0 = jnp.asarray(self.x0, jnp.float32)
        return FXDynamics(
            x0=x0,
            sigma_x=jnp.asarray(self.sigma_x, jnp.float32),
            r_f=jnp.asarray(self.r_f, jnp.float32),
            rho=jnp.asarray(self.rho, jnp.float32),
            kx=(x0 if self.kx is None
                else jnp.asarray(self.kx, jnp.float32)),
            x_bar=(x0 if self.x_bar is None
                   else jnp.asarray(self.x_bar, jnp.float32)),
        )


DEMO_FX = FXDynamics()


# --- contract registry ------------------------------------------------------
# Each contract is a pure function (p, s_t, x_t) -> domestic payoff at T;
# static names bake into the kernel at trace time (like the payoff
# registry, ops/payoffs.py).

def _gk(sign):
    return lambda p, s_t, x_t: jnp.maximum(sign * (x_t - p.kx), 0.0)


def _quanto(sign):
    return lambda p, s_t, x_t: p.x_bar * jnp.maximum(sign * (s_t - p.k),
                                                     0.0)


def _compo(sign):
    return lambda p, s_t, x_t: jnp.maximum(sign * (s_t * x_t - p.k), 0.0)


def _flexo(sign):
    return lambda p, s_t, x_t: x_t * jnp.maximum(sign * (s_t - p.k), 0.0)


FX_CONTRACTS = {
    "gk_call": _gk(1.0), "gk_put": _gk(-1.0),
    "quanto_call": _quanto(1.0), "quanto_put": _quanto(-1.0),
    "compo_call": _compo(1.0), "compo_put": _compo(-1.0),
    "flexo_call": _flexo(1.0), "flexo_put": _flexo(-1.0),
}


def get_fx_contract(name: str):
    if name not in FX_CONTRACTS:
        raise KeyError(f"unknown fx contract {name!r}; "
                       f"available: {sorted(FX_CONTRACTS)}")
    return name


_FX_FIELDS = ("s0", "k", "x0", "kx", "x_bar", "rho", "rho_perp",
              "drift_s_t", "vol_s_t", "drift_x_t", "vol_x_t")


def _pack_fx(option, fx):
    """Flat f32 parameter vector with both terminal laws precomputed."""
    s0, t, k, r, sigma_s, _, _, _, q = (jnp.float32(v)
                                        for v in option.astuple())
    rho = jnp.float32(fx.rho)
    sigma_x = jnp.float32(fx.sigma_x)
    r_f = jnp.float32(fx.r_f)
    vals = dict(
        s0=s0, k=k, x0=jnp.float32(fx.x0), kx=jnp.float32(fx.kx),
        x_bar=jnp.float32(fx.x_bar), rho=rho,
        rho_perp=jnp.sqrt(1.0 - rho * rho),
        # domestic-measure terminal laws (module docstring)
        drift_s_t=(r_f - q - rho * sigma_s * sigma_x
                   - 0.5 * sigma_s * sigma_s) * t,
        vol_s_t=sigma_s * jnp.sqrt(t),
        drift_x_t=(r - r_f - 0.5 * sigma_x * sigma_x) * t,
        vol_x_t=sigma_x * jnp.sqrt(t),
    )
    return jnp.stack([vals[f] for f in _FX_FIELDS])


def _unpack_fx(ref):
    return SimpleNamespace(**{f: ref[i] for i, f in enumerate(_FX_FIELDS)})


def _fx_vals(contract: str, p, valid, z0, z1):
    """[pay, pay^2] from one Box-Muller pair: z_s = z0 drives the asset,
    z_x = rho z0 + rho_perp z1 the FX rate (exact terminal draws)."""
    z_x = p.rho * z0 + p.rho_perp * z1
    s_t = p.s0 * jnp.exp(p.drift_s_t + p.vol_s_t * z0)
    x_t = p.x0 * jnp.exp(p.drift_x_t + p.vol_x_t * z_x)
    pay = FX_CONTRACTS[contract](p, s_t, x_t)
    pay = jnp.where(valid, pay, 0.0)
    return [pay, pay * pay]


def _fx_partials(contract, cfg, key, params, offset, bound):

    offset = jnp.asarray(offset, jnp.uint32)
    bound = (offset + jnp.uint32(cfg.n_paths) if bound is None
             else jnp.asarray(bound, jnp.uint32))
    p = _unpack_fx(params)
    k0 = jnp.asarray(key[0], jnp.uint32)
    k1 = jnp.asarray(key[1], jnp.uint32)

    def tile_fn(ids, valid):
        c1 = jnp.zeros_like(ids)
        z0, z1 = rng.normal_pair(k0, k1, ids, c1)
        return _fx_vals(contract, p, valid, z0, z1)

    return xla_moment_scan(tile_fn, cfg.n_paths, cfg.tile_rows, 2,
                           offset=offset, bound=bound)


@functools.partial(
    jax.jit,
    static_argnames=("contract", "sim", "tile_rows",
                     "rng_source"))
def _price_fx_impl(option, fx, contract, sim, tile_rows,
                   key, rng_source="threefry13"):
    cfg = pk.KernelConfig(n_paths=sim.n_paths, n_steps=1,
                          tile_rows=tile_rows, rng_source=rng_source)
    params = _pack_fx(option, fx)
    s, sq = _fx_partials(contract, cfg, key, params, 0, None)
    r = jnp.asarray(option.r, jnp.float32)
    t = jnp.asarray(option.t, jnp.float32)
    return summarize(finish_sum(s), finish_sum(sq),
                     jnp.asarray(sim.n_paths, jnp.float32),
                     jnp.exp(-r * t))


def price_fx(option: OptionParams = DEMO_OPTION,
             fx: FXDynamics = DEMO_FX,
             sim: SimParams = DEMO_SIM,
             contract: str = "quanto_call",
             *,
             tile_rows: int = 128,
             stream: int = STREAM_OUTER,
             key=None,
             rng_source: str = "threefry13") -> PriceResult:
    """Monte Carlo price of a cross-currency contract (`FX_CONTRACTS`).

    Terminal laws are exact so ``sim.n_steps`` is ignored (rainbow
    convention).  Counter layout: one threefry pair per path, counter
    (path id, 0), under the fx stream tag — independent of the GBM and
    model-family streams at the same seed.
    """
    contract = get_fx_contract(contract)
    if key is None:
        key = jnp.asarray(rng.derive_key(sim.seed, stream, FX_TAG),
                          jnp.uint32)
    return _price_fx_impl(option.as_f32(), fx.as_f32(), contract,
                          sim.replace(seed=0), tile_rows,
                          key, rng_source=rng_source)


def quanto_option_params(option: OptionParams, fx: FXDynamics):
    """(adjusted OptionParams, x_bar scale) mapping a quanto contract
    onto the single-asset GBM engine.

    Under the domestic measure S drifts at r_f - q - rho sigma_s
    sigma_x while discounting stays at r_d; the GBM engine drifts at
    r - q_eff, so q_eff = r_d - r_f + q + rho sigma_s sigma_x.  Any
    payoff of the S path alone (vanilla, Asian, barrier, cliquet, ...)
    then prices through `engines.price` / `qmc.price_qmc` /
    `greeks.greeks`; multiply the result by ``x_bar``.  Exact identity
    (gated in f64 in tests): oracle.quanto_call == x_bar *
    oracle.bs_call(..., q=q_eff).
    """
    q_eff = (float(option.r) - float(fx.r_f) + float(option.q)
             + float(fx.rho) * float(option.sigma) * float(fx.sigma_x))
    x_bar = float(fx.x0 if fx.x_bar is None else fx.x_bar)
    return dataclasses.replace(option, q=q_eff), x_bar
