"""Pluggable path-payoff registry.

The reference hard-codes one payoff per kernel family: vanilla call
(``inc/trajectories.cuh:76``) and the "bullet" barrier-window call
(``inc/trajectories.cuh:149-153``: count steps with ``S_t < B``; pay
``max(S_T - K, 0)`` iff the count lands in ``[P1, P2]``).  Here a payoff is a
small static object with three pure functions over ``(state, S, params)``;
one generic fused kernel handles every payoff (bullet, Asian, knock-out,
lookback, ...) because the payoff code is inlined into the step loop at
trace time.  Branches like ``if (B > St) count += 1`` become masked
``jnp.where`` — the divergence-free form every lane runs in step.

State arrays are all float32 so kernels carry a homogeneous tuple; step
counts are exact in f32 up to 2^24 steps.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax.numpy as jnp

__all__ = ["PathPayoff", "PAYOFFS", "get_payoff"]

State = Tuple[Any, ...]


class PathPayoff:
    """Base: a payoff accumulated along the path with O(1) state.

    ``init(params, like)`` -> state tuple of arrays shaped like ``like``;
    ``update(state, s, params)`` -> state, applied after every Euler step;
    ``terminal(state, s, params)`` -> payoff array.

    Instances are static singletons (hashable, no traced leaves) so they can
    be closed over by Pallas kernels and used as jit static arguments.
    """

    name: str = "base"
    n_state: int = 0

    def init(self, params, like) -> State:
        return ()

    def update(self, state: State, s, params) -> State:
        return state

    def terminal(self, state: State, s, params):
        raise NotImplementedError

    # Payoffs that need no step loop (European) can be priced with the exact
    # one-shot terminal draw (trajectories.cuh:74-75).
    terminal_only: bool = False

    def validate(self, option, n_steps: int) -> None:
        """Entry-point validation with CONCRETE option fields (called by
        the host pricers before tracing).  Implementations must silently
        skip traced/array-valued fields (book pricing)."""

    # Optional payoff-specific control variate: ``control(state, s, p)``
    # returns the per-path control X and ``control_expectation(p)`` its
    # exact expectation (engines fall back to X = S_T, E[X] = S0 e^{rT}).
    has_control: bool = False

    def control(self, state: State, s, p):
        raise NotImplementedError

    def control_expectation(self, p):
        raise NotImplementedError

    def __repr__(self):
        return f"<PathPayoff {self.name}>"

    def __hash__(self):
        return hash((type(self).__name__, self.name))

    def __eq__(self, other):
        return type(self) is type(other) and self.name == getattr(other, "name", None)


class VanillaCall(PathPayoff):
    """max(S_T - K, 0) — trajectories.cuh:76."""

    name = "vanilla_call"
    terminal_only = True

    def terminal(self, state, s, p):
        return jnp.maximum(s - p.k, 0.0)


class VanillaPut(PathPayoff):
    name = "vanilla_put"
    terminal_only = True

    def terminal(self, state, s, p):
        return jnp.maximum(p.k - s, 0.0)


class BestOfCash(PathPayoff):
    """max(S_T, K) — asset-or-cash (models/rainbow's best_of_cash on
    the single/folded level).  Identity: e^{-rT} E[max(S_T, K)] =
    K e^{-rT} + bs_call(S0, K, ...) — the exact-gate in test_payoffs.
    On the rainbow NMC/LSMC level it is the best-of-assets-or-cash
    contract of `models/rainbow.RAINBOW_PAYOFFS`."""

    name = "best_of_cash"
    terminal_only = True

    def terminal(self, state, s, p):
        return jnp.maximum(s, p.k)


class DigitalCall(PathPayoff):
    """Cash-or-nothing digital call: pays 1 iff S_T > K.

    The canonical DISCONTINUOUS payoff: zero-a.e. pathwise derivative
    (LRM/FD Greeks only) and the sharpest test of estimator bias — the
    closed form is e^{-rT} N(d2) (oracle.bs_digital_call).
    """

    name = "digital_call"
    terminal_only = True

    def terminal(self, state, s, p):
        return jnp.where(s > p.k, 1.0, 0.0)


class DigitalPut(PathPayoff):
    """Cash-or-nothing digital put: pays 1 iff S_T < K.

    Complement of the digital call (pathwise: put + call + 1{S_T==K}
    = 1), so the closed form is e^{-rT} N(-d2) and the MC pair sums to
    the discount bond exactly — the parity gate in test_payoffs.
    """

    name = "digital_put"
    terminal_only = True

    def terminal(self, state, s, p):
        return jnp.where(s < p.k, 1.0, 0.0)


class ZeroCouponBond(PathPayoff):
    """Pays 1 at maturity.  Trivial under deterministic rates (price is
    e^{-rT} exactly); under the stochastic-rate model (`models.vasicek`,
    which discounts PATHWISE by exp(-int r dt)) it prices the zero-coupon
    bond — the gate against the Vasicek affine closed form
    (`oracle.vasicek_zcb`)."""

    name = "zcb"
    terminal_only = True

    def terminal(self, state, s, p):
        return jnp.ones_like(s)


class BulletCall(PathPayoff):
    """Barrier-window call (trajectories.cuh:144-153).

    state = (count,): number of steps with S < B, as f32.
    Pays max(S_T - K, 0) iff P1 <= count <= P2.
    """

    name = "bullet_call"
    n_state = 1

    def init(self, p, like):
        return (jnp.zeros_like(like),)

    def update(self, state, s, p):
        (count,) = state
        return (count + jnp.where(s < p.barrier, 1.0, 0.0).astype(count.dtype),)

    def terminal(self, state, s, p):
        (count,) = state
        in_window = jnp.logical_and(count >= p.p1, count <= p.p2)
        return jnp.where(in_window, jnp.maximum(s - p.k, 0.0), 0.0)


class AsianCall(PathPayoff):
    """Arithmetic-average Asian call: max(mean(S_1..S_N) - K, 0).

    state = (running sum of S,). The mean divisor is folded in at terminal
    via params.n_steps_f (set by the engine).
    """

    name = "asian_call"
    n_state = 1

    def init(self, p, like):
        return (jnp.zeros_like(like),)

    def update(self, state, s, p):
        (acc,) = state
        return (acc + s,)

    def terminal(self, state, s, p):
        (acc,) = state
        return jnp.maximum(acc * p.inv_n_steps - p.k, 0.0)


class UpOutCall(PathPayoff):
    """Up-and-out knock-out call: pays max(S_T-K,0) unless S ever >= B.

    state = (alive flag as f32,).
    """

    name = "up_out_call"
    n_state = 1

    def init(self, p, like):
        return (jnp.ones_like(like),)

    def update(self, state, s, p):
        (alive,) = state
        return (alive * jnp.where(s < p.barrier, 1.0, 0.0).astype(alive.dtype),)

    def terminal(self, state, s, p):
        (alive,) = state
        return alive * jnp.maximum(s - p.k, 0.0)


class DownOutCall(PathPayoff):
    """Down-and-out knock-out call: dies if S ever < B (discrete monitoring).

    Complements `DownInCall` — in-out parity: down_in + down_out = vanilla,
    path by path, under the same draws.
    """

    name = "down_out_call"
    n_state = 1

    def init(self, p, like):
        return (jnp.ones_like(like),)

    def update(self, state, s, p):
        (alive,) = state
        return (alive * jnp.where(s >= p.barrier, 1.0, 0.0).astype(alive.dtype),)

    def terminal(self, state, s, p):
        (alive,) = state
        return alive * jnp.maximum(s - p.k, 0.0)


class UpOutCallBB(PathPayoff):
    """Up-and-out call with the Brownian-bridge barrier correction.

    Discrete monitoring at n steps over-prices a continuously monitored
    knock-out by O(1/sqrt(n)) (the path can cross and come back between
    steps).  Under GBM, log S is a Brownian bridge between step points, so
    the conditional one-step survival probability is closed-form
    (Glasserman, *MC Methods in Fin. Eng.*, section 6.4):

        P(no cross | S_{i-1}, S_i) = 1 - exp(-2 ln(B/S_{i-1}) ln(B/S_i)
                                              / (sigma^2 dt))

    and weighting the payoff by the product of these survivals gives an
    UNBIASED estimator of the continuous-barrier price at ANY step count.
    state = (prev S, survival weight).  GBM-specific: the bridge variance
    uses p.sigma/p.dt (constant-vol log dynamics).
    """

    name = "up_out_call_bb"
    n_state = 2

    def init(self, p, like):
        return (jnp.zeros_like(like) + p.s0, jnp.ones_like(like))

    def update(self, state, s, p):
        prev_s, surv = state
        a = jnp.log(p.barrier / prev_s)
        bb = jnp.log(p.barrier / s)
        p_cross = jnp.exp(-2.0 * a * bb / (p.sigma * p.sigma * p.dt))
        below = jnp.logical_and(prev_s < p.barrier, s < p.barrier)
        surv = surv * jnp.where(below, 1.0 - p_cross, 0.0)
        return (s, surv)

    def terminal(self, state, s, p):
        _, surv = state
        return surv * jnp.maximum(s - p.k, 0.0)


class DownOutCallBB(PathPayoff):
    """Down-and-out call with the Brownian-bridge barrier correction.

    Same construction as `UpOutCallBB` with the crossing measured downward:
    both endpoints above B, bridge crossing probability
    exp(-2 ln(S_{i-1}/B) ln(S_i/B) / (sigma^2 dt)).
    """

    name = "down_out_call_bb"
    n_state = 2

    def init(self, p, like):
        return (jnp.zeros_like(like) + p.s0, jnp.ones_like(like))

    def update(self, state, s, p):
        prev_s, surv = state
        a = jnp.log(prev_s / p.barrier)
        bb = jnp.log(s / p.barrier)
        p_cross = jnp.exp(-2.0 * a * bb / (p.sigma * p.sigma * p.dt))
        above = jnp.logical_and(prev_s > p.barrier, s > p.barrier)
        surv = surv * jnp.where(above, 1.0 - p_cross, 0.0)
        return (s, surv)

    def terminal(self, state, s, p):
        _, surv = state
        return surv * jnp.maximum(s - p.k, 0.0)


class DownInCall(PathPayoff):
    """Down-and-in call: pays only if S ever < B (knock-in at the barrier)."""

    name = "down_in_call"
    n_state = 1

    def init(self, p, like):
        return (jnp.zeros_like(like),)

    def update(self, state, s, p):
        (hit,) = state
        return (jnp.maximum(hit, jnp.where(s < p.barrier, 1.0, 0.0).astype(hit.dtype)),)

    def terminal(self, state, s, p):
        (hit,) = state
        return hit * jnp.maximum(s - p.k, 0.0)


class VarianceSwap(PathPayoff):
    """Realized-variance swap: pays (annualized realized variance - K).

    state = (prev S, running sum of squared log returns); the terminal
    value is sum((log S_i/S_{i-1})^2)/T - K, where the strike field K is
    the VARIANCE strike (e.g. 0.04 for a 20-vol strike).  Signed payoff
    (a swap, not an option).

    Sharp oracle gates per model: E[RV] = sigma^2 under GBM (up to
    O(mu^2 dt)), theta + (v0-theta)(1-e^{-kT})/(kT) under Heston, and
    sigma^2 + lam (mu_j^2 + sigma_j^2) under Merton — the jump
    contribution to quadratic variation the diffusion models miss.
    """

    name = "variance_swap"
    n_state = 2

    def init(self, p, like):
        return (jnp.zeros_like(like) + p.s0, jnp.zeros_like(like))

    def update(self, state, s, p):
        prev_s, acc = state
        lr = jnp.log(s / prev_s)
        return (s, acc + lr * lr)

    def terminal(self, state, s, p):
        _, acc = state
        return acc / p.t - p.k


class ForwardStartCall(PathPayoff):
    """Forward-start call: pays max(S_T - k * S_{t1}, 0).

    The strike is set at the DETERMINATION DATE t1 as a ratio ``k`` of
    the then-spot (use e.g. OptionParams(k=1.0) for at-the-money-forward;
    k here is a RATIO, not an absolute level).  ``p1`` is the
    determination STEP index (1-based: the strike fixes after step p1;
    p1=0 fixes at S0, reducing to a vanilla with strike k*S0 — the test
    gate).  state = (step count, S at t1).

    Closed form under GBM: Rubinstein (1991) —
    `oracle.bs_forward_start_call`.
    """

    name = "forward_start_call"
    n_state = 2

    def validate(self, option, n_steps):
        try:
            p1 = float(option.p1)
        except TypeError:
            return  # traced/array field (book pricing) — can't check
        if p1 != int(p1) or not 0 <= p1 <= n_steps:
            raise ValueError(
                f"forward_start_call: p1 (determination step) must be an "
                f"integer in [0, n_steps={n_steps}], got {p1} — a "
                f"non-matching p1 would silently price a vanilla struck "
                f"at k*S0")

    def init(self, p, like):
        return (jnp.zeros_like(like), jnp.zeros_like(like) + p.s0)

    def update(self, state, s, p):
        count, s_ref = state
        count = count + 1.0
        s_ref = jnp.where(count == p.p1, s, s_ref)
        return (count, s_ref)

    def terminal(self, state, s, p):
        _, s_ref = state
        return jnp.maximum(s - p.k * s_ref, 0.0)


class Cliquet(PathPayoff):
    """Ratchet cliquet: sum of clamped simple period returns.

    Pays  sum_i  clamp(S_{t_i}/S_{t_{i-1}} - 1, floor, cap)  with resets
    every ``k`` steps (k = PERIOD LENGTH in steps here — the strike field
    is unused by a cliquet), floor = ``p1``, cap = ``p2``.  Signed payoff
    (a ratchet note leg, not an option).

    Under GBM the period returns are iid, so the fair value has a FULL
    closed form (a Black call-spread per period):
    `oracle.bs_cliquet`.  state = (step count, S at last reset, acc).
    """

    name = "cliquet"
    n_state = 3

    def validate(self, option, n_steps):
        try:
            k = float(option.k)
            p1, p2 = float(option.p1), float(option.p2)
        except TypeError:
            return  # traced/array fields (book pricing) — can't check
        if k != int(k) or not 1 <= k <= n_steps:
            raise ValueError(
                f"cliquet: k (period length in steps) must be an integer "
                f"in [1, n_steps={n_steps}], got {k}")
        if p1 > p2:
            raise ValueError(f"cliquet: floor p1={p1} > cap p2={p2}")

    def init(self, p, like):
        return (jnp.zeros_like(like), jnp.zeros_like(like) + p.s0,
                jnp.zeros_like(like))

    def update(self, state, s, p):
        count, s_ref, acc = state
        count = count + 1.0
        reset = (count % p.k) == 0.0
        ret = jnp.clip(s / s_ref - 1.0, p.p1, p.p2)
        acc = jnp.where(reset, acc + ret, acc)
        s_ref = jnp.where(reset, s, s_ref)
        return (count, s_ref, acc)

    def terminal(self, state, s, p):
        _, _, acc = state
        return acc


class LookbackFixedCall(PathPayoff):
    """Fixed-strike lookback call: max(max_t S_t - K, 0). state = (running max,)."""

    name = "lookback_call"
    n_state = 1

    def init(self, p, like):
        return (like,)  # running max starts at S0

    def update(self, state, s, p):
        (m,) = state
        return (jnp.maximum(m, s),)

    def terminal(self, state, s, p):
        (m,) = state
        return jnp.maximum(m - p.k, 0.0)


class AsianCallGeoCV(AsianCall):
    """Arithmetic Asian call with the geometric-Asian control variate.

    state = (running sum of S, running sum of log S).  The control is the
    geometric-average call payoff, whose discrete-average distribution is
    exactly lognormal under GBM — `control_expectation` is its closed
    form, making this the classic high-power Asian variance reduction.
    Requires params fields n_steps_f/drift/vol context supplied by the
    engine namespace (log-variance terms are derived from p.sigma, p.t,
    p.inv_n_steps).
    """

    name = "asian_call_geo_cv"
    n_state = 2
    has_control = True

    def init(self, p, like):
        return (jnp.zeros_like(like), jnp.zeros_like(like))

    def update(self, state, s, p):
        acc, lacc = state
        return (acc + s, lacc + jnp.log(s))

    def terminal(self, state, s, p):
        acc, _ = state
        return jnp.maximum(acc * p.inv_n_steps - p.k, 0.0)

    def control(self, state, s, p):
        _, lacc = state
        geo = jnp.exp(lacc * p.inv_n_steps)
        return jnp.maximum(geo - p.k, 0.0)

    def control_expectation(self, p):
        # Discrete geometric average of GBM is lognormal:
        #   mean log: mu = ln S0 + (r - sigma^2/2) T (n+1)/(2n)
        #   var log:  s2 = sigma^2 T (n+1)(2n+1)/(6 n^2)
        # E[(G-K)+] = e^{mu+s2/2} N(d1) - K N(d2), d1=(mu-lnK+s2)/s, d2=d1-s.
        from jax.scipy.stats import norm
        n = 1.0 / p.inv_n_steps
        mu = (jnp.log(p.s0)
              + (p.r - p.q - 0.5 * p.sigma * p.sigma)
              * p.t * (n + 1.0) / (2.0 * n))
        s2 = (p.sigma * p.sigma * p.t
              * (n + 1.0) * (2.0 * n + 1.0) / (6.0 * n * n))
        s_ = jnp.sqrt(s2)
        d1 = (mu - jnp.log(p.k) + s2) / s_
        d2 = d1 - s_
        return jnp.exp(mu + 0.5 * s2) * norm.cdf(d1) - p.k * norm.cdf(d2)


PAYOFFS: Dict[str, PathPayoff] = {
    po.name: po
    for po in (
        VanillaCall(), VanillaPut(), DigitalCall(), BulletCall(),
        AsianCall(), AsianCallGeoCV(), UpOutCall(), DownInCall(),
        DownOutCall(), UpOutCallBB(), DownOutCallBB(),
        LookbackFixedCall(), VarianceSwap(), ZeroCouponBond(),
        ForwardStartCall(), Cliquet(), DigitalPut(), BestOfCash(),
    )
}


def get_payoff(name_or_payoff) -> PathPayoff:
    if isinstance(name_or_payoff, PathPayoff):
        return name_or_payoff
    try:
        return PAYOFFS[name_or_payoff]
    except KeyError:
        raise KeyError(
            f"unknown payoff {name_or_payoff!r}; available: {sorted(PAYOFFS)}"
        ) from None
