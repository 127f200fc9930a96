"""Portfolio (book-level) batch pricing under common random numbers."""

import numpy as np
import pytest

from mc_tpu import OptionParams, SimParams, price
from mc_tpu.engines import price_portfolio
from mc_tpu.oracle import bs_call

SIM = SimParams(n_paths=50_000, n_steps=20)


def book():
    return OptionParams(
        s0=np.array([100.0, 100.0, 90.0, 110.0], np.float32),
        t=np.array([1.0, 0.5, 1.0, 2.0], np.float32),
        k=np.array([100.0, 105.0, 95.0, 100.0], np.float32),
        r=np.full(4, 0.1, np.float32),
        sigma=np.array([0.2, 0.25, 0.15, 0.3], np.float32),
        barrier=np.full(4, 120.0, np.float32),
        p1=np.full(4, 2.0, np.float32),
        p2=np.full(4, 12.0, np.float32),
    )


def test_portfolio_matches_bs():
    res = price_portfolio(book(), SIM, antithetic=True, tile_rows=8)
    p = np.asarray(res.price)
    se = np.asarray(res.stderr)
    b = book()
    for i in range(4):
        bs = float(bs_call(b.s0[i], b.k[i], b.t[i], b.r[i], b.sigma[i]))
        assert abs(p[i] - bs) <= 4.0 * se[i], (i, p[i], bs)


def test_portfolio_matches_individual():
    """vmapped book entry == single price() on the same stream, bitwise."""
    res = price_portfolio(book(), SIM, tile_rows=8)
    b = book()
    # method pinned: the book kernel shares the classic per-path stream
    # across contracts (CRN), so the scalar side must ride it too.
    single = price(OptionParams(*(float(getattr(b, f)[1]) for f in
                                  ("s0", "t", "k", "r", "sigma", "barrier",
                                   "p1", "p2"))),
                   SIM, tile_rows=8, method="terminal")
    assert float(res.price[1]) == float(single.price)


def test_portfolio_bullet():
    res = price_portfolio(book(), SIM, payoff="bullet_call", tile_rows=8)
    assert (np.asarray(res.price) >= 0).all()


def test_portfolio_large_book():
    """B=64 book through the single batched kernel."""
    rng_np = np.random.default_rng(7)
    b = 64
    opts = OptionParams(
        s0=np.full(b, 100.0, np.float32),
        t=rng_np.uniform(0.5, 2.0, b).astype(np.float32),
        k=rng_np.uniform(80.0, 120.0, b).astype(np.float32),
        r=np.full(b, 0.1, np.float32),
        sigma=rng_np.uniform(0.1, 0.4, b).astype(np.float32),
    )
    sim = SimParams(n_paths=50_000, n_steps=4)
    res = price_portfolio(opts, sim, method="terminal",
                          tile_rows=8)
    ref = price_portfolio(opts, sim, method="terminal",
                          tile_rows=8)
    np.testing.assert_array_equal(np.asarray(res.price),
                                  np.asarray(ref.price))
    bs = np.array([float(bs_call(float(opts.s0[i]), float(opts.k[i]),
                                 float(opts.t[i]), 0.1,
                                 float(opts.sigma[i])))
                   for i in range(b)])
    err = np.abs(np.asarray(res.price) - bs) / np.asarray(res.stderr)
    assert (err < 5.0).mean() > 0.95, err.max()


def test_portfolio_cv_book_bitwise():
    """CV books now run through the batched kernel too (previously a
    sequential lax.map fallback): 5 moment slabs per contract, CV finish
    bitwise-equal to the vmapped XLA dual."""
    kw = dict(payoff="vanilla_call", method="euler", control_variate=True,
              tile_rows=8)
    a = price_portfolio(book(), SIM, **kw)
    b = price_portfolio(book(), SIM, **kw)
    np.testing.assert_array_equal(np.asarray(a.price), np.asarray(b.price))
    np.testing.assert_array_equal(np.asarray(a.stderr),
                                  np.asarray(b.stderr))
    # CV must help on the call book
    plain = price_portfolio(book(), SIM, payoff="vanilla_call", method="euler",
                            tile_rows=8)
    assert np.all(np.asarray(a.stderr) < np.asarray(plain.stderr))
