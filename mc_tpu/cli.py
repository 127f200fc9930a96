"""Command-line interface: the reference's driver binaries, configurable.

``python -m mc_tpu demo``   — the ``./main`` equivalent (``hello.cu:3-48``):
runs every pricer family on one config and prints the table with the
Black-Scholes oracle beside the MC estimates.  Unlike the reference, every
parameter is a flag instead of a recompile (SURVEY.md section 5 "config
system: absent"), and every estimate carries its standard error.

``python -m mc_tpu traj``   — the ``./test`` trajectory dump
(``testing.cu:20-49``): writes the tidy ``time,trajectory,value`` CSV used
for plotting.

``python -m mc_tpu price|nmc|bench|info`` — single pricer / NMC surface /
benchmark / device dump.
"""

from __future__ import annotations

import argparse
import json
import sys

import jax

from mc_tpu.config import OptionParams, SimParams
from mc_tpu.utils.platform import start


def _add_option_flags(p: argparse.ArgumentParser):
    g = p.add_argument_group("option/market (OptionData, tool.cuh:13-26)")
    g.add_argument("--s0", type=float, default=100.0)
    g.add_argument("--strike", "-K", type=float, default=100.0, dest="k")
    g.add_argument("--maturity", "-T", type=float, default=1.0, dest="t")
    g.add_argument("--rate", "-r", type=float, default=0.1, dest="r")
    g.add_argument("--sigma", "-v", type=float, default=0.2)
    g.add_argument("--barrier", "-B", type=float, default=120.0)
    g.add_argument("--p1", type=float, default=10.0,
                   help="bullet window lower step count")
    g.add_argument("--p2", type=float, default=50.0,
                   help="bullet window upper step count")
    g.add_argument("--dividend", "-q", type=float, default=0.0, dest="q",
                   help="continuous dividend yield")
    g = p.add_argument_group("simulation")
    g.add_argument("--n-paths", "-N", type=int, default=100_000)
    g.add_argument("--n-steps", type=int, default=100)
    g.add_argument("--n-inner", type=int, default=1_000,
                   help="inner paths per NMC point")
    g.add_argument("--seed", type=int, default=1234)
    g.add_argument("--tile-rows", type=int, default=None,
                   help="paths per tile / 128 (default: the engine's; "
                        "128 for the model families)")


def _add_engine_flag(p: argparse.ArgumentParser):
    """--engine, for the commands whose pricers have a Triton kernel."""
    p.add_argument("--engine", choices=("pallas", "xla"), default=None,
                   help="default: the Triton kernels on a GPU, the XLA "
                        "engine elsewhere")


def _tile_rows(args) -> int:
    """Tile height for the commands without a per-engine default."""
    return 128 if args.tile_rows is None else args.tile_rows


def _parse(args):
    option = OptionParams(s0=args.s0, t=args.t, k=args.k, r=args.r,
                          sigma=args.sigma, barrier=args.barrier,
                          p1=args.p1, p2=args.p2, q=args.q)
    sim = SimParams(n_paths=args.n_paths, n_steps=args.n_steps,
                    n_paths_inner=args.n_inner, seed=args.seed)
    return option, sim


def _fmt(label, res, bs=None):
    line = (f"  {label:<38s} {float(res.price):>10.4f} "
            f"+/- {float(res.stderr):.4f}")
    if bs is not None:
        dev = abs(float(res.price) - bs) / max(float(res.stderr), 1e-12)
        line += f"   ({dev:.2f} se from BS)"
    return line


def cmd_demo(args):
    from mc_tpu import price
    from mc_tpu.nmc import price_nmc
    from mc_tpu.oracle import bs_call
    from mc_tpu.utils import device_summary

    # The reference demo's sizes on a GPU (hello.cu:5-19: 100k outer x
    # 1000 inner NMC paths); off the GPU the XLA engine runs the NMC leg
    # at a size that finishes in minutes unless the user pins values.
    on_gpu = jax.default_backend() == "gpu"
    if args.n_inner is None:
        args.n_inner = 1_000 if on_gpu else 64
    if args.nmc_max_paths is None:
        args.nmc_max_paths = args.n_paths if on_gpu else 256

    option, sim = _parse(args)
    print(device_summary())
    if not on_gpu:
        print("(no GPU: XLA engine; NMC leg scaled to "
              f"{min(sim.n_paths, args.nmc_max_paths)}x{args.n_inner} — "
              "pass --n-inner/--nmc-max-paths to override)")
    print(f"\nConfig: S0={args.s0} K={args.k} T={args.t} r={args.r} "
          f"sigma={args.sigma} B={args.barrier} window=[{args.p1},{args.p2}] "
          f"N={sim.n_paths} steps={sim.n_steps} inner={sim.n_paths_inner}")
    bs = float(bs_call(args.s0, args.k, args.t, args.r, args.sigma,
                       args.q))

    # CPU reference pricers beside the device rows — the reference demo's
    # at-a-glance cross-check (hello.cu:28-33, wrapper_cpu_option_vanilla
    # + wrapper_cpu_bullet_option).  Same threefry stream as the device
    # engines (native C++ mirror), so agreement is exact-distribution,
    # not merely statistical.
    if not args.skip_cpu:
        try:
            from types import SimpleNamespace

            from mc_tpu import rng as _rng
            from mc_tpu.native.lib import price_cpu

            ck = _rng.derive_key(sim.seed, 0)
            cpu_n = min(sim.n_paths, args.cpu_max_paths)
            print(f"\nCPU reference pricers (native C++, {cpu_n} paths; "
                  f"vs wrapper_cpu_*):")
            for label, payoff_name in (("CPU vanilla", "vanilla_call"),
                                       ("CPU bullet", "bullet_call")):
                p, se = price_cpu(payoff_name, ck, cpu_n, sim.n_steps,
                                  s0=args.s0, k=args.k, r=args.r,
                                  sigma=args.sigma, t=args.t,
                                  barrier=args.barrier, p1=args.p1,
                                  p2=args.p2, q=args.q)
                res = SimpleNamespace(price=p, stderr=se)
                print(_fmt(label, res,
                           bs if payoff_name == "vanilla_call" else None))
        except Exception as e:  # native lib unbuildable: demo still runs
            print(f"\n(CPU reference pricers unavailable: {e})")

    def mc(**kw):
        return price(option, sim, engine=args.engine,
                     tile_rows=args.tile_rows, **kw)

    print("\nVanilla European call (vs wrapper_gpu_option_vanilla):")
    print(_fmt("terminal (exact one-shot draw)", mc(), bs))
    print(_fmt("terminal_pair (both BM halves)",
               mc(method="terminal_pair"), bs))
    print(_fmt("euler (step loop)", mc(method="euler"), bs))
    print(_fmt("antithetic", mc(antithetic=True), bs))
    print(_fmt("antithetic + control variate",
               mc(method="euler", antithetic=True, control_variate=True),
               bs))

    print("\nBullet option (vs wrapper_gpu_bullet_option[_atomic]):")
    print(_fmt("bullet", mc(payoff="bullet_call")))
    print(_fmt("bullet antithetic", mc(payoff="bullet_call",
                                         antithetic=True)))

    if not args.skip_nmc:
        nmc_sim = sim.replace(n_paths=min(sim.n_paths, args.nmc_max_paths))
        print(f"\nNested MC (vs wrapper_gpu_bullet_option_nmc_*; "
              f"{nmc_sim.n_paths} outer paths):")
        res = price_nmc(option, nmc_sim, engine=args.engine)
        print(_fmt("outer estimate", res.outer))
        print(f"  {'surface mean over all points':<38s} "
              f"{float(res.surface_mean):>10.4f}")

    print(f"\n  {'Black-Scholes closed form':<38s} {bs:>10.4f}"
          f"   (BlackandScholes.hpp:34-43)")
    return 0


def cmd_price(args):
    from mc_tpu import price
    from mc_tpu.oracle import bs_call

    option, sim = _parse(args)
    shift = args.importance_shift
    if shift not in (None, "auto"):
        shift = float(shift)
    res = price(option, sim, payoff=args.payoff, engine=args.engine,
                antithetic=args.antithetic,
                control_variate=args.control_variate,
                importance_shift=shift if shift is not None else 0.0,
                tile_rows=args.tile_rows)
    out = {
        "payoff": args.payoff,
        "price": float(res.price),
        "stderr": float(res.stderr),
        "n_paths": int(float(res.n_paths)),
    }
    if args.payoff in ("vanilla_call", "vanilla_put"):
        out["black_scholes"] = float(
            bs_call(args.s0, args.k, args.t, args.r, args.sigma, args.q))
        if args.payoff == "vanilla_call":
            from mc_tpu.oracle import bs_implied_vol
            out["implied_vol"] = float(bs_implied_vol(
                res.price, args.s0, args.k, args.t, args.r, args.q))
    elif args.payoff == "digital_call":
        from mc_tpu.oracle import bs_digital_call
        out["closed_form"] = float(bs_digital_call(
            args.s0, args.k, args.t, args.r, args.sigma, args.q))
    elif args.payoff in ("up_out_call_bb", "down_out_call_bb"):
        from mc_tpu.oracle import bs_down_out_call, bs_up_out_call
        fn = (bs_up_out_call if args.payoff == "up_out_call_bb"
              else bs_down_out_call)
        out["closed_form_continuous_barrier"] = fn(
            args.s0, args.k, args.t, args.r, args.sigma, args.barrier,
            q=args.q)
    print(json.dumps(out))
    return 0


def _xva_outputs(res, args, out):
    """Shared XVA rows (DVA/BCVA/FVA/collateral) for single-contract and
    book NMC results — both carry the ExposureMetrics mixin."""
    import numpy as np
    if args.dva_hazard is not None:
        out["dva"] = float(res.dva(args.dva_hazard, args.cva_recovery))
        if args.cva_hazard is not None:
            out["bilateral_cva"] = float(res.bilateral_cva(
                args.cva_hazard, args.dva_hazard, args.cva_recovery,
                args.cva_recovery))
    if args.fva_spread is not None:
        fca, fba = res.fva(args.fva_spread)
        out["fca"], out["fba"] = float(fca), float(fba)
    if args.collateral_threshold is not None:
        c = res.collateralized(args.collateral_threshold,
                               mta=args.mta, mpor_steps=args.mpor_steps)
        cee, _ = c.exposure_profile(args.pfe_quantile)
        out["collateralized_ee"] = [round(float(x), 6)
                                    for x in np.asarray(cee)]
        if args.cva_hazard is not None:
            out["collateralized_cva"] = float(
                c.cva(args.cva_hazard, args.cva_recovery))
    if args.im_quantile is not None:
        im = res.im_profile(args.im_quantile,
                            mpor_steps=max(args.mpor_steps, 1))
        out["initial_margin"] = [round(float(x), 6)
                                 for x in np.asarray(im)]
        if args.mva_spread is not None:
            out["mva"] = float(res.mva(args.mva_spread,
                                       args.im_quantile,
                                       max(args.mpor_steps, 1)))
    if args.cva_hazard is not None and args.wwr_beta is not None:
        out["cva_wwr"] = float(res.cva_wwr(
            args.cva_hazard, args.wwr_beta, args.cva_recovery))
    if (args.cva_hazard is not None
            and args.wwr_spot_beta is not None):
        if not hasattr(res, "cva_wwr_spot"):
            raise SystemExit("--wwr-spot-beta needs a single-contract "
                             "NMC surface (books carry no spot grid)")
        out["cva_wwr_spot"] = float(res.cva_wwr_spot(
            args.cva_hazard, args.wwr_spot_beta, args.cva_recovery))
    return out


def cmd_nmc(args):
    from mc_tpu.nmc import price_nmc

    option, sim = _parse(args)
    dyn = None  # set by the model branches; cva_greeks reuses it
    if args.book_strikes:
        # Netting-set NMC: one contract per strike, netted EE/PFE/CVA;
        # --model nets the book under that family's dynamics.
        if args.cva_greeks:
            raise SystemExit("--cva-greeks differentiates a single "
                             "contract's CVA; not supported with "
                             "--book-strikes")
        import numpy as np

        from mc_tpu.nmc_book import price_nmc_book
        ks = [float(x) for x in args.book_strikes.split(",")]
        ws = ([float(x) for x in args.book_weights.split(",")]
              if args.book_weights else None)
        book = OptionParams(
            s0=np.full(len(ks), args.s0, np.float32),
            k=np.asarray(ks, np.float32),
            t=np.full(len(ks), args.t, np.float32),
            r=np.full(len(ks), args.r, np.float32),
            sigma=np.full(len(ks), args.sigma, np.float32),
            barrier=np.full(len(ks), args.barrier, np.float32),
            p1=np.full(len(ks), args.p1, np.float32),
            p2=np.full(len(ks), args.p2, np.float32),
            q=np.full(len(ks), args.q, np.float32))
        res = price_nmc_book(book, sim, payoff=args.payoff, weights=ws,
                             model=args.model)
        ee, pfe = res.exposure_profile(args.pfe_quantile)
        out = {
            "n_contracts": len(ks),
            "net_outer_price": float(res.net_outer_price),
            "per_contract_price": [round(float(x), 6)
                                   for x in np.asarray(res.outers.price)],
            "netted_ee": [round(float(x), 6) for x in np.asarray(ee)],
            "netted_pfe": [round(float(x), 6) for x in np.asarray(pfe)],
            "sum_of_standalone_ee": [
                round(float(x), 6)
                for x in np.asarray(res.ee_contract).sum(axis=0)],
        }
        if args.cva_hazard is not None:
            out["netted_cva"] = float(res.cva(args.cva_hazard,
                                              args.cva_recovery))
        out = _xva_outputs(res, args, out)
        print(json.dumps(out))
        return 0
    if args.model == "heston":
        if args.discount != "full":
            raise SystemExit("--discount is fixed (full) with --model heston")
        from mc_tpu.models.heston import HestonDynamics
        from mc_tpu.nmc_heston import price_nmc_heston
        dyn = HestonDynamics(v0=args.v0, kappa=args.kappa,
                             theta=args.theta_v, xi=args.xi,
                             rho=args.rho_sv)
        res = price_nmc_heston(option, dyn, sim, payoff=args.payoff)
    elif args.model == "localvol":
        if args.discount != "full":
            raise SystemExit("--discount is fixed (full) with --model localvol")
        from mc_tpu.models.localvol import LocalVolSurface
        from mc_tpu.nmc_localvol import price_nmc_localvol
        dyn = LocalVolSurface.from_function(
            lambda x, t: args.sigma + args.smile_curv * x * x,
            sim.n_steps)
        res = price_nmc_localvol(option, dyn, sim, payoff=args.payoff)
    elif args.model == "vasicek":
        if args.discount != "full":
            raise SystemExit("--discount is fixed (full) with --model vasicek")
        from mc_tpu.models.vasicek import VasicekDynamics
        from mc_tpu.nmc_vasicek import price_nmc_vasicek
        dyn = VasicekDynamics(a=args.a, b=args.b, sigma_r=args.sigma_r,
                              rho=args.rho_r)
        res = price_nmc_vasicek(option, dyn, sim, payoff=args.payoff)
    elif args.model == "bates":
        if args.discount != "full":
            raise SystemExit("--discount is fixed (full) with --model bates")
        from mc_tpu.models.bates import BatesDynamics
        from mc_tpu.nmc_bates import price_nmc_bates
        dyn = BatesDynamics(v0=args.v0, kappa=args.kappa,
                            theta=args.theta_v, xi=args.xi,
                            rho=args.rho_sv, lam=args.lam,
                            mu_j=args.mu_j, sigma_j=args.sigma_j)
        res = price_nmc_bates(option, dyn, sim, payoff=args.payoff)
    elif args.model == "merton":
        if args.discount != "full":
            raise SystemExit("--discount is fixed (full) with --model merton")
        from mc_tpu.models.merton import MertonDynamics
        from mc_tpu.nmc_merton import price_nmc_merton
        dyn = MertonDynamics(lam=args.lam, mu_j=args.mu_j,
                             sigma_j=args.sigma_j)
        res = price_nmc_merton(option, dyn, sim, payoff=args.payoff)
    elif args.model == "term":
        if args.discount != "full":
            raise SystemExit("--discount is fixed (full) with --model term")
        from mc_tpu.nmc_term import price_nmc_term
        res = price_nmc_term(option, None, sim, payoff=args.payoff)
    elif args.model == "cev":
        if args.discount != "full":
            raise SystemExit("--discount is fixed (full) with --model cev")
        from mc_tpu.models.cev import CEVDynamics
        from mc_tpu.nmc_cev import price_nmc_cev
        dyn = CEVDynamics.from_atm_vol(args.sigma_atm, args.beta, args.s0)
        res = price_nmc_cev(option, dyn, sim, payoff=args.payoff)
    elif args.model == "sabr":
        if args.discount != "full":
            raise SystemExit("--discount is fixed (full) with --model sabr")
        from mc_tpu.models.sabr import SABRDynamics
        from mc_tpu.nmc_sabr import price_nmc_sabr
        dyn = SABRDynamics(alpha=args.alpha, nu=args.nu,
                           rho=args.rho_sv)
        res = price_nmc_sabr(option, dyn, sim, payoff=args.payoff)
    elif args.model == "basket":
        if args.discount != "full":
            raise SystemExit("--discount is fixed (full) with --model basket")
        from mc_tpu.models.basket import _demo_basket
        from mc_tpu.nmc_basket import price_nmc_basket
        dyn = _demo_basket(d=args.n_assets, rho=args.corr)
        res = price_nmc_basket(option, dyn, sim, payoff=args.payoff)
    elif args.model == "rainbow":
        if args.discount != "full":
            raise SystemExit("--discount is fixed (full) with --model rainbow")
        from mc_tpu.models.basket import _demo_basket
        from mc_tpu.nmc_rainbow import price_nmc_rainbow
        dyn = _demo_basket(d=args.n_assets, rho=args.corr)
        res = price_nmc_rainbow(option, dyn, sim, payoff=args.payoff)
    else:
        res = price_nmc(option, sim, payoff=args.payoff,
                        engine=args.engine, discount=args.discount)
    out = {
        "outer_price": float(res.outer.price),
        "outer_stderr": float(res.outer.stderr),
        "surface_mean": float(res.surface_mean),
        "n_points": int(float(res.n_points)),
    }
    if args.exposure:
        ee, pfe = res.exposure_profile(args.pfe_quantile)
        import numpy as np
        out["expected_exposure"] = [round(float(x), 6)
                                    for x in np.asarray(ee)]
        out["pfe"] = [round(float(x), 6) for x in np.asarray(pfe)]
        if args.cva_hazard is not None:
            out["cva"] = float(res.cva(args.cva_hazard, args.cva_recovery,
                                       t_horizon=args.t))
        out = _xva_outputs(res, args, out)
    if args.cva_greeks:
        if args.cva_hazard is None:
            raise SystemExit("--cva-greeks needs --cva-hazard")
        from mc_tpu.greeks import cva_greeks
        g = cva_greeks(option, sim, args.payoff,
                       hazard_rate=args.cva_hazard,
                       recovery=args.cva_recovery,
                       which=tuple(args.cva_greeks.split(",")),
                       model=None if args.model == "gbm" else args.model,
                       dyn=dyn)
        out["cva_greeks"] = {k: float(v) for k, v in g.items()}
    if args.surface_npz:
        import numpy as np
        np.savez_compressed(args.surface_npz,
                            surface=np.asarray(res.surface_matrix()))
        out["surface_npz"] = args.surface_npz
    print(json.dumps(out))
    return 0


def cmd_traj(args):
    """CSV trajectory dump in the reference's tidy format (testing.cu:37-47:
    ``time,trajectory,value`` rows, one per (step, path))."""
    import numpy as np
    from mc_tpu import simulate_trajectories

    option, sim = _parse(args)
    traj = simulate_trajectories(option, sim, payoff=args.payoff,
                                 tile_rows=8, engine=args.engine)
    mat = np.asarray(traj.path_matrix())  # (paths, steps)
    n_paths, n_steps = mat.shape
    try:
        from mc_tpu.native import lib as native_lib
    except Exception:
        native_lib = None
    if native_lib is not None and native_lib.available:
        native_lib.write_traj_csv(args.out, mat)
    else:
        with open(args.out, "w") as f:
            f.write("time,trajectory,value\n")
            for j in range(n_steps):
                for i in range(n_paths):
                    f.write(f"{j},{i},{mat[i, j]:.6f}\n")
    out = {"csv": args.out, "trajectories": n_paths, "steps": n_steps}
    if args.plot:
        # The reference's golden plots (imgs/all_the_trajectories.png,
        # readme.md:3) — every trajectory over time, barrier marked.
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(10, 6))
        steps = np.arange(1, n_steps + 1)
        for i in range(min(n_paths, args.plot_max)):
            ax.plot(steps, mat[i], lw=0.6, alpha=0.5)
        ax.axhline(args.barrier, color="black", ls="--", lw=1.2,
                   label=f"barrier B={args.barrier}")
        ax.axhline(args.k, color="gray", ls=":", lw=1.0,
                   label=f"strike K={args.k}")
        ax.set_xlabel("step")
        ax.set_ylabel("S")
        ax.set_title(f"{min(n_paths, args.plot_max)} GBM trajectories "
                     f"(S0={args.s0}, sigma={args.sigma}, r={args.r})")
        ax.legend(loc="upper left")
        fig.tight_layout()
        fig.savefig(args.plot, dpi=120)
        out["plot"] = args.plot
    print(json.dumps(out))
    return 0


def cmd_heston(args):
    from mc_tpu.models.heston import (HestonDynamics, heston_call_cf,
                                      price_heston)

    option, sim = _parse(args)
    dyn = HestonDynamics(v0=args.v0, kappa=args.kappa, theta=args.theta_v,
                         xi=args.xi, rho=args.rho_sv)
    res = price_heston(option, dyn, sim, payoff=args.payoff,
                       scheme=args.scheme,
                       antithetic=args.antithetic,
                       tile_rows=_tile_rows(args))
    out = {"payoff": args.payoff, "scheme": args.scheme,
           "price": float(res.price), "stderr": float(res.stderr)}
    if args.payoff == "vanilla_call":
        out["cf_oracle"] = heston_call_cf(args.s0, args.k, args.t, args.r,
                                          args.v0, args.kappa, args.theta_v,
                                          args.xi, args.rho_sv, q=args.q)
    print(json.dumps(out))
    return 0


def cmd_bates(args):
    from mc_tpu.models.bates import (BatesDynamics, bates_call_cf,
                                     price_bates)

    option, sim = _parse(args)
    dyn = BatesDynamics(v0=args.v0, kappa=args.kappa, theta=args.theta_v,
                        xi=args.xi, rho=args.rho_sv, lam=args.lam,
                        mu_j=args.mu_j, sigma_j=args.sigma_j)
    res = price_bates(option, dyn, sim, payoff=args.payoff,
                      scheme=args.scheme,
                      antithetic=args.antithetic,
                      tile_rows=_tile_rows(args))
    out = {"payoff": args.payoff, "scheme": args.scheme,
           "price": float(res.price), "stderr": float(res.stderr)}
    if args.payoff == "vanilla_call":
        out["cf_oracle"] = bates_call_cf(
            args.s0, args.k, args.t, args.r, args.v0, args.kappa,
            args.theta_v, args.xi, args.rho_sv, args.lam, args.mu_j,
            args.sigma_j, q=args.q)
    print(json.dumps(out))
    return 0


def cmd_fx(args):
    from mc_tpu import oracle
    from mc_tpu.models.fx import FXDynamics, price_fx

    option, sim = _parse(args)
    fx = FXDynamics(x0=args.x0, sigma_x=args.sigma_x, r_f=args.rf,
                    rho=args.rho_fx, kx=args.kx, x_bar=args.x_bar)
    res = price_fx(option, fx, sim, args.contract, tile_rows=_tile_rows(args))
    kx = args.x0 if args.kx is None else args.kx
    xb = args.x0 if args.x_bar is None else args.x_bar
    ref = {
        "gk_call": lambda: oracle.gk_call(args.x0, kx, args.t, args.r,
                                          args.rf, args.sigma_x),
        "gk_put": lambda: oracle.gk_put(args.x0, kx, args.t, args.r,
                                        args.rf, args.sigma_x),
        "quanto_call": lambda: oracle.quanto_call(
            args.s0, args.k, args.t, args.r, args.rf, args.sigma,
            args.sigma_x, args.rho_fx, args.q, xb),
        "quanto_put": lambda: oracle.quanto_put(
            args.s0, args.k, args.t, args.r, args.rf, args.sigma,
            args.sigma_x, args.rho_fx, args.q, xb),
        "compo_call": lambda: oracle.compo_call(
            args.s0, args.x0, args.k, args.t, args.r, args.sigma,
            args.sigma_x, args.rho_fx, args.q),
        "compo_put": lambda: oracle.compo_put(
            args.s0, args.x0, args.k, args.t, args.r, args.sigma,
            args.sigma_x, args.rho_fx, args.q),
        "flexo_call": lambda: oracle.flexo_call(
            args.s0, args.x0, args.k, args.t, args.rf, args.sigma,
            args.q),
        "flexo_put": lambda: oracle.flexo_put(
            args.s0, args.x0, args.k, args.t, args.rf, args.sigma,
            args.q),
    }[args.contract]()
    z = (float(res.price) - ref) / max(float(res.stderr), 1e-12)
    print(json.dumps({"contract": args.contract,
                      "price": float(res.price),
                      "stderr": float(res.stderr),
                      "oracle": ref, "z": round(z, 3)}))
    return 0


def cmd_american(args):
    from mc_tpu.lsmc import (binomial_american, price_american,
                             price_american_basket, price_american_heston)

    option, sim = _parse(args)
    if args.exposure:
        import numpy as np

        from mc_tpu.lsmc import american_exposure_family
        if args.model == "gbm":
            raise SystemExit("--exposure runs on the family engine: "
                             "pick --model heston|bates|cev|merton|sabr|"
                             "localvol|vasicek|basket|rainbow")
        dyn = None
        if args.model in ("basket", "rainbow"):
            from mc_tpu.models.basket import _demo_basket
            dyn = _demo_basket(d=args.n_assets, rho=args.corr)
        e = american_exposure_family(
            args.model, option, dyn, sim, payoff=args.payoff,
            degree=args.degree, exercise_every=args.exercise_every,
            n_inner=args.bounds_inner)
        ee, pfe = e.exposure_profile()
        out = {"payoff": args.payoff, "model": args.model,
               "american_ee": [round(float(x), 6)
                               for x in np.asarray(ee)],
               "american_pfe": [round(float(x), 6)
                                for x in np.asarray(pfe)]}
        if args.cva_hazard is not None:
            out["american_cva"] = float(e.cva(args.cva_hazard))
        print(json.dumps(out))
        return 0
    if args.model in ("cev", "merton", "sabr", "bates"):
        raise SystemExit(
            f"--model {args.model}: the CLI offers --exposure for this "
            "family (prices/bounds: lsmc.price_american_family / "
            "american_bounds_family in the library)")
    if args.greeks:
        if args.model not in ("gbm", "heston"):
            raise SystemExit("--greeks supports --model gbm|heston")
        from mc_tpu.lsmc import american_greeks
        g = american_greeks(option, sim, payoff=args.payoff,
                            model=args.model, degree=args.degree,
                            exercise_every=args.exercise_every)
        out = {"payoff": args.payoff, "model": args.model}
        out.update({k: round(v, 6) for k, v in g.items()})
        if args.model == "gbm" and args.payoff in ("vanilla_put",
                                                   "vanilla_call"):
            kind = "put" if args.payoff == "vanilla_put" else "call"
            h, hv = 0.5, 0.005
            f = lambda s: binomial_american(s, args.k, args.t, args.r,
                                            args.sigma, kind=kind,
                                            div_yield=args.q)
            fv = lambda sg: binomial_american(args.s0, args.k, args.t,
                                              args.r, sg, kind=kind,
                                              div_yield=args.q)
            out["crr_delta"] = round((f(args.s0 + h) - f(args.s0 - h))
                                     / (2 * h), 6)
            out["crr_vega"] = round((fv(args.sigma + hv)
                                     - fv(args.sigma - hv)) / (2 * hv), 6)
        print(json.dumps(out))
        return 0
    if args.model in ("basket", "rainbow") and args.bounds:
        from mc_tpu.lsmc import american_bounds_family
        from mc_tpu.models.basket import _demo_basket
        dyn = _demo_basket(d=args.n_assets, rho=args.corr)
        lo, up = american_bounds_family(
            args.model, option, dyn, sim, payoff=args.payoff,
            degree=args.degree, n_inner=args.bounds_inner,
            exercise_every=args.exercise_every)
        print(json.dumps({
            "payoff": args.payoff, "model": args.model,
            "n_assets": args.n_assets,
            "lower": float(lo.price),
            "lower_stderr": float(lo.stderr),
            "upper": float(up.price),
            "upper_stderr": float(up.stderr),
            "gap": float(up.price) - float(lo.price)}))
        return 0
    if args.model == "basket":
        from mc_tpu.models.basket import _demo_basket
        dyn = _demo_basket(d=args.n_assets, rho=args.corr)
        res = price_american_basket(option, dyn, sim, payoff=args.payoff,
                                    degree=args.degree, two_pass=True,
                                    exercise_every=args.exercise_every)
        print(json.dumps({"payoff": args.payoff, "model": "basket",
                          "n_assets": args.n_assets,
                          "price": float(res.price),
                          "stderr": float(res.stderr)}))
        return 0
    if args.model == "rainbow":
        from mc_tpu.lsmc import price_american_rainbow
        from mc_tpu.models.basket import _demo_basket
        dyn = _demo_basket(d=args.n_assets, rho=args.corr)
        res = price_american_rainbow(option, dyn, sim,
                                     payoff=args.payoff,
                                     degree=args.degree, two_pass=True,
                                     exercise_every=args.exercise_every)
        print(json.dumps({"payoff": args.payoff, "model": "rainbow",
                          "n_assets": args.n_assets,
                          "price": float(res.price),
                          "stderr": float(res.stderr)}))
        return 0
    if args.model == "localvol":
        from mc_tpu.models.localvol import LocalVolSurface
        surf = LocalVolSurface.from_function(
            lambda x, t: (args.sigma + args.smile_curv * x * x),
            sim.n_steps)
        if args.bounds:
            from mc_tpu.lsmc import american_bounds_family
            lo, up = american_bounds_family(
                "localvol", option, surf, sim, payoff=args.payoff,
                degree=args.degree, n_inner=args.bounds_inner,
                exercise_every=args.exercise_every)
            print(json.dumps({
                "payoff": args.payoff, "model": "localvol",
                "lower": float(lo.price),
                "lower_stderr": float(lo.stderr),
                "upper": float(up.price),
                "upper_stderr": float(up.stderr),
                "gap": float(up.price) - float(lo.price)}))
            return 0
        from mc_tpu.lsmc import price_american_localvol
        res = price_american_localvol(option, surf, sim,
                                      payoff=args.payoff,
                                      degree=args.degree, two_pass=True,
                                      exercise_every=args.exercise_every)
        print(json.dumps({"payoff": args.payoff, "model": "localvol",
                          "price": float(res.price),
                          "stderr": float(res.stderr)}))
        return 0
    if args.model == "vasicek":
        if args.bounds:
            raise SystemExit("--bounds is not supported with "
                             "--model vasicek yet")
        from mc_tpu.lsmc import price_american_vasicek
        from mc_tpu.models.vasicek import VasicekDynamics
        dyn = VasicekDynamics(a=args.a, b=args.b, sigma_r=args.sigma_r,
                              rho=args.rho_r)
        res = price_american_vasicek(option, dyn, sim, payoff=args.payoff,
                                     degree=args.degree, two_pass=True,
                                     exercise_every=args.exercise_every)
        print(json.dumps({"payoff": args.payoff, "model": "vasicek",
                          "price": float(res.price),
                          "stderr": float(res.stderr)}))
        return 0
    if args.model == "heston":
        from mc_tpu.models.heston import HestonDynamics
        hes = HestonDynamics(v0=args.v0, kappa=args.kappa,
                             theta=args.theta_h, xi=args.xi, rho=args.rho)
        if args.bounds:
            from mc_tpu.lsmc import american_bounds
            lo, up = american_bounds(option, sim, payoff=args.payoff,
                                     heston=hes, degree=args.degree,
                                     n_inner=args.bounds_inner,
                                     exercise_every=args.exercise_every)
            print(json.dumps({
                "payoff": args.payoff, "model": "heston",
                "lower": float(lo.price),
                "lower_stderr": float(lo.stderr),
                "upper": float(up.price),
                "upper_stderr": float(up.stderr),
                "gap": float(up.price) - float(lo.price)}))
            return 0
        res = price_american_heston(option, hes, sim, payoff=args.payoff,
                                    degree=args.degree, two_pass=True,
                                    exercise_every=args.exercise_every)
        one = price_american_heston(option, hes, sim, payoff=args.payoff,
                                    degree=args.degree, two_pass=False,
                                    exercise_every=args.exercise_every)
        out = {"payoff": args.payoff, "model": "heston",
               "price": float(res.price), "stderr": float(res.stderr),
               "one_pass": float(one.price),
               "one_pass_stderr": float(one.stderr)}
        print(json.dumps(out))
        return 0
    if args.bounds:
        from mc_tpu.lsmc import american_bounds
        lo, up = american_bounds(option, sim, payoff=args.payoff,
                                 degree=args.degree,
                                 n_inner=args.bounds_inner,
                                 exercise_every=args.exercise_every)
        print(json.dumps({
            "payoff": args.payoff,
            "lower": float(lo.price), "lower_stderr": float(lo.stderr),
            "upper": float(up.price), "upper_stderr": float(up.stderr),
            "gap": float(up.price) - float(lo.price)}))
        return 0
    res = price_american(option, sim, payoff=args.payoff,
                         degree=args.degree, two_pass=True,
                         exercise_every=args.exercise_every)
    one = price_american(option, sim, payoff=args.payoff,
                         degree=args.degree, two_pass=False,
                         exercise_every=args.exercise_every)
    out = {"payoff": args.payoff, "price": float(res.price),
           "stderr": float(res.stderr),
           # in-sample estimator: the (price, one_pass) spread brackets
           # the regression error
           "one_pass": float(one.price),
           "one_pass_stderr": float(one.stderr)}
    if args.payoff in ("vanilla_put", "vanilla_call"):
        out["binomial_oracle"] = binomial_american(
            args.s0, args.k, args.t, args.r, args.sigma,
            kind="put" if args.payoff.endswith("put") else "call",
            div_yield=args.q)
    print(json.dumps(out))
    return 0


def cmd_ladder(args):
    import numpy as np
    from mc_tpu.engines import price_ladder

    option, sim = _parse(args)
    strikes = np.linspace(args.k_min, args.k_max, args.n_strikes)
    res = price_ladder(strikes, option, sim, payoff=args.payoff,
                       antithetic=args.antithetic,
                       tile_rows=_tile_rows(args))
    print(json.dumps({
        "strikes": [round(float(k), 6) for k in strikes],
        "prices": [round(float(p), 6) for p in np.asarray(res.price)],
        "stderrs": [round(float(s), 6) for s in np.asarray(res.stderr)],
        "n_paths": sim.n_paths,
    }))
    return 0


def cmd_greeks(args):
    from mc_tpu.greeks import greeks

    option, sim = _parse(args)
    if args.which is None:
        # LRM supports only the density parameters; default per method
        args.which = ("delta,vega,rho" if args.method == "lrm"
                      else "delta,vega,rho,theta")
    which = tuple(args.which.split(","))
    g = greeks(option, sim, payoff=args.payoff, method=args.method,
               which=which, antithetic=args.antithetic, engine=args.engine,
               tile_rows=_tile_rows(args))
    print(json.dumps({k: float(v) for k, v in g.items()}))
    return 0


def cmd_qmc(args):
    from mc_tpu.oracle import bs_call
    from mc_tpu.qmc import price_qmc, price_qmc_model

    option, sim = _parse(args)
    if args.model != "gbm":
        res = price_qmc_model(args.model, option, None, sim,
                              payoff=args.payoff, family=args.family,
                              n_shifts=args.n_shifts,
                              tile_rows=_tile_rows(args))
        out = {"model": args.model, "price": float(res.price),
               "stderr": float(res.stderr),
               "point_n": int(float(res.n_paths)) // args.n_shifts,
               "n_shifts": args.n_shifts}
        if args.model == "heston" and args.payoff == "vanilla_call":
            from mc_tpu.models.heston import DEMO_HESTON, heston_call_cf
            out["cf_oracle"] = float(heston_call_cf(
                args.s0, args.k, args.t, args.r,
                *DEMO_HESTON.astuple(), q=args.q))
        if args.model == "bates" and args.payoff == "vanilla_call":
            from mc_tpu.models.bates import DEMO_BATES, bates_call_cf
            out["cf_oracle"] = float(bates_call_cf(
                args.s0, args.k, args.t, args.r,
                *DEMO_BATES.astuple(), q=args.q))
        print(json.dumps(out))
        return 0
    res = price_qmc(option, sim, payoff=args.payoff, family=args.family,
                    n_shifts=args.n_shifts, tile_rows=_tile_rows(args))
    out = {"price": float(res.price), "stderr": float(res.stderr),
           "lattice_n": int(float(res.n_paths)) // args.n_shifts,
           "n_shifts": args.n_shifts}
    if args.payoff in ("vanilla_call", "vanilla_put"):
        out["black_scholes"] = float(
            bs_call(args.s0, args.k, args.t, args.r, args.sigma, args.q))
    print(json.dumps(out))
    return 0


def cmd_bench(args):
    import os
    import subprocess
    bench = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench.py")
    if not os.path.exists(bench):
        bench = "bench.py"  # installed layouts: fall back to cwd
    return subprocess.call([sys.executable, bench])


def cmd_info(args):
    from mc_tpu.utils import device_summary
    print(device_summary())
    return 0


def cmd_cev(args):
    from mc_tpu.models.cev import (CEVDynamics, cev_call_closed_form,
                                   price_cev)

    option, sim = _parse(args)
    dyn = CEVDynamics.from_atm_vol(args.sigma_atm, args.beta, args.s0)
    res = price_cev(option, dyn, sim, payoff=args.payoff,
                    antithetic=args.antithetic,
                    tile_rows=_tile_rows(args))
    out = {"payoff": args.payoff, "price": float(res.price),
           "stderr": float(res.stderr), "beta": args.beta}
    if args.payoff == "vanilla_call":
        try:
            out["ncx2_oracle"] = float(cev_call_closed_form(
                args.s0, args.k, args.t, args.r,
                float(dyn.sigma_lv), args.beta, q=args.q))
        except Exception:
            pass
    print(json.dumps(out))
    return 0


def cmd_merton(args):
    from mc_tpu.models.merton import (MertonDynamics,
                                      merton_call_closed_form, price_merton)

    option, sim = _parse(args)
    dyn = MertonDynamics(lam=args.lam, mu_j=args.mu_j, sigma_j=args.sigma_j)
    res = price_merton(option, dyn, sim, payoff=args.payoff,
                       method=args.method, antithetic=args.antithetic,
                       tile_rows=_tile_rows(args))
    out = {"payoff": args.payoff, "price": float(res.price),
           "stderr": float(res.stderr), "lam": args.lam}
    if args.payoff == "vanilla_call":
        out["merton_series_oracle"] = merton_call_closed_form(
            args.s0, args.k, args.t, args.r, args.sigma,
            lam=args.lam, mu_j=args.mu_j, sigma_j=args.sigma_j, q=args.q)
    print(json.dumps(out))
    return 0


def cmd_sabr(args):
    from mc_tpu.models.sabr import (SABRDynamics, price_sabr,
                                    sabr_call_hagan, sabr_implied_vol)
    from mc_tpu.oracle import bs_implied_vol

    option, sim = _parse(args)
    dyn = SABRDynamics(alpha=args.alpha, beta=args.beta, nu=args.nu,
                       rho=args.rho_fv)
    res = price_sabr(option, dyn, sim, payoff=args.payoff,
                     antithetic=args.antithetic,
                     tile_rows=_tile_rows(args))
    out = {"payoff": args.payoff, "price": float(res.price),
           "stderr": float(res.stderr)}
    if args.payoff == "vanilla_call":
        import math
        out["hagan_oracle"] = sabr_call_hagan(
            args.s0, args.k, args.t, args.r, alpha=args.alpha,
            beta=args.beta, nu=args.nu, rho=args.rho_fv, q=args.q)
        f = args.s0 * math.exp((args.r - args.q) * args.t)
        out["hagan_implied_vol"] = sabr_implied_vol(
            f, args.k, args.t, args.alpha, args.beta, args.nu, args.rho_fv)
        out["mc_implied_vol"] = float(bs_implied_vol(
            res.price, args.s0, args.k, args.t, args.r, args.q))
    print(json.dumps(out))
    return 0


def cmd_calibrate(args):
    """The full production loop on one command: MC prices under the given
    SABR dynamics -> implied vols -> Gauss-Newton fit -> recovered params.
    ``--model heston`` round-trips the CF oracle; ``--model localvol``
    extracts a Dupire surface and re-prices the smile under it."""
    import math

    import numpy as np

    from mc_tpu.calibrate import calibrate_sabr
    from mc_tpu.models.sabr import SABRDynamics, price_sabr
    from mc_tpu.oracle import bs_implied_vol

    option, sim = _parse(args)
    if args.model == "heston":
        from mc_tpu.calibrate import _bs_iv_host, calibrate_heston
        from mc_tpu.models.heston import heston_call_cf
        true = dict(v0=args.v0, kappa=args.kappa, theta=args.theta_v,
                    xi=args.xi, rho=args.rho_sv)
        ks = np.linspace(args.k_min, args.k_max, args.n_strikes)
        mats = np.array([0.5 * args.t, args.t, 2.0 * args.t])
        ivs = np.array([[_bs_iv_host(
            heston_call_cf(args.s0, k, t, args.r, q=args.q, **true),
            args.s0, k, t, args.r, args.q) for k in ks] for t in mats])
        fit = calibrate_heston(ks, mats, ivs, s0=args.s0, r=args.r,
                               q=args.q)
        print(json.dumps({"model": "heston", "true": true,
                          "fit": {"v0": fit.v0, "kappa": fit.kappa,
                                  "theta": fit.theta, "xi": fit.xi,
                                  "rho": fit.rho},
                          "iv_rmse": fit.rmse}))
        return 0
    if args.model == "hullwhite":
        from mc_tpu.calibrate import calibrate_hullwhite
        from mc_tpu.models.hullwhite import DEMO_CURVE
        from mc_tpu.oracle import hw_swaption
        true_a, true_sig = args.a, args.sigma_r
        quotes = []
        for (t0, tau, n) in ((0.5, 0.5, 6), (1.0, 0.5, 10),
                             (2.0, 0.5, 8), (5.0, 0.5, 6)):
            for k in (0.035, 0.045):
                px = hw_swaption(true_a, true_sig, DEMO_CURVE.df,
                                 t0, tau, n, k)
                quotes.append((t0, tau, n, k, px))
        fit = calibrate_hullwhite(DEMO_CURVE, quotes)
        print(json.dumps({"model": "hullwhite",
                          "true": {"a": true_a, "sigma_r": true_sig},
                          "fit": {"a": fit.a, "sigma_r": fit.sigma_r},
                          "price_rmse": fit.rmse,
                          "n_quotes": len(quotes)}))
        return 0
    if args.model == "g2pp":
        from mc_tpu.calibrate import calibrate_g2
        from mc_tpu.models.hullwhite import DEMO_CURVE
        from mc_tpu.oracle import g2_swaption
        true = (args.a, args.sigma_x, args.b_mr_cal, args.eta,
                args.rho_xy)
        quotes = []
        for t0 in (0.5, 1.0, 3.0):
            for (tau, n) in ((0.5, 10), (0.5, 4), (1.0, 7)):
                for k in (0.035, 0.05):
                    px = g2_swaption(*true, DEMO_CURVE.df, t0, tau, n,
                                     k, n_quad=801)
                    quotes.append((t0, tau, n, k, px))
        fit = calibrate_g2(DEMO_CURVE, quotes, n_iter=args.n_iter)
        # G2 has an exact (a, sigma) <-> (b_mr, eta) relabeling ridge:
        # judge by REPRICING (in-sample rmse + one out-of-sample quote),
        # never by parameter identity.
        oos = g2_swaption(fit.a, fit.sigma, fit.b_mr, fit.eta, fit.rho,
                          DEMO_CURVE.df, 2.0, 0.5, 6, 0.042, n_quad=801)
        oos_true = g2_swaption(*true, DEMO_CURVE.df, 2.0, 0.5, 6, 0.042,
                               n_quad=801)
        print(json.dumps({"model": "g2++",
                          "true": dict(zip(("a", "sigma", "b_mr", "eta",
                                            "rho"), true)),
                          "fit": {"a": fit.a, "sigma": fit.sigma,
                                  "b_mr": fit.b_mr, "eta": fit.eta,
                                  "rho": fit.rho},
                          "price_rmse": fit.rmse,
                          "oos_price": oos, "oos_true": oos_true,
                          "oos_abs_err": abs(oos - oos_true),
                          "n_quotes": len(quotes),
                          "n_iter": fit.n_iter}))
        return 0
    if args.model == "localvol":
        from mc_tpu.calibrate import calibrate_localvol
        from mc_tpu.models.localvol import price_localvol
        ks = np.linspace(args.k_min, args.k_max, args.n_strikes)
        mats = np.array([0.5 * args.t, args.t])

        def iv_fn(k):
            y = math.log(k / args.s0)
            return args.sigma - args.smile_skew * y + args.smile_curv * y * y

        ivs = np.array([[iv_fn(k) for k in ks] for _ in mats])
        surf = calibrate_localvol(ks, mats, ivs, s0=args.s0, r=args.r,
                                  q=args.q, n_steps=sim.n_steps,
                                  x_lo=-0.8, x_hi=0.8, n_knots=33)
        out = {"model": "localvol", "strikes": [float(k) for k in ks],
               "target_ivs": [iv_fn(k) for k in ks], "repriced_ivs": []}
        for k in ks:
            res = price_localvol(
                OptionParams(s0=args.s0, t=args.t, k=float(k), r=args.r,
                             q=args.q), surf, sim, tile_rows=_tile_rows(args))
            out["repriced_ivs"].append(float(bs_implied_vol(
                res.price, args.s0, float(k), args.t, args.r, args.q)))
        print(json.dumps(out))
        return 0
    dyn = SABRDynamics(alpha=args.alpha, beta=args.beta, nu=args.nu,
                       rho=args.rho_fv)
    ks = np.linspace(args.k_min, args.k_max, args.n_strikes,
                     dtype=np.float32)
    ivs = []
    for k in ks:
        res = price_sabr(
            OptionParams(s0=args.s0, t=args.t, k=float(k), r=args.r,
                         q=args.q),
            dyn, sim, antithetic=True,
            tile_rows=_tile_rows(args))
        ivs.append(float(bs_implied_vol(res.price, args.s0, k, args.t,
                                        args.r, args.q)))
    f = args.s0 * math.exp((args.r - args.q) * args.t)
    fit = calibrate_sabr(f, args.t, ks, np.asarray(ivs, np.float32),
                         beta=args.beta)
    print(json.dumps({
        "strikes": [float(k) for k in ks],
        "mc_implied_vols": ivs,
        "true": {"alpha": args.alpha, "nu": args.nu, "rho": args.rho_fv},
        "fitted": {"alpha": float(fit.alpha), "nu": float(fit.nu),
                   "rho": float(fit.rho)},
        "iv_rmse": float(fit.rmse)}))
    return 0


def cmd_divs(args):
    from mc_tpu.models.dividends import (bs_call_cash_div, div_schedule,
                                         price_divs)

    option, sim = _parse(args)
    steps = ([int(x) for x in args.div_steps.split(",")]
             if args.div_steps else [])
    amounts = ([float(x) for x in args.div_amounts.split(",")]
               if args.div_amounts else [])
    if len(steps) != len(amounts):
        raise SystemExit("--div-steps and --div-amounts must pair up")
    divs = div_schedule(sim.n_steps, steps, amounts)
    res = price_divs(option, divs, sim, payoff=args.payoff,
                     antithetic=args.antithetic,
                     tile_rows=_tile_rows(args))
    out = {"payoff": args.payoff, "price": float(res.price),
           "stderr": float(res.stderr),
           "dividends": [[int(j), float(a)]
                         for j, a in zip(steps, amounts)]}
    tau = ((steps[0] + 1) / sim.n_steps * args.t) if len(steps) == 1 \
        else None
    if (args.payoff == "vanilla_call" and tau is not None
            and 0.0 < tau < args.t):
        out["quadrature_oracle"] = bs_call_cash_div(
            args.s0, args.k, args.t, args.r, args.sigma, amounts[0], tau,
            q=args.q)
        out["z_score"] = ((out["price"] - out["quadrature_oracle"])
                          / out["stderr"])
    print(json.dumps(out))
    return 0


def cmd_basket(args):
    from mc_tpu.models.basket import _demo_basket, price_basket

    option, sim = _parse(args)
    dyn = _demo_basket(d=args.n_assets, rho=args.corr)
    res = price_basket(option, dyn, sim, payoff=args.payoff,
                       antithetic=args.antithetic,
                       tile_rows=_tile_rows(args))
    print(json.dumps({"payoff": args.payoff, "n_assets": args.n_assets,
                      "price": float(res.price),
                      "stderr": float(res.stderr)}))
    return 0


def cmd_rainbow(args):
    from mc_tpu.models.rainbow import BasketDynamics, price_rainbow

    import numpy as np

    option, sim = _parse(args)
    d = args.n_assets
    corr = np.full((d, d), args.corr, np.float32)
    np.fill_diagonal(corr, 1.0)
    sigmas = np.linspace(args.sigma, args.sigma2, d).astype(np.float32)
    s0s = np.linspace(args.s0, args.s02, d).astype(np.float32)
    dyn = BasketDynamics(s0s=s0s, sigmas=sigmas,
                         weights=np.full(d, 1.0 / d, np.float32),
                         corr=corr)
    res = price_rainbow(option, dyn, sim, payoff=args.payoff,
                        antithetic=args.antithetic,
                        tile_rows=_tile_rows(args))
    out = {"payoff": args.payoff, "n_assets": d,
           "price": float(res.price), "stderr": float(res.stderr)}
    if args.greeks:
        from mc_tpu.greeks import rainbow_greeks
        g = rainbow_greeks(option, dyn, sim, args.payoff,
                           tile_rows=_tile_rows(args))
        out["delta"] = [float(x) for x in np.asarray(g["delta"])]
        out["vega"] = [float(x) for x in np.asarray(g["vega"])]
        out["cega_01"] = (float(np.asarray(g["cega"])[0, 1])
                          if d > 1 else 0.0)
    if d == 2:  # closed-form oracle column (Margrabe / Stulz)
        from mc_tpu import oracle
        a = (float(s0s[0]), float(s0s[1]))
        if args.payoff == "exchange":
            out["oracle"] = oracle.margrabe(a[0], a[1], args.t,
                                            sigmas[0], sigmas[1],
                                            args.corr, args.q, args.q)
        elif args.payoff != "best_of_cash":
            fn = {"call_on_min": oracle.stulz_min_call,
                  "call_on_max": oracle.stulz_max_call,
                  "put_on_min": oracle.stulz_min_put,
                  "put_on_max": oracle.stulz_max_put}[args.payoff]
            out["oracle"] = fn(a[0], a[1], args.k, args.t, args.r,
                               sigmas[0], sigmas[1], args.corr,
                               args.q, args.q)
        if "oracle" in out:
            out["z_score"] = (out["price"] - out["oracle"]) / out["stderr"]
    print(json.dumps(out))
    return 0


def cmd_vasicek(args):
    from mc_tpu import oracle
    from mc_tpu.models.vasicek import VasicekDynamics, price_vasicek

    option, sim = _parse(args)
    dyn = VasicekDynamics(a=args.a, b=args.b, sigma_r=args.sigma_r,
                          rho=args.rho_r)
    res = price_vasicek(option, dyn, sim, payoff=args.payoff,
                        antithetic=args.antithetic,
                        tile_rows=_tile_rows(args))
    out = {"payoff": args.payoff, "price": float(res.price),
           "stderr": float(res.stderr)}
    if args.payoff == "zcb":
        out["oracle"] = oracle.vasicek_zcb(args.r, args.a, args.b,
                                           args.sigma_r, args.t)
    elif args.payoff == "vanilla_call":
        out["oracle"] = oracle.bsv_call(args.s0, args.k, args.t, args.r,
                                        args.sigma, args.a, args.b,
                                        args.sigma_r, args.rho_r, args.q)
    if "oracle" in out:
        out["z_score"] = (out["price"] - out["oracle"]) / out["stderr"]
    print(json.dumps(out))
    return 0


def cmd_swaption(args):
    from mc_tpu import oracle
    from mc_tpu.models.swaption import (SwaptionSpec,
                                        price_bermudan_swaption,
                                        price_swaption)
    from mc_tpu.models.vasicek import VasicekDynamics

    option, sim = _parse(args)
    dyn = VasicekDynamics(a=args.a, b=args.b, sigma_r=args.sigma_r)
    spec = SwaptionSpec(expiry=args.expiry, tenor=args.tenor,
                        n_payments=args.n_payments, k_rate=args.k_rate,
                        payer=not args.receiver)
    res = price_swaption(spec, dyn, sim, r0=args.r, seed=args.seed)
    ref = oracle.vasicek_swaption(args.r, args.a, args.b, args.sigma_r,
                                  args.expiry, args.tenor,
                                  args.n_payments, args.k_rate,
                                  payer=not args.receiver)
    out = {"style": "european", "price": float(res.price),
           "stderr": float(res.stderr), "oracle": ref,
           "z_score": (float(res.price) - ref) / float(res.stderr)}
    if args.bermudan:
        ber = price_bermudan_swaption(spec, dyn, sim, r0=args.r,
                                      degree=args.degree,
                                      seed=args.seed)
        out["bermudan_price"] = float(ber.price)
        out["bermudan_stderr"] = float(ber.stderr)
        out["early_exercise_premium"] = float(ber.price) - float(res.price)
    if args.bounds:
        from mc_tpu.models.swaption import bermudan_swaption_bounds
        lo, up = bermudan_swaption_bounds(spec, dyn, sim, r0=args.r,
                                          degree=args.degree,
                                          n_branch=args.bounds_inner,
                                          seed=args.seed)
        out["lower"] = float(lo.price)
        out["lower_stderr"] = float(lo.stderr)
        out["upper"] = float(up.price)
        out["upper_stderr"] = float(up.stderr)
        out["duality_gap"] = float(up.price) - float(lo.price)
    if args.qmc:
        from mc_tpu.models.swaption import price_swaption_qmc
        q = price_swaption_qmc(spec, dyn, sim, r0=args.r, seed=args.seed)
        out["qmc_price"] = float(q.price)
        out["qmc_stderr"] = float(q.stderr)
        if args.bermudan:
            from mc_tpu.models.swaption import \
                price_bermudan_swaption_qmc
            qb = price_bermudan_swaption_qmc(spec, dyn, sim, r0=args.r,
                                             degree=args.degree,
                                             seed=args.seed)
            out["bermudan_qmc_price"] = float(qb.price)
            out["bermudan_qmc_stderr"] = float(qb.stderr)
    if args.greeks:
        from mc_tpu.models.swaption import swaption_greeks
        g = swaption_greeks(spec, dyn, sim, r0=args.r,
                            style="bermudan" if args.bermudan
                            else "european", degree=args.degree,
                            seed=args.seed)
        out.update({k: float(v) for k, v in g.items()})
    if args.exposure:
        import numpy as np

        from mc_tpu.models.swaption import swap_exposure
        e = swap_exposure(spec, dyn, sim, r0=args.r, seed=args.seed)
        ee, pfe = e.exposure_profile()
        out["swap_ee"] = [round(float(x), 6) for x in np.asarray(ee)]
        out["swap_pfe"] = [round(float(x), 6) for x in np.asarray(pfe)]
        if args.bermudan:
            from mc_tpu.models.swaption import bermudan_swaption_exposure
            be = bermudan_swaption_exposure(spec, dyn, sim, r0=args.r,
                                            degree=args.degree,
                                            seed=args.seed)
            bee, _ = be.exposure_profile()
            out["bermudan_ee"] = [round(float(x), 6)
                                  for x in np.asarray(bee)]
            if args.cva_hazard is not None:
                out["bermudan_cva"] = float(be.cva(args.cva_hazard))
        if args.cva_hazard is not None:
            out["swap_cva"] = float(e.cva(args.cva_hazard))
            if args.greeks:
                from mc_tpu.models.swaption import swap_cva_greeks
                cg = swap_cva_greeks(spec, dyn, sim,
                                     hazard_rate=args.cva_hazard,
                                     r0=args.r, seed=args.seed,
                                     which=("dv01", "vega_r", "kappa",
                                            "theta_b"))
                out["swap_cva_greeks"] = {k: float(v)
                                          for k, v in cg.items()}
    print(json.dumps(out))
    return 0


def cmd_hullwhite(args):
    from mc_tpu import oracle
    from mc_tpu.models.hullwhite import (DiscountCurve,
                                         HullWhiteDynamics,
                                         hw_swap_exposure,
                                         price_hw_swaption)
    from mc_tpu.models.swaption import SwaptionSpec

    option, sim = _parse(args)
    times = [float(x) for x in args.curve_times.split(",")]
    zeros = [float(x) for x in args.curve_zeros.split(",")]
    if args.par_swap_rates:
        # bootstrap from the actual market input (par swap quotes)
        mats = ([float(x) for x in args.par_swap_times.split(",")]
                if args.par_swap_times else times)
        pars = [float(x) for x in args.par_swap_rates.split(",")]
        curve = DiscountCurve.from_par_swaps(mats, pars,
                                             tenor=args.tenor)
        times, zeros = list(curve.times), list(curve.zeros)
    else:
        curve = DiscountCurve(times, zeros)
    dyn = HullWhiteDynamics(a=args.a, sigma_r=args.sigma_r)
    spec = SwaptionSpec(expiry=args.expiry, tenor=args.tenor,
                        n_payments=args.n_payments, k_rate=args.k_rate,
                        payer=not args.receiver)
    proj = None
    if args.proj_spread_bp:
        proj = DiscountCurve(
            times, [z + args.proj_spread_bp * 1e-4 for z in zeros])
        # Incompatibility check BEFORE any pricing runs (the Bermudan/
        # bounds/QMC legs are expensive; don't price and then discard).
        if args.bermudan or args.bounds or args.qmc or args.bucket_dv01:
            raise SystemExit("--proj-spread-bp supports European pricing "
                             "and --exposure (Bermudans/QMC/bucket "
                             "ladders are single-curve)")
    res = price_hw_swaption(spec, dyn, curve, sim, seed=args.seed,
                            projection_curve=proj)
    if proj is not None:
        ref = oracle.hw_swaption_multicurve(
            args.a, args.sigma_r, curve.df, proj.df, args.expiry,
            args.tenor, args.n_payments, args.k_rate,
            payer=not args.receiver)
    else:
        ref = oracle.hw_swaption(args.a, args.sigma_r, curve.df,
                                 args.expiry, args.tenor,
                                 args.n_payments, args.k_rate,
                                 payer=not args.receiver)
    out = {"model": "hull-white", "price": float(res.price),
           "stderr": float(res.stderr), "oracle": ref,
           "z_score": (float(res.price) - ref) / float(res.stderr),
           "curve_dfs": [round(curve.df(t), 6) for t in times]}
    if args.bermudan:
        from mc_tpu.models.hullwhite import price_bermudan_hw_swaption
        ber = price_bermudan_hw_swaption(spec, dyn, curve, sim,
                                         degree=args.degree,
                                         seed=args.seed)
        out["bermudan_price"] = float(ber.price)
        out["bermudan_stderr"] = float(ber.stderr)
        out["early_exercise_premium"] = float(ber.price) - float(res.price)
    if args.bounds:
        from mc_tpu.models.hullwhite import bermudan_hw_swaption_bounds
        lo, up = bermudan_hw_swaption_bounds(spec, dyn, curve, sim,
                                             degree=args.degree,
                                             seed=args.seed)
        out["lower"] = float(lo.price)
        out["upper"] = float(up.price)
        out["duality_gap"] = float(up.price) - float(lo.price)
    if args.qmc:
        from mc_tpu.models.hullwhite import price_hw_swaption_qmc
        q = price_hw_swaption_qmc(spec, dyn, curve, sim, seed=args.seed)
        out["qmc_price"] = float(q.price)
        out["qmc_stderr"] = float(q.stderr)
        if args.bermudan:
            from mc_tpu.models.hullwhite import \
                price_bermudan_hw_swaption_qmc
            qb = price_bermudan_hw_swaption_qmc(spec, dyn, curve, sim,
                                                degree=args.degree,
                                                seed=args.seed)
            out["bermudan_qmc_price"] = float(qb.price)
            out["bermudan_qmc_stderr"] = float(qb.stderr)
    if args.greeks:
        from mc_tpu.models.hullwhite import hw_swaption_greeks
        out.update(hw_swaption_greeks(
            spec, dyn, curve, sim,
            style="bermudan" if args.bermudan else "european",
            degree=args.degree, seed=args.seed))
    if args.bucket_dv01:
        from mc_tpu.models.hullwhite import hw_swaption_bucket_dv01
        b = hw_swaption_bucket_dv01(
            spec, dyn, curve, sim,
            style="bermudan" if args.bermudan else "european",
            degree=args.degree, seed=args.seed)
        out["bucket_times"] = [float(t) for t in curve.times]
        out["bucket_dv01"] = [float(x) for x in b]
    if args.curve_var:
        import numpy as np

        from mc_tpu.risk import CurveScenarioSet, hw_swaption_curve_pnl
        specs, wv = [spec], None
        if args.book_k_rates:
            ks = [float(x) for x in args.book_k_rates.split(",")]
            sides = (args.book_sides.split(",") if args.book_sides
                     else ["p"] * len(ks))
            specs = [SwaptionSpec(expiry=args.expiry, tenor=args.tenor,
                                  n_payments=args.n_payments, k_rate=k,
                                  payer=(s.strip().lower() != "r"))
                     for k, s in zip(ks, sides)]
            if args.book_weights:
                wv = np.array([float(x)
                               for x in args.book_weights.split(",")])
        sc = CurveScenarioSet.factor(args.var_scenarios, curve.times,
                                     horizon_days=args.var_horizon_days,
                                     seed=args.seed)
        rv = hw_swaption_curve_pnl(specs, dyn, curve, sim,
                                   scenarios=sc, weights=wv,
                                   seed=args.seed)
        out["curve_var"] = rv.var(args.var_alpha)
        out["curve_es"] = rv.es(args.var_alpha)
        out["curve_component_es"] = [round(float(x), 8)
                                     for x in rv.component_es(
                                         args.var_alpha)]
    if args.book_k_rates:
        import numpy as np

        from mc_tpu.models.hullwhite import hw_swap_book_exposure
        ks = [float(x) for x in args.book_k_rates.split(",")]
        sides = (args.book_sides.split(",") if args.book_sides
                 else ["p"] * len(ks))
        ws = ([float(x) for x in args.book_weights.split(",")]
              if args.book_weights else None)
        specs = [SwaptionSpec(expiry=args.expiry, tenor=args.tenor,
                              n_payments=args.n_payments, k_rate=k,
                              payer=(s.strip().lower() != "r"))
                 for k, s in zip(ks, sides)]
        book = hw_swap_book_exposure(specs, dyn, curve, sim,
                                     weights=ws, seed=args.seed)
        bee, bpfe = book.exposure_profile()
        out["book_netted_ee"] = [round(float(x), 6)
                                 for x in np.asarray(bee)]
        out["book_netted_pfe"] = [round(float(x), 6)
                                  for x in np.asarray(bpfe)]
        if args.cva_hazard is not None:
            out["book_netted_cva"] = float(book.cva(args.cva_hazard))
    if args.exposure:
        import numpy as np
        e = hw_swap_exposure(spec, dyn, curve, sim, seed=args.seed,
                             projection_curve=proj)
        ee, pfe = e.exposure_profile()
        out["swap_ee"] = [round(float(x), 6) for x in np.asarray(ee)]
        out["swap_pfe"] = [round(float(x), 6) for x in np.asarray(pfe)]
        if args.cva_hazard is not None:
            out["swap_cva"] = float(e.cva(args.cva_hazard))
    print(json.dumps(out))
    return 0


def cmd_g2pp(args):
    from mc_tpu import oracle
    from mc_tpu.models.g2pp import (G2Dynamics, g2_swap_exposure,
                                    price_g2_swaption)
    from mc_tpu.models.hullwhite import DiscountCurve
    from mc_tpu.models.swaption import SwaptionSpec

    option, sim = _parse(args)
    times = [float(x) for x in args.curve_times.split(",")]
    zeros = [float(x) for x in args.curve_zeros.split(",")]
    if args.par_swap_rates:
        mats = ([float(x) for x in args.par_swap_times.split(",")]
                if args.par_swap_times else times)
        pars = [float(x) for x in args.par_swap_rates.split(",")]
        curve = DiscountCurve.from_par_swaps(mats, pars,
                                             tenor=args.tenor)
    else:
        curve = DiscountCurve(times, zeros)
    dyn = G2Dynamics(a=args.a, sigma=args.sigma_x, b_mr=args.b_mr,
                     eta=args.eta, rho=args.rho_xy)
    spec = SwaptionSpec(expiry=args.expiry, tenor=args.tenor,
                        n_payments=args.n_payments, k_rate=args.k_rate,
                        payer=not args.receiver)
    res = price_g2_swaption(spec, dyn, curve, sim, seed=args.seed)
    ref = oracle.g2_swaption(dyn.a, dyn.sigma, dyn.b_mr, dyn.eta,
                             dyn.rho, curve.df, args.expiry, args.tenor,
                             args.n_payments, args.k_rate,
                             payer=not args.receiver)
    out = {"model": "g2++", "price": float(res.price),
           "stderr": float(res.stderr), "oracle": ref,
           "z_score": (float(res.price) - ref) / float(res.stderr)}
    if args.bermudan:
        from mc_tpu.models.g2pp import price_bermudan_g2_swaption
        ber = price_bermudan_g2_swaption(spec, dyn, curve, sim,
                                         seed=args.seed)
        out["bermudan_price"] = float(ber.price)
        out["bermudan_stderr"] = float(ber.stderr)
        out["early_exercise_premium"] = float(ber.price) - float(res.price)
    if args.bounds:
        from mc_tpu.models.g2pp import bermudan_g2_swaption_bounds
        lo, up = bermudan_g2_swaption_bounds(spec, dyn, curve, sim,
                                             seed=args.seed)
        out["lower"] = float(lo.price)
        out["upper"] = float(up.price)
        out["duality_gap"] = float(up.price) - float(lo.price)
    if args.qmc:
        from mc_tpu.models.g2pp import price_g2_swaption_qmc
        q = price_g2_swaption_qmc(spec, dyn, curve, sim, seed=args.seed)
        out["qmc_price"] = float(q.price)
        out["qmc_stderr"] = float(q.stderr)
        if args.bermudan:
            from mc_tpu.models.g2pp import \
                price_bermudan_g2_swaption_qmc
            qb = price_bermudan_g2_swaption_qmc(spec, dyn, curve, sim,
                                                seed=args.seed)
            out["bermudan_qmc_price"] = float(qb.price)
            out["bermudan_qmc_stderr"] = float(qb.stderr)
    if args.greeks:
        from mc_tpu.models.g2pp import g2_swaption_greeks
        out.update(g2_swaption_greeks(
            spec, dyn, curve, sim,
            style="bermudan" if args.bermudan else "european",
            seed=args.seed))
    if args.bucket_dv01:
        from mc_tpu.models.g2pp import g2_swaption_bucket_dv01
        b = g2_swaption_bucket_dv01(
            spec, dyn, curve, sim,
            style="bermudan" if args.bermudan else "european",
            seed=args.seed)
        out["bucket_times"] = [float(t) for t in curve.times]
        out["bucket_dv01"] = [float(x) for x in b]
    if args.exposure:
        import numpy as np
        e = g2_swap_exposure(spec, dyn, curve, sim, seed=args.seed)
        ee, pfe = e.exposure_profile()
        out["swap_ee"] = [round(float(x), 6) for x in np.asarray(ee)]
        out["swap_pfe"] = [round(float(x), 6) for x in np.asarray(pfe)]
        if args.cva_hazard is not None:
            out["swap_cva"] = float(e.cva(args.cva_hazard))
    print(json.dumps(out))
    return 0


def cmd_term(args):
    import numpy as np

    from mc_tpu.models.term import TermStructure, price_term
    from mc_tpu.oracle import bs_call

    option, sim = _parse(args)
    rates = [float(x) for x in args.rate_knots.split(",")]
    sigmas = [float(x) for x in args.sigma_knots.split(",")]
    term = TermStructure.from_knots(rates, sigmas, sim.n_steps)
    res = price_term(option, term, sim, payoff=args.payoff,
                     antithetic=args.antithetic,
                     tile_rows=_tile_rows(args))
    out = {"payoff": args.payoff, "rate_knots": rates,
           "sigma_knots": sigmas, "price": float(res.price),
           "stderr": float(res.stderr)}
    if args.payoff == "vanilla_call":
        rs = np.asarray(term.rates, np.float64)
        sg = np.asarray(term.sigmas, np.float64)
        out["oracle"] = float(bs_call(args.s0, args.k, args.t,
                                      float(rs.mean()),
                                      float(np.sqrt((sg ** 2).mean())),
                                      args.q))
        out["z_score"] = (out["price"] - out["oracle"]) / out["stderr"]
    print(json.dumps(out))
    return 0


def cmd_localvol(args):
    import math

    from mc_tpu.models.localvol import LocalVolSurface, price_localvol

    option, sim = _parse(args)
    if args.beta is not None:
        beta = args.beta
        fn = lambda x, t: args.sigma * math.exp((beta - 1.0) * x)
    else:
        fn = (lambda x, t: args.sigma + args.smile_curv * x * x
              + args.term_slope * t)
    surf = LocalVolSurface.from_function(fn, sim.n_steps,
                                         n_knots=args.n_knots)
    res = price_localvol(option, surf, sim, payoff=args.payoff,
                         antithetic=args.antithetic,
                         tile_rows=_tile_rows(args))
    out = {"payoff": args.payoff, "price": float(res.price),
           "stderr": float(res.stderr)}
    if (args.beta is not None and args.payoff == "vanilla_call"
            and 0.0 < args.beta < 1.0):  # the ncx2 form's validity range
        from mc_tpu.models.cev import cev_call_closed_form
        out["cev_oracle"] = cev_call_closed_form(
            args.s0, args.k, args.t, args.r,
            args.sigma * args.s0 ** (1.0 - args.beta), args.beta, args.q)
        out["z_score"] = (out["price"] - out["cev_oracle"]) / out["stderr"]
    print(json.dumps(out))
    return 0


def cmd_mlmc(args):
    from mc_tpu.mlmc import price_heston_mlmc, price_mlmc_family
    from mc_tpu.models.heston import HestonDynamics

    option, sim = _parse(args)
    if args.model == "heston":
        # the dedicated fused Pallas level estimator
        dyn = HestonDynamics(v0=args.v0, kappa=args.kappa,
                             theta=args.theta_v, xi=args.xi,
                             rho=args.rho_sv)
        res = price_heston_mlmc(option, dyn, payoff=args.payoff,
                                n0=args.n0, n_levels=args.n_levels,
                                eps=args.eps, seed=args.seed,
                                n_pilot=args.n_paths,
                                tile_rows=min(_tile_rows(args), 64))
    else:
        # any Gaussian-driven family via the rollout-hook estimator
        # (demo dynamics; library callers pass their own dyn)
        res = price_mlmc_family(args.model, option, payoff=args.payoff,
                                n0=args.n0, n_levels=args.n_levels,
                                eps=args.eps, seed=args.seed,
                                n_pilot=args.n_paths,
                                tile_rows=min(_tile_rows(args), 64))
    print(json.dumps({
        "model": args.model,
        "payoff": args.payoff, "price": float(res.price),
        "stderr": float(res.stderr), "levels": list(res.levels),
        "n_per_level": [int(x) for x in res.n_per_level],
        "variance_decay_rate": res.variance_decay_rate()}))
    return 0


def cmd_book(args):
    import numpy as np

    from mc_tpu.engines import price_portfolio

    option, sim = _parse(args)
    rng_np = np.random.default_rng(args.seed)
    b = args.n_contracts
    book = OptionParams(
        s0=np.full(b, args.s0, np.float32),
        t=np.full(b, args.t, np.float32),
        k=rng_np.uniform(0.8 * args.k, 1.2 * args.k, b).astype(np.float32),
        r=np.full(b, args.r, np.float32),
        sigma=rng_np.uniform(0.5 * args.sigma, 2.0 * args.sigma,
                             b).astype(np.float32),
        barrier=np.full(b, args.barrier, np.float32),
        p1=np.full(b, args.p1, np.float32),
        p2=np.full(b, args.p2, np.float32),
        q=np.full(b, args.q, np.float32))
    res = price_portfolio(book, sim, payoff=args.payoff,
                          tile_rows=_tile_rows(args))
    prices = [round(float(x), 6) for x in np.asarray(res.price)]
    print(json.dumps({"payoff": args.payoff, "n_contracts": b,
                      "prices": prices,
                      "stderr_max": float(np.max(np.asarray(res.stderr)))}))
    return 0


def cmd_risk(args):
    import numpy as np

    from mc_tpu.risk import (ScenarioSet, book_scenario_pnl,
                             delta_gamma_pnl, var_es)

    option, sim = _parse(args)
    sc = ScenarioSet.gbm(args.n_scenarios,
                         horizon_days=args.horizon_days,
                         spot_vol=args.scenario_spot_vol,
                         vol_of_vol=args.scenario_vol_of_vol,
                         rate_vol=args.scenario_rate_vol,
                         seed=args.scenario_seed)
    w = None
    book = option
    if args.book_strikes:
        ks = np.array([float(x) for x in args.book_strikes.split(",")],
                      np.float64)
        book = OptionParams(s0=option.s0, t=option.t, k=ks, r=option.r,
                            sigma=option.sigma, barrier=option.barrier,
                            p1=option.p1, p2=option.p2, q=option.q)
        if args.book_weights:
            w = np.array([float(x) for x in args.book_weights.split(",")],
                         np.float64)
    if args.model != "gbm":
        from mc_tpu.risk import model_scenario_pnl
        res = model_scenario_pnl(args.model, book, None, sim,
                                 args.payoff, scenarios=sc, weights=w,
                                 method=args.method,
                                 tile_rows=_tile_rows(args))
    else:
        res = book_scenario_pnl(book, sim, args.payoff, scenarios=sc,
                                weights=w, method=args.method or "xla",
                                tile_rows=_tile_rows(args))
    out = {"method": args.method, "n_scenarios": len(sc),
           "alpha": args.alpha, "base_value": res.base_value,
           "var": res.var(args.alpha), "es": res.es(args.alpha),
           "pnl_mean": float(res.pnl.mean()),
           "pnl_worst": float(res.pnl.min()),
           "component_es": [round(float(x), 6)
                            for x in res.component_es(args.alpha)]}
    if args.payoff in ("vanilla_call", "vanilla_put"):
        if args.model == "gbm":
            # the BS Taylor approximation is the flat-vol model's
            dg = delta_gamma_pnl(book, args.payoff, scenarios=sc,
                                 weights=w)
            out["dg_var"], out["dg_es"] = var_es(dg, args.alpha)
        if args.method == "mc":
            from mc_tpu.risk import _SCEN_ORACLES
            if args.model == "gbm":
                ro = book_scenario_pnl(book, payoff=args.payoff,
                                       scenarios=sc, weights=w,
                                       method="oracle")
            elif args.model in _SCEN_ORACLES:
                from mc_tpu.risk import model_scenario_pnl
                ro = model_scenario_pnl(args.model, book, None, sim,
                                        args.payoff, scenarios=sc,
                                        weights=w, method="oracle")
            else:
                ro = None  # sabr/localvol: no exact vanilla oracle
            if ro is not None:
                out["oracle_var"] = ro.var(args.alpha)
                out["oracle_es"] = ro.es(args.alpha)
    print(json.dumps(out))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="mc_tpu", description="Monte Carlo option pricing on the GPU")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("demo", help="run all pricers + BS oracle (hello.cu)")
    _add_option_flags(p)
    _add_engine_flag(p)
    p.add_argument("--skip-nmc", action="store_true")
    p.add_argument("--skip-cpu", action="store_true",
                   help="omit the native CPU reference rows")
    p.add_argument("--cpu-max-paths", type=int, default=100_000,
                   help="path cap for the sequential-ish CPU pricers")
    p.add_argument("--nmc-max-paths", type=int, default=None,
                   help="cap outer paths for the NMC stage of the demo "
                        "(default: all of them on a GPU, 256 elsewhere)")
    # Backend-adaptive defaults resolved in cmd_demo (None = not pinned):
    # the XLA engine on a CPU would take hours at the reference's sizes.
    p.set_defaults(fn=cmd_demo, n_inner=None)

    p = sub.add_parser("price", help="price one option, JSON output")
    _add_option_flags(p)
    _add_engine_flag(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--antithetic", action="store_true")
    p.add_argument("--control-variate", action="store_true")
    p.add_argument("--importance-shift", default=None,
                   help="drift shift in sd units, or 'auto' (aim at K)")
    p.set_defaults(fn=cmd_price)

    p = sub.add_parser("nmc", help="nested MC price surface, JSON output")
    _add_option_flags(p)
    _add_engine_flag(p)
    p.add_argument("--payoff", default="bullet_call")
    p.add_argument("--discount", choices=("full", "remaining"),
                   default="full")
    p.add_argument("--surface-npz", default=None,
                   help="save the (paths, steps) surface to this .npz")
    p.add_argument("--exposure", action="store_true",
                   help="emit EE/PFE exposure profiles from the surface")
    p.add_argument("--pfe-quantile", type=float, default=0.95)
    p.add_argument("--cva-hazard", type=float, default=None,
                   help="flat hazard rate: emit unilateral CVA")
    p.add_argument("--cva-recovery", type=float, default=0.4)
    p.add_argument("--cva-greeks", default=None,
                   help="comma list of CVA sensitivities by forward-mode "
                        "AD through the nested pipeline: option greeks "
                        "(delta,rho,dual_delta; vega under gbm) or, with "
                        "--model, any scalar dynamics field (e.g. "
                        "'delta,v0,xi' under heston, 'delta,lam' under "
                        "merton); needs --cva-hazard")
    p.add_argument("--dva-hazard", type=float, default=None,
                   help="own flat hazard: emit DVA and bilateral CVA "
                        "(needs --cva-hazard)")
    p.add_argument("--fva-spread", type=float, default=None,
                   help="funding spread: emit FCA/FBA")
    p.add_argument("--collateral-threshold", type=float, default=None,
                   help="two-way CSA threshold: emit collateralized "
                        "EE/CVA (with --mta / --mpor-steps)")
    p.add_argument("--mta", type=float, default=0.0)
    p.add_argument("--mpor-steps", type=int, default=0,
                   help="margin period of risk, in steps")
    p.add_argument("--im-quantile", type=float, default=None,
                   help="dynamic initial-margin profile: quantile of "
                        "the adverse MtM move over the MPoR")
    p.add_argument("--mva-spread", type=float, default=None,
                   help="funding spread on the IM profile -> MVA "
                        "(needs --im-quantile)")
    p.add_argument("--wwr-beta", type=float, default=None,
                   help="exposure-linked wrong-way-risk CVA "
                        "(needs --cva-hazard)")
    p.add_argument("--wwr-spot-beta", type=float, default=None,
                   help="SPOT-linked wrong-way-risk CVA: intensity "
                        "rides the underlying level (sign flips with "
                        "the position; needs --cva-hazard)")
    p.add_argument("--model",
                   choices=("gbm", "heston", "bates", "merton", "vasicek",
                            "localvol", "cev", "basket", "sabr", "term",
                            "rainbow"),
                   default="gbm")
    p.add_argument("--alpha", type=float, default=0.2,
                   help="sabr initial vol")
    p.add_argument("--nu", type=float, default=0.4,
                   help="sabr vol-of-vol")
    p.add_argument("--n-assets", type=int, default=4,
                   help="basket size (with --model basket)")
    p.add_argument("--corr", type=float, default=0.5,
                   help="basket pairwise correlation")
    p.add_argument("--sigma-atm", type=float, default=0.2,
                   help="cev at-the-money vol")
    p.add_argument("--beta", type=float, default=0.5,
                   help="cev elasticity")
    p.add_argument("--book-strikes", default=None,
                   help="comma list of strikes: netting-set NMC (netted "
                        "EE/PFE/CVA over the book)")
    p.add_argument("--book-weights", default=None,
                   help="comma list of +/- position sizes (with "
                        "--book-strikes; default all +1)")
    p.add_argument("--v0", type=float, default=0.04)
    p.add_argument("--kappa", type=float, default=2.0)
    p.add_argument("--theta-v", type=float, default=0.04)
    p.add_argument("--xi", type=float, default=0.3)
    p.add_argument("--rho-sv", type=float, default=-0.7)
    p.add_argument("--lam", type=float, default=0.3,
                   help="merton jump intensity")
    p.add_argument("--mu-j", type=float, default=-0.10)
    p.add_argument("--sigma-j", type=float, default=0.15)
    p.add_argument("--a", type=float, default=0.3,
                   help="vasicek rate mean-reversion speed")
    p.add_argument("--b", type=float, default=0.05,
                   help="vasicek long-run rate level")
    p.add_argument("--sigma-r", type=float, default=0.015)
    p.add_argument("--rho-r", type=float, default=-0.3,
                   help="equity/rate correlation")
    p.add_argument("--smile-curv", type=float, default=0.1,
                   help="localvol: sigma(x) = sigma + curv*x^2")
    p.set_defaults(fn=cmd_nmc)

    p = sub.add_parser("traj", help="dump trajectories CSV (testing.cu)")
    _add_option_flags(p)
    _add_engine_flag(p)
    p.add_argument("--payoff", default="bullet_call")
    p.add_argument("--out", default="testing.csv")
    p.add_argument("--plot", default=None,
                   help="also render trajectories to this PNG (imgs/ parity)")
    p.add_argument("--plot-max", type=int, default=200,
                   help="max trajectories to draw")
    p.set_defaults(fn=cmd_traj)

    p = sub.add_parser("heston", help="Heston stochastic-vol price")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--antithetic", action="store_true")
    p.add_argument("--v0", type=float, default=0.04)
    p.add_argument("--kappa", type=float, default=2.0)
    p.add_argument("--theta-v", type=float, default=0.04)
    p.add_argument("--xi", type=float, default=0.3)
    p.add_argument("--rho-sv", type=float, default=-0.7)
    p.add_argument("--scheme", default="euler", choices=("euler", "qe"),
                   help="discretization: full-truncation Euler or "
                   "Andersen QE (exact per-step martingale, low bias "
                   "at coarse steps)")
    p.set_defaults(fn=cmd_heston)

    p = sub.add_parser("bates", help="Bates SVJ (Heston + jumps) price "
                       "vs the factorized CF oracle")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--antithetic", action="store_true")
    p.add_argument("--v0", type=float, default=0.04)
    p.add_argument("--kappa", type=float, default=2.0)
    p.add_argument("--theta-v", type=float, default=0.04)
    p.add_argument("--xi", type=float, default=0.3)
    p.add_argument("--rho-sv", type=float, default=-0.7)
    p.add_argument("--lam", type=float, default=0.3,
                   help="jump intensity (per year)")
    p.add_argument("--mu-j", type=float, default=-0.10,
                   help="mean log jump size")
    p.add_argument("--sigma-j", type=float, default=0.15,
                   help="std of log jump size")
    p.add_argument("--scheme", default="euler", choices=("euler", "qe"),
                   help="diffusion substep; jumps are exact in law "
                   "either way")
    p.set_defaults(fn=cmd_bates)

    p = sub.add_parser("fx", help="cross-currency quanto/compo/GK/flexo "
                       "price vs exact closed form")
    _add_option_flags(p)
    p.add_argument("--contract", default="quanto_call",
                   choices=["gk_call", "gk_put", "quanto_call",
                            "quanto_put", "compo_call", "compo_put",
                            "flexo_call", "flexo_put"])
    p.add_argument("--x0", type=float, default=1.0,
                   help="FX spot, domestic per foreign")
    p.add_argument("--sigma-x", type=float, default=0.15)
    p.add_argument("--rf", type=float, default=0.03,
                   help="foreign short rate")
    p.add_argument("--rho-fx", type=float, default=-0.35,
                   help="asset/FX log-return correlation")
    p.add_argument("--kx", type=float, default=None,
                   help="FX strike for gk contracts (default: x0)")
    p.add_argument("--x-bar", type=float, default=None,
                   help="fixed quanto conversion rate (default: x0)")
    p.set_defaults(fn=cmd_fx)

    p = sub.add_parser("american", help="Longstaff-Schwartz American price")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_put")
    p.add_argument("--degree", type=int, default=3)
    p.add_argument("--greeks", action="store_true",
                   help="frozen-policy pathwise delta/vega (+ CRR-FD "
                        "reference for gbm vanilla)")
    p.add_argument("--model",
                   choices=("gbm", "heston", "bates", "basket", "vasicek",
                            "localvol", "rainbow", "cev", "merton",
                            "sabr"),
                   default="gbm")
    p.add_argument("--exposure", action="store_true",
                   help="American-MC exposure surface: EE/PFE of the "
                        "position under the frozen policy (exercise "
                        "absorbs; family models only); --cva-hazard "
                        "adds the CVA")
    p.add_argument("--cva-hazard", type=float, default=None)
    p.add_argument("--n-assets", type=int, default=4)
    p.add_argument("--corr", type=float, default=0.5)
    p.add_argument("--a", type=float, default=0.3,
                   help="vasicek rate mean-reversion speed")
    p.add_argument("--b", type=float, default=0.05,
                   help="vasicek long-run rate level")
    p.add_argument("--sigma-r", type=float, default=0.015)
    p.add_argument("--rho-r", type=float, default=-0.3,
                   help="equity/rate correlation")
    p.add_argument("--v0", type=float, default=0.04)
    p.add_argument("--kappa", type=float, default=2.0)
    p.add_argument("--theta-h", type=float, default=0.04,
                   help="Heston long-run variance")
    p.add_argument("--xi", type=float, default=0.5)
    p.add_argument("--rho", type=float, default=-0.7)
    p.add_argument("--smile-curv", type=float, default=0.1,
                   help="localvol: sigma(x) = sigma + curv*x^2")
    p.add_argument("--exercise-every", type=int, default=1,
                   help="Bermudan: exercise every k-th grid date")
    p.add_argument("--bounds", action="store_true",
                   help="emit the Andersen-Broadie [lower, upper] bracket")
    p.add_argument("--bounds-inner", type=int, default=128)
    p.set_defaults(fn=cmd_american)

    p = sub.add_parser("ladder", help="strike ladder on shared paths")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--antithetic", action="store_true")
    p.add_argument("--k-min", type=float, default=60.0)
    p.add_argument("--k-max", type=float, default=140.0)
    p.add_argument("--n-strikes", type=int, default=17)
    p.set_defaults(fn=cmd_ladder)

    p = sub.add_parser("greeks",
                       help="MC Greeks (pathwise, CRN-FD, or LRM)")
    _add_option_flags(p)
    _add_engine_flag(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--method", choices=("pathwise", "fd", "lrm"),
                   default="pathwise")
    p.add_argument("--which", default=None,
                   help="comma list; default depends on --method")
    p.add_argument("--antithetic", action="store_true")
    p.set_defaults(fn=cmd_greeks)

    p = sub.add_parser("qmc", help="randomized-QMC price (lattice/Sobol)")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--n-shifts", type=int, default=16)
    p.add_argument("--family", choices=("lattice", "sobol"),
                   default="lattice")
    p.add_argument("--model",
                   choices=("gbm", "heston", "bates", "basket", "cev", "sabr",
                            "localvol", "vasicek", "merton", "term"),
                   default="gbm",
                   help="drive a model family's step loop from the "
                        "low-discrepancy points")
    p.set_defaults(fn=cmd_qmc)

    p = sub.add_parser("cev", help="CEV local-vol price (ncx2 oracle)")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--antithetic", action="store_true")
    p.add_argument("--sigma-atm", type=float, default=0.2)
    p.add_argument("--beta", type=float, default=0.5)
    p.set_defaults(fn=cmd_cev)

    p = sub.add_parser("merton",
                       help="Merton jump-diffusion price (series oracle)")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--method", choices=("euler", "terminal"),
                   default="euler")
    p.add_argument("--antithetic", action="store_true")
    p.add_argument("--lam", type=float, default=0.3,
                   help="jump intensity (per year)")
    p.add_argument("--mu-j", type=float, default=-0.10,
                   help="mean log jump size")
    p.add_argument("--sigma-j", type=float, default=0.15,
                   help="std of log jump size")
    p.set_defaults(fn=cmd_merton)

    p = sub.add_parser("sabr",
                       help="SABR stochastic-vol price (Hagan oracle)")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--antithetic", action="store_true")
    p.add_argument("--alpha", type=float, default=0.2,
                   help="initial forward vol")
    p.add_argument("--beta", type=float, default=1.0,
                   help="CEV backbone exponent")
    p.add_argument("--nu", type=float, default=0.4, help="vol-of-vol")
    p.add_argument("--rho-fv", type=float, default=-0.4,
                   help="forward-vol correlation")
    p.set_defaults(fn=cmd_sabr)

    p = sub.add_parser("calibrate",
                       help="MC smile -> implied vols -> model fit "
                            "(sabr | heston | localvol | hullwhite: "
                            "swaption quotes -> (a, sigma_r) round "
                            "trip on the demo curve)")
    _add_option_flags(p)
    p.add_argument("--model",
                   choices=("sabr", "heston", "localvol", "hullwhite",
                            "g2pp"),
                   default="sabr")
    p.add_argument("--alpha", type=float, default=0.2)
    p.add_argument("--beta", type=float, default=1.0)
    p.add_argument("--nu", type=float, default=0.4)
    p.add_argument("--rho-fv", type=float, default=-0.4)
    p.add_argument("--k-min", type=float, default=85.0)
    p.add_argument("--k-max", type=float, default=115.0)
    p.add_argument("--n-strikes", type=int, default=5)
    p.add_argument("--v0", type=float, default=0.04)
    p.add_argument("--kappa", type=float, default=2.0)
    p.add_argument("--theta-v", type=float, default=0.04)
    p.add_argument("--xi", type=float, default=0.3)
    p.add_argument("--rho-sv", type=float, default=-0.7)
    p.add_argument("--a", type=float, default=0.3,
                   help="hullwhite true mean reversion (round trip)")
    p.add_argument("--sigma-r", type=float, default=0.015,
                   help="hullwhite true short-rate vol (round trip)")
    p.add_argument("--smile-skew", type=float, default=0.08,
                   help="localvol target smile slope")
    p.add_argument("--smile-curv", type=float, default=0.15,
                   help="localvol target smile curvature")
    p.add_argument("--sigma-x", type=float, default=0.01,
                   help="g2pp true first-factor vol (repricing gate)")
    p.add_argument("--b-mr-cal", type=float, default=0.05,
                   help="g2pp true second-factor mean reversion")
    p.add_argument("--eta", type=float, default=0.008,
                   help="g2pp true second-factor vol")
    p.add_argument("--rho-xy", type=float, default=-0.7,
                   help="g2pp true factor correlation")
    p.add_argument("--n-iter", type=int, default=80,
                   help="g2pp LM iteration cap")
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser("divs",
                       help="GBM with discrete cash dividends "
                            "(quadrature oracle)")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--antithetic", action="store_true")
    p.add_argument("--div-steps", default="24",
                   help="comma list of dividend step indices")
    p.add_argument("--div-amounts", default="5.0",
                   help="comma list of cash amounts")
    p.set_defaults(fn=cmd_divs)

    p = sub.add_parser("basket", help="correlated multi-asset basket price")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--antithetic", action="store_true")
    p.add_argument("--n-assets", type=int, default=4)
    p.add_argument("--corr", type=float, default=0.5)
    p.set_defaults(fn=cmd_basket)

    p = sub.add_parser("rainbow",
                       help="best-of/worst-of rainbow (Stulz/Margrabe "
                            "oracle at d=2)")
    _add_option_flags(p)
    p.add_argument("--payoff", default="call_on_max",
                   help="call_on_max|call_on_min|put_on_max|put_on_min|"
                        "exchange|best_of_cash")
    p.add_argument("--antithetic", action="store_true")
    p.add_argument("--greeks", action="store_true",
                   help="per-asset delta/vega + cega (one jax.grad pass)")
    p.add_argument("--n-assets", type=int, default=2)
    p.add_argument("--corr", type=float, default=0.5)
    p.add_argument("--s02", type=float, default=105.0,
                   help="last asset's spot (spots interpolate s0..s02)")
    p.add_argument("--sigma2", type=float, default=0.25,
                   help="last asset's vol (vols interpolate sigma..sigma2)")
    p.set_defaults(fn=cmd_rainbow)

    p = sub.add_parser("vasicek",
                       help="stochastic-rate (Black-Scholes-Vasicek) "
                            "price, pathwise discounting")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call",
                   help="any registry payoff; 'zcb' prices the bond")
    p.add_argument("--antithetic", action="store_true")
    p.add_argument("--a", type=float, default=0.3,
                   help="rate mean-reversion speed")
    p.add_argument("--b", type=float, default=0.05,
                   help="long-run rate level (r0 is --rate)")
    p.add_argument("--sigma-r", type=float, default=0.015)
    p.add_argument("--rho-r", type=float, default=-0.3,
                   help="equity/rate correlation")
    p.set_defaults(fn=cmd_vasicek)

    p = sub.add_parser("swaption",
                       help="Vasicek swaption: exact date-grid MC vs "
                            "Jamshidian; --bermudan adds the LSMC "
                            "early-exercise premium")
    _add_option_flags(p)
    p.add_argument("--expiry", type=float, default=1.0)
    p.add_argument("--tenor", type=float, default=0.5)
    p.add_argument("--n-payments", type=int, default=10)
    p.add_argument("--k-rate", type=float, default=0.05,
                   help="fixed leg rate (r0 is --rate)")
    p.add_argument("--receiver", action="store_true")
    p.add_argument("--bermudan", action="store_true")
    p.add_argument("--bounds", action="store_true",
                   help="Andersen-Broadie [lower, upper] bracket on the "
                        "Bermudan from the same fitted policy")
    p.add_argument("--bounds-inner", type=int, default=32,
                   help="one-step branches per conditional in the dual")
    p.add_argument("--qmc", action="store_true",
                   help="randomized-QMC rows: European on the 2-dim "
                        "exact draw; with --bermudan also the frozen-"
                        "policy Sobol pass over the full date grid")
    p.add_argument("--greeks", action="store_true",
                   help="dv01/vega_r/kappa/theta_b by one jax.grad pass")
    p.add_argument("--exposure", action="store_true",
                   help="EE/PFE of the SWAP (swaption-strip identity); "
                        "--cva-hazard adds the swap CVA")
    p.add_argument("--cva-hazard", type=float, default=None)
    p.add_argument("--degree", type=int, default=3,
                   help="LSMC basis degree in the short rate")
    p.add_argument("--a", type=float, default=0.3)
    p.add_argument("--b", type=float, default=0.05)
    p.add_argument("--sigma-r", type=float, default=0.015)
    p.set_defaults(fn=cmd_swaption)

    p = sub.add_parser("hullwhite",
                       help="curve-fitted Hull-White swaption: exact "
                            "(x, int x) draws, curve bonds, vs the "
                            "curve-consistent Jamshidian oracle; "
                            "--exposure adds the swap EE/PFE/CVA")
    _add_option_flags(p)
    p.add_argument("--expiry", type=float, default=1.0)
    p.add_argument("--tenor", type=float, default=0.5)
    p.add_argument("--n-payments", type=int, default=10)
    p.add_argument("--k-rate", type=float, default=0.04)
    p.add_argument("--receiver", action="store_true")
    p.add_argument("--curve-times", default="0.5,1,2,3,5,10",
                   help="zero-curve knot times (years, ascending)")
    p.add_argument("--curve-zeros", default="0.03,0.035,0.04,0.043,"
                                            "0.046,0.048",
                   help="zero rates at the knots (the curve the model "
                        "reprices exactly)")
    p.add_argument("--par-swap-rates", default=None,
                   help="BOOTSTRAP the curve from par swap quotes "
                        "instead (comma list; maturities from "
                        "--par-swap-times, default --curve-times; "
                        "must sit on the --tenor grid)")
    p.add_argument("--par-swap-times", default=None)
    p.add_argument("--exposure", action="store_true")
    p.add_argument("--proj-spread-bp", type=float, default=0.0,
                   help="MULTI-CURVE: forwards off a projection curve "
                        "this many bp above the discount (OIS) curve")
    p.add_argument("--book-k-rates", default=None,
                   help="NETTING SET: comma list of per-swap fixed "
                        "rates (with --book-sides p/r and "
                        "--book-weights); emits netted EE/PFE/CVA")
    p.add_argument("--book-sides", default=None)
    p.add_argument("--book-weights", default=None)
    p.add_argument("--bermudan", action="store_true",
                   help="co-terminal Bermudan LSMC on the curve "
                        "(x-state basis; 1-payment bitwise == European)")
    p.add_argument("--bounds", action="store_true",
                   help="Andersen-Broadie [lower, upper] bracket on "
                        "the curve Bermudan (lower bitwise == LSMC)")
    p.add_argument("--degree", type=int, default=3)
    p.add_argument("--qmc", action="store_true",
                   help="randomized-Sobol price (with --bermudan: "
                        "frozen-policy QMC over the full date grid)")
    p.add_argument("--greeks", action="store_true",
                   help="CRN-FD price sensitivities (curve_dv01 per "
                        "+1bp, vega_r, kappa; Bermudan if --bermudan)")
    p.add_argument("--bucket-dv01", action="store_true",
                   help="key-rate DV01 ladder: dPrice per +1bp bump of "
                        "EACH curve knot (one batched device call; "
                        "sums to the parallel curve_dv01)")
    p.add_argument("--curve-var", action="store_true",
                   help="curve-scenario VaR/ES of the swaption (or "
                        "--book-k-rates book) under level/slope/"
                        "curvature zero-curve shocks — full "
                        "revaluation, one batched call per spec")
    p.add_argument("--var-scenarios", type=int, default=256)
    p.add_argument("--var-alpha", type=float, default=0.99)
    p.add_argument("--var-horizon-days", type=float, default=10.0)
    p.add_argument("--cva-hazard", type=float, default=None)
    p.add_argument("--a", type=float, default=0.3)
    p.add_argument("--sigma-r", type=float, default=0.015)
    p.set_defaults(fn=cmd_hullwhite)

    p = sub.add_parser("g2pp",
                       help="curve-fitted G2++ two-factor swaption vs "
                            "the conditional-Jamshidian oracle; "
                            "--exposure adds the swap EE/PFE/CVA")
    _add_option_flags(p)
    p.add_argument("--expiry", type=float, default=1.0)
    p.add_argument("--tenor", type=float, default=0.5)
    p.add_argument("--n-payments", type=int, default=10)
    p.add_argument("--k-rate", type=float, default=0.04)
    p.add_argument("--receiver", action="store_true")
    p.add_argument("--curve-times", default="0.5,1,2,3,5,10")
    p.add_argument("--curve-zeros", default="0.03,0.035,0.04,0.043,"
                                            "0.046,0.048")
    p.add_argument("--par-swap-rates", default=None,
                   help="bootstrap the curve from par swap quotes "
                        "(comma list; maturities from --par-swap-times, "
                        "default --curve-times)")
    p.add_argument("--par-swap-times", default=None)
    p.add_argument("--exposure", action="store_true")
    p.add_argument("--bermudan", action="store_true",
                   help="co-terminal Bermudan LSMC on the (x, y) state")
    p.add_argument("--bounds", action="store_true",
                   help="Andersen-Broadie bracket on the two-factor "
                        "Bermudan (lower bitwise == LSMC)")
    p.add_argument("--qmc", action="store_true",
                   help="randomized-Sobol price (with --bermudan: "
                        "frozen-policy QMC over the full date grid)")
    p.add_argument("--greeks", action="store_true",
                   help="CRN-FD price sensitivities (curve_dv01, "
                        "per-factor vegas; Bermudan if --bermudan)")
    p.add_argument("--bucket-dv01", action="store_true",
                   help="key-rate DV01 ladder: dPrice per +1bp bump of "
                        "EACH curve knot (one batched device call; "
                        "sums to the parallel curve_dv01)")
    p.add_argument("--cva-hazard", type=float, default=None)
    p.add_argument("--a", type=float, default=0.5)
    p.add_argument("--sigma-x", type=float, default=0.01,
                   help="first-factor vol")
    p.add_argument("--b-mr", type=float, default=0.05,
                   help="second-factor mean reversion")
    p.add_argument("--eta", type=float, default=0.008,
                   help="second-factor vol")
    p.add_argument("--rho-xy", type=float, default=-0.7,
                   help="factor correlation")
    p.set_defaults(fn=cmd_g2pp)

    p = sub.add_parser("term",
                       help="rate/vol term-structure price (averaged-BS "
                            "oracle)")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--antithetic", action="store_true")
    p.add_argument("--rate-knots", default="0.10,0.07,0.05",
                   help="comma list spread evenly over the steps")
    p.add_argument("--sigma-knots", default="0.15,0.22,0.30")
    p.set_defaults(fn=cmd_term)

    p = sub.add_parser("localvol",
                       help="local-volatility surface price (CEV oracle "
                            "with --beta)")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--antithetic", action="store_true")
    p.add_argument("--smile-curv", type=float, default=0.1,
                   help="sigma(x,t) = sigma + curv*x^2 + slope*t")
    p.add_argument("--term-slope", type=float, default=0.05)
    p.add_argument("--beta", type=float, default=None,
                   help="CEV-shaped surface sigma*e^{(beta-1)x} instead "
                        "(prints the noncentral-chi^2 oracle z-score)")
    p.add_argument("--n-knots", type=int, default=9)
    p.set_defaults(fn=cmd_localvol)

    p = sub.add_parser("mlmc", help="multilevel MC under any supported "
                                    "model family (merton couples jumps "
                                    "at the increment level)")
    _add_option_flags(p)
    p.add_argument("--model", default="heston",
                   choices=["heston", "bates", "cev", "sabr", "vasicek", "basket",
                            "merton"])
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--n0", type=int, default=4)
    p.add_argument("--n-levels", type=int, default=5)
    p.add_argument("--eps", type=float, default=1e-2)
    p.add_argument("--v0", type=float, default=0.04)
    p.add_argument("--kappa", type=float, default=2.0)
    p.add_argument("--theta-v", type=float, default=0.04)
    p.add_argument("--xi", type=float, default=0.3)
    p.add_argument("--rho-sv", type=float, default=-0.7)
    p.set_defaults(fn=cmd_mlmc)

    p = sub.add_parser("book", help="B-contract book in one batched kernel")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--n-contracts", type=int, default=16)
    p.set_defaults(fn=cmd_book)

    p = sub.add_parser("risk",
                       help="scenario VaR/ES: full-revaluation book "
                            "P&L over joint spot/vol/rate shocks "
                            "(one batched kernel; MC vs f64-oracle vs "
                            "delta-gamma cross-gated)")
    _add_option_flags(p)
    p.add_argument("--payoff", default="vanilla_call")
    p.add_argument("--method", default="mc", choices=("mc", "oracle"),
                   help="mc: batched portfolio engine (any terminal "
                        "payoff); oracle: exact f64 BS revaluation "
                        "(vanilla books)")
    p.add_argument("--model", default="gbm",
                   choices=("gbm", "heston", "bates", "merton", "cev",
                            "sabr", "localvol", "vasicek"),
                   help="revaluation model: gbm (flat vol, the batched "
                        "portfolio engine) or any single-asset family "
                        "from the registry (oracle = the family's "
                        "exact/semi-analytic closed form where one "
                        "exists; sabr/localvol are MC-only)")
    p.add_argument("--alpha", type=float, default=0.99)
    p.add_argument("--n-scenarios", type=int, default=512)
    p.add_argument("--horizon-days", type=float, default=10.0)
    p.add_argument("--scenario-spot-vol", type=float, default=0.2)
    p.add_argument("--scenario-vol-of-vol", type=float, default=0.5)
    p.add_argument("--scenario-rate-vol", type=float, default=0.01)
    p.add_argument("--scenario-seed", type=int, default=0)
    p.add_argument("--book-strikes", default=None,
                   help="comma list of strikes (the book; other fields "
                        "from the global option flags)")
    p.add_argument("--book-weights", default=None,
                   help="comma list of position sizes (default 1)")
    p.set_defaults(fn=cmd_risk)

    p = sub.add_parser("bench", help="run the benchmark harness")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("info", help="device capability dump (tool.cuh:56)")
    p.set_defaults(fn=cmd_info)

    # Every subcommand accepts --platform: pin the JAX platform before the
    # first device touch (default: JAX's own choice, the GPU when present).
    for sp in set(sub.choices.values()):
        g = sp.add_argument_group("backend")
        g.add_argument("--platform", choices=("gpu", "cpu"), default=None,
                       help="pin the JAX platform before device init")

    args = ap.parse_args(argv)
    if args.fn is cmd_bench:
        return args.fn(args)  # bench.py starts its own backend
    start(args.platform)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
