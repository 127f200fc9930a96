"""CLI smoke tests for the late-round-3 surfaces: swaptions, family
MLMC, multi-asset greeks, and the XVA flags on the NMC paths."""

import json

import pytest

from mc_tpu.cli import main

SMALL = ["-N", "2048", "--n-steps", "8", "--tile-rows", "8"]


def run(capsys, argv):
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_swaption_european_and_bermudan(capsys):
    rc, out = run(capsys, ["swaption", "--bermudan", "--greeks",
                           "-N", "8192"])
    doc = json.loads(out)
    assert rc == 0
    assert abs(doc["z_score"]) < 5.0
    assert doc["bermudan_price"] >= doc["price"] - 3 * doc["stderr"]
    assert doc["early_exercise_premium"] > -1e-4
    assert "dv01" in doc  # frozen-policy Bermudan greeks emitted


def test_swaption_bounds_cli(capsys):
    rc, out = run(capsys, ["swaption", "--bermudan", "--bounds",
                           "--bounds-inner", "8", "-N", "4096"])
    doc = json.loads(out)
    assert rc == 0
    assert doc["lower"] == doc["bermudan_price"]  # shared stream + fit
    assert doc["upper"] >= doc["lower"]
    assert doc["duality_gap"] < 0.25 * doc["lower"]  # 8 branches only


def test_nmc_family_cva_greeks_cli(capsys):
    rc, out = run(capsys, ["nmc", "--payoff", "vanilla_call",
                           "--n-inner", "8", "--model", "heston",
                           "--cva-hazard", "0.02",
                           "--cva-greeks", "delta,v0"] + SMALL)
    doc = json.loads(out)
    assert rc == 0
    assert doc["cva_greeks"]["delta"] > 0
    assert doc["cva_greeks"]["v0"] > 0


def test_hullwhite_cli(capsys):
    rc, out = run(capsys, ["hullwhite", "--exposure",
                           "--cva-hazard", "0.02", "-N", "65536"])
    doc = json.loads(out)
    assert rc == 0
    assert abs(doc["z_score"]) < 5.0
    assert doc["swap_cva"] > 0
    assert doc["swap_ee"][0] > doc["swap_ee"][-1]  # profile decays


def test_american_exposure_cli(capsys):
    rc, out = run(capsys, ["american", "--model", "heston", "--exposure",
                           "--cva-hazard", "0.02", "-N", "4096",
                           "--n-steps", "8", "--bounds-inner", "8"])
    doc = json.loads(out)
    assert rc == 0
    ee = doc["american_ee"]
    assert all(a >= b - 1e-3 for a, b in zip(ee, ee[1:]))  # telescopes
    assert doc["american_cva"] > 0


def test_nmc_wwr_spot_cli(capsys):
    rc, out = run(capsys, ["nmc", "--payoff", "vanilla_put",
                           "--n-inner", "8", "--exposure",
                           "--cva-hazard", "0.02", "--wwr-beta", "2.0",
                           "--wwr-spot-beta", "2.0",
                           "-N", "2048",
                           "--n-steps", "8", "--tile-rows", "8"])
    doc = json.loads(out)
    assert rc == 0
    assert doc["cva_wwr"] > doc["cva"]       # exposure link marks up
    assert doc["cva_wwr_spot"] < doc["cva"]  # put: right-way on spot


def test_mlmc_family_models(capsys):
    rc, out = run(capsys, ["mlmc", "--model", "cev", "--n-levels", "3",
                           "-N", "4096"])
    doc = json.loads(out)
    assert rc == 0 and doc["model"] == "cev" and doc["price"] > 0
    assert doc["variance_decay_rate"] > 0.3


def test_rainbow_greeks_cli(capsys):
    rc, out = run(capsys, ["rainbow", "--greeks", "-N", "65536"])
    doc = json.loads(out)
    assert rc == 0
    assert len(doc["delta"]) == 2 and len(doc["vega"]) == 2
    assert 0.0 < doc["delta"][0] < 1.0
    assert doc["cega_01"] < 0.0  # best-of loses value with correlation


def test_nmc_xva_flags(capsys):
    rc, out = run(capsys, ["nmc", "--payoff", "vanilla_call",
                           "--n-inner", "8", "--exposure",
                           "--cva-hazard", "0.02", "--dva-hazard", "0.03",
                           "--fva-spread", "0.01",
                           "--collateral-threshold", "5",
                           "--im-quantile", "0.99",
                           "--mva-spread", "0.01",
                           "--mpor-steps", "2"] + SMALL)
    doc = json.loads(out)
    assert rc == 0
    assert doc["mva"] > 0 and doc["initial_margin"][0] > 0
    assert doc["cva"] > 0 and doc["dva"] == 0.0  # long call: V >= 0
    assert doc["bilateral_cva"] == doc["cva"]
    assert doc["fca"] > 0 and doc["fba"] == 0.0
    assert 0 < doc["collateralized_cva"] <= doc["cva"]
    # first two dates are uncollateralized under the 2-step MPoR
    assert (doc["collateralized_ee"][0]
            == doc["expected_exposure"][0])


def test_hullwhite_book_and_bounds_cli(capsys):
    rc, out = run(capsys, ["hullwhite", "--book-k-rates", "0.04,0.045",
                           "--book-sides", "p,r", "--cva-hazard", "0.02",
                           "-N", "8192"])
    doc = json.loads(out)
    assert rc == 0 and doc["book_netted_cva"] > 0
    rc, out = run(capsys, ["hullwhite", "--bermudan", "--bounds",
                           "--qmc", "--greeks", "-N", "4096"])
    doc = json.loads(out)
    assert rc == 0
    assert doc["lower"] == doc["bermudan_price"]
    assert doc["upper"] >= doc["lower"]
    assert doc["bermudan_qmc_stderr"] < doc["bermudan_stderr"]
    assert (abs(doc["bermudan_qmc_price"] - doc["bermudan_price"])
            < 5 * (doc["bermudan_stderr"] + doc["bermudan_qmc_stderr"])
            + 2e-4)  # pilot-policy vs in-sample-fit slack
    assert doc["curve_dv01"] != 0 and "vega_r" in doc  # Bermudan greeks


def test_g2pp_cli(capsys):
    rc, out = run(capsys, ["g2pp", "--exposure", "--cva-hazard", "0.02",
                           "--qmc", "--greeks", "-N", "16384"])
    doc = json.loads(out)
    assert rc == 0
    assert abs(doc["z_score"]) < 5.0
    assert doc["swap_cva"] > 0
    assert abs(doc["qmc_price"] - doc["oracle"]) < 5 * doc["qmc_stderr"]
    assert doc["qmc_stderr"] < doc["stderr"]
    assert "vega_x" in doc and "vega_y" in doc


def test_calibrate_g2pp_cli(capsys):
    """Five-parameter G2 calibration on the CLI: repricing-gated (the
    (a, sigma) <-> (b_mr, eta) ridge makes parameter identity
    meaningless) — in-sample rmse ~1e-8 and an out-of-sample swaption
    repriced at the true model's value."""
    rc, out = run(capsys, ["calibrate", "--model", "g2pp"])
    doc = json.loads(out)
    assert rc == 0
    assert doc["price_rmse"] < 1e-6
    assert doc["oos_abs_err"] < 1e-5


def test_hullwhite_par_bootstrap_cli(capsys):
    """--par-swap-rates bootstraps the curve from the actual market
    input: the bootstrapped dfs reprice the quoted par rates (to the
    6-decimal df rounding in the JSON) and the MC still gates against
    the curve-consistent oracle."""
    from mc_tpu.models.hullwhite import DiscountCurve
    src = DiscountCurve([0.5, 1.0, 2.0, 3.0, 5.0],
                        [0.03, 0.035, 0.04, 0.043, 0.046])

    def par_from(dfs, m, tenor=0.5):
        n = round(m / tenor)
        return (1.0 - dfs[n - 1]) / (tenor * sum(dfs[:n]))

    src_dfs = [src.df(0.5 * (j + 1)) for j in range(10)]
    mats = [1.0, 2.0, 3.0, 5.0]
    pars = ",".join(f"{par_from(src_dfs, m):.10f}" for m in mats)
    rc, out = run(capsys, ["hullwhite", "--par-swap-rates", pars,
                           "--par-swap-times", "1,2,3,5",
                           "-N", "16384"])
    doc = json.loads(out)
    assert rc == 0 and abs(doc["z_score"]) < 5.0
    for m in mats:
        assert abs(par_from(doc["curve_dfs"], m)
                   - par_from(src_dfs, m)) < 1e-5
    rc, out = run(capsys, ["g2pp", "--par-swap-rates", pars,
                           "--par-swap-times", "1,2,3,5",
                           "-N", "16384"])
    doc = json.loads(out)
    assert rc == 0 and abs(doc["z_score"]) < 5.0  # same bootstrapped curve


def test_bucket_dv01_cli(capsys):
    """--bucket-dv01 emits the key-rate ladder on both curve models:
    one entry per knot, unused 0.5y pillar exactly zero, ladder sums
    near the parallel curve_dv01 emitted by --greeks."""
    rc, out = run(capsys, ["hullwhite", "--greeks", "--bucket-dv01",
                           "-N", "16384"])
    doc = json.loads(out)
    assert rc == 0
    assert doc["bucket_times"] == [0.5, 1.0, 2.0, 3.0, 5.0, 10.0]
    b = doc["bucket_dv01"]
    assert len(b) == 6 and b[0] == 0.0
    assert abs(sum(b) - doc["curve_dv01"]) < 2e-3 * abs(doc["curve_dv01"]) + 1e-9
    rc, out = run(capsys, ["g2pp", "--bucket-dv01", "-N", "8192"])
    doc = json.loads(out)
    assert rc == 0 and len(doc["bucket_dv01"]) == 6
    assert doc["bucket_dv01"][0] == 0.0


def test_risk_cli(capsys):
    """risk subcommand: full-reval VaR/ES with the delta-gamma and
    oracle cross rows; losses on a long book floor at its value."""
    rc, out = run(capsys, ["risk", "-N", "16384", "--n-steps", "1",
                           "--n-scenarios", "128",
                           "--book-strikes", "90,100,110",
                           "--book-weights", "1,-2,1"])
    doc = json.loads(out)
    assert rc == 0
    assert doc["es"] >= doc["var"]
    assert doc["var"] <= doc["base_value"] + 1e-6  # long book floors
    assert abs(doc["var"] - doc["oracle_var"]) < 0.05 * doc["base_value"]
    assert "dg_var" in doc
    rc, out = run(capsys, ["risk", "--method", "oracle",
                           "--payoff", "vanilla_put",
                           "--n-scenarios", "64"])
    doc = json.loads(out)
    assert rc == 0 and doc["es"] >= doc["var"]
    assert sum(doc["component_es"]) == pytest.approx(doc["es"],
                                                     abs=1e-5)
    # smile-model revaluation: --model heston crosses vs the CF oracle
    rc, out = run(capsys, ["risk", "--model", "heston", "-N", "8192",
                           "--n-steps", "16", "--n-scenarios", "32",
                           "--scenario-vol-of-vol", "0.25",
                           "--book-strikes", "90,110"])
    doc = json.loads(out)
    assert rc == 0 and doc["es"] >= doc["var"]
    assert doc["var"] == pytest.approx(doc["oracle_var"], rel=0.15)
    assert "dg_var" not in doc  # BS Taylor is not the smile model's
    # curve-scenario VaR on the rates desk (hullwhite --curve-var)
    rc, out = run(capsys, ["hullwhite", "-N", "16384", "--curve-var",
                           "--var-scenarios", "64",
                           "--book-k-rates", "0.04,0.045",
                           "--book-sides", "p,r"])
    doc = json.loads(out)
    assert rc == 0
    assert doc["curve_es"] >= doc["curve_var"]
    assert sum(doc["curve_component_es"]) == pytest.approx(
        doc["curve_es"], abs=1e-6)


def test_fx_cli(capsys):
    """fx subcommand: every contract carries its exact oracle + z."""
    rc, out = run(capsys, ["fx", "-N", "262144"] + SMALL[2:])
    doc = json.loads(out)
    assert rc == 0 and doc["contract"] == "quanto_call"
    assert abs(doc["z"]) < 5.0
    rc, out = run(capsys, ["fx", "--contract", "gk_put", "--x0", "1.2",
                           "--kx", "1.25", "-N", "262144"] + SMALL[2:])
    doc = json.loads(out)
    assert rc == 0 and abs(doc["z"]) < 5.0
    assert doc["oracle"] > 0


def test_bates_cli(capsys):
    """Bates SVJ subcommand: MC within 5 z of the factorized CF oracle,
    for both diffusion schemes."""
    for scheme in ("euler", "qe"):
        rc, out = run(capsys, ["bates", "--scheme", scheme,
                               "-N", "65536", "--n-steps", "16",
                               "--tile-rows", "8"])
        doc = json.loads(out)
        assert rc == 0
        z = (doc["price"] - doc["cf_oracle"]) / doc["stderr"]
        assert abs(z) < 5.0, (scheme, doc)
