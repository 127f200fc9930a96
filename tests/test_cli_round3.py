"""CLI smoke tests for the round-3 surfaces (netting-set NMC, model
NMC additions, dividends, calibration models, American greeks/bounds,
model QMC)."""

import json

from mc_tpu.cli import main

SMALL = ["-N", "2048", "--n-steps", "8", "--tile-rows", "8"]


def run(capsys, argv):
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_nmc_book(capsys):
    rc, out = run(capsys, ["nmc", "--book-strikes", "90,100,110",
                           "--book-weights", "1,-2,1",
                           "--payoff", "vanilla_call", "--n-inner", "8",
                           "--cva-hazard", "0.02"] + SMALL)
    doc = json.loads(out)
    assert rc == 0 and doc["n_contracts"] == 3
    assert doc["netted_cva"] > 0
    net = sum(w * p for w, p in
              zip([1, -2, 1], doc["per_contract_price"]))
    assert abs(doc["net_outer_price"] - net) < 1e-3


def test_nmc_new_models(capsys):
    for model in ("cev", "sabr", "basket"):
        rc, out = run(capsys, ["nmc", "--model", model, "--payoff",
                               "vanilla_call", "--n-inner", "8"] + SMALL)
        doc = json.loads(out)
        assert rc == 0 and doc["outer_price"] > 0, model


def test_divs_oracle_zscore(capsys):
    rc, out = run(capsys, ["divs", "--div-steps", "4",
                           "--div-amounts", "5", "-N", "100000",
                           "--n-steps", "10", "--tile-rows", "8"])
    doc = json.loads(out)
    assert rc == 0
    assert abs(doc["z_score"]) < 4.0


def test_calibrate_heston_cli(capsys):
    rc, out = run(capsys, ["calibrate", "--model", "heston"] + SMALL)
    doc = json.loads(out)
    assert rc == 0 and doc["iv_rmse"] < 1e-3


def test_qmc_model_cli(capsys):
    rc, out = run(capsys, ["qmc", "--model", "heston", "-N", "4096",
                           "--n-steps", "8", "--n-shifts", "4",
                           "--tile-rows", "8"])
    doc = json.loads(out)
    assert rc == 0 and doc["stderr"] > 0
    assert abs(doc["price"] - doc["cf_oracle"]) < 1.0


def test_american_greeks_cli(capsys):
    rc, out = run(capsys, ["american", "--greeks", "-N", "20000",
                           "--n-steps", "10", "--tile-rows", "8"])
    doc = json.loads(out)
    assert rc == 0
    assert abs(doc["delta"] - doc["crr_delta"]) < 0.08


def test_american_localvol_bounds_cli(capsys):
    rc, out = run(capsys, ["american", "--model", "localvol", "--bounds",
                           "--bounds-inner", "32", "-N", "8000",
                           "--n-steps", "8", "--tile-rows", "8"])
    doc = json.loads(out)
    assert rc == 0
    assert doc["upper"] + 0.3 >= doc["lower"]
    assert doc["gap"] == doc["upper"] - doc["lower"]


def test_nmc_rainbow_cli(capsys):
    rc, out = run(capsys, ["nmc", "--model", "rainbow", "--n-assets",
                           "2", "--payoff", "vanilla_call", "--n-inner",
                           "8", "--exposure"] + SMALL)
    doc = json.loads(out)
    assert rc == 0 and doc["outer_price"] > 0
    assert len(doc["expected_exposure"]) == 8


def test_american_rainbow_cli(capsys):
    rc, out = run(capsys, ["american", "--model", "rainbow",
                           "--n-assets", "2", "--payoff", "put_on_min",
                           "-N", "4096", "--n-steps", "8",
                           "--tile-rows", "8"])
    doc = json.loads(out)
    assert rc == 0 and doc["price"] > 0 and doc["model"] == "rainbow"


def test_american_rainbow_bounds_cli(capsys):
    rc, out = run(capsys, ["american", "--model", "rainbow", "--bounds",
                           "--n-assets", "2", "--payoff", "put_on_min",
                           "--bounds-inner", "16", "-N", "4096",
                           "--n-steps", "8", "--tile-rows", "8"])
    doc = json.loads(out)
    assert rc == 0
    assert doc["upper"] + 0.3 >= doc["lower"]


