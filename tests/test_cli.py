"""CLI smoke tests (the reference's ./main and ./test drivers, C14/C16)."""

import json

import numpy as np
import pytest

from mc_tpu.cli import main

SMALL = ["-N", "20000", "--n-steps", "10", "--tile-rows", "8"]


def run(capsys, argv):
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, out


def test_price_json(capsys):
    rc, out = run(capsys, ["price"] + SMALL)
    assert rc == 0
    doc = json.loads(out)
    assert abs(doc["price"] - doc["black_scholes"]) < 1.0
    assert doc["stderr"] > 0


def test_price_custom_market(capsys):
    rc, out = run(capsys, ["price", "--payoff", "vanilla_put", "-K", "90",
                           "--sigma", "0.3"] + SMALL)
    doc = json.loads(out)
    assert rc == 0 and doc["price"] > 0


def test_nmc_json(capsys):
    rc, out = run(capsys, ["nmc", "-N", "1024", "--n-steps", "6",
                           "--n-inner", "8", "--p1", "1", "--p2", "4",
                           "--tile-rows", "8"])
    doc = json.loads(out)
    assert rc == 0
    assert doc["n_points"] == 1024 * 6
    assert doc["outer_stderr"] > 0


def test_traj_csv(capsys, tmp_path):
    out_csv = str(tmp_path / "t.csv")
    rc, out = run(capsys, ["traj", "-N", "64", "--n-steps", "10",
                           "--tile-rows", "8", "--out", out_csv])
    doc = json.loads(out)
    assert rc == 0 and doc["trajectories"] == 64
    lines = open(out_csv).read().strip().splitlines()
    assert lines[0] == "time,trajectory,value"
    assert len(lines) == 1 + 64 * 10


def test_ladder_json(capsys):
    rc, out = run(capsys, ["ladder", "--n-strikes", "3"] + SMALL)
    doc = json.loads(out)
    assert rc == 0
    assert doc["prices"] == sorted(doc["prices"], reverse=True)


def test_greeks_json(capsys):
    rc, out = run(capsys, ["greeks", "--which", "delta"] + SMALL)
    doc = json.loads(out)
    assert rc == 0 and 0.5 < doc["delta"] < 1.0


def test_qmc_json(capsys):
    rc, out = run(capsys, ["qmc", "-N", "2053", "--n-shifts", "4",
                           "--tile-rows", "8"])
    doc = json.loads(out)
    assert rc == 0
    assert abs(doc["price"] - doc["black_scholes"]) < 0.2


def test_info(capsys):
    rc, out = run(capsys, ["info"])
    assert rc == 0 and "backend:" in out


def test_demo_table(capsys):
    rc, out = run(capsys, ["demo", "--skip-nmc", "-N", "20000",
                           "--n-steps", "10", "--tile-rows", "8"])
    assert rc == 0
    assert "Black-Scholes closed form" in out
    assert "bullet" in out


def test_unknown_command_fails(capsys):
    with pytest.raises(SystemExit):
        main(["frobnicate"])


def test_model_family_commands(capsys):
    """Every model family / technique has a CLI entry (C14 parity:
    hello.cu ran everything from one driver)."""
    import json

    from mc_tpu.cli import main
    for argv, key in ((["cev", "--n-paths", "20000", "--n-steps", "10"],
                       "ncx2_oracle"),
                      (["basket", "--n-paths", "20000", "--n-steps", "10"],
                       "n_assets"),
                      (["mlmc", "--n-paths", "8192", "--eps", "0.05"],
                       "variance_decay_rate"),
                      (["book", "--n-contracts", "4", "--n-paths", "20000",
                        "--n-steps", "4"], "prices"),
                      (["qmc", "--family", "sobol", "--n-paths", "4096",
                        "--n-steps", "8"], "price")):
        assert main(argv) == 0, argv
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert key in out, (argv, out)


def test_model_family_commands_round2(capsys):
    """Round-2 model subcommands: each emits its oracle column (merton,
    sabr, vasicek, term, localvol) and the localvol/vasicek American
    variants run end to end."""
    import json

    from mc_tpu.cli import main
    small = ["--n-paths", "8192", "--n-steps", "8"]
    for argv, key in (
            (["merton", *small], "merton_series_oracle"),
            (["sabr", *small], "hagan_oracle"),
            (["vasicek", "--payoff", "zcb", *small], "oracle"),
            (["term", *small], "oracle"),
            (["localvol", "--beta", "0.7", *small], "cev_oracle"),
            # out-of-range beta: price still printed, oracle skipped
            (["localvol", "--beta", "1.2", *small], "price"),
            (["american", "--model", "localvol", "--n-paths", "4096",
              "--n-steps", "8"], "price"),
            (["american", "--model", "vasicek", "--n-paths", "4096",
              "--n-steps", "8"], "price")):
        assert main(argv) == 0, argv
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert key in out, (argv, out)
