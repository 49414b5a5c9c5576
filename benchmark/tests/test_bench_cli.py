"""The command line and the last line's JSON form, at a tiny box on the
CPU."""

import json

import pytest

import run as run_mod


def test_arguments_parse():
    args = run_mod.parse(["--workload", "water23k-pme.dhdl500", "--seed",
                          "4294967311", "--seconds", "30", "--trace", "1"])
    assert (args.workload, args.seed, args.seconds, args.trace) == (
        "water23k-pme.dhdl500", 4294967311, 30.0, 1)
    with pytest.raises(SystemExit):
        run_mod.parse(["--workload", "x", "--seed", "1", "--seconds", "1",
                       "--trace", "2"])
    with pytest.raises(SystemExit):
        run_mod.parse(["--seed", "1", "--seconds", "1"])


def test_no_card_exits_without_a_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = run_mod.main(["--workload", "water23k-pme.dhdl500", "--seed",
                         "1", "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert code != 0
    assert out == ""
    assert "CUDA" in err


def test_too_few_cards_exit(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    code = run_mod.main(["--workload", "water23k-pme.dhdl500", "--seed",
                         "1", "--seconds", "1", "--trace", "0"])
    assert code != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("cell,trace", [("water23k-pme.dhdl500", 0),
                                        ("solute23k-pme.dhdl500", 1)])
def test_result_line_form(tiny_run, cell, trace):
    code, result = tiny_run(cell, seconds=1.0, trace=trace)
    assert code == 0
    # the result's keys, with the checks last
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    json.loads(json.dumps(result))
    for metric in result["metrics"].values():
        assert set(metric) == {"value", "unit"}
    if trace:
        # the profiled sample is left out of the host spans' metrics, and
        # a CPU run has no device operations to read
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert {"ns_day", "setup_s"} <= set(result["metrics"])
    for check in result["checks"].values():
        assert check["value"] <= check["limit"]


def test_same_seed_same_inputs(tiny_run):
    """The velocities, and so the whole state, come from the seed: the
    checked numbers repeat."""
    first = tiny_run("water23k-pme.dhdl500", seconds=0.0, seed=77)[1]
    second = tiny_run("water23k-pme.dhdl500", seconds=0.0, seed=77)[1]
    assert first["checks"] == second["checks"]


@pytest.mark.gpu
def test_tiny_cell_on_the_card(tiny_run):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    code, result = tiny_run("water23k-pme.dhdl500", seconds=1.0,
                            device="cuda")
    assert code == 0 and result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["memory_peak_bytes"] > 0
