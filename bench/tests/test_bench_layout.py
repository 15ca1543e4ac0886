"""The benchmark's files: every cell, configuration, traffic kind and
metric named in BENCHMARK.json is found by name, and BENCHMARK.json keeps
to the contract's shape."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from bench_small import BENCH
import common
import counts
from reference import family

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
PER_LAYER = [m["name"] for m in SPEC["per_layer"]]
# a published key and the port key it maps to
HELD = {"hidden_size": "d_model", "num_hidden_layers": "n_layers", "vocab_size": "vocab",
        "num_experts_per_tok": "moe_topk"}


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and SPEC["command"] == ["python3", "bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in (
            "lower", "higher")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len((BENCH.parent / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    entry = next(w for w in SPEC["workloads"] if w["name"] == name)
    cell = common.load_json("workloads", name)
    assert cell["config"] == entry["config"] and cell["traffic"] == entry["traffic"]
    assert cell["why"] == entry["why"] and len(entry["why"]) <= 200
    assert entry["chips"] == 1
    conf = common.load_json("configs", cell["config"])
    assert conf["name"] == cell["config"]
    assert hasattr(common.load_module("traffic", cell["traffic_kind"]), "MODE")
    e2e, layer = common.cell_metrics(name, SPEC)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_configuration_files(conf):
    body = json.loads((BENCH.parent / conf["file"]).read_text())
    assert body["source"] == conf["source"] and body["reduced"] == conf["reduced"]
    for key in ("published", "assumed", "deployment", "departures", "port"):
        assert body[key]
    pub, port = body["published"], body["port"]
    for key, port_key in HELD.items():      # a cut (depth, vocabulary) is listed in reduced
        if key in pub and not {key, port_key} & set(body["reduced"]):
            assert port[port_key] == pub[key], key
    assert any(w["config"] == conf["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_configuration_names_its_family(conf):
    """The family a configuration names has its reference and its counts,
    with the interface the harness calls."""
    body = common.load_json("configs", conf["name"])
    fam = family(body)
    for name in ("draw_params", "served_logits", "layer", "layer_leaves", "small"):
        assert callable(getattr(fam, name)), name
    assert callable(counts.family(body).train_step_flops)
    small = fam.small(body["port"])
    assert small["dtype"] == "float32" and small["n_layers"] < body["port"]["n_layers"]


@pytest.mark.parametrize("name", [m["name"] for m in SPEC["end_to_end"]] + PER_LAYER)
def test_metric_readers(name):
    mod = common.load_module("metrics", name)
    entry = next(m for m in SPEC["end_to_end"] + SPEC["per_layer"] if m["name"] == name)
    assert mod.NAME == name and mod.UNIT == entry["unit"] and mod.SOURCE == entry["source"]
    if name in PER_LAYER:
        assert mod.LAYER == entry["layer"] and mod.MOVES == entry["moves"]
        for cell in entry["workloads"]:
            e2e, _ = common.cell_metrics(cell, SPEC)
            assert entry["moves"] in {m["name"] for m in e2e}


def test_new_workload_file_found_without_code_edit(tmp_path, monkeypatch):
    copy = tmp_path / "bench"
    shutil.copytree(BENCH / "workloads", copy / "workloads")
    shutil.copytree(BENCH / "configs", copy / "configs")
    cell = json.loads((copy / "workloads" / CELLS[0]).with_suffix(".json").read_text())
    cell["traffic_params"]["rate"] = 0.5
    (copy / "workloads" / "a-new-cell.json").write_text(json.dumps(cell))
    monkeypatch.setattr(common, "BENCH", copy)
    found = common.load_json("workloads", "a-new-cell")
    assert found["traffic_params"]["rate"] == 0.5
    assert common.load_json("configs", found["config"])["name"] == found["config"]
    with pytest.raises(FileNotFoundError):
        common.load_json("workloads", "no-such-cell")
