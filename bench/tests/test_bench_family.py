"""A configuration names its model family (``"reference"``), and the harness
finds the family's weights, reference, small size and counts by that name.

Pinned: at the tests' size, the tree each configuration draws, its served
logits (float32 and the float8 control) and two training steps of the
reference are the values the harness gave before the family modules
existed, bit for bit. And a family the harness has never seen (a block of
two layer specs, ``fixture_lm.py``) runs a serve cell and a train cell to
``correct`` from added files alone, its planted faults failing them."""
from __future__ import annotations

import copy
import hashlib
import json
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench_small import BENCH, small_cell, small_conf
import common
from reference import family, train_ref

SEED = 3_000_000_019
CONFIGS = ["olmoe-1b-7b", "granite-moe-1b-a400m"]
# computed at the tests' size with the harness as it was before the
# family modules (draw_params in model.py, moe_lm called by name)
PINS = {
    "olmoe-1b-7b": {
        "tree": "d13f8cbbd737a1f346e9479e566f1182d72f8307ac818891a610e8ebbcdec325",
        "served_fp32": "bcd7b5b4e15f8895331cd1e315f45344d046e14c1d60654c5a159bd6c28c01a7",
        "served_fp8": "415697027d3472873795d5740d17331b73c9a16abed7ad2ab2ad0f1c8151d5d7",
        "losses": ["0x1.a4b1b80000000p+2", "0x1.acc9740000000p+2"],
        "first_grad": "7c4c7c4e8f53280439be47394ec19be635ccd36ea497761e9408f6a5cc0bf692",
        "change": "b1b084139906625e17244b5d0ee64f914117fadd50db65a886d28d6772b5d4db",
    },
    "granite-moe-1b-a400m": {
        "tree": "88a4ccbc545809abdcbec488ef879a37e8e22249502a58c44d5d71a23e08fdb8",
        "served_fp32": "57db25f1c87a481a55f0854f8d130267257ac7688ed50eb86799d036b7d28bf3",
        "served_fp8": "f75f3de47a3454f23236a85a01def0ee9af952686f740ee2fb46093f7af426bd",
        "losses": ["0x1.ab90040000000p+2", "0x1.b485120000000p+2"],
        "first_grad": "b6c35c8f07cd4eb5bf38fcbb943bd0548e91fbb3e1f4de2071e6eb9d503c048c",
        "change": "a694add2af0dfda1ede93970a868be1a2a0ada644d69bc9cfa58fe3790d1cdde",
    },
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drawn(name: str):
    conf = small_conf(common.load_json("configs", name))
    return conf, family(conf).draw_params(conf["port"], SEED, "cpu")


def _sha(chunks) -> str:
    h = hashlib.sha256()
    for c in chunks:
        h.update(c)
    return h.hexdigest()


def _floats(d: dict) -> str:
    return _sha([f"{k}={float(v).hex()};".encode() for k, v in sorted(d.items())])


@pytest.mark.parametrize("name", CONFIGS)
def test_drawn_tree_is_pinned(name):
    """Every leaf's path, dtype, shape and bytes, in path order."""
    _, params = _drawn(name)
    leaves = sorted(train_ref.flat(params).items())
    got = _sha(c for path, t in leaves for c in (
        f"{path}:{t.dtype}:{tuple(t.shape)};".encode(), t.contiguous().numpy().tobytes()))
    assert got == PINS[name]["tree"]


@pytest.mark.parametrize("name", CONFIGS)
def test_served_logits_are_pinned(name):
    conf, params = _drawn(name)
    sz = conf["port"]
    rng = np.random.default_rng(5)
    seqs = [(rng.integers(0, sz["vocab"], 64 + 11).tolist(), 64),
            (rng.integers(0, sz["vocab"], 40 + 19).tolist(), 40)]
    for precision in ("fp32", "fp8"):
        logits = family(conf).served_logits(params, sz, seqs, precision=precision)
        assert _sha(t.contiguous().numpy().tobytes() for t in logits) == PINS[name][
            f"served_{precision}"], precision


@pytest.mark.parametrize("name", CONFIGS)
def test_training_steps_are_pinned(name):
    """``train_ref.run_steps`` over two batches of the training cell's
    traffic: each loss, every leaf's first gradient and change."""
    conf, params = _drawn(name)
    cell, _ = small_cell("granite-train-4k")
    traffic = common.load_module("traffic", cell["traffic_kind"])
    batches = [{k: torch.from_numpy(v) for k, v in traffic.batch(
        cell["traffic_params"], SEED, k, conf["port"]["vocab"]).items()} for k in range(2)]
    ref = train_ref.run_steps(params, conf, batches, cell["optimizer"], 1)
    assert [x.hex() for x in ref["losses"]] == PINS[name]["losses"]
    assert _floats(ref["first_grad"]) == PINS[name]["first_grad"]
    assert _floats(ref["change"]) == PINS[name]["change"]


def test_configuration_without_a_family_stops(tmp_path, monkeypatch):
    (tmp_path / "configs").mkdir()
    body = common.load_json("configs", CONFIGS[0])
    del body["reference"]
    (tmp_path / "configs" / "no-family.json").write_text(json.dumps(body))
    monkeypatch.setattr(common, "BENCH", tmp_path)
    with pytest.raises(KeyError, match=re.escape(str(tmp_path / "configs" / "no-family.json"))):
        common.load_json("configs", "no-family")


def test_only_the_family_modules_name_a_family():
    """No harness file outside a family's own modules names a family: each is
    reached through its configuration's ``"reference"`` key."""
    names = {common.load_json("configs", c)["reference"] for c in CONFIGS}
    for path in sorted(BENCH.rglob("*.py")):
        rel = path.relative_to(BENCH)
        if rel.parts[0] == "tests" or rel.stem in names and rel.parent.name in (
                "reference", "counts"):
            continue
        found = [n for n in names if n in path.read_text()]
        assert not found, (path, found)


# ------------------------------------------------- a family from new files only
FIXTURE = "fixture-lm"
FIXTURE_CONF = {
    "name": FIXTURE,
    "source": "the tests' family: jamba's alternating feed-forward, attention + MLP then "
              "attention + MoE",
    "reference": "fixture_lm",
    "reduced": [],
    "port": {"name": FIXTURE, "family": "moe", "n_layers": 8, "d_model": 256, "n_heads": 8,
             "n_kv_heads": 4, "d_ff": 512, "vocab": 4096, "head_dim": 32,
             "block": [{"kind": "attn", "ffn": "mlp"}, {"kind": "attn", "ffn": "moe"}],
             "moe_experts": 16, "moe_topk": 4, "moe_d_ff": 128, "moe_capacity_factor": 1.25,
             "moe_parallel": "tp", "qk_norm": True, "rope_theta": 10000.0, "norm_eps": 1e-06,
             "tie_embeddings": False, "act": "silu", "max_seq": 4096, "dtype": "bfloat16"},
}
# cell -> the cell it copies
FIXTURE_CELLS = {"fixture-chat": "olmoe-chat-pressure", "fixture-train": "granite-train-4k"}
ADDED = {f"configs/{FIXTURE}.json", "reference/fixture_lm.py", "counts/fixture_lm.py",
         *(f"workloads/{c}.json" for c in FIXTURE_CELLS)}
# run in the copy: each cell sound and with a fault of test_bench_runs.py planted
RUNS = """
import json, sys
sys.path[:0] = [{tests!r}, {bench!r}, {src!r}]
import torch
torch.set_num_threads(2)
from bench_small import run_small
from test_bench_runs import _alter_token, _half_batch
out = {{}}
for name, fault in (("fixture-chat", None), ("fixture-chat", _alter_token),
                    ("fixture-train", None), ("fixture-train", _half_batch)):
    res = run_small(name, seconds=1.0, trace=name == "fixture-train", fault=fault)
    out[name + ":" + (fault.__name__ if fault else "sound")] = {{
        "correct": res["correct"], "checks": res["checks"], "metrics": sorted(res["metrics"])}}
print(json.dumps(out))
"""


def _with_fixture(spec: dict) -> dict:
    """``BENCHMARK.json`` with the fixture's entries added."""
    spec = copy.deepcopy(spec)
    spec["configs"].append({"name": FIXTURE, "source": FIXTURE_CONF["source"],
                            "file": f"bench/configs/{FIXTURE}.json", "reduced": [],
                            "why": "a block of two layer specs"})
    reports = {"fixture-chat": ["itl_p50_ms"], "fixture-train": ["train_tokens_per_s",
                                                                 "mfu.train"]}
    for cell, like in FIXTURE_CELLS.items():
        entry = next(w for w in spec["workloads"] if w["name"] == like)
        spec["workloads"].append({**entry, "name": cell, "config": FIXTURE})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if m["name"] in reports[cell]:
                m["workloads"].append(cell)
    return spec


def _files(root) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_family_from_added_files_only(tmp_path):
    copy_bench = tmp_path / "bench"
    shutil.copytree(BENCH, copy_bench, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(_with_fixture(spec), indent=2))
    (copy_bench / "configs" / f"{FIXTURE}.json").write_text(json.dumps(FIXTURE_CONF))
    for cell, like in FIXTURE_CELLS.items():
        body = common.load_json("workloads", like)
        (copy_bench / "workloads" / f"{cell}.json").write_text(
            json.dumps({**body, "config": FIXTURE}))
    shutil.copy(BENCH / "tests" / "fixture_lm.py", copy_bench / "reference" / "fixture_lm.py")
    shutil.copy(BENCH / "tests" / "fixture_counts.py", copy_bench / "counts" / "fixture_lm.py")

    script = RUNS.format(tests=str(copy_bench / "tests"), bench=str(copy_bench),
                         src=str(BENCH.parent / "src"))
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.splitlines()[-1])
    for cell in FIXTURE_CELLS:
        assert res[f"{cell}:sound"]["correct"], res[f"{cell}:sound"]["checks"]
    assert not res["fixture-chat:_alter_token"]["correct"]
    assert not res["fixture-train:_half_batch"]["correct"]
    assert "mfu.train" in res["fixture-train:sound"]["metrics"]   # the fixture's counts

    orig, got = _files(BENCH), _files(copy_bench)
    assert set(got) - set(orig) == ADDED
    assert [k for k in orig if got.get(k) != orig[k]] == []
