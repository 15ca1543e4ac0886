"""Whole runs of the cells on the CPU at the tests' size, the program's
kernels replaced by their plain versions: the result line's keys, the
program held to the reference, and ``correct`` coming out false with the
timed path broken underneath (each fault the cell can have) and with the
control (the reference in float8) judged in the program's place."""
from __future__ import annotations

import copy
import json
import subprocess
import sys

import pytest
import torch

from bench_small import BENCH, run_small, small_cell
import common
import model
import serve
from reference import family

@pytest.fixture(autouse=True)
def two_threads():
    """Two threads a test: the tests run beside others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


KEYS = {"correct", "attempted", "failed", "metrics", "device"}
SERVE = ["olmoe-chat-pressure"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", SERVE + ["granite-train-4k"])
def test_result_keys_and_reference_match(name, trace):
    res = run_small(name, seconds=1.0, trace=trace)
    assert set(res) == KEYS | {"checks"} | ({"breakdown"} if trace else set())
    assert list(res)[-1] == "checks"
    assert res["correct"], res["checks"]
    e2e, layer = common.cell_metrics(name)
    want = {m["name"] for m in (layer if trace else e2e)}
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want
    for c in res["checks"].values():         # the program in float32 here: rounding only
        assert c["value"] is not None and c["value"] <= max(c["limit"], 0) + 1e-4
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_pressure_preempts_and_stays_correct():
    """Under the pressure cell's pool rows are preempted, offloaded, fetched
    back and resumed, and the run still holds to the reference."""
    preempted = []

    def spy(engine):
        preempt = engine._preempt
        engine._preempt = lambda req: (preempted.append(req.rid), preempt(req))[1]

    res = run_small("olmoe-chat-pressure", seconds=2.0, fault=spy)
    assert preempted and res["correct"], res["checks"]


def _keep_pools(engine):
    step = engine.step_fn

    def unchanged(params, pools, *args):       # the step writes into copies
        return step(params, tuple({k: v.clone() for k, v in p.items()} for p in pools), *args)
    engine.step_fn = unchanged


def _alter_token(engine):
    step = engine.step_fn
    engine.step_fn = lambda *args: step(*args).roll(1, dims=-1)


@pytest.mark.parametrize("fault", [_keep_pools, _alter_token])
@pytest.mark.parametrize("name", SERVE)
def test_serving_faults_fail(name, fault):
    res = run_small(name, fault=fault)
    assert not res["correct"]
    assert res["checks"]["mean_gap"]["value"] > res["checks"]["mean_gap"]["limit"]


def _state_unchanged(step):
    def broken(params, state, batch):
        _, _, metrics = step(copy.deepcopy(params), copy.deepcopy(state), batch)
        return params, state, metrics
    return broken


def _half_batch(step):
    return lambda params, state, batch: step(
        params, state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_training_faults_fail(fault):
    res = run_small("granite-train-4k", seconds=0.5, fault=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", SERVE)
def test_serving_control_fails(name):
    """The cell's traffic at its own load, the sample a run would judge,
    and the control's mean gap over it against the cell's limit."""
    from reference import judge

    cell, conf = small_cell(name)
    cfg = model.port_config(conf)
    traffic = common.load_module("traffic", cell["traffic_kind"])
    for seed in (11, 12, 13):
        params = family(conf).draw_params(conf["port"], seed, "cpu")
        engine = serve.engine_for(cfg, params, cell["engine"], "cpu")
        work = traffic.generate(cell["traffic_params"], seed, 1.0, cfg.vocab)
        w = serve.drive(engine, work, 1.0, cell, common.Spans(torch),
                        common.TraceWindow(torch, False, 0.0), False, 0.0)
        engine.run(max_steps=2000)
        finished = [(t.prompt, list(engine.result(r).out), t.preempted)
                    for r, t in w["tracks"].items() if engine.result(r).state == "done"]
        engine.close()
        picked = judge.sample(finished, seed, cell["check"]["sample_tokens"])
        gaps = judge.served_gaps(params, conf, picked, control=True)["control"]
        assert judge.gap_numbers(gaps)["mean_gap"] > cell["check"]["mean_gap"]


def test_training_control_fails():
    from reference import judge, train_ref

    cell, conf = small_cell("granite-train-4k")
    cfg = model.port_config(conf)
    traffic = common.load_module("traffic", cell["traffic_kind"])
    for seed in (11, 12, 13):
        params = family(conf).draw_params(conf["port"], seed, "cpu")
        batches = [{k: torch.from_numpy(v) for k, v in
                    traffic.batch(cell["traffic_params"], seed, k, cfg.vocab).items()}
                   for k in range(cell["checked_steps"])]
        args = (params, conf, batches, cell["optimizer"], cell["microbatches"])
        got = judge.train_numbers(train_ref.run_steps(*args, precision="fp8"),
                                  train_ref.run_steps(*args))
        assert any(got[k] > cell["check"][k] for k in cell["check"]), got


def test_command_prints_no_result_without_a_card(tmp_path):
    """The real command on this machine: no card, a non-zero exit, no result
    line; and run in a directory that holds only BENCHMARK.json and bench/
    (no program) it fails the same way."""
    args = ["--workload", "olmoe-chat-pressure", "--seed", "1", "--seconds", "1"]
    for root in (BENCH.parent, tmp_path):
        if root == tmp_path:
            import shutil
            shutil.copytree(BENCH, tmp_path / "bench",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
        out = subprocess.run([sys.executable, "bench/run.py", *args], cwd=root,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_emit_prints_checks_last(capsys, monkeypatch):
    monkeypatch.setattr(common, "forbidden_loaded", lambda names=None: [])
    common.emit({"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {}},
                {"widest_gap": {"value": 0.5, "limit": 1.0, "held": True}})
    out, err = capsys.readouterr()
    line = json.loads(out.splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert err.splitlines()[-1].startswith("check widest_gap: 0.5 limit 1.0")
