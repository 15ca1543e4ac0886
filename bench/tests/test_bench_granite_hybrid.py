"""The Granite 4.0-H family (``granite_hybrid``): its reference's chunked SSD
against a token-by-token recurrence, its reference cut into smaller pieces
against itself, its counts at the cell's size, and the training cell run
through a copy of the benchmark to ``correct`` (and not, with a fault
planted)."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from bench_small import BENCH, small_conf
import common
import counts
from reference import granite_hybrid as G
from reference.plain import Matmul

CELL = "granite-h-train-32k"


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scan_inputs(b=2, s=200, h=3, p=4, n=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    f64 = dict(generator=g, dtype=torch.float64)
    return (torch.randn(b, s, h, p, **f64), torch.rand(b, s, h, **f64) * 0.3,
            -torch.rand(h, **f64) * 4, torch.randn(b, s, n, **f64), torch.randn(b, s, n, **f64))


@pytest.mark.parametrize("chunk", [16, 64])
def test_chunked_ssd_equals_the_recurrence(chunk):
    """Two chunk sizes, neither dividing the 200 tokens."""
    args = _scan_inputs()
    want = G.ssd_recurrence(*args)
    assert torch.allclose(G.ssd(*args, chunk=chunk), want, rtol=1e-10, atol=1e-10)


def test_reference_pieces_do_not_change_the_layer(monkeypatch):
    """A Mamba2 and an attention layer, forward and gradient, with the
    token and query chunks far smaller than the sequence: the same values
    as in one piece."""
    sz = G.small(common.load_json("configs", "granite-4.0-h-small")["port"])
    params = G.draw_params(sz, 7, "cpu")
    x = torch.randn((1, 96, sz["d_model"]), generator=torch.Generator().manual_seed(1))
    outs = {}
    for pieces in ("one", "many"):
        if pieces == "many":
            monkeypatch.setattr(G, "TOKEN_CHUNK", 16)
            monkeypatch.setattr(G, "ATTN_CHUNK", 8)
        for l in (0, 1):                                # Mamba2, attention
            xg = x.clone().requires_grad_()
            y, lb, z = G.layer(xg, G.layer_weights(params, l, sz), l, sz, Matmul(), None)
            (y.square().mean() + lb + z).backward()
            outs[pieces, l] = (y.detach(), xg.grad)
    for l in (0, 1):
        for a, b in zip(outs["one", l], outs["many", l]):
            assert torch.allclose(a, b, rtol=1e-5, atol=1e-6)


def test_drawn_mamba_ranges():
    """A in [-16, -1] and softplus(dt_bias) in [0.001, 0.1], Mamba2's own."""
    sz = G.small(common.load_json("configs", "granite-4.0-h-small")["port"])
    m = G.draw_params(sz, 11, "cpu")["blocks"][0]["attn"]
    a = torch.exp(m["A_log"])
    assert 1.0 <= float(a.min()) and float(a.max()) <= 16.0
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert 0.999e-3 <= float(dt.min()) and float(dt.max()) <= 0.1001


def test_counts_at_the_cell():
    """The cut's 1.323 B active parameters (9 Mamba2 layers of 102.2 M,
    one attention layer, ten routers, shared experts and 1.25 experts a
    token of 9 held, the head) and a step of 1 x 32,768 tokens: 260.1
    TFLOP of projections, 26.4 of attention, 5.6 of the SSD."""
    conf = common.load_json("configs", "granite-4.0-h-small")
    fam = counts.family(conf)
    sz = conf["port"]
    assert fam.mixer_params(sz, "mamba") == 102_236_160
    assert fam.active_params(sz) == 1_323_106_304
    assert fam.ssd_flops(sz, 1, 32768) == 207_504_801_792
    assert fam.train_step_flops(sz, 1, 32768) == 292_124_998_238_208


# ------------------------------------------- the cell through a copy's run.execute
RUNS = """
import json, sys
sys.path[:0] = [{tests!r}, {bench!r}, {src!r}]
import torch
torch.set_num_threads(2)
import run
from bench_small import small_cell
from model import port_config
from repro_torch.launch.steps import make_train_step
from test_bench_runs import _half_batch

cell, conf = small_cell({cell!r})
cell["checked_steps"] = 2


def shared_left_out(step):
    import dataclasses
    cfg = dataclasses.replace(port_config(conf), moe_shared_d_ff=0)
    o = cell["optimizer"]
    return make_train_step(cfg, remat=True, peak_lr=o["peak_lr"], warmup=o["warmup"],
                           total_steps=o["total_steps"], weight_decay=o["weight_decay"])


out = {{}}
for fault, trace in ((None, False), (None, True), (_half_batch, False), (shared_left_out, False)):
    res = run.execute({cell!r}, cell, conf, 3_000_000_029, 0.5, trace, "cpu", fault=fault)
    out[(fault.__name__ if fault else "sound") + (":traced" if trace else "")] = {{
        "correct": res["correct"], "checks": res["checks"], "metrics": sorted(res["metrics"])}}
print(json.dumps(out))
"""


def test_cell_runs_correct_through_a_copy(tmp_path):
    copy_bench = tmp_path / "bench"
    shutil.copytree(BENCH, copy_bench, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    script = RUNS.format(tests=str(copy_bench / "tests"), bench=str(copy_bench),
                         src=str(BENCH.parent / "src"), cell=CELL)
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["sound"]["correct"] and res["sound:traced"]["correct"], res
    assert set(res["sound"]["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert "mfu.train" in res["sound:traced"]["metrics"]
    assert not res["_half_batch"]["correct"], res["_half_batch"]
    assert not res["shared_left_out"]["correct"], res["shared_left_out"]


def test_small_is_the_family_at_the_tests_size():
    conf = common.load_json("configs", "granite-4.0-h-small")
    sz = small_conf(conf)["port"]
    kinds = [b["kind"] for b in sz["block"]]
    assert kinds.count("attn") == 1 and kinds.count("mamba") == 2
    assert (sz["moe_experts"], sz["moe_topk"], sz["moe_held_experts"]) == (72, 10, 9)
    assert sz["moe_shared_d_ff"] and sz["n_heads"] // sz["n_kv_heads"] == 4
