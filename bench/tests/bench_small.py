"""Small CPU versions of the benchmark's cells for the tests: the same
files, equations and code paths at widths a test run holds."""
from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import common  # noqa: E402
from reference import family  # noqa: E402


def small_conf(conf: dict) -> dict:
    """The configuration with its ``port`` section at the CPU tests' size,
    as its family's ``small`` shrinks it: the same equations at widths a
    test run holds, float32."""
    return {**conf, "port": family(conf).small(conf["port"])}


def small_cell(name: str) -> tuple[dict, dict]:
    """(cell, configuration) of cell ``name`` at the tests' size."""
    cell = copy.deepcopy(common.load_json("workloads", name))
    conf = small_conf(common.load_json("configs", cell["config"]))
    tp = cell["traffic_params"]
    if cell["traffic_kind"] == "open_loop_chat":
        tp["rate"] = 20
        tp["prompt"].update(median=24, lo=4, hi=64)
        tp["output"].update(median=8, lo=2, hi=16)
        cell["engine"].update(max_batch=4, num_sets=3, max_pages=24, page_size=4)
        cell["drain_s"] = 60
    else:
        tp.update(batch=4, seq=64)
    if "sample_tokens" in cell["check"]:
        cell["check"]["sample_tokens"] = 256
    return cell, conf


def run_small(name: str, seconds: float = 1.0, trace: bool = False, fault=None,
              seed: int = 3_000_000_017) -> dict:
    """A whole run of cell ``name`` at the tests' size on the CPU."""
    import run

    cell, conf = small_cell(name)
    return run.execute(name, cell, conf, seed, seconds, trace, "cpu", fault=fault,
                       t_process=time.perf_counter())
