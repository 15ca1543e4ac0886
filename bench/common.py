"""What every cell of the benchmark shares: finding a cell's files by name,
the environment a run keeps to, spans, the reduction of a profiler trace,
percentiles and the result line.

Nothing here imports the program: ``program_path()`` puts ``src/`` on the
import path, and only the timed drivers (``serve.py``, ``train.py``) import
``repro_torch`` after that.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# modules that no benchmark process may hold, compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


# ------------------------------------------------------------------ files
def load_json(kind: str, name: str) -> dict:
    """``bench/<kind>/<name>.json``: a cell (``workloads``) or a
    configuration (``configs``). A configuration names its model family
    (``"reference"``), by which ``reference/`` and ``counts/`` find its
    modules; there is no default."""
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file named {name!r} ({path})")
    body = json.loads(path.read_text())
    if kind == "configs" and "reference" not in body:
        raise KeyError(f"{path} names no model family: it needs a top-level \"reference\" key "
                       "(bench/reference/<family>.py)")
    return body


def load_module(kind: str, name: str):
    """``bench/<kind>/<name>.py`` as a module (a traffic generator or a
    per-layer metric's reader); names may hold dots, so it is loaded by path."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_metrics(cell: str, bench: dict | None = None) -> tuple[list, list]:
    """The cell's end-to-end and per-layer metric entries of ``BENCHMARK.json``."""
    bench = bench or benchmark()
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if cell in m.get("workloads", [cell] if m["moves"] in moved else [])]
    return e2e, layer


# ------------------------------------------------------------ environment
def keep_caches_in_checkout() -> None:
    """Every build and kernel cache under ``build/`` of the checkout, at
    fixed paths (the kernels' own ``build/torch_ext`` is fixed by the
    program); nothing of JAX or Flax loaded by a library."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton_cache"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def program_path() -> None:
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def forbidden_loaded(names=None) -> list[str]:
    """The modules of ``names`` (the process's, by default) whose whole
    top-level name is forbidden."""
    return sorted(m for m in (sys.modules if names is None else names)
                  if m.split(".")[0] in FORBIDDEN)


def card_check(torch, chips: int) -> None:
    """Exit non-zero, printing no result, without the cards the cell asks for."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: needs {chips} CUDA device(s), found {n}", file=sys.stderr)
        sys.exit(3)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


# ------------------------------------------------------------------ spans
class Spans:
    """Host spans around the calls into the program's layers: per name the
    count and total seconds, and under a profiler a ``record_function``
    range of the same name, so the trace can say what the host was doing."""

    def __init__(self, torch=None, traced: bool = False):
        self.torch, self.traced = torch, traced
        self.on = True                  # off once the measured window has closed
        self.total: dict[str, float] = {}
        self.count: dict[str, int] = {}
        self.values: dict[str, list] = {}

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        if not self.on:
            yield
            return
        ctx = (self.torch.profiler.record_function(f"bench.{name}") if self.traced
               else contextlib.nullcontext())
        with ctx:
            t0 = time.perf_counter()
            yield
            if sync and self.torch is not None and self.torch.cuda.is_available():
                self.torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        self.total[name] = self.total.get(name, 0.0) + dt
        self.count[name] = self.count.get(name, 0) + 1

    def add(self, name: str, value) -> None:
        """A counter or per-call value recorded beside the spans."""
        if self.on:
            self.values.setdefault(name, []).append(value)


# ---------------------------------------------------------------- numbers
def percentile(values: list[float], q: float) -> float:
    """The q-th percentile by linear interpolation between order statistics
    (numpy's default); an infinite value (a request that never answered)
    ranks above every other."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if xs[hi] == math.inf:
        return math.inf
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


# ------------------------------------------------------------------ trace
def reduce_trace(torch, prof, window_s: float) -> dict:
    """From a ``torch.profiler`` run: the seconds some device operation ran
    (the union of their intervals), device seconds and launches by name,
    the top operations, and the idle gaps between device work named by
    the innermost ``bench.*`` host range open at the gap's middle."""
    cuda = torch.autograd.DeviceType.CUDA
    evs = prof.events()
    # ranges (the harness's and the program's record_function) also show up
    # as device-side annotations: they are not device work
    ranges = {e.name for e in evs if getattr(e, "is_user_annotation", False)
              or e.name.startswith("bench.")}
    dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in evs
                 if e.device_type == cuda and e.name not in ranges)
    host = sorted((e.time_range.start, e.time_range.end, e.name[6:]) for e in evs
                  if e.device_type != cuda and e.name.startswith("bench."))
    by_name: dict[str, list] = {}
    busy_us, cur_s, cur_e, gaps = 0.0, None, None, []
    for s, e, name in dev:
        rec = by_name.setdefault(name, [0.0, 0])
        rec[0] += (e - s) / 1e6
        rec[1] += 1
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    idle: dict[str, float] = {}
    j, open_spans = 0, []
    for g0, g1 in gaps:                        # in time order, as the host spans
        mid = (g0 + g1) / 2
        while j < len(host) and host[j][0] <= mid:
            open_spans.append(host[j])
            j += 1
        open_spans = [h for h in open_spans if h[1] >= mid]
        name = open_spans[-1][2] if open_spans else "outside a bench span"
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"busy_s": busy_us / 1e6, "window_s": window_s,
            "kernels": {k: {"s": v[0], "n": v[1]} for k, v in by_name.items()},
            "device_ops": [[k[:120], v[0]] for k, v in top],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:10]}


class TraceWindow:
    """``torch.profiler`` over ``seconds`` of the measured window of a
    ``--trace 1`` run: its first seconds (``tick`` stops it at the first
    step boundary past them), or with ``at_end`` its last (an open loop,
    whose arrivals the profiler's stop would delay; the driver stops it as
    the window closes). The rest of the window runs unprofiled, so a
    traced run stays short and writes nothing to disk. A no-op otherwise."""

    def __init__(self, torch, on: bool, seconds: float, window: float = 0.0,
                 at_end: bool = False):
        self.torch, self.on, self.seconds = torch, on, seconds
        self.begin = max(0.0, window - seconds) if at_end else 0.0
        self.prof, self.active, self.length, self.t0 = None, False, 0.0, 0.0

    def prime(self) -> None:
        """Pay the profiler's start-up (CUPTI's, seconds) in the set-up."""
        if self.on:
            prof = self.torch.profiler
            with prof.profile(activities=[prof.ProfilerActivity.CPU,
                                          prof.ProfilerActivity.CUDA]):
                self.torch.zeros(1, device="cuda" if self.torch.cuda.is_available()
                                 else "cpu").add_(1)

    def maybe_start(self, elapsed: float) -> None:
        """Start once ``elapsed`` seconds of the window reach the traced part."""
        if not self.on or self.prof is not None or elapsed < self.begin:
            return
        prof = self.torch.profiler
        self.prof = prof.profile(activities=[prof.ProfilerActivity.CPU,
                                             prof.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.active, self.t0 = True, time.perf_counter()

    def tick(self) -> None:
        """Stop once the traced part is over."""
        if self.active and time.perf_counter() - self.t0 >= self.seconds:
            self.stop()

    def stop(self) -> None:
        if not self.active:
            return
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.length = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.active = False

    def reduce(self) -> dict | None:
        return reduce_trace(self.torch, self.prof, self.length) if self.prof else None


def kernel_seconds(trace: dict, *parts: str) -> tuple[float, int]:
    """Device seconds and launches of the kernels whose names hold any of
    ``parts``."""
    s = n = 0
    for name, rec in trace["kernels"].items():
        if any(p in name for p in parts):
            s += rec["s"]
            n += rec["n"]
    return s, n


# ----------------------------------------------------------------- result
def emit(result: dict, checks: dict) -> None:
    """The checks on standard error, each number beside its limit, then the
    result line (``checks`` last) as the last line of standard output."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"({'held' if c['held'] else 'FAILED'})", file=sys.stderr)
    found = forbidden_loaded()
    if found:
        print(f"bench: the process holds {found}; no result", file=sys.stderr)
        sys.exit(4)
    line = {**result, "checks": {k: {"value": c["value"], "limit": c["limit"]}
                                 for k, c in checks.items()}}
    print(json.dumps(line), flush=True)
