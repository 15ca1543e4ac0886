"""The trace schema of the SSD-array simulator's ``TraceSource``: the op
codes and column names a recorded trace carries. Only these four constants
of ``repro/core/workloads.py`` are copied: the port records traces
(``serving/trace_shim.py``), the simulator that replays them stays in the
JAX package, numpy on the host, and is not ported.
"""
from __future__ import annotations

# trace op codes for TraceSource arrays
TRACE_READ = 0
TRACE_WRITE = 1

# Trace schema: a trace is a float64 array of shape (n, 3), ``(time, lba,
# op)``, or (n, 4) with a trailing integer tenant column.
# ``serving.trace_shim`` emits and loads the versioned ``.npz`` form.
TRACE_VERSION = 1
TRACE_COLUMNS = ("time", "lba", "op", "tenant")
