"""The port's serving bench (``repro_torch.benchmarks.serving_bench``)
against the JAX package: the traffic of ``benchmarks/serving_bench.run``
(reduced tinyllama, 8 prompts of 16 tokens from seed 5, 24 new, batch 4,
page 8, 4 sets x 3) on weights converted from
``repro.models.transformer.init_params``.

In both flusher modes every request's tokens equal JAX's greedy decode of
its prompt (``prefill`` + ``decode_step``, the 8 prompts as one batch: they
are all 16 tokens long), which is what JAX's engine emits when it loses no
page: ``tests/test_serving.py`` holds the JAX engine to the same decode.
The JAX engine itself is not the oracle here: its ``step`` and
``_prefill_row`` replace ``self.pools`` outside ``_pools_lock``, so a
fetch worker's ``_copy_in`` that lands during a step is overwritten and
the resumed row attends over a stale page (ROADMAP Queue 3; on this
traffic with the flusher on, 2 runs of 60 emitted another token in one
row). The port's engine runs
each step under the lock. The result has JAX ``run()``'s keys, and the
flusher takes blocking offloads off the critical path
(``blocking_offload_reduction`` >= 0)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import transformer as JT
from repro_torch.benchmarks import serving_bench
from repro_torch.convert import params_from_jax

STATS = {"offloads", "fetches", "stale_discards", "clean_evictions", "dirty_evictions",
         "alloc_failures", "preemptions", "blocking_offloads"}


def _jax_greedy(cfg, params) -> list:
    """JAX's greedy tokens of the bench's 8 prompts, one batch."""
    rng = np.random.default_rng(5)
    prompts = np.array([[int(x) for x in rng.integers(1, 250, 16)] for _ in range(8)],
                       np.int32)
    logits, cache = JT.prefill(params, jnp.asarray(prompts), cfg, max_seq=64)
    step = jax.jit(lambda p, t, c: JT.decode_step(p, t, c, cfg))
    tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
    out = []
    for _ in range(24):
        out.append(np.asarray(tok[:, 0]))
        logits, cache = step(params, tok, cache)
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
    return np.stack(out, axis=1).tolist()


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    jcfg = jax_reduced(jax_get_config("tinyllama-1.1b"))
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    out_dir = tmp_path_factory.mktemp("bench_torch")
    res = serving_bench.run(device="cpu", out_dir=out_dir,
                            params=params_from_jax(jax.tree.map(np.asarray, jparams)))
    return res, jcfg, jparams, out_dir


@pytest.mark.parametrize("use_flusher", [True, False])
def test_tokens_equal_jax_greedy(bench, use_flusher):
    res, jcfg, jparams, _ = bench
    got = res["flusher_on" if use_flusher else "flusher_off"]
    assert got["outputs"] == _jax_greedy(jcfg, jparams)
    assert got["done"] == 8 and got["tokens"] == 8 * 24


def test_result_has_the_jax_keys(bench):
    res, _, _, out_dir = bench
    assert {"flusher_on", "flusher_off", "blocking_offload_reduction"} <= set(res)
    for mode in ("flusher_on", "flusher_off"):
        assert STATS | {"tokens", "wall_s"} <= set(res[mode])
        assert res[mode]["preemptions"] > 0
    assert res["blocking_offload_reduction"] >= 0
    assert res["blocking_offload_reduction"] == (res["flusher_off"]["blocking_offloads"]
                                                 - res["flusher_on"]["blocking_offloads"])
    assert json.loads((out_dir / "serving_flusher.json").read_text())["config"]["device"] == "cpu"
