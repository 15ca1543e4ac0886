"""The MoE, Mamba2 and hybrid families on the port's serving path: the paged
step's state route and the engine's tokens against the JAX engine and dense
greedy decode (reduced configs, float32)."""
import numpy as np
import pytest

import jax
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.models import transformer as JT
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.serving import ServeEngine
from repro_torch.serving.paged_model import init_pools, make_paged_decode_step

MAMBA_FAMILIES = ["mamba2-780m", "jamba-v0.1-52b"]
# at least ssm_conv - 1 = 3 tokens each: the JAX engine fails on shorter
# prompts (tests/test_torch_families.py::test_short_prompt_tail_is_zero_padded)
PROMPTS = [[5, 7, 11, 13, 17], [2, 3, 4], [21, 22, 23, 24, 25, 26, 27, 28, 29]]


def _dense_greedy(params, cfg, prompt, n):
    last, cache = T.prefill(params, torch.tensor([prompt]), cfg, max_seq=128)
    out = []
    t = last[:, -1, :].argmax(-1)[:, None]
    for _ in range(n):
        out.append(int(t[0, 0]))
        lg, cache = T.decode_step(params, t, cache, cfg)
        t = lg[:, -1, :].argmax(-1)[:, None]
    return out


# ---------------------------------------------------------------------------
# the paged step's state route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MAMBA_FAMILIES)
def test_paged_step_moves_only_active_rows_state(arch):
    """The step computes every row but writes the new mamba state only at
    the active rows (JAX's where(active, new, old))."""
    cfg = reduced(get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    pools = init_pools(cfg, num_pages=9, page_size=8, max_batch=3)
    gen = torch.Generator().manual_seed(1)
    for p in pools:
        for a in p.values():
            a.copy_(torch.randn(a.shape, generator=gen))
    before = [{k: a.clone() for k, a in p.items()} for p in pools]
    step = make_paged_decode_step(cfg, page_size=8)
    table = torch.arange(9, dtype=torch.int32).reshape(3, 3)
    step(params, pools, torch.tensor([[3], [4], [5]]), torch.tensor([5, 9, 2], dtype=torch.int32),
         table, torch.tensor([True, False, True]))
    for spec, p, old in zip(cfg.block, pools, before):
        if spec.kind != "mamba":
            continue
        for k, a in p.items():
            torch.testing.assert_close(a[:, 1], old[k][:, 1], atol=0, rtol=0)
            assert not torch.equal(a[:, 0], old[k][:, 0]) and not torch.equal(a[:, 2], old[k][:, 2])


def _cloned(pools):
    return tuple({k: a.clone() for k, a in p.items()} for p in pools)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b"] + MAMBA_FAMILIES)
def test_inactive_row_writes_nothing_an_active_row_reads(arch):
    """An inactive row with a stale length past its table, whose table
    points at an active row's live pages, changes no page but the sink
    (the pool's last page) and none of its own mamba state; the active
    rows' logits, K/V and state equal those of an all-active call on the
    same inputs, the inactive row given a length and pages of its own."""
    cfg = reduced(get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    page, b = 8, 4
    pools = init_pools(cfg, num_pages=b * 3 + 1, page_size=page, max_batch=b)
    gen = torch.Generator().manual_seed(1)
    for p in pools:
        for a in p.values():
            a.copy_(torch.randn(a.shape, generator=gen))
    sink = b * 3
    step = make_paged_decode_step(cfg, page_size=page)
    tokens = torch.tensor([[3], [4], [5], [6]])
    table = torch.arange(b * 3, dtype=torch.int32).reshape(b, 3)
    lengths = torch.tensor([5, 20, 2, 9], dtype=torch.int32)
    stale_table, stale_lengths = table.clone(), lengths.clone()
    stale_table[2], stale_lengths[2] = table[0], 3 * page + 7    # slot 3 of a 3-page table
    masked, full = _cloned(pools), _cloned(pools)
    with torch.no_grad():
        got = step(params, masked, tokens, stale_lengths, stale_table,
                   torch.tensor([True, True, False, True]))
        want = step(params, full, tokens, lengths, table, torch.ones(b, dtype=torch.bool))
    live, own = [0, 1, 3], table[2].tolist()
    torch.testing.assert_close(got[live], want[live], atol=2e-5, rtol=2e-5)
    for spec, p, m, w in zip(cfg.block, pools, masked, full):
        for k, a in m.items():
            if spec.kind == "attn":
                others = [q for q in range(sink) if q not in own]
                torch.testing.assert_close(a[:, others], w[k][:, others], atol=2e-5, rtol=2e-5)
                assert torch.equal(a[:, own], p[k][:, own])
            else:
                torch.testing.assert_close(a[:, live], w[k][:, live], atol=2e-5, rtol=2e-5)
                assert torch.equal(a[:, 2], p[k][:, 2])


class _HostValues(TorchDispatchMode):
    """The ops that compute with a tensor built from a host value
    (``torch.tensor``, ``aten.lift_fresh``). Taking its number back to the
    host (``.item()``, ``aten._local_scalar_dense``) is not such a use: a
    CUDA graph captures that number as a kernel argument."""

    def __init__(self):
        super().__init__()
        self.fresh: list[torch.Tensor] = []     # held, so no id is reused
        self.uses: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.lift_fresh.default:
            self.fresh.append(out)
        elif func is not torch.ops.aten._local_scalar_dense.default:
            read = tree_leaves((args, kwargs))
            if any(a is f for a in read for f in self.fresh):
                self.uses.append(str(func))
        return out


def test_host_value_detector_sees_a_device_tensor_of_a_host_value():
    """``_HostValues`` flags a product with ``torch.tensor(v)`` (a device
    tensor on a card) and passes one with ``torch.tensor(v).item()``."""
    x = torch.ones(3)
    with _HostValues() as c:
        x * torch.tensor(2.0, dtype=x.dtype, device=x.device)
    assert c.uses == ["aten.mul.Tensor"]
    with _HostValues() as c:
        x * torch.tensor(2.0, dtype=x.dtype).item()
    assert c.fresh and not c.uses


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a != "whisper-tiny"])
def test_paged_step_builds_no_tensor_from_host_values(arch):
    """No op of the paged step, in any family the engine serves, computes
    with a tensor built from a host value (gemma2's embedding scale once,
    M-RoPE's sections): on a card such a tensor is copied from host memory,
    and the engine captures the step in a CUDA graph, which would replay
    that copy from host memory long freed."""
    cfg = reduced(get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    pools = init_pools(cfg, num_pages=7, page_size=8, max_batch=2)
    args = (params, pools, torch.tensor([[3], [4]]), torch.tensor([5, 9], dtype=torch.int32),
            torch.arange(6, dtype=torch.int32).reshape(2, 3), torch.tensor([True, False]))
    step = make_paged_decode_step(cfg, page_size=8)
    with torch.no_grad(), _HostValues() as c:
        step(*args)
    assert not c.uses


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-780m", "jamba-v0.1-52b"])
def test_engine_tokens_match_jax_engine(arch):
    """Without preemption, the port's engine emits the JAX engine's greedy
    tokens, and those of dense prefill + decode."""
    jcfg = jax_reduced(jax_get_config(arch))
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = reduced(get_config(arch))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    kw = dict(max_batch=3, page_size=8, num_sets=16, set_size=4)
    eng, jeng = ServeEngine(cfg, params, device="cpu", **kw), JaxServeEngine(jcfg, jparams, **kw)
    rids = [eng.submit(p, max_new=10) for p in PROMPTS]
    jrids = [jeng.submit(p, max_new=10) for p in PROMPTS]
    eng.run(200)
    jeng.run(200)
    assert eng.stats()["preemptions"] == 0
    for rid, jrid, p in zip(rids, jrids, PROMPTS):
        assert eng.result(rid).state == "done"
        assert eng.result(rid).out == jeng.result(jrid).out
        assert eng.result(rid).out == _dense_greedy(params, cfg, p, 10)
    eng.close()
    jeng.close()


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-780m", "jamba-v0.1-52b"])
def test_engine_exact_under_pool_pressure(arch):
    """Preemption + offload + resume are lossless: engine tokens == dense
    greedy. For the mamba families this is a deviation from the reference:
    the port's engine keeps a preempted row's mamba state with the request
    and writes it back on resume, where the JAX engine loses it."""
    cfg = reduced(get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    eng = ServeEngine(cfg, params, max_batch=4, page_size=8, num_sets=4, set_size=3,
                      device="cpu")
    rng = np.random.default_rng(3)
    prompts = [[int(x) for x in rng.integers(1, 250, int(rng.integers(3, 20)))]
               for _ in range(6)]
    rids = [eng.submit(p, max_new=24) for p in prompts]
    eng.run(800)
    st = eng.stats()
    assert st["preemptions"] > 0, "test must exercise the pressure path"
    assert st["offloads"] > 0 and st["fetches"] > 0
    for rid, p in zip(rids, prompts):
        r = eng.result(rid)
        assert r.state == "done" and r.mamba_state is None
        assert r.out == _dense_greedy(params, cfg, p, 24), f"rid{rid}"
    eng.close()


@pytest.mark.parametrize("arch", MAMBA_FAMILIES)
def test_preempted_row_keeps_its_mamba_state_in_host_memory(arch):
    """Deviation (a): ``_preempt`` copies the row's mamba state into host
    memory (a copy, not a view of the pools, so preempted requests hold no
    device memory) and ``_refill_row`` writes it back when the request
    resumes, whatever the row held meanwhile."""
    cfg = reduced(get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    eng = ServeEngine(cfg, params, max_batch=2, page_size=8, num_sets=8, set_size=2,
                      device="cpu")
    rid = eng.submit(PROMPTS[0], max_new=8)
    eng.step()
    eng.step()
    req = eng.result(rid)
    live = {i: {k: a[:, req.row].clone() for k, a in eng.pools[i].items()}
            for i in eng._mamba_positions}
    eng._preempt(req)
    assert req.state == "preempted" and set(req.mamba_state) == set(live) != set()
    for i, st in req.mamba_state.items():
        for k, a in st.items():
            assert a.device.type == "cpu"
            assert a.untyped_storage().data_ptr() != eng.pools[i][k].untyped_storage().data_ptr()
            torch.testing.assert_close(a, live[i][k], atol=0, rtol=0)
            eng.pools[i][k].zero_()          # the row is another request's now
    eng._waiting.append(rid)
    eng.run(50)
    eng.close()
    assert req.state == "done" and req.mamba_state is None
    assert req.out == _dense_greedy(params, cfg, PROMPTS[0], 8)


@pytest.mark.parametrize("arch, n, refused", [
    ("mamba2-780m", 300, True), ("jamba-v0.1-52b", 257, True),
    ("mamba2-780m", 512, False), ("mamba2-780m", 255, False), ("olmoe-1b-7b", 300, False)])
def test_submit_checks_the_mamba_prefill_length(arch, n, refused):
    """A prompt the mamba prefill cannot take (longer than its 256-token
    chunk and not a multiple of it) is refused by ``submit``, before any
    engine state changes; other lengths, and models without mamba layers,
    are queued."""
    cfg = reduced(get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    eng = ServeEngine(cfg, params, max_batch=2, page_size=8, num_sets=8, set_size=2,
                      device="cpu")
    if refused:
        with pytest.raises(ValueError, match="not a multiple of it"):
            eng.submit([1] * n, max_new=4)
        assert eng._waiting == [] and eng._reqs == {} and eng._rows == [None, None]
        n = 5
    assert eng.submit([1] * n, max_new=4) == 0 and eng._waiting == [0]
    eng.close()


def test_attention_free_engine_copies_empty_pages():
    """mamba2 has no attention layer: pages hold no K/V, so the host-tier
    copies are empty lists, as in JAX."""
    cfg = reduced(get_config("mamba2-780m"))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    eng = ServeEngine(cfg, params, max_batch=2, page_size=8, num_sets=8, set_size=2,
                      device="cpu")
    rid = eng.submit([3, 1, 4, 1, 5, 9, 2, 6], max_new=4)
    eng.step()
    tag = eng.result(rid).pages[0]
    assert eng._copy_out(tag) == ([], [])
    eng._copy_in(tag, ([], []))
    eng.run(50)
    assert eng.result(rid).out == _dense_greedy(params, cfg, [3, 1, 4, 1, 5, 9, 2, 6], 4)
    eng.close()


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-780m"])
def test_serve_cli_smoke_preset(arch, capsys):
    """``launch.serve --arch <arch> --preset smoke`` finishes its requests."""
    eng = serve.main(["--arch", arch, "--preset", "smoke", "--device", "cpu",
                      "--requests", "4", "--max-new", "6"])
    assert all(r.state == "done" for r in eng._reqs.values())
    assert "4/4 done" in capsys.readouterr().out
