"""The port's cost counter (``repro_torch.launch.cost``) and its kernel
formulas.

* Counting rules, the counterparts of ``tests/test_hlo_cost_model.py``: a
  slice write is credited with the slice, a scatter with its updates,
  elementwise work has no FLOPs, and a loop of matmuls counts each.
* The kernel formulas at the shapes ``PERF.md`` prints (chip_smoke.py
  phase 3's bounds), the operators' fake implementations (``opcheck``),
  and the counter charging each kernel operator by its formula.
* FLOP parity with ``repro.launch.hlo_cost.analyze`` of the jitted JAX
  function on the same reduced config and shapes, both sides shape-only
  (``jax.ShapeDtypeStruct``; fake tensors). Forward, prefill and decode of
  reduced tinyllama, qwen3, olmoe, mamba2, whisper-tiny and qwen2-vl, and
  the train step of tinyllama and olmoe, equal exactly, but for four
  named gaps, each held at its measured size:
  - mamba2's forward counts 1,048,576 FLOPs (4.4 %) more: the inter-chunk
    einsum ``bcln,bclh,bchnp->bclhp`` (``models/ssm.py``, ``y_inter``) over
    the zero initial state. JAX's forward keeps no state, so XLA simplifies
    its one-trip scan and folds the product with zeros away; the port
    computes it (PyTorch runs every einsum). Prefill, which returns the
    state, is equal.
  - prefill counts the K/V projections twice: the port projects them once
    for the cache (``layers.project_kv``) and again inside
    ``multihead_attention`` (ROADMAP's parked prefill lever), where XLA's
    CSE merges JAX's two identical products. With ``project_kv``'s FLOPs
    taken off, the counts are equal.
  - whisper's prefill: JAX counts its cross-attention K/V projections
    twice (in each decoder layer's cross-attention, and again in
    ``encode_cross_kv`` for the cache, in another loop, so no CSE), the
    port once: it projects them in ``encode_cross_kv`` and feeds the same
    K/V to the cross-attention and the cache. JAX's count is larger by
    exactly those projections (524,288 FLOPs at this size).
  - a train step of one loss chunk (S 64 <= 1,024) counts the chunk's
    logits matmul twice: both packages recompute it in the backward
    (a checkpoint per chunk), but XLA inlines JAX's one-trip scan and its
    CSE merges the recompute with the forward. At S 2,048 (two chunks, a
    real loop) the train steps are equal exactly.
* The card's route: with the flash kernel as an operator, the count is
  the CPU route's, minus the plain attention's matmuls, plus the flash
  formula; a train step's attention backward is one backward kernel
  operator a layer and microbatch, charged by its formula. This CPU build of PyTorch cannot index a fake CUDA tensor from
  Python (``tensor[i]`` asks for a CUDA device guard), so the model runs on
  fake CPU tensors that answer ``is_cuda`` True: ``layers._attend`` then
  takes its card branch, the operator, unchanged.
* Per device: on a fake process group of 256 ranks, a (16, 16)-sharded
  matmul counts one device's product, once (DTensor's global-shape
  propagation is not counted), and a partial sum's all-reduce its payload.
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import ShapeConfig as JaxShape
from repro.launch import specs as JS
from repro.launch import steps as JSteps
from repro.launch.hlo_cost import analyze as hlo_analyze
from repro.models import transformer as JT
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import (flash_attention, flash_attention_bwd, flush_score, ops,
                                  paged_attention)
from repro_torch.launch import cost
from repro_torch.launch import specs as S
from repro_torch.launch import steps as Steps
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init

# ---------------------------------------------------------------------------
# counting rules
# ---------------------------------------------------------------------------


def test_slice_write_credited_as_slice_not_buffer():
    """64 row writes into a (512, 256) buffer charge 64 rows, not 64 buffers
    (JAX: a scan of dynamic-update-slice)."""
    n, rows, d = 64, 512, 256
    buf, xs = torch.zeros(rows, d), torch.randn(n, d)
    with cost.CostMode() as c:
        for i in range(n):
            buf[i].copy_(xs[i])
    assert c.memory_bytes == n * d * 4
    assert torch.equal(buf[:n], xs)


def test_scatter_credited_as_updates():
    buf = torch.zeros(4096, 128)
    idx, upd = torch.arange(8), torch.randn(8, 128)
    with cost.CostMode() as c:
        buf.index_put_((idx,), upd)
        out = buf.scatter(0, idx[:, None].expand(8, 128), upd)
    assert c.memory_bytes == 2 * upd.numel() * 4 < buf.numel() * 4
    assert torch.equal(out[:8], upd)


def test_flops_exclude_elementwise():
    x = torch.randn(1024, 1024)
    with cost.CostMode() as c:
        torch.tanh(x) * 2 + 1
    assert c.flops == 0
    assert c.memory_bytes == 3 * x.numel() * 4      # three outputs written, no operand read


def test_loop_of_matmuls_counts_each():
    """The eager counterpart of JAX's nested scans (3 x 4 trips): every
    matmul runs and is counted, a matmul's operands read."""
    x = torch.randn(128, 128)
    with cost.CostMode() as c:
        for _ in range(4):
            for _ in range(3):
                x = torch.tanh(x @ x)
    assert c.flops == 12 * 2 * 128 ** 3
    assert c.memory_bytes == 12 * 4 * 128 * 128 * 4     # mm reads 2, writes 1; tanh writes 1


def test_views_and_empty_write_nothing():
    x = torch.randn(64, 64)
    with cost.CostMode() as c:
        x.reshape(-1)[:10].view(2, 5)
        x.t().unsqueeze(0).expand(3, 64, 64)
        torch.empty(1 << 20)
    assert c.memory_bytes == 0
    with cost.CostMode() as c:
        x.t().reshape(-1)              # not a view: a copy of 64 x 64
    assert c.memory_bytes == x.numel() * 4


# ---------------------------------------------------------------------------
# kernel formulas, the operators, and the counter charging them
# ---------------------------------------------------------------------------

PAGED_TIMED = {   # chip_smoke.py PAGED_TIMED: table, lengths -> bytes in PERF.md
    "serve": (64, [42, 52, 6, 59], 716_864),
    "decode-4k": (264, [4098, 4104, 4098, 4103], 67_256_352),
    "decode-32k": (2048, [32768], 134_242_308),
}


@pytest.mark.parametrize("name", list(PAGED_TIMED))
def test_paged_formula_at_perf_shapes(name):
    table, lengths, want = PAGED_TIMED[name]
    b = len(lengths)
    got = paged_attention.cost((b, 32, 128), (1, 16, 8, 128), (b, table), 2, lengths)
    assert got["bytes"] == want
    assert got["flops"] == 4 * 32 * 128 * sum(lengths)
    worst = paged_attention.cost((b, 32, 128), (1, 16, 8, 128), (b, table), 2)
    assert worst == paged_attention.cost((b, 32, 128), (1, 16, 8, 128), (b, table), 2,
                                         [table * 16] * b)


def test_flush_and_flash_formulas_at_perf_shapes():
    assert flush_score.cost(131_072, 12) == {"flops": 0, "bytes": 14_680_064}
    assert flash_attention.pairs(4096, 4096, True, 0, 0) == 8_390_656
    got = flash_attention.cost((1, 4096, 32, 128), (1, 4096, 8, 128), 2)
    assert got["flops"] == 4 * 32 * 128 * 8_390_656 == 137_472_507_904
    assert got["bytes"] == 2 * (2 * 4096 * 32 * 128 + 2 * 4096 * 8 * 128)


@pytest.mark.parametrize("sq,skv,causal,window,q_offset", [
    (16, 16, True, 0, 0), (16, 48, False, 0, 0), (13, 40, True, 5, 27), (64, 64, True, 8, 0),
    (7, 100, True, 0, 93), (130, 200, True, 4, 197), (5, 9, False, 3, 2), (1, 1, True, 0, 0)])
def test_flash_pairs_equal_the_masks(sq, skv, causal, window, q_offset):
    qpos = np.arange(sq)[:, None] + q_offset
    kpos = np.arange(skv)[None, :]
    mask = np.ones((sq, skv), bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    assert flash_attention.pairs(sq, skv, causal, window, q_offset) == int(mask.sum())


def _kernel_calls():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g) for s in ((2, 20, 4, 16), (2, 24, 2, 16),
                                                     (2, 24, 2, 16)))
    pq = torch.randn(3, 4, 16, generator=g)
    pages = torch.randn(6, 8, 2, 16, generator=g)
    table = torch.randint(0, 6, (3, 4), generator=g, dtype=torch.int32)
    lengths = torch.tensor([5, 0, 17], dtype=torch.int32)
    hits = torch.randint(0, 9, (10, 7), generator=g, dtype=torch.int32)
    clock = torch.randint(-50, 50, (10,), generator=g, dtype=torch.int32)
    valid = torch.rand(10, 7, generator=g) > 0.3
    return {"flash_attention": (q, k, v, True, 4, 0.0, 4),
            "paged_attention": (pq, pages, pages.clone(), table, lengths, 0.0),
            "flush_scores": (hits, clock, valid)}


@pytest.mark.parametrize("name", ["flash_attention", "paged_attention", "flush_scores"])
def test_kernel_operator_registration(name):
    """Schema, fake implementation and dispatch of each kernel operator, by
    ``torch.library.opcheck``; on CPU tensors it is the plain version."""
    args = _kernel_calls()[name]
    op = getattr(torch.ops.repro_torch, name).default
    torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))
    from repro_torch.kernels import ref
    plain = {"flash_attention": lambda q, k, v, c, w, s, o: ref.flash_attention_ref(
                 q, k, v, causal=c, window=w, softcap=s, q_offset=o),
             "paged_attention": lambda *a: ref.paged_attention_ref(*a[:5], softcap=a[5]),
             "flush_scores": ref.flush_scores_ref}[name]
    assert torch.equal(op(*args), plain(*args))


def test_counter_charges_kernel_operators_by_formula():
    calls = _kernel_calls()
    q, k, _, causal, window, _, q_offset = calls["flash_attention"]
    pq, pages, _, table, lengths, _ = calls["paged_attention"]
    hits = calls["flush_scores"][0]
    want = {"flash_attention": flash_attention.cost(q.shape, k.shape, 4, causal=causal,
                                                    window=window, q_offset=q_offset),
            "paged_attention": paged_attention.cost(pq.shape, pages.shape, table.shape, 4,
                                                    lengths.tolist()),
            "flush_scores": flush_score.cost(*hits.shape)}
    for name, args in calls.items():
        with cost.CostMode() as c:
            getattr(torch.ops.repro_torch, name)(*args)
        assert (c.flops, c.memory_bytes) == (want[name]["flops"], want[name]["bytes"]), name
        assert c.kernel_calls == {name: 1}
    # through the public entry points, and on fake tensors (no lengths to
    # read: the paged formula's whole table)
    mode = FakeTensorMode()
    fake = {n: tuple(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args)
            for n, args in calls.items()}
    with mode, cost.CostMode() as c:
        ops.flash_attention(*fake["flash_attention"][:3], causal=causal, window=window,
                            q_offset=q_offset)
        ops.paged_attention(*fake["paged_attention"][:5])
        ops.flush_scores(*fake["flush_scores"])
    worst = paged_attention.cost(pq.shape, pages.shape, table.shape, 4)
    assert c.flops == want["flash_attention"]["flops"] + worst["flops"]
    assert c.memory_bytes == sum(want[n]["bytes"] for n in ("flash_attention", "flush_scores")) \
        + worst["bytes"]


# ---------------------------------------------------------------------------
# FLOP parity with the JAX package's HLO count
# ---------------------------------------------------------------------------

PARITY_ARCHS = ["tinyllama-1.1b", "qwen3-8b", "olmoe-1b-7b", "mamba2-780m", "whisper-tiny",
                "qwen2-vl-72b"]


def _jax_flops(arch: str, mode: str, seq: int, batch: int, remat: bool) -> float:
    cfg = jax_reduced(jax_get_config(arch))
    shape = JaxShape("t", seq, batch, mode)
    params = JS.params_specs(cfg)
    if mode == "forward":
        kw = {}
        if cfg.encoder_layers:
            kw["enc_frames"] = jax.ShapeDtypeStruct((batch, cfg.encoder_seq, cfg.d_model),
                                                    np.float32)
        if cfg.vis_tokens:
            kw["vis_embeds"] = jax.ShapeDtypeStruct((batch, cfg.vis_tokens, cfg.d_model),
                                                    np.float32)
        fn = jax.jit(lambda p, t, **k: JT.forward_logits(p, t, cfg, remat=False, **k))
        lowered = fn.lower(params, jax.ShapeDtypeStruct((batch, seq), np.int32), **kw)
    elif mode == "train":
        fn = jax.jit(JSteps.make_train_step(cfg, None, remat=remat))
        lowered = fn.lower(params, jax.eval_shape(jax_adamw_init, params),
                           JS.train_batch_specs(cfg, shape))
    elif mode == "prefill":
        fn = jax.jit(JSteps.make_prefill_step(cfg, seq))
        lowered = fn.lower(params, JS.prefill_batch_specs(cfg, shape))
    else:
        fn = jax.jit(JSteps.make_decode_step(cfg))
        lowered = fn.lower(params, JS.cache_specs_struct(cfg, batch, seq),
                           JS.decode_batch_specs(cfg, shape))
    return hlo_analyze(lowered.compile().as_text())["flops"]


def _port_cost(arch: str, mode: str, seq: int, batch: int, remat: bool) -> dict:
    cfg = reduced(get_config(arch))
    shape = ShapeConfig("t", seq, batch, mode)
    fm = FakeTensorMode()
    params = S.params_specs(cfg, "cpu", fm)
    with fm:
        if mode == "forward":
            kw = {}
            if cfg.encoder_layers:
                kw["enc_frames"] = torch.empty(batch, cfg.encoder_seq, cfg.d_model)
            if cfg.vis_tokens:
                kw["vis_embeds"] = torch.empty(batch, cfg.vis_tokens, cfg.d_model)
            tokens = torch.empty(batch, seq, dtype=torch.int32)
            fn = lambda: T.forward_logits(params, tokens, cfg, remat=False, **kw)
        elif mode == "train":
            args = (params, adamw_init(params), S.train_batch_specs(cfg, shape, "cpu", fm))
            fn = lambda: Steps.make_train_step(cfg, None, remat=remat)(*args)
        elif mode == "prefill":
            batch_specs = S.prefill_batch_specs(cfg, shape, "cpu", fm)
            fn = lambda: Steps.make_prefill_step(cfg, seq)(params, batch_specs)
        else:
            args = (params, S.cache_specs_struct(cfg, batch, seq, "cpu", fm),
                    S.decode_batch_specs(cfg, shape, "cpu", fm))
            fn = lambda: Steps.make_decode_step(cfg)(*args)
        with torch.set_grad_enabled(mode == "train"):
            return cost.analyze(fn, breakdown=True)


def _path_flops(res: dict, needle: str) -> int:
    return sum(v[0] for k, v in res["by_path"].items() if needle in k)


@pytest.mark.parametrize("mode", ["forward", "prefill", "decode"])
@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_flops_equal_jax_hlo_count(arch, mode):
    got = _port_cost(arch, mode, 64, 2, remat=False)
    want = _jax_flops(arch, mode, 64, 2, remat=False)
    flops = got["flops"]
    if mode == "prefill":
        flops -= _path_flops(got, "transformer.prefill > models.layers.project_kv")
    if arch == "whisper-tiny" and mode == "prefill":
        cross = _path_flops(got, "encode_cross_kv > models.layers.project_kv")
        assert want - flops == cross == 2 * 2 * 2 * 2 * 16 * 64 * 32   # K, V x 2 layers
        return
    if arch == "mamba2-780m" and mode == "forward":
        assert flops - want == 1_048_576 == 2 * 2 * 2 * 64 * 8 * 16 * 16   # y_inter x 2 layers
        assert flops / want - 1 == pytest.approx(0.044, abs=1e-3)
        return
    assert flops == want


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b"])
def test_train_step_flops_equal_jax_hlo_count(arch):
    """Two loss chunks (S 2,048): equal exactly. One chunk (S 64): the
    chunk's logits matmul once more, 2 B S D V."""
    assert (_port_cost(arch, "train", 2048, 1, remat=True)["flops"]
            == _jax_flops(arch, "train", 2048, 1, remat=True))
    cfg = reduced(get_config(arch))
    gap = 2 * 2 * 64 * cfg.d_model * cfg.vocab
    got = _port_cost(arch, "train", 64, 2, remat=True)["flops"]
    want = _jax_flops(arch, "train", 64, 2, remat=True)
    assert got - want == gap
    assert abs(got / want - 1) < {"tinyllama-1.1b": 0.042, "olmoe-1b-7b": 0.0092}[arch]


@pytest.mark.parametrize("arch", ["qwen3-8b", "whisper-tiny"])
def test_card_route_is_cpu_route_with_the_flash_formula(arch, monkeypatch):
    """Forward of reduced ``arch`` (B 2, S 64; whisper's encoder is
    non-causal over 16 frames): the card's count is the CPU route's without
    the plain attention's matmuls (4 B H hd Sq Skv a call), plus the flash
    kernel's formula for each call."""
    cpu = _port_cost(arch, "forward", 64, 2, remat=False)
    monkeypatch.setattr(FakeTensor, "is_cuda", property(lambda self: True), raising=False)
    card = _port_cost(arch, "forward", 64, 2, remat=False)
    cfg = reduced(get_config(arch))
    b, h, hd = 2, cfg.n_heads, cfg.head_dim
    calls = [(64, 64, True)] * cfg.n_layers
    if cfg.encoder_layers:
        calls += [(cfg.encoder_seq, cfg.encoder_seq, False)] * cfg.encoder_layers
        calls += [(64, cfg.encoder_seq, False)] * cfg.n_layers          # cross-attention
    plain = sum(4 * b * h * hd * sq * skv for sq, skv, _ in calls)
    kernel = sum(4 * b * h * hd * flash_attention.pairs(sq, skv, causal, 0, 0)
                 for sq, skv, causal in calls)
    assert card["kernel_calls"] == {"flash_attention": len(calls)}
    assert _path_flops(cpu, "layers._dense_attention") == plain
    assert card["flops"] == cpu["flops"] - plain + kernel


# ---------------------------------------------------------------------------
# per device, on a fake process group
# ---------------------------------------------------------------------------

@pytest.fixture
def mesh_16x16():
    """A (16, 16) ``data, model`` mesh on a fake group of 256 ranks, this
    process rank 0; the group is process-global and ended after the test."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.dryrun import start_fake_group

    start_fake_group(256)
    try:
        yield init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_sharded_matmul_counts_one_device_once(mesh_16x16):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = mesh_16x16
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(256, 4096), mesh, [Shard(0), Replicate()],
                              src_data_rank=None)
        w = distribute_tensor(torch.empty(4096, 4096), mesh, [Replicate(), Shard(1)],
                              src_data_rank=None)
        with cost.CostMode() as c:
            y = x @ w
        assert y.to_local().shape == (16, 256)
        assert c.flops == 2 * 16 * 4096 * 256 == 2 * 256 * 4096 * 4096 // 256
        assert c.collective_counts == dict.fromkeys(cost.COLLECTIVES, 0)
        # contraction dim over model: a local product, then the partial sums' all-reduce
        xk = distribute_tensor(torch.empty(256, 4096), mesh, [Shard(0), Shard(1)],
                               src_data_rank=None)
        wk = distribute_tensor(torch.empty(4096, 1024), mesh, [Replicate(), Shard(0)],
                               src_data_rank=None)
        with cost.CostMode() as c:
            yk = (xk @ wk).redistribute(mesh, [Shard(0), Replicate()])
        assert yk.to_local().shape == (16, 1024)
        assert c.flops == 2 * 16 * 256 * 1024
        assert c.collective_counts["all-reduce"] == 1
        assert c.collective_bytes["all-reduce"] == 16 * 1024 * 4
        assert sum(c.collective_by_group.values()) == 16 * 1024 * 4


@pytest.mark.parametrize("kv_heads", [1, 2])
def test_rank_counts_half_the_attention_at_model_2(kv_heads):
    """A prefill's attention core (``layers._attend``: the plain
    attention's two products) counts, on a rank of a (1, 2) mesh, half the
    world-1 FLOPs: the query heads are cut over ``model`` whether it
    divides the KV heads (2) or not (1 KV head, each rank reading it,
    ``layers.head_split`` "q")."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun

    shape = ShapeConfig("prefill_64", 64, 2, "prefill")
    over = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": kv_heads, "d_ff": 128,
            "vocab": 256, "head_dim": 16, "dtype": "float32"}

    def attention_flops(mesh) -> int:
        counter = dryrun.count_cell("tinyllama-1.1b", shape, mesh, device="cpu",
                                    cfg_overrides=over, breakdown=True)["counter"]
        return sum(row[0] for path, row in counter.by_path.items()
                   if "layers._attend" in path)

    alone = attention_flops(None)
    dryrun.start_fake_group(2)
    try:
        rank = attention_flops(init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model")))
    finally:
        dist.destroy_process_group()
    assert alone == 2 * 2 * (2 * 4 * 64 * 64 * 16) * 2      # 2 products, 2 layers
    assert rank * 2 == alone


def test_card_route_train_step_charges_the_backward_kernel(monkeypatch):
    """A train step of reduced tinyllama (B 4, S 64, remat, 2 microbatches)
    on the card's route (fake tensors answering ``is_cuda``): the attention
    backward is one ``flash_attention_backward`` call for each layer and
    microbatch, each charged once by ``flash_attention_bwd.cost`` (no ATen
    operator of the plain version is counted), the forward
    ``flash_attention_lse`` twice (the block and its recompute), and the
    step runs to its end."""
    monkeypatch.setattr(FakeTensor, "is_cuda", property(lambda self: True), raising=False)
    cfg = reduced(get_config("tinyllama-1.1b"))
    b, s, mb = 4, 64, 2
    fm = FakeTensorMode()
    params = S.params_specs(cfg, "cpu", fm)
    with fm:
        args = (params, adamw_init(params),
                S.train_batch_specs(cfg, ShapeConfig("t", s, b, "train"), "cpu", fm))
        step = Steps.make_train_step(cfg, None, remat=True, microbatches=mb)
        res = cost.analyze(step, *args, breakdown=True)
    n = cfg.n_layers * mb
    assert res["kernel_calls"] == {"flash_attention_lse": 2 * n, "flash_attention_backward": n}
    itemsize = params["embed"].element_size()
    per = flash_attention_bwd.cost((b // mb, s, cfg.n_heads, cfg.head_dim),
                                   (b // mb, s, cfg.n_kv_heads, cfg.head_dim), itemsize)
    assert res["by_op"]["repro_torch.flash_attention_backward"] == (n * per["flops"],
                                                                     n * per["bytes"], 0)
    assert not [p for p in res["by_path"] if "ref.flash_attention_bwd" in p]
    new_params, _, metrics = res["result"]
    assert set(metrics) >= {"ce", "grad_norm"} and new_params["embed"].shape == params["embed"].shape
