"""granite-4.0-h-small's family on the port, on the CPU in float32, against
the plain reference of the benchmark (``bench/reference/granite_hybrid.py``):
a 10-layer period (9 Mamba2 + 1 NoPE attention, each with a MoE of 9 held
of 72 experts and a shared expert) with Granite's four multipliers.

The program's loss and every leaf's gradient equal the reference's, and
each planted fault (the shared expert left out, the residual multiplier 1,
hd**-0.5 in place of the attention multiplier, RoPE applied) fails that
comparison; the eight expert shares of a layer add up to the uncut layer;
``remat`` per sublayer gives the gradients of no remat and holds one
sublayer's activations at a time; the defaults launch the ops they launched
before the new fields (pinned counts); prefill and paged decode match the
reference's served logits; the published configuration's parameter
counts."""
import dataclasses
import hashlib
import json
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.configs.granite_4_0_h_small import CONFIG as PUBLISHED
from repro_torch.launch.steps import LB_COEF, Z_COEF, make_loss_fn, make_train_step
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import adamw_init
from repro_torch.serving.paged_model import init_pools, make_paged_decode_step
from repro_torch.tree import flatten_with_paths, leaves, unflatten

BENCH = Path(__file__).resolve().parents[1] / "bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))
from reference import granite_hybrid as G  # noqa: E402
from reference.plain import Matmul, no_tf32, rmsnorm  # noqa: E402

CONF = json.loads((BENCH / "configs" / "granite-4.0-h-small.json").read_text())
SEED = 3_000_000_023


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    no_tf32()
    yield
    torch.set_num_threads(n)


def period_sz(**over) -> dict:
    """The reference's small widths with the published 10-layer period, one
    block, and the logits divisor as published."""
    sz = G.small(CONF["port"])
    sz.update(block=CONF["port"]["block"], n_layers=10, logits_divisor=16.0)
    sz.update(over)
    return sz


def program_cfg(sz: dict, **over) -> ModelConfig:
    fields = {**sz, "block": tuple(LayerSpec(**b) for b in sz["block"]), **over}
    return ModelConfig(**fields)


def _batch(sz: dict, b: int = 1, s: int = 512, seed: int = 5) -> dict:
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, sz["vocab"], (b, s + 1), generator=g)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def reference_loss(w: dict, sz: dict, batch: dict):
    """The published loss on the flat float32 leaves ``w``: the layers, the
    final norm, the tied head over the logits divisor, the mean
    cross-entropy, plus the program's load-balance and z terms."""
    mm = Matmul()
    x = w["embed"][batch["tokens"]]
    lb = z = torch.zeros(())
    for l in range(sz["n_layers"]):
        x, lb_l, z_l = G.layer(x, G.layer_leaves(w, l, sz), l, sz, mm, None)
        lb, z = lb + lb_l, z + z_l
    logits = rmsnorm(x, w["final_norm"], sz["norm_eps"]) @ w["embed"].T / sz["logits_divisor"]
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), batch["labels"].reshape(-1))
    return ce + LB_COEF * lb + Z_COEF * z


def _flat(params) -> dict:
    from reference.train_ref import flat
    return flat(params)


def reference_grads(params, sz, batch):
    w = {k: v.detach().clone().requires_grad_() for k, v in _flat(params).items()}
    loss = reference_loss(w, sz, batch)
    grads = torch.autograd.grad(loss, list(w.values()))
    return float(loss.detach()), dict(zip(w, grads))


def program_grads(params, cfg, batch, remat=True):
    ls = [p.detach().clone().requires_grad_() for p in leaves(params)]
    tree = unflatten(params, ls)
    loss, _ = make_loss_fn(cfg, remat=remat)(tree, batch)
    grads = torch.autograd.grad(loss, ls, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, ls)]
    return float(loss.detach()), dict(zip(flatten_with_paths(params), grads))


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def gaps(prog, ref) -> tuple[float, float]:
    """(relative loss gap, the worst leaf's relative L2 gradient gap)."""
    (lp, gp), (lr, gr) = prog, ref
    return abs(lp - lr) / abs(lr), max(_rel(gp[k], gr[k]) for k in gr)


@pytest.fixture(scope="module")
def period():
    sz = period_sz()
    params = G.draw_params(sz, SEED, "cpu")
    batch = _batch(sz)
    return sz, params, batch, reference_grads(params, sz, batch)


def test_loss_and_every_gradient_equal_the_reference(period):
    sz, params, batch, ref = period
    loss_gap, grad_gap = gaps(program_grads(params, program_cfg(sz), batch), ref)
    assert loss_gap < 1e-5 and grad_gap < 1e-4, (loss_gap, grad_gap)


FAULTS = {"shared_expert_left_out": {"moe_shared_d_ff": 0},
          "residual_multiplier_one": {"residual_multiplier": 1.0},
          "attention_scaled_by_head_dim": {"attention_multiplier": None},
          "rope_applied": {"rope_theta": 10000.0}}


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail(period, fault):
    sz, params, batch, ref = period
    loss_gap, grad_gap = gaps(program_grads(params, program_cfg(sz, **FAULTS[fault]), batch),
                              ref)
    assert grad_gap > 1e-2, (fault, loss_gap, grad_gap)


# ------------------------------------------------------------ expert shares
def test_expert_shares_add_up_to_the_uncut_layer():
    """Eight chips each hold 9 of the 72 experts (first ids 0, 9, ..., 63):
    the parts of a layer's output that their experts give, plus once what
    every chip computes alike (the mixer, the shared expert, the residual),
    equal the uncut reference layer holding all 72."""
    sz = period_sz(moe_held_experts=72, n_layers=1,
                   block=[{"kind": "mamba", "ffn": "moe"}], moe_capacity_factor=1.25)
    params = G.draw_params(sz, SEED + 1, "cpu")
    p = T.layer_params(params["blocks"][0], 0)
    x = torch.randn((2, 64, sz["d_model"]), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want, _, _ = G.layer(x, G.layer_weights(params, 0, sz), 1, sz, Matmul(), None)
        spec, cfg = LayerSpec("mamba", "moe"), program_cfg(sz, moe_held_experts=9)
        pos = torch.arange(64)[None].expand(2, -1)

        def share(first: int, zero_routed: bool = False):
            moe = {**p["moe"]}
            for k in ("w_gate", "w_up", "w_down"):
                moe[k] = p["moe"][k][first:first + 9]
            if zero_routed:
                moe["w_down"] = torch.zeros_like(moe["w_down"])
            c = dataclasses.replace(cfg, moe_first_expert=first)
            return T._apply_sublayer(x, {**p, "moe": moe}, spec, c, positions=pos)[0]

        common = share(0, zero_routed=True)
        got = common + sum(share(first) - common for first in range(0, 72, 9))
    assert _rel(got, want) < 1e-5
    assert _rel(share(0), want) > 1e-2           # one share alone is not the layer


# ---------------------------------------------------------------- remat
@pytest.mark.parametrize("which", ["jamba", "hybrid"])
def test_remat_per_sublayer_keeps_the_gradients(which):
    if which == "jamba":
        cfg = reduced(get_config("jamba-v0.1-52b"))
        params = T.init_params(cfg, torch.Generator().manual_seed(0))
        batch = _batch({"vocab": cfg.vocab}, b=2, s=32)
    else:
        sz = period_sz()
        cfg, params, batch = program_cfg(sz), G.draw_params(sz, SEED, "cpu"), _batch(sz, s=64)
    on, off = program_grads(params, cfg, batch, True), program_grads(params, cfg, batch, False)
    assert on[0] == off[0]
    assert max(_rel(on[1][k], off[1][k]) for k in off[1]) < 1e-6


class _Live(TorchDispatchMode):
    """The bytes of the op outputs still alive, and the most seen at once
    while ``on``."""

    def __init__(self):
        super().__init__()
        self.refs: dict[int, tuple] = {}
        self.on, self.peak = False, 0

    def live(self) -> int:
        self.refs = {k: v for k, v in self.refs.items() if not v[0].expired()}
        return sum(n for _, n in self.refs.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.device.type == "cpu":
                st = t.untyped_storage()
                self.refs[st.data_ptr()] = (StorageWeakRef(st), st.nbytes())
        if self.on:
            self.peak = max(self.peak, self.live())
        return out


def _saved_bytes(fn) -> int:
    """Bytes of the distinct storages autograd saves while ``fn`` runs."""
    seen: dict[int, int] = {}

    def pack(t):
        seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(seen.values())


def test_remat_backward_holds_one_sublayer_at_a_time():
    """Counted with ``saved_tensors_hooks``, each sublayer of the period
    saves S_i bytes for its backward without remat. Under ``remat=True`` the
    backward's live bytes beyond those at its start (the sublayers'
    inputs, the parameters) stay under 1.5 x the largest S_i: one
    sublayer's activations at a time, where a checkpoint of the whole
    10-sublayer block would hold about the sum of the S_i."""
    sz = period_sz(d_model=32, n_heads=2, head_dim=16, moe_d_ff=8, moe_shared_d_ff=8,
                   vocab=64)
    cfg, params = program_cfg(sz), G.draw_params(sz, SEED, "cpu")
    batch = _batch(sz, s=1024)
    ls = [p.detach().clone().requires_grad_() for p in leaves(params)]
    tree = unflatten(params, ls)
    x = T.embed_tokens(tree, batch["tokens"], cfg).detach()
    pos = torch.arange(1024)[None]
    per = []
    for i, spec in enumerate(cfg.block):
        p = T.layer_params(tree["blocks"][i], 0)
        per.append(_saved_bytes(lambda: T._apply_sublayer(x, p, spec, cfg, positions=pos)))
    mode = _Live()
    with mode:
        loss, _ = make_loss_fn(cfg, remat=True)(tree, batch)
        start = mode.live()
        mode.on = True
        torch.autograd.grad(loss, ls, allow_unused=True)
    extra = mode.peak - start
    assert extra < 1.5 * max(per), (extra, per)
    assert sum(per) > 5 * max(per)          # the bound tells the two apart


# ------------------------------------------------- defaults launch nothing new
class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _digest(ops) -> tuple[int, str]:
    return len(ops), hashlib.sha256("\n".join(ops).encode()).hexdigest()


# counted on the tree before the new ModelConfig fields, ranges and remat
# per sublayer (commit bb0444f), with this file's functions; the decode step
# re-counted for its (B,) active mask, which replaced the active rows' index
# (351 ops before)
PINNED = {"olmoe_decode": (352, "37d4a13feda6dd286a78bde127f4f353966268c19d024722653c4590b30baeaf"),
          "granite_train": (1662,
                            "458f513861507b30a17ac82a87925dc74ae17ac46622ad9da78b651d7e07a18a")}


def test_olmoe_paged_decode_launches_the_pinned_ops():
    cfg = reduced(get_config("olmoe-1b-7b"))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    pools = init_pools(cfg, num_pages=9, page_size=8, max_batch=3)
    step = make_paged_decode_step(cfg, page_size=8)
    args = (params, pools, torch.tensor([[3], [4], [5]]), torch.tensor([5, 9, 2], dtype=torch.int32),
            torch.arange(9, dtype=torch.int32).reshape(3, 3), torch.tensor([True, False, True]))
    with torch.no_grad():
        step(*args)
        with _Ops() as c:
            step(*args)
    assert _digest(c.ops) == PINNED["olmoe_decode"]


def test_granite_moe_train_step_launches_the_pinned_ops():
    cfg = reduced(get_config("granite-moe-1b-a400m"))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    state = adamw_init(params)
    step = make_train_step(cfg, remat=True)
    toks = torch.randint(0, cfg.vocab, (2, 17), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    params, state, _ = step(params, state, batch)
    with _Ops() as c:
        step(params, state, batch)
    assert _digest(c.ops) == PINNED["granite_train"]


# ---------------------------------------------------------------- serving
def test_prefill_and_paged_decode_match_the_reference():
    """Prompts of at most 256 tokens (one SSD chunk), float32: the logits of
    prefill's last position and of four greedy paged decode steps equal
    the reference's served logits, and prefill's equal the forward's."""
    sz = period_sz(n_layers=20)                         # two blocks of the period
    cfg, params = program_cfg(sz), G.draw_params(sz, SEED + 2, "cpu")
    prompts = [torch.randint(0, sz["vocab"], (n,), generator=torch.Generator().manual_seed(n))
               for n in (5, 37)]
    page, steps = 8, 4
    pools = init_pools(cfg, num_pages=16, page_size=page, max_batch=2)
    table = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    decode = make_paged_decode_step(cfg, page_size=page)
    seqs, got = [], []
    with torch.no_grad():
        for row, pr in enumerate(prompts):
            last, cache = T.prefill(params, pr[None], cfg, max_seq=64)
            full, _ = T.forward_logits(params, pr[None], cfg)
            assert _rel(last[0, -1], full[0, -1]) < 1e-5
            for i, spec in enumerate(cfg.block):      # the prompt's state into the pools
                for k, v in cache.layers[i].items():
                    if spec.kind == "attn" and k in ("k", "v"):
                        for t in range(len(pr)):
                            pools[i][k][:, table[row, t // page], t % page] = v[:, 0, t]
                    elif spec.kind == "mamba":
                        pools[i][k][:, row] = v[:, 0]
            seqs.append([int(t) for t in pr])
            got.append([last[0, -1]])
        lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
        for _ in range(steps):
            toks = torch.stack([g[-1].argmax() for g in got])[:, None]
            for row in range(2):
                seqs[row].append(int(toks[row, 0]))
            logits = decode(params, pools, toks, lengths, table, torch.ones(2, dtype=torch.bool))
            for row in range(2):
                got[row].append(logits[row, 0])
            lengths = lengths + 1
        for row in range(2):                          # the token the last step chose
            seqs[row].append(int(got[row][-1].argmax()))
        want = G.served_logits(params, sz, [(s[:-1], len(p)) for s, p in zip(seqs, prompts)])
    for g, w in zip(got, want):
        assert _rel(torch.stack(g), w) < 1e-5


# --------------------------------------------------------- the published config
def test_published_parameter_counts():
    assert abs(PUBLISHED.param_count() / 32.2e9 - 1) < 0.01
    assert abs(PUBLISHED.active_param_count() / 8.8e9 - 1) < 0.03
    assert [s.kind for s in PUBLISHED.block].count("mamba") == 9 and PUBLISHED.n_blocks == 4
