"""Plain PyTorch reference of the attention + MoE language model family
(``"reference": "moe_lm"``): every layer one attention + MoE block, no
shared expert, in float32 with TF32 off.

It follows the program's equations, not the published models' where the
two part (each configuration file lists the departures): pre-norm blocks
with ``plain.rmsnorm``, per-head q/k RMSNorm, half-split RoPE, causal GQA
attention, a top-k router whose weights are renormalised over the k
chosen, and the capacity-bounded dispatch: an expert keeps at most ``cap``
of a call's assignments, counted in token-major order,
``cap = max(8, ceil8(int(T * k / E * factor)))``.

It imports nothing of the program. It draws the weights from the seed into
the program's tree layout (``draw_params``), and reads a configuration
file's ``port`` sizes and those weights, upcasting them a layer at a time.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .plain import Matmul, causal_attention, rmsnorm, rope


def draw_params(sz: dict, seed: int, device) -> dict:
    """The program's parameter tree (stacked over blocks, ``transformer``'s
    layout) for the ``port`` sizes ``sz``, drawn from ``seed`` on ``device``
    in a few large draws: matrices N(0, 1) * fan_in**-0.5 in the config
    dtype, the router in float32, norm scales (used as ``1 + scale``)
    N(0, 1) * 0.1 in float32."""
    if [dict(b) for b in sz["block"]] != [{"kind": "attn", "ffn": "moe"}]:
        raise ValueError(f"moe_lm draws one attention + MoE layer spec, not {sz['block']}")
    g = torch.Generator(device=device)
    g.manual_seed(seed % (2 ** 63))
    dt = getattr(torch, sz["dtype"])
    n, d, h, kv = sz["n_layers"], sz["d_model"], sz["n_heads"], sz["n_kv_heads"]
    hd = sz["head_dim"]
    e, f = sz["moe_experts"], sz["moe_d_ff"]

    def mat(shape, fan_in, dtype=dt):
        x = torch.randn(shape, generator=g, device=device, dtype=dtype)
        return x.mul_(fan_in ** -0.5)

    def norm(shape):
        return torch.randn(shape, generator=g, device=device, dtype=torch.float32).mul_(0.1)

    attn = {"wq": mat((n, d, h * hd), d), "wk": mat((n, d, kv * hd), d),
            "wv": mat((n, d, kv * hd), d), "wo": mat((n, h * hd, d), h * hd)}
    if sz["qk_norm"]:
        attn["q_norm"], attn["k_norm"] = norm((n, hd)), norm((n, hd))
    block = {"norm": norm((n, d)), "attn": attn, "ffn_norm": norm((n, d)),
             "moe": {"router": mat((n, d, e), d, torch.float32),
                     "w_gate": mat((n, e, d, f), d), "w_up": mat((n, e, d, f), d),
                     "w_down": mat((n, e, f, d), f)}}
    params = {"embed": mat((sz["vocab"], d), d), "final_norm": norm((d,)), "blocks": (block,)}
    if not sz["tie_embeddings"]:
        params["lm_head"] = mat((d, sz["vocab"]), d)
    return params


def small(port: dict) -> dict:
    """``port`` at the CPU tests' size: the same equations (MoE, GQA,
    qk-norm, tying, capacity factor) at widths a test run holds, float32."""
    p = dict(port)
    kv_ratio = p["n_heads"] // p["n_kv_heads"]
    p.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4 // kv_ratio, head_dim=16,
             d_ff=32, moe_d_ff=32, moe_experts=8, moe_topk=2, vocab=512, max_seq=4096,
             dtype="float32")
    return p


def capacity(tokens: int, topk: int, experts: int, factor: float) -> int:
    c = int(tokens * topk / experts * factor)
    return max(8, -(-c // 8) * 8)


def moe(x, p, sz: dict, mm: Matmul, prefix: int | None = None):
    """x (T, d) in token-major order. Returns (y (T, d), lb, z). The
    capacity rule holds over the first ``prefix`` tokens (a prefill call of
    that many); the tokens after them are decode steps, each routed in its
    own call, and keep every assignment. ``prefix`` None: one call of all T."""
    t = x.shape[0]
    e, k = sz["moe_experts"], sz["moe_topk"]
    logits = x @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    n = t if prefix is None else prefix
    cap = capacity(n, k, e, sz["moe_capacity_factor"])
    flat = idx.reshape(-1)
    first = flat[: n * k]
    # each assignment's slot: the assignments to its expert before it (a scan
    # along each expert's row, which runs fast where one down the columns
    # of a (T*k, E) table does not)
    counts = torch.cumsum(F.one_hot(first, e).T.contiguous(), dim=1).T
    slot = (counts - 1).gather(1, first[:, None])[:, 0]
    keep = torch.cat([slot < cap, torch.ones(flat.numel() - n * k, dtype=torch.bool,
                                             device=x.device)])
    wk = (w.reshape(-1) * keep).reshape(t, k)
    y = torch.zeros_like(x)
    act = F.silu if sz.get("act", "silu") == "silu" else (lambda a: F.gelu(a, approximate="tanh"))
    for j in range(e):
        tok, kk = torch.nonzero((idx == j) & keep.reshape(t, k), as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        hcur = act(mm(xe, p["w_gate"][j])) * mm(xe, p["w_up"][j])
        y = y.index_add(0, tok, mm(hcur, p["w_down"][j]) * wk[tok, kk][:, None])
    me = probs.mean(0)
    ce = F.one_hot(idx, e).float().sum(1).mean(0) / k
    lb = e * (me * ce).sum()
    z = torch.logsumexp(logits, dim=-1).square().mean()
    return y, lb, z


def layer(x, p, l: int, sz: dict, mm: Matmul, pos, prefix=None):
    """Layer ``l`` (every layer alike) on x (B, S, d), its weights ``p``.
    Returns (x, lb, z)."""
    b, s, d = x.shape
    h_, kv, hd = sz["n_heads"], sz["n_kv_heads"], sz["head_dim"]
    eps = sz["norm_eps"]
    hn = rmsnorm(x, p["norm"], eps)
    a = p["attn"]
    q = mm(hn, a["wq"]).reshape(b, s, h_, hd)
    k = mm(hn, a["wk"]).reshape(b, s, kv, hd)
    v = mm(hn, a["wv"]).reshape(b, s, kv, hd)
    if "q_norm" in a:
        q, k = rmsnorm(q, a["q_norm"], eps), rmsnorm(k, a["k_norm"], eps)
    theta = sz["rope_theta"]
    q, k = rope(q, pos, theta), rope(k, pos, theta)
    x = x + mm(causal_attention(q, k, v).reshape(b, s, h_ * hd), a["wo"])
    hn = rmsnorm(x, p["ffn_norm"], eps).reshape(b * s, d)
    y, lb, z = moe(hn, p["moe"], sz, mm, prefix)
    return x + y.reshape(b, s, d), lb, z


def layer_weights(params: dict, l: int) -> dict:
    """Layer ``l``'s weights: block ``l`` of the stacked tree, in float32."""
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) else t[l].float()
    return pick(params["blocks"][0])


def layer_leaves(w: dict, l: int, sz: dict) -> dict:
    """Layer ``l``'s weights out of the flat float32 leaves ``w`` (paths of
    the program's tree): block l of the stacked leaves under "blocks/0/"."""
    out: dict = {}
    for path, t in w.items():
        if not path.startswith("blocks/0/"):
            continue
        node = out
        keys = path.split("/")[2:]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t[l]
    return out


def head(params: dict, sz: dict) -> torch.Tensor:
    return params["embed"].float().T if sz["tie_embeddings"] else params["lm_head"].float()


@torch.no_grad()
def served_logits(params: dict, sz: dict, seqs: list[tuple[list[int], int]],
                  precision: str = "fp32") -> list[torch.Tensor]:
    """For each (tokens, prompt_len) of ``seqs``, tokens = prompt + served
    tokens but the last: the logits (n, V) at the positions that chose the
    n served tokens (the prompt's last position on). The prompt is one
    prefill call (its capacity), each later token a step of its own. Layer
    by layer over the sequences, so each layer's weights are upcast once."""
    mm = Matmul(precision)
    dev = params["embed"].device
    xs = [params["embed"][torch.tensor(t, device=dev)].float()[None] for t, _ in seqs]
    pos = [torch.arange(len(t), device=dev) for t, _ in seqs]
    for l in range(sz["n_layers"]):
        w = layer_weights(params, l)
        xs = [layer(x, w, l, sz, mm, p, prefix=n)[0] for x, p, (_, n) in zip(xs, pos, seqs)]
        del w
    w_out = head(params, sz)
    fn = params["final_norm"].float()
    return [mm(rmsnorm(x[0, n - 1:], fn, sz["norm_eps"]), w_out) for x, (_, n) in zip(xs, seqs)]
