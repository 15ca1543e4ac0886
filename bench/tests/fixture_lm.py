"""A model family of the reference for the tests (``"reference":
"fixture_lm"``), whose tree ``moe_lm`` cannot draw: a block of several
attention layer specs, each with a dense SwiGLU MLP or a MoE (the tests'
block: attention + MLP, then attention + MoE, as jamba's block alternates
its feed-forward). The program stacks each spec's leaves over the blocks
(``blocks[i]``), so layer l is spec ``l % len(block)`` of block
``l // len(block)``.

``test_bench_family.py`` copies it to ``reference/fixture_lm.py`` of a
copy of the benchmark, to show that a family is added with new files
only. It imports the shared plain pieces and ``moe_lm``'s MoE.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .moe_lm import head, moe
from .plain import Matmul, causal_attention, rmsnorm, rope


def draw_params(sz: dict, seed: int, device) -> dict:
    """The program's tree for ``sz``, drawn from ``seed`` as ``moe_lm``
    draws its leaves, spec by spec."""
    specs = sz["block"]
    if any(s["kind"] != "attn" or s["ffn"] not in ("mlp", "moe") for s in specs):
        raise ValueError(f"fixture_lm draws attention + MLP or MoE specs, not {specs}")
    g = torch.Generator(device=device)
    g.manual_seed(seed % (2 ** 63))
    dt = getattr(torch, sz["dtype"])
    n, d, h, kv = sz["n_layers"] // len(specs), sz["d_model"], sz["n_heads"], sz["n_kv_heads"]
    hd, e = sz["head_dim"], sz["moe_experts"]

    def mat(shape, fan_in, dtype=dt):
        return torch.randn(shape, generator=g, device=device, dtype=dtype).mul_(fan_in ** -0.5)

    def norm(shape):
        return torch.randn(shape, generator=g, device=device, dtype=torch.float32).mul_(0.1)

    def ffn(f, experts=()):
        return {"w_gate": mat((n, *experts, d, f), d), "w_up": mat((n, *experts, d, f), d),
                "w_down": mat((n, *experts, f, d), f)}

    blocks = []
    for spec in specs:
        attn = {"wq": mat((n, d, h * hd), d), "wk": mat((n, d, kv * hd), d),
                "wv": mat((n, d, kv * hd), d), "wo": mat((n, h * hd, d), h * hd)}
        if sz["qk_norm"]:
            attn["q_norm"], attn["k_norm"] = norm((n, hd)), norm((n, hd))
        block = {"norm": norm((n, d)), "attn": attn, "ffn_norm": norm((n, d))}
        if spec["ffn"] == "mlp":
            block["mlp"] = ffn(sz["d_ff"])
        else:
            block["moe"] = {"router": mat((n, d, e), d, torch.float32),
                            **ffn(sz["moe_d_ff"], (e,))}
        blocks.append(block)
    params = {"embed": mat((sz["vocab"], d), d), "final_norm": norm((d,)),
              "blocks": tuple(blocks)}
    if not sz["tie_embeddings"]:
        params["lm_head"] = mat((d, sz["vocab"]), d)
    return params


def small(port: dict) -> dict:
    """Two blocks at the tests' widths, float32."""
    p = dict(port)
    p.update(n_layers=2 * len(p["block"]), d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=48, moe_d_ff=32, moe_experts=8, moe_topk=2, vocab=512, max_seq=4096,
             dtype="float32")
    return p


def layer(x, p, l: int, sz: dict, mm: Matmul, pos, prefix=None):
    """Layer ``l`` on x (B, S, d): attention, then its spec's MLP or MoE.
    Returns (x, lb, z); an MLP layer adds nothing to lb and z."""
    b, s, d = x.shape
    h_, kv, hd, eps = sz["n_heads"], sz["n_kv_heads"], sz["head_dim"], sz["norm_eps"]
    hn = rmsnorm(x, p["norm"], eps)
    a = p["attn"]
    q = mm(hn, a["wq"]).reshape(b, s, h_, hd)
    k = mm(hn, a["wk"]).reshape(b, s, kv, hd)
    v = mm(hn, a["wv"]).reshape(b, s, kv, hd)
    if "q_norm" in a:
        q, k = rmsnorm(q, a["q_norm"], eps), rmsnorm(k, a["k_norm"], eps)
    q, k = rope(q, pos, sz["rope_theta"]), rope(k, pos, sz["rope_theta"])
    x = x + mm(causal_attention(q, k, v).reshape(b, s, h_ * hd), a["wo"])
    hn = rmsnorm(x, p["ffn_norm"], eps)
    if "mlp" in p:
        m, zero = p["mlp"], x.new_zeros(())
        act = F.silu if sz["act"] == "silu" else (lambda t: F.gelu(t, approximate="tanh"))
        return x + mm(act(mm(hn, m["w_gate"])) * mm(hn, m["w_up"]), m["w_down"]), zero, zero
    y, lb, z = moe(hn.reshape(b * s, d), p["moe"], sz, mm, prefix)
    return x + y.reshape(b, s, d), lb, z


def _spec(l: int, sz: dict) -> tuple[int, int]:
    """(the spec, the block) of layer ``l``."""
    return l % len(sz["block"]), l // len(sz["block"])


def layer_weights(params: dict, l: int, sz: dict) -> dict:
    """Layer ``l``'s weights out of the stacked tree, in float32."""
    i, j = _spec(l, sz)

    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) else t[j].float()
    return pick(params["blocks"][i])


def layer_leaves(w: dict, l: int, sz: dict) -> dict:
    """Layer ``l``'s weights out of the flat float32 leaves ``w``."""
    i, j = _spec(l, sz)
    out: dict = {}
    for path, t in w.items():
        if path.startswith(f"blocks/{i}/"):
            node = out
            keys = path.split("/")[2:]
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = t[j]
    return out


@torch.no_grad()
def served_logits(params: dict, sz: dict, seqs: list, precision: str = "fp32") -> list:
    """As ``moe_lm.served_logits``: the logits at the positions that chose
    the served tokens, the prompt one prefill call, each later token a step."""
    mm = Matmul(precision)
    dev = params["embed"].device
    xs = [params["embed"][torch.tensor(t, device=dev)].float()[None] for t, _ in seqs]
    pos = [torch.arange(len(t), device=dev) for t, _ in seqs]
    for l in range(sz["n_layers"]):
        w = layer_weights(params, l, sz)
        xs = [layer(x, w, l, sz, mm, p, prefix=n)[0] for x, p, (_, n) in zip(xs, pos, seqs)]
    w_out, fn = head(params, sz), params["final_norm"].float()
    return [mm(rmsnorm(x[0, n - 1:], fn, sz["norm_eps"]), w_out) for x, (_, n) in zip(xs, seqs)]
