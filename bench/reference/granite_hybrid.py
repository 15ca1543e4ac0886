"""Plain PyTorch reference of the Granite 4.0-H family (``"reference":
"granite_hybrid"``): a period of Mamba2 and NoPE attention layers, each
followed by a MoE with a shared expert, with Granite's four multipliers, in
float32 with TF32 off.

The published equations (``GraniteMoeHybrid`` in Hugging Face's
``transformers``), layer by layer:

* embeddings times ``embedding_multiplier`` (layer 0 takes the embedding
  rows as the table holds them and scales them first, so that
  ``train_ref.loss``, which looks the rows up, runs the published model);
  each sublayer's output times ``residual_multiplier`` before its residual
  add; the served logits over ``logits_divisor`` (``train_ref.loss`` forms
  the training logits itself, with no divisor: a configuration judged by it
  runs with ``logits_divisor`` 1 and lists that as a departure);
* attention: pre-RMSNorm, GQA with no position encoding, the scores scaled
  by ``attention_multiplier`` (not head_dim**-0.5);
* Mamba2: pre-RMSNorm; in_proj to z, x, B, C and dt; the depthwise causal
  conv (with bias) and SiLU over x, B and C; dt = softplus(dt + dt_bias);
  A = -exp(A_log); the SSD scan (one group: B and C shared by every head);
  + D * x; y * silu(z) through an RMSNorm over d_inner; out_proj;
* MoE: a top-k router (the k largest of the E logits, softmaxed over those
  k, which is the softmax over E renormalised over the k), the experts'
  SwiGLU, plus a shared expert's SwiGLU on every token.

Where the program departs from the published model, so does this
reference (the configuration file lists each departure): norms scale by
``1 + scale``, an expert keeps at most ``cap`` of a call's assignments
counted in token-major order, ``cap = max(8, ceil8(int(T * k / E *
factor)))``, and the load-balance and z terms are computed. A layer holds
``moe_held_experts`` experts from id ``moe_first_expert`` on (0: all): an
assignment to another expert adds nothing, as the chip that holds one
share of an expert-parallel layer computes without the exchange.

The SSD runs in its chunked form, at ``SSD_CHUNK`` tokens a chunk (the
program's chunk is 256), over groups of ``HEAD_GROUP`` heads. While a
gradient is recorded, each group, the Mamba2 layer's projections and conv
and its gate, norm and out_proj (over ``TOKEN_CHUNK`` tokens at a time)
run under checkpoints of their own, and attention over query chunks of
``ATTN_CHUNK``: beside the float32 state of ``train_ref`` (about 62 GB at
32,768 tokens of the cut granite-4.0-h-small) a layer's backward then
holds a few (tokens, d_inner) tensors at a time, and no (chunks, heads, L,
L) tensor of every head.

It imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .plain import Matmul, rmsnorm

SSD_CHUNK = 64
HEAD_GROUP = 16
ATTN_CHUNK = 128
TOKEN_CHUNK = 4096


# ------------------------------------------------------------------ weights
def draw_params(sz: dict, seed: int, device) -> dict:
    """The program's parameter tree for the ``port`` sizes ``sz`` (a tuple
    of blocks, one per layer spec, each leaf stacked over the blocks),
    drawn from ``seed`` on ``device`` in a few large draws: matrices
    N(0, 1) * fan_in**-0.5 in the config dtype, the router in float32, norm
    scales (used as ``1 + scale``) N(0, 1) * 0.1 in float32; Mamba2's conv
    weights N(0, 1) * conv**-0.5 and biases N(0, 1) * 0.1, A = U(1, 16),
    dt at softplus(dt_bias) log-uniform in [0.001, 0.1], D = 1 + N(0, 1) *
    0.1 (Mamba2's own ranges)."""
    specs = sz["block"]
    if any(s["kind"] not in ("attn", "mamba") or s["ffn"] != "moe" for s in specs):
        raise ValueError(f"granite_hybrid draws Mamba2 or attention + MoE specs, not {specs}")
    g = torch.Generator(device=device)
    g.manual_seed(seed % (2 ** 63))
    dt = getattr(torch, sz["dtype"])
    f32 = torch.float32
    n, d = sz["n_layers"] // len(specs), sz["d_model"]
    h, kv, hd = sz["n_heads"], sz["n_kv_heads"], sz["head_dim"]
    di, ns, cw = sz["ssm_expand"] * d, sz["ssm_state"], sz["ssm_conv"]
    sh = di // sz["ssm_head_dim"]
    held = sz.get("moe_held_experts") or sz["moe_experts"]
    f, fs = sz["moe_d_ff"], sz["moe_shared_d_ff"]

    def randn(shape, dtype=dt):
        return torch.randn(shape, generator=g, device=device, dtype=dtype)

    def mat(shape, fan_in, dtype=dt):
        return randn(shape, dtype).mul_(fan_in ** -0.5)

    def norm(shape):
        return randn(shape, f32).mul_(0.1)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g, device=device, dtype=f32).mul_(hi - lo).add_(lo)

    def mamba():
        step = torch.exp(uniform((n, sh), math.log(1e-3), math.log(1e-1))).clamp_min(1e-4)
        return {"in_x": mat((n, d, di), d), "in_z": mat((n, d, di), d),
                "in_bc": mat((n, d, 2 * ns), d), "in_dt": mat((n, d, sh), d),
                "conv_x_w": mat((n, cw, di), cw), "conv_x_b": randn((n, di)).mul_(0.1),
                "conv_bc_w": mat((n, cw, 2 * ns), cw), "conv_bc_b": randn((n, 2 * ns)).mul_(0.1),
                "A_log": torch.log(uniform((n, sh), 1.0, 16.0)),
                "D": norm((n, sh)).add_(1.0),
                "dt_bias": step + torch.log(-torch.expm1(-step)),    # softplus^-1(step)
                "norm": norm((n, di)), "out_proj": mat((n, di, d), di)}

    def attention():
        return {"wq": mat((n, d, h * hd), d), "wk": mat((n, d, kv * hd), d),
                "wv": mat((n, d, kv * hd), d), "wo": mat((n, h * hd, d), h * hd)}

    blocks = []
    for spec in specs:
        moe = {"router": mat((n, d, sz["moe_experts"]), d, f32),
               "w_gate": mat((n, held, d, f), d), "w_up": mat((n, held, d, f), d),
               "w_down": mat((n, held, f, d), f),
               "shared": {"w_gate": mat((n, d, fs), d), "w_up": mat((n, d, fs), d),
                          "w_down": mat((n, fs, d), fs)}}
        blocks.append({"norm": norm((n, d)),
                       "attn": attention() if spec["kind"] == "attn" else mamba(),
                       "ffn_norm": norm((n, d)), "moe": moe})
    params = {"embed": mat((sz["vocab"], d), d), "final_norm": norm((d,)),
              "blocks": tuple(blocks)}
    if not sz["tie_embeddings"]:
        params["lm_head"] = mat((d, sz["vocab"]), d)
    return params


def small(port: dict) -> dict:
    """``port`` at the CPU tests' size: two blocks of a three-layer period
    (Mamba2, attention, Mamba2), the router's 72 experts, top-10 and 9
    held, a shared expert, GQA 4:1, the multipliers as published, at
    widths a test run holds, float32."""
    p = dict(port)
    p.update(n_layers=6, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16, d_ff=0,
             block=[{"kind": "mamba", "ffn": "moe"}, {"kind": "attn", "ffn": "moe"},
                    {"kind": "mamba", "ffn": "moe"}],
             moe_d_ff=16, moe_shared_d_ff=32, ssm_state=16, ssm_head_dim=16, vocab=512,
             max_seq=4096, dtype="float32")
    return p


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
    """Layer ``l``'s weights out of the flat float32 leaves ``w`` (paths of
    the program's tree, ``blocks/<spec>/...`` stacked over the blocks)."""
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


def head(params: dict, sz: dict) -> torch.Tensor:
    return params["embed"].float().T if sz["tie_embeddings"] else params["lm_head"].float()


# -------------------------------------------------------------------- SSD
def segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., T) -> (..., T, T): out[i, j] = a[j+1] + ... + a[i] for i >= j
    (a sum over the segment itself, so no difference of large cumulative
    sums loses precision), -inf above the diagonal."""
    t = a.shape[-1]
    x = a[..., None].expand(*a.shape, t)                       # x[..., i, j] = a[i]
    below = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device), -1)
    s = torch.cumsum(x.masked_fill(~below, 0.0), dim=-2)
    keep = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device))
    return s.masked_fill(~keep, -math.inf)


def ssd(x, dt, A, B, C, chunk: int = SSD_CHUNK):
    """The SSD scan h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T, y_t = h_t
    C_t, in its chunked form: within a chunk the quadratic form over its
    (L, L) pairs, across chunks the chunks' states carried by a product over
    the chunk totals. x (b, s, h, p), dt (b, s, h), A (h,), B and C (b, s,
    n). Returns y (b, s, h, p). A sequence that ``chunk`` does not divide is
    padded at its end (causal: the padding changes no earlier output)."""
    b, s, h, p = x.shape
    L = min(chunk, s)
    pad = -s % L
    if pad:
        x, dt, B, C = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, dt, B, C))
    nc = (s + pad) // L
    xc = x.reshape(b, nc, L, h, p)
    Bc, Cc = B.reshape(b, nc, L, -1), C.reshape(b, nc, L, -1)
    dtc = dt.reshape(b, nc, L, h)
    a = (dtc * A).permute(0, 3, 1, 2)                          # (b, h, c, L) log-decays
    a_cum = torch.cumsum(a, dim=-1)
    # within a chunk: y_l = sum_{m <= l} (C_l . B_m) exp(a_{m+1} + .. + a_l) dt_m x_m
    decay = torch.exp(segsum(a))                               # (b, h, c, L, L)
    y = torch.einsum("bcln,bcmn,bhclm,bcmh,bcmhp->bclhp", Cc, Bc, decay, dtc, xc)
    # each chunk's state at its end, then the states carried from chunk to chunk
    to_end = torch.exp(a_cum[..., -1:] - a_cum)                # (b, h, c, L)
    states = torch.einsum("bcln,bhcl,bclh,bclhp->bchnp", Bc, to_end, dtc, xc)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    carry = torch.exp(segsum(F.pad(a_cum[..., -1], (1, 0))))   # (b, h, c+1, c+1)
    before = torch.einsum("bhzc,bchnp->bzhnp", carry, states)[:, :-1]
    y = y + torch.einsum("bcln,bhcl,bchnp->bclhp", Cc, torch.exp(a_cum), before)
    return y.reshape(b, nc * L, h, p)[:, :s]


def ssd_recurrence(x, dt, A, B, C):
    """The same scan token by token (the tests' check of ``ssd``)."""
    b, s, h, p = x.shape
    state = x.new_zeros((b, h, B.shape[-1], p))
    ys = []
    for t in range(s):
        state = (state * torch.exp(dt[:, t] * A)[:, :, None, None]
                 + torch.einsum("bh,bn,bhp->bhnp", dt[:, t], B[:, t], x[:, t]))
        ys.append(torch.einsum("bn,bhnp->bhp", C[:, t], state))
    return torch.stack(ys, dim=1)


def _conv(x, w, bias):
    """Depthwise causal conv over the sequence, then SiLU. x (b, s, c), w (cw, c)."""
    cw, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    return F.silu(sum(xp[:, i:i + s] * w[i] for i in range(cw)) + bias)


def _saved(fn, *args):
    """``fn(*args)``, under a checkpoint of its own while a gradient is
    recorded."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _mamba_in(hn, m, mm: Matmul):
    """x, B and C through the causal conv, and dt."""
    xs = _conv(mm(hn, m["in_x"]), m["conv_x_w"], m["conv_x_b"])
    bc = _conv(mm(hn, m["in_bc"]), m["conv_bc_w"], m["conv_bc_b"])
    return xs, bc, F.softplus(mm(hn, m["in_dt"]) + m["dt_bias"])


def _mamba_out(hn, y, m, eps: float, mm: Matmul):
    """The gate silu(z), the norm over d_inner and out_proj."""
    g = y * F.silu(mm(hn, m["in_z"]))
    return mm(rmsnorm(g, m["norm"], eps), m["out_proj"])


def mamba(hn, m, sz: dict, mm: Matmul):
    """The Mamba2 mixer on the normed input hn (b, s, d). The projections
    and the conv run ``TOKEN_CHUNK`` tokens at a time, each chunk from the
    ``conv - 1`` tokens before it on, and keep the chunk's outputs."""
    b, s, _ = hn.shape
    ns, p = sz["ssm_state"], sz["ssm_head_dim"]
    back = m["conv_x_w"].shape[0] - 1
    parts = []
    for a in range(0, s, TOKEN_CHUNK):
        lo = max(a - back, 0)
        parts.append([t[:, a - lo:] for t in _saved(_mamba_in, hn[:, lo:a + TOKEN_CHUNK], m, mm)])
    xs, bc, dt = (torch.cat(ts, dim=1) for ts in zip(*parts))
    del parts
    A = -torch.exp(m["A_log"])
    h = dt.shape[-1]
    xh = xs.reshape(b, s, h, p)
    ys = [_saved(ssd, xh[:, :, g:g + HEAD_GROUP], dt[..., g:g + HEAD_GROUP],
                 A[g:g + HEAD_GROUP], bc[..., :ns], bc[..., ns:])
          for g in range(0, h, HEAD_GROUP)]
    y = (torch.cat(ys, dim=2) + m["D"][:, None] * xh).reshape(b, s, h * p)
    return torch.cat([_saved(_mamba_out, hn[:, a:a + TOKEN_CHUNK], y[:, a:a + TOKEN_CHUNK], m,
                             sz["norm_eps"], mm) for a in range(0, s, TOKEN_CHUNK)], dim=1)


def _attend_rows(q, k, v, q0: int, scale: float):
    """Causal attention of the queries at q0.. (b, c, kv, rep, hd), each
    group of ``rep`` query heads over its KV head's keys 0..q0+c-1, the
    scores times ``scale``."""
    n = q0 + q.shape[1]
    s = torch.einsum("bqgrd,bkgd->bgrqk", q, k[:, :n]) * scale
    later = (torch.arange(n, device=q.device)[None, :]
             > torch.arange(q0, n, device=q.device)[:, None])
    p = torch.softmax(s.masked_fill(later, -math.inf), dim=-1)
    return torch.einsum("bgrqk,bkgd->bqgrd", p, v[:, :n])


def attention(hn, a, sz: dict, mm: Matmul):
    """NoPE GQA on the normed input hn (b, s, d), the scores scaled by the
    attention multiplier, over query chunks of ``ATTN_CHUNK``."""
    b, s, _ = hn.shape
    h, kv, hd = sz["n_heads"], sz["n_kv_heads"], sz["head_dim"]
    q = mm(hn, a["wq"]).reshape(b, s, kv, h // kv, hd)
    k = mm(hn, a["wk"]).reshape(b, s, kv, hd)
    v = mm(hn, a["wv"]).reshape(b, s, kv, hd)
    o = torch.cat([_saved(_attend_rows, q[:, q0:q0 + ATTN_CHUNK], k, v, q0,
                          sz["attention_multiplier"]) for q0 in range(0, s, ATTN_CHUNK)], dim=1)
    return mm(o.reshape(b, s, h * hd), a["wo"])


# -------------------------------------------------------------------- MoE
def capacity(tokens: int, topk: int, experts: int, factor: float) -> int:
    c = int(tokens * topk / experts * factor)
    return max(8, -(-c // 8) * 8)


def moe(x, p, sz: dict, mm: Matmul, prefix: int | None = None):
    """x (T, d) in token-major order. Returns (the routed experts' and the
    shared expert's output (T, d), lb, z). The router, the capacity and the
    aux losses are over all ``moe_experts``; only the held experts add to
    the output. The capacity rule holds over the first ``prefix`` tokens (a
    prefill call of that many); the tokens after them are decode steps,
    each routed in its own call, and keep every assignment. ``prefix``
    None: one call of all T."""
    t = x.shape[0]
    e, k = sz["moe_experts"], sz["moe_topk"]
    held = sz.get("moe_held_experts") or e
    first_id = sz.get("moe_first_expert", 0)
    logits = x @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    n = t if prefix is None else prefix
    cap = capacity(n, k, e, sz["moe_capacity_factor"])
    flat = idx.reshape(-1)
    first = flat[: n * k]
    # each assignment's slot: the assignments to its expert before it
    counts = torch.cumsum(F.one_hot(first, e).T.contiguous(), dim=1).T
    slot = (counts - 1).gather(1, first[:, None])[:, 0]
    keep = torch.cat([slot < cap, torch.ones(flat.numel() - n * k, dtype=torch.bool,
                                             device=x.device)]).reshape(t, k)
    y = torch.zeros_like(x)
    for j in range(held):
        tok, kk = torch.nonzero((idx == first_id + j) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        hcur = F.silu(mm(xe, p["w_gate"][j])) * mm(xe, p["w_up"][j])
        y = y.index_add(0, tok, mm(hcur, p["w_down"][j]) * w[tok, kk][:, None])
    sp = p["shared"]
    y = y + mm(F.silu(mm(x, sp["w_gate"])) * mm(x, sp["w_up"]), sp["w_down"])
    me = probs.mean(0)
    ce = F.one_hot(idx, e).float().sum(1).mean(0) / k
    lb = e * (me * ce).sum()
    z = torch.logsumexp(logits, dim=-1).square().mean()
    return y, lb, z


# ------------------------------------------------------------------ layers
def layer(x, p, l: int, sz: dict, mm: Matmul, pos, prefix=None):
    """Layer ``l`` on x (B, S, d), its weights ``p``: its spec's Mamba2 or
    attention, then the MoE, each added times the residual multiplier.
    Returns (x, lb, z). Layer 0 scales its input, the embedding rows, by
    the embedding multiplier first. ``pos`` is unused: no layer encodes
    positions."""
    b, s, d = x.shape
    eps, r = sz["norm_eps"], sz["residual_multiplier"]
    if l == 0:
        x = x * sz["embedding_multiplier"]
    hn = rmsnorm(x, p["norm"], eps)
    if sz["block"][_spec(l, sz)[0]]["kind"] == "mamba":
        x = x + r * mamba(hn, p["attn"], sz, mm)
    else:
        x = x + r * attention(hn, p["attn"], sz, mm)
    hn = rmsnorm(x, p["ffn_norm"], eps).reshape(b * s, d)
    y, lb, z = moe(hn, p["moe"], sz, mm, prefix)
    return x + r * y.reshape(b, s, d), lb, z


@torch.no_grad()
def served_logits(params: dict, sz: dict, seqs: list[tuple[list[int], int]],
                  precision: str = "fp32") -> list[torch.Tensor]:
    """For each (tokens, prompt_len) of ``seqs``, tokens = prompt + served
    tokens but the last: the logits (n, V) at the positions that chose the
    n served tokens (the prompt's last position on), over the logits
    divisor. The prompt is one prefill call (its capacity), each later
    token a step of its own. Layer by layer over the sequences."""
    mm = Matmul(precision)
    dev = params["embed"].device
    xs = [params["embed"][torch.tensor(t, device=dev)].float()[None] for t, _ in seqs]
    for l in range(sz["n_layers"]):
        w = layer_weights(params, l, sz)
        xs = [layer(x, w, l, sz, mm, None, prefix=n)[0] for x, (_, n) in zip(xs, seqs)]
        del w
    w_out, fn = head(params, sz), params["final_norm"].float()
    return [mm(rmsnorm(x[0, n - 1:], fn, sz["norm_eps"]), w_out) / sz["logits_divisor"]
            for x, (_, n) in zip(xs, seqs)]
