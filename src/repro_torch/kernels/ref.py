"""Plain PyTorch versions of the port's kernels (the allclose targets).

They run on any device; ``ops`` sends CPU tensors here, and the checks on
the card hold each kernel to them.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _masked_scores(q, k, causal, window, softcap, q_offset):
    """Scaled (and capped) scores (B, KV, rep, Sq, Skv) in f32, -1e30 where
    the masks drop a key, and the (Sq, Skv) mask."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    qf = (q.float() * hd ** -0.5).reshape(b, sq, kvh, h // kvh, hd)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qf, k.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return torch.where(mask, s, torch.full_like(s, NEG_INF)), mask


def _softmax_v(s, mask, q, v):
    """softmax(s) v in q's layout and dtype; a row with no valid key gives 0."""
    b, sq, h, hd = q.shape
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1)[:, None], p, torch.zeros_like(p))
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())
    return o.reshape(b, sq, h, hd).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0, q_offset=0):
    """Materialized-softmax attention. q: (B,Sq,H,hd); k/v: (B,Skv,KV,hd).

    f32 math, output in q's dtype; a row with no valid key gives 0, as the
    Hopper kernel, the JAX Pallas kernel and the JAX ``ref`` do."""
    s, mask = _masked_scores(q, k, causal, window, softcap, q_offset)
    return _softmax_v(s, mask, q, v)


def flash_attention_lse(q, k, v, *, causal=True, window=0, softcap=0.0, q_offset=0):
    """``flash_attention_ref``'s output and each row's log-sum-exp of its
    valid scores, (B, H, Sq) f32, +inf for a row with no valid key (the
    Hopper forward kernel's second output, which its backward reads)."""
    b, sq, h, _ = q.shape
    s, mask = _masked_scores(q, k, causal, window, softcap, q_offset)
    lse = torch.logsumexp(s, dim=-1).reshape(b, h, sq)
    lse = torch.where(mask.any(dim=-1), lse, torch.full_like(lse, float("inf")))
    return _softmax_v(s, mask, q, v), lse


def flash_attention_bwd(q, k, v, out, do, *, causal=True, window=0, softcap=0.0,
                        q_offset=0, kv_chunk=512):
    """Gradients (dq, dk, dv) of ``flash_attention_ref`` at (q, k, v), whose
    output is ``out``, for the output gradient ``do`` (B, Sq, H, hd), in the
    inputs' dtypes.

    The counterpart of JAX's autodiff of its jnp attention, in f32 math and
    in chunks of ``kv_chunk`` keys, so no (B, H, Sq, Skv) tensor is held.
    D = sum_j P_ij dP_ij is rowsum(do * out). A first pass recomputes each
    row's max and sum online; a second forms each chunk's P and
    dS = P (dP - D) (times the softcap's tanh derivative) and gives the
    chunk's dk and dv and its share of dq. The query heads of a group and
    their rows make one matrix dimension, (B, KV, group x Sq, hd), so every
    product is one batched matmul and GQA's sum over a group falls out of it.
    Chunks wholly past the last query of a causal mask are skipped. A row
    with no valid key has output 0 and gets zero gradient."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    scale = hd ** -0.5

    def rows(x):    # (B, Sq, H, hd) -> (B, KV, rep x Sq, hd), f32
        x = x.float().reshape(b, sq, kvh, rep, hd).permute(0, 2, 3, 1, 4)
        return x.reshape(b, kvh, rep * sq, hd)

    qf, dof = rows(q) * scale, rows(do)
    dsum = (dof * rows(out)).sum(dim=-1)
    kf, vf = (x.float().transpose(1, 2).contiguous() for x in (k, v))   # (B, KV, Skv, hd)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    starts = [c0 for c0 in range(0, skv, kv_chunk)
              if not (causal and c0 > q_offset + sq - 1)]

    def scores(c0):
        kc = kf[:, :, c0:c0 + kv_chunk]
        s = qf @ kc.transpose(-1, -2)                       # (B, KV, rep x Sq, chunk)
        t = None
        if softcap:
            t = torch.tanh(s / softcap)
            s = softcap * t
        kpos = c0 + torch.arange(kc.shape[2], device=q.device)[None, :]
        mask = torch.ones((sq, kc.shape[2]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        s.view(b, kvh, rep, sq, -1).masked_fill_(~mask, NEG_INF)
        return kc, s, t, mask

    m = torch.full((b, kvh, rep * sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    valid = torch.zeros((sq,), dtype=torch.bool, device=q.device)
    for c0 in starts:
        _, s, _, mask = scores(c0)
        m_new = torch.maximum(m, s.amax(dim=-1))
        l = l * torch.exp(m - m_new) + s.sub_(m_new[..., None]).exp_().sum(dim=-1)
        m = m_new
        valid |= mask.any(dim=-1)
    inv_l = torch.where(valid.repeat(rep), 1.0 / l.clamp_min(1e-30), torch.zeros_like(l))

    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for c0 in starts:
        kc, s, t, _ = scores(c0)
        p = s.sub_(m[..., None]).exp_().mul_(inv_l[..., None])
        dv[:, :, c0:c0 + kv_chunk] = p.transpose(-1, -2) @ dof
        ds = (dof @ vf[:, :, c0:c0 + kv_chunk].transpose(-1, -2)).sub_(dsum[..., None]).mul_(p)
        if softcap:
            ds.mul_(1.0 - t * t)
        dq += ds @ kc
        dk[:, :, c0:c0 + kv_chunk] = ds.transpose(-1, -2) @ qf
    dq = (dq * scale).reshape(b, kvh, rep, sq, hd).permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return dq.to(q.dtype), dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


def paged_attention_ref(q, k_pages, v_pages, page_table, lengths, *, softcap=0.0):
    """Decode attention over a paged pool, by gathering the pages.

    q: (B, H, hd); k/v_pages: (P, page, KV, hd); page_table: (B, max_pages)
    int32 (entries beyond the sequence are arbitrary valid page ids);
    lengths: (B,). A row with length 0 gives 0, as the Hopper kernel and the
    JAX Pallas kernel do (the JAX ``ref.paged_attention_ref`` would average
    V uniformly there).
    """
    b, h, hd = q.shape
    _, page, kvh, _ = k_pages.shape
    max_pages = page_table.shape[1]
    rep = h // kvh
    idx = page_table.long()
    k_ctx = k_pages[idx].reshape(b, max_pages * page, kvh, hd)
    v_ctx = v_pages[idx].reshape(b, max_pages * page, kvh, hd)
    qf = (q.float() * hd ** -0.5).reshape(b, kvh, rep, hd)
    s = torch.einsum("bgrd,bkgd->bgrk", qf, k_ctx.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    valid = (torch.arange(max_pages * page, device=q.device)[None, :]
             < lengths[:, None])
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid.any(dim=-1)[:, None, None, None], p, torch.zeros_like(p))
    o = torch.einsum("bgrk,bkgd->bgrd", p, v_ctx.float())
    return o.reshape(b, h, hd).to(q.dtype)


def flush_scores_ref(hits, clock, valid):
    """Paper section 3.3.1, over all sets at once: distance_score =
    hits * set_size + distance; flush score = set_size - 1 - rank(distance
    score, ties by slot), -1 for an invalid slot. int32 arithmetic, which
    wraps as JAX's does.

    hits: (num_sets, set_size) int32; clock: (num_sets,) int32; valid:
    (num_sets, set_size) bool -> (num_sets, set_size) int32."""
    ns, ss = hits.shape
    pos = torch.arange(ss, dtype=torch.int32, device=hits.device)[None, :]
    dist = torch.remainder(pos - clock.int()[:, None], ss)   # non-negative, as jnp.mod
    d = hits.int() * ss + dist
    d = torch.where(valid, d, torch.full_like(d, torch.iinfo(torch.int32).max))
    idx = torch.arange(ss, device=hits.device)
    lt = ((d[:, None, :] < d[:, :, None])
          | ((d[:, None, :] == d[:, :, None]) & (idx[None, None, :] < idx[None, :, None])))
    fs = ss - 1 - lt.sum(dim=-1, dtype=torch.int32)
    return torch.where(valid, fs, torch.full_like(fs, -1))
