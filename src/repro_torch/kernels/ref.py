"""Plain PyTorch versions of the port's kernels (the allclose targets).

They run on any device; ``ops`` sends CPU tensors here, and the checks on
the card hold each kernel to them.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


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
