"""A configuration file as the program runs it, and its weights drawn from
the seed.

The benchmark makes the weights itself, on the device, in the types they
are served in, a few large draws (one per stacked leaf), and hands the
same tensors to the program (in the program's parameter tree) and to the
reference (which reads them in float32). It never calls the program's own
initialisation.
"""
from __future__ import annotations


def port_config(conf: dict):
    """The program's ``ModelConfig`` from a configuration file's ``port``
    section."""
    from repro_torch.configs.base import LayerSpec, ModelConfig

    fields = dict(conf["port"])
    fields["block"] = tuple(LayerSpec(**b) for b in fields["block"])
    return ModelConfig(**fields)


def draw_params(cfg, seed: int, device) -> dict:
    """The program's parameter tree (stacked over blocks, ``transformer``'s
    layout) for an attention + MoE model, drawn from ``seed`` on ``device``:
    matrices N(0, 1) * fan_in**-0.5 in the config dtype, the router in
    float32, norm scales (used as ``1 + scale``) N(0, 1) * 0.1 in float32."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed % (2 ** 63))
    dt = getattr(torch, cfg.dtype)
    n, d, h, kv, hd = cfg.n_blocks, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    e, f = cfg.moe_experts, cfg.moe_d_ff

    def mat(shape, fan_in, dtype=dt):
        x = torch.randn(shape, generator=g, device=device, dtype=dtype)
        return x.mul_(fan_in ** -0.5)

    def norm(shape):
        return torch.randn(shape, generator=g, device=device, dtype=torch.float32).mul_(0.1)

    attn = {"wq": mat((n, d, h * hd), d), "wk": mat((n, d, kv * hd), d),
            "wv": mat((n, d, kv * hd), d), "wo": mat((n, h * hd, d), h * hd)}
    if cfg.qk_norm:
        attn["q_norm"], attn["k_norm"] = norm((n, hd)), norm((n, hd))
    block = {"norm": norm((n, d)), "attn": attn, "ffn_norm": norm((n, d)),
             "moe": {"router": mat((n, d, e), d, torch.float32),
                     "w_gate": mat((n, e, d, f), d), "w_up": mat((n, e, d, f), d),
                     "w_down": mat((n, e, f, d), f)}}
    params = {"embed": mat((cfg.vocab, d), d), "final_norm": norm((d,)), "blocks": (block,)}
    if not cfg.tie_embeddings:
        params["lm_head"] = mat((d, cfg.vocab), d)
    return params
