"""Model/shape configuration system.

Every assigned architecture is a ``ModelConfig`` (frozen dataclass). Layer
stacking is expressed as a repeating ``block`` pattern of sublayer kinds so
heterogeneous stacks (gemma2 local/global, jamba attn:mamba 1:7 with MoE on
odd layers) still scan over homogeneous parameter groups.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class LayerSpec:
    """One sublayer inside the repeating block."""

    kind: str              # "attn" | "mamba"
    ffn: str = "mlp"       # "mlp" | "moe" | "none"
    window: int = 0        # sliding-window size; 0 = full attention


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|encdec|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    block: tuple[LayerSpec, ...] = ()  # () -> homogeneous full-attn + mlp

    # attention flavour
    qk_norm: bool = False
    attn_softcap: float = 0.0
    # sequences longer than this use the chunked online-softmax path (the
    # pure-JAX twin of the flash Pallas kernel); hillclimb overrides lower it
    attn_dense_threshold: int = 8192
    # Megatron-style sequence parallelism: residual stream + norms sharded
    # over the model axis on the sequence dim; GSPMD turns the TP all-reduces
    # into reduce-scatter + all-gather pairs and elementwise traffic /= TP
    seq_parallel: bool = False
    logit_softcap: float = 0.0
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, ...] = ()   # qwen2-vl M-RoPE (t, h, w) half-dims

    # MoE
    moe_experts: int = 0
    moe_topk: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25   # per-expert buffer = T*topk/E * this
    # "ep": experts sharded over data, token all-to-all (paper-standard);
    # "tp": expert weights sharded over model d_ff, output psum — moves
    #       T x d instead of E x C x d per layer (§Perf hillclimb)
    moe_parallel: str = "ep"

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64

    # encoder-decoder
    encoder_layers: int = 0
    encoder_seq: int = 0             # precomputed-frame length (whisper: 1500)

    # VLM stub
    vis_tokens: int = 0              # precomputed patch embeddings prepended

    act: str = "silu"                # silu | gelu
    tie_embeddings: bool = False
    embed_scale: bool = False        # multiply embeddings by sqrt(d_model) (gemma)
    norm_eps: float = 1e-6
    max_seq: int = 32768
    dtype: str = "bfloat16"
    # post-attention / post-ffn extra norms (gemma2 style)
    post_norms: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if not self.block:
            object.__setattr__(self, "block", (LayerSpec(kind="attn", ffn="mlp"),))
        assert self.n_layers % len(self.block) == 0, (
            f"{self.name}: n_layers {self.n_layers} not divisible by block {len(self.block)}")

    @property
    def n_blocks(self) -> int:
        return self.n_layers // len(self.block)

    @property
    def d_inner(self) -> int:          # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def has_attention(self) -> bool:
        return any(l.kind == "attn" for l in self.block)

    @property
    def sub_quadratic(self) -> bool:
        """Whether the long_500k cell runs (SSM/hybrid/windowed-attention).

        Hybrids qualify: most layers are O(1)-state Mamba; the few full-
        attention layers cost O(ctx) per decoded token (linear, not
        quadratic) with a KV footprint that fits when sharded."""
        if self.family in ("ssm", "hybrid"):
            return True
        return all(l.kind == "mamba" or l.window > 0 for l in self.block)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, hd = self.d_model, self.head_dim
        total = self.vocab * d                     # embed
        if not self.tie_embeddings:
            total += d * self.vocab                # lm_head
        per_block = 0
        for spec in self.block:
            per_block += d                          # pre-norm
            if self.post_norms:
                per_block += d
            if spec.kind == "attn":
                per_block += d * self.n_heads * hd          # wq
                per_block += 2 * d * self.n_kv_heads * hd   # wk, wv
                per_block += self.n_heads * hd * d          # wo
                if self.qk_norm:
                    per_block += 2 * hd
            else:  # mamba2
                di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
                per_block += d * (2 * di + 2 * N + H)   # in_proj (x,z,B,C,dt)
                per_block += self.ssm_conv * (di + 2 * N)
                per_block += 3 * H                       # A_log, D, dt_bias
                per_block += di                          # gated norm
                per_block += di * d                      # out_proj
            if spec.ffn == "mlp":
                per_block += d + 3 * d * self.d_ff
                if self.post_norms:
                    per_block += d
            elif spec.ffn == "moe":
                per_block += d + d * self.moe_experts    # norm + router
                per_block += self.moe_experts * 3 * d * self.moe_d_ff
                if self.post_norms:
                    per_block += d
        total += per_block * self.n_blocks
        total += d                                  # final norm
        if self.encoder_layers:
            enc = self.encoder_layers * (2 * d + d * self.n_heads * hd +
                                         2 * d * self.n_kv_heads * hd +
                                         self.n_heads * hd * d + 3 * d * self.d_ff + d)
            # cross-attention in every decoder layer
            cross = self.n_layers * (d + d * self.n_heads * hd +
                                     2 * d * self.n_kv_heads * hd + self.n_heads * hd * d)
            total += enc + cross + d
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if self.moe_experts == 0:
            return self.param_count()
        full = self.param_count()
        n_moe = sum(1 for l in self.block if l.ffn == "moe") * self.n_blocks
        inactive = n_moe * (self.moe_experts - self.moe_topk) * 3 * self.d_model * self.moe_d_ff
        return full - inactive


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                        # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    base = dict(
        n_layers=len(cfg.block) * 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_ff=128,
        vocab=256,
        head_dim=16,
        max_seq=128,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=16 if cfg.encoder_layers else 0,
        vis_tokens=8 if cfg.vis_tokens else 0,
        moe_experts=min(cfg.moe_experts, 4) if cfg.moe_experts else 0,
        moe_topk=min(cfg.moe_topk, 2) if cfg.moe_topk else 0,
        moe_d_ff=32 if cfg.moe_experts else 0,
        # tiny smoke configs run drop-free so prefill+decode == forward exactly
        moe_capacity_factor=16.0 if cfg.moe_experts else 1.25,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        mrope_sections=(4, 2, 2) if cfg.mrope_sections else (),
        dtype="float32",
    )
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
