"""The MoE, Mamba2 and hybrid families in the port against the JAX package:
the model's forward, prefill, decode and aux losses (reduced configs,
float32, weights converted from the JAX init). Their serving path is in
tests/test_torch_families_serving.py."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.models import transformer as JT
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as T

FAMILIES = ["olmoe-1b-7b", "granite-moe-1b-a400m", "mamba2-780m", "jamba-v0.1-52b"]
MAMBA_FAMILIES = ["mamba2-780m", "jamba-v0.1-52b"]


@pytest.fixture(scope="module", params=FAMILIES)
def model(request):
    arch = request.param
    jcfg = jax_reduced(jax_get_config(arch))
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = reduced(get_config(arch))
    return cfg, params_from_jax(jax.tree.map(np.asarray, jparams)), jcfg, jparams


def _close(out, want, tol):
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# the model (5e-3, as tests/test_models.py)
# ---------------------------------------------------------------------------

def test_forward_prefill_decode_match_jax(model):
    """Logits of forward, prefill and three decode steps within 5e-3 of
    JAX's, and forward's lb/z aux losses (nonzero for the MoE families)."""
    cfg, params, jcfg, jparams = model
    b, s, extra = 2, 12, 3
    toks = np.random.default_rng(1).integers(0, cfg.vocab, size=(b, s + extra))
    ttoks = torch.from_numpy(toks)
    full, aux = T.forward_logits(params, ttoks, cfg)
    jfull, jaux = JT.forward_logits(jparams, jnp.asarray(toks), jcfg)
    _close(full, jfull, 5e-3)
    for k in ("lb", "z"):
        _close(aux[k], jaux[k], 2e-5)
    if cfg.moe_experts:
        assert aux["lb"] > 0 and aux["z"] > 0
    last, cache = T.prefill(params, ttoks[:, :s], cfg, max_seq=32)
    jlast, jcache = JT.prefill(jparams, jnp.asarray(toks[:, :s]), jcfg, max_seq=32)
    _close(last, jlast, 5e-3)
    for t in range(s, s + extra):
        lg, cache = T.decode_step(params, ttoks[:, t:t + 1], cache, cfg)
        jlg, jcache = JT.decode_step(jparams, jnp.asarray(toks[:, t:t + 1]), jcache, jcfg)
        _close(lg, jlg, 5e-3)
    for lc, jlc in zip(cache.layers, jcache.layers):
        for k in lc:
            _close(lc[k], jlc[k], 5e-3)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_matches_forward(arch):
    cfg = reduced(get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    b, s, extra = 2, 24, 3
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, size=(b, s + extra)))
    full, _ = T.forward_logits(params, toks, cfg)
    last, cache = T.prefill(params, toks[:, :s], cfg, max_seq=64)
    _close(last, full[:, s - 1:s], 5e-3)
    for t in range(s, s + extra):
        lg, cache = T.decode_step(params, toks[:, t:t + 1], cache, cfg)
        _close(lg, full[:, t:t + 1], 5e-3)


@pytest.mark.parametrize("arch", MAMBA_FAMILIES)
@pytest.mark.parametrize("s", [1, 2])
def test_short_prompt_tail_is_zero_padded(arch, s):
    """A deviation from the reference: a prompt shorter than ssm_conv - 1
    tokens. JAX's prefill keeps a conv tail of s rows and its first decode
    step fails; the port zero-pads the tail at the front, as the causal conv
    pads in forward, so prefill + decode equals forward."""
    cfg = reduced(get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(s).integers(0, cfg.vocab, size=(2, s + 4)))
    full, _ = T.forward_logits(params, toks, cfg)
    last, cache = T.prefill(params, toks[:, :s], cfg, max_seq=16)
    _close(last, full[:, s - 1:s], 5e-3)
    mamba = [lc for lc, spec in zip(cache.layers, cfg.block) if spec.kind == "mamba"][0]
    assert mamba["conv_x"].shape[2] == cfg.ssm_conv - 1
    assert not mamba["conv_x"][:, :, :cfg.ssm_conv - 1 - s].any()
    for t in range(s, s + 4):
        lg, cache = T.decode_step(params, toks[:, t:t + 1], cache, cfg)
        _close(lg, full[:, t:t + 1], 5e-3)


def test_only_whisper_and_qwen2_vl_still_raise():
    """Every arch of the repo now goes through the model API (a reduced
    init, no family refused), and the serving engine's check refuses only
    the encoder-decoder one, whisper-tiny, which the JAX engine cannot serve
    either; qwen2-vl-72b, the other family that raised, passes it."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        assert T.init_params(reduced(cfg), torch.Generator().manual_seed(0))["blocks"]
        if cfg.encoder_layers:
            with pytest.raises(NotImplementedError, match="encoder-decoder"):
                T.check_servable(cfg)
        else:
            T.check_servable(cfg)
    assert [a for a in ARCH_IDS if get_config(a).encoder_layers] == ["whisper-tiny"]
