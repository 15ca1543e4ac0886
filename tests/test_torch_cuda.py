"""The port's CUDA kernels on the card: kernel == plain version, and the
serving engine through the kernel == dense decode. Skips without a card.

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports nothing of JAX, so it runs on a machine that has none.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as cuda_paged
from repro_torch.models import transformer as T
from repro_torch.serving import ServeEngine

pytestmark = pytest.mark.cuda

PAGED_CASES = [
    # b, h, kv, hd, page, max_pages, pool
    (4, 8, 2, 64, 16, 8, 64),
    (2, 4, 4, 128, 32, 4, 16),
    (3, 6, 6, 32, 8, 16, 128),
    (1, 16, 8, 64, 64, 4, 8),
    (4, 32, 8, 128, 16, 64, 65),      # qwen3-8b decode
    (2, 4, 2, 16, 8, 4, 16),          # reduced configs (hd 16)
]
TOLS = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel is CUDA C++ and has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(case, dtype, seed, lengths=None):
    b, h, kv, hd, page, maxp, pool = case
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().to(dtype)

    table = torch.from_numpy(rng.integers(0, pool, size=(b, maxp)).astype(np.int32)).cuda()
    if lengths is None:
        lengths = rng.integers(1, maxp * page, size=(b,))
    return (t(b, h, hd), t(pool, page, kv, hd), t(pool, page, kv, hd), table,
            torch.tensor(np.asarray(lengths, np.int32)).cuda())


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dtype", list(TOLS))
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_kernel_matches_plain_version(card, case, dtype, softcap):
    args = _inputs(case, getattr(torch, dtype), seed=PAGED_CASES.index(case))
    before = cuda_paged.paged_attention.launches
    out = ops.paged_attention(*args, softcap=softcap)
    torch.cuda.synchronize()
    assert cuda_paged.paged_attention.launches == before + 1
    want = ref.paged_attention_ref(*args, softcap=softcap)
    torch.testing.assert_close(out.float(), want.float(), atol=TOLS[dtype], rtol=TOLS[dtype])


@pytest.mark.parametrize("dtype", list(TOLS))
def test_kernel_length_zero_gives_zero(card, dtype):
    args = _inputs((5, 4, 2, 16, 8, 4, 16), getattr(torch, dtype), seed=9,
                   lengths=[0, 1, 8, 9, 32])
    out = ops.paged_attention(*args)
    assert torch.all(out[0] == 0)
    torch.testing.assert_close(out.float(), ref.paged_attention_ref(*args).float(),
                               atol=TOLS[dtype], rtol=TOLS[dtype])


def test_engine_through_kernel_matches_dense_decode(card):
    cfg = reduced(get_config("tinyllama-1.1b"))
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), card)
    eng = ServeEngine(cfg, params, max_batch=4, page_size=8, num_sets=4, set_size=3,
                      device=card)
    rng = np.random.default_rng(3)
    prompts = [[int(x) for x in rng.integers(1, 250, int(rng.integers(3, 20)))]
               for _ in range(6)]
    rids = [eng.submit(p, max_new=24) for p in prompts]
    before = cuda_paged.paged_attention.launches
    eng.run(800)
    eng.close()
    assert cuda_paged.paged_attention.launches > before
    assert eng.stats()["preemptions"] > 0
    with torch.no_grad():
        for rid, p in zip(rids, prompts):
            last, cache = T.prefill(params, torch.tensor([p], device=card), cfg, max_seq=128)
            t = last[:, -1].argmax(-1)[:, None]
            want = []
            for _ in range(24):
                want.append(int(t[0, 0]))
                lg, cache = T.decode_step(params, t, cache, cfg)
                t = lg[:, -1].argmax(-1)[:, None]
            assert eng.result(rid).out == want
