"""The port's async checkpoint manager: ports of the 8 tests of
tests/test_checkpoint.py, the JAX package's key strings, interop with JAX
checkpoints of (params, optimizer state) both ways, and bf16 leaves."""
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.checkpoint import flatten_with_paths as jax_flatten_with_paths
from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.models import transformer as JT
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.checkpoint import CheckpointManager, flatten_with_paths
from repro_torch.configs import get_config, reduced
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init
from repro_torch.tree import leaves


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((32, 16), generator=g),
            "b": {"w": torch.randn((8,), generator=g),
                  "s": torch.tensor(seed, dtype=torch.int32)}}


def _equal(a, b):
    for x, y in zip(leaves(a), leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_roundtrip(tmp_path):
    m = CheckpointManager(tmp_path, n_targets=2)
    t = _tree(0)
    m.save_async(0, t)
    assert m.wait_for_commit(0, 30)
    step, got = m.restore(t)
    assert step == 0
    _equal(t, got)
    m.close()


def test_supersede_discards_stale_writes(tmp_path):
    # a slow writer + rapid saves: early steps' chunks are discarded at the
    # queue head because newer saves superseded them (paper §3.3.2)
    m = CheckpointManager(tmp_path, n_targets=1, max_inflight=1, write_delay=0.05)
    for s in range(6):
        m.save_async(s, _tree(s))
    assert m.drain(60)
    assert m.stats["discarded_stale"] > 0
    assert m.latest_step() == 5
    _, got = m.restore(_tree(0))
    assert torch.equal(got["a"], _tree(5)["a"])
    m.close()


def test_restore_runs_while_writes_queued(tmp_path):
    m = CheckpointManager(tmp_path, n_targets=1, max_inflight=1, write_delay=0.02)
    t = _tree(1)
    m.save_async(0, t)
    assert m.wait_for_commit(0, 30)
    for s in range(1, 5):
        m.save_async(s, _tree(s))
    t0 = time.monotonic()
    step, got = m.restore(t, step=0)          # HIGH priority overtakes
    dt = time.monotonic() - t0
    assert step == 0
    # must not wait for the whole backlog (4 saves x 3 chunks x 20ms each)
    assert dt < 0.2, f"restore waited {dt}s behind low-priority writes"
    m.drain(60)
    m.close()


def test_resume_to_different_structure_fails_loud(tmp_path):
    m = CheckpointManager(tmp_path)
    m.save_async(0, _tree(0))
    assert m.wait_for_commit(0, 30)
    with pytest.raises(Exception):
        m.restore({"different": torch.zeros(3)})
    with pytest.raises(ValueError):                     # a leaf of another shape
        m.restore({**_tree(0), "a": torch.zeros((16, 32))})
    with pytest.raises(TypeError):                      # a leaf of another dtype
        m.restore({**_tree(0), "a": torch.zeros((32, 16), dtype=torch.float64)})
    m.close()


def test_retention(tmp_path):
    m = CheckpointManager(tmp_path, keep=2)
    for s in range(5):
        m.save_async(s, _tree(s))
        assert m.wait_for_commit(s, 30)
    # drain() returns once the commit's pruning has run (see the JAX test)
    assert m.drain(30)
    manifests = sorted(p.name for p in tmp_path.glob("manifest-*.json"))
    assert manifests == ["manifest-3.json", "manifest-4.json"]
    m.close()


def test_changed_keys_filter(tmp_path):
    m = CheckpointManager(tmp_path, n_targets=2)
    t = _tree(0)
    m.save_async(0, t)
    assert m.wait_for_commit(0, 30)
    w0 = m.stats["written"]
    m.save_async(1, t, changed={"a"})          # dirty-chunk tracking
    m.drain(30)
    assert m.stats["written"] == w0 + 1
    m.close()


def test_write_barrier_orders_durability(tmp_path):
    """Paper §3.4: everything before the barrier is durable after it."""
    m = CheckpointManager(tmp_path, n_targets=2, write_delay=0.01)
    for s in range(3):
        m.save_async(s, _tree(s))
    assert m.barrier(60)
    assert m.latest_step() == 2
    committed = sorted(int(p.stem.split("-")[1]) for p in tmp_path.glob("manifest-*.json"))
    drained = m.stats["written"] + m.stats["discarded_stale"]
    assert drained == 3 * 3  # 3 chunks per tree, none left in flight
    assert committed[-1] == 2
    m.close()


def test_elastic_restore_places_on_like(tmp_path):
    """The port's twin of test_elastic_restore_reshards (there is no mesh
    until the port's distribution): each leaf comes back on the device and
    in the layout of ``like``'s, a copy that the saved tree does not share."""
    m = CheckpointManager(tmp_path)
    t = _tree(4)
    m.save_async(0, t)
    assert m.wait_for_commit(0, 30)
    like = {"a": torch.zeros((16, 32)).T, "b": {"w": torch.zeros(8), "s": torch.tensor(0, dtype=torch.int32)}}
    step, got = m.restore(like)
    assert step == 0
    _equal(t, got)
    for g in leaves(got):
        assert g.device == torch.device("cpu") and g.is_contiguous()
    t["a"].add_(1.0)                       # the restored tree is not the saved one
    assert not torch.equal(t["a"], got["a"])
    m.close()


def test_save_copies_before_returning(tmp_path):
    """The port updates tensors in place: a save holds the values of the
    moment it was called, whatever the tree does afterwards."""
    m = CheckpointManager(tmp_path, n_targets=1, max_inflight=1, write_delay=0.05)
    t = _tree(2)
    want = {k: v.clone() for k, v in t.items() if k == "a"}
    m.save_async(0, t)
    t["a"].zero_()
    assert m.drain(30)
    _, got = m.restore(_tree(0), step=0)
    assert torch.equal(got["a"], want["a"])
    m.close()


# ---------------------------------------------------------------------------
# interop with the JAX package
# ---------------------------------------------------------------------------

def _jax_state(dtype: str):
    jcfg = jax_reduced(jax_get_config("olmoe-1b-7b"), dtype=dtype)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jparams, jax_adamw_init(jparams)


def test_keys_match_jax():
    """``flatten_with_paths`` of (params, AdamW state) gives the JAX
    package's key strings, in its order; None (no master copy) is no leaf."""
    for dtype in ("float32", "bfloat16"):
        jp, js = _jax_state(dtype)
        tp = params_from_jax(jax.tree.map(np.asarray, jp))
        ts = opt_state_from_jax(jax.tree.map(np.asarray, js))
        assert list(flatten_with_paths((tp, ts))) == list(jax_flatten_with_paths((jp, js)))


def test_jax_checkpoint_restores_into_port_and_back(tmp_path):
    """fp32 (params, opt) written by the JAX manager restore bitwise into the
    port's tree, and the port's write restores bitwise into JAX's."""
    jp, js = _jax_state("float32")
    jm = JaxCheckpointManager(tmp_path / "jax", n_targets=2)
    jm.save_async(3, (jp, js))
    assert jm.wait_for_commit(3, 30) and jm.drain(30)
    cfg = reduced(get_config("olmoe-1b-7b"))
    fresh = T.init_params(cfg, torch.Generator().manual_seed(9))
    like = (fresh, adamw_init(fresh))
    m = CheckpointManager(tmp_path / "jax", n_targets=2)
    step, (tp, ts) = m.restore(like)
    assert step == 3 and ts.master is None
    for got, want in zip(leaves((tp, ts)), jax.tree.leaves((jp, js))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.numpy().dtype == np.asarray(want).dtype
    m.save_async(4, (tp, ts))
    assert m.wait_for_commit(4, 30) and m.drain(30)
    _, back = JaxCheckpointManager(tmp_path / "jax").restore((jp, js), step=4)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves((jp, js))):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    m.close()
    jm.close()


def test_jax_bf16_chunk_restores_bitwise(tmp_path):
    """A bf16 leaf written by the JAX manager (header ``'<V2'``, read back as
    ``|V2``) restores bitwise into a port bf16 leaf, and the port writes the
    same file byte for byte."""
    jp, js = _jax_state("bfloat16")
    jtree = {"embed": jp["embed"], "master_embed": js.master["embed"]}
    jm = JaxCheckpointManager(tmp_path / "jax", n_targets=1)
    jm.save_async(0, jtree)
    assert jm.wait_for_commit(0, 30) and jm.drain(30)
    jm.close()
    like = {"embed": torch.zeros(jp["embed"].shape, dtype=torch.bfloat16),
            "master_embed": torch.zeros(jp["embed"].shape)}
    m = CheckpointManager(tmp_path / "jax", n_targets=1)
    _, got = m.restore(like)
    want = np.asarray(jp["embed"])
    assert got["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["embed"].view(torch.int16).numpy(), want.view(np.int16))
    np.testing.assert_array_equal(got["master_embed"].numpy(), np.asarray(js.master["embed"]))
    m.save_async(1, got)
    assert m.wait_for_commit(1, 30) and m.drain(30)
    m.close()
    name = "embed-{}.npy"
    assert (tmp_path / "jax" / name.format(1)).read_bytes() == \
        (tmp_path / "jax" / name.format(0)).read_bytes()


def test_bf16_roundtrip(tmp_path):
    """The port's own bf16 model and AdamW state (f32 master copy) through
    save and restore, bitwise."""
    cfg = reduced(get_config("tinyllama-1.1b"), dtype="bfloat16")
    params = T.init_params(cfg, torch.Generator().manual_seed(1))
    state = (params, adamw_init(params))
    assert state[1].master is not None
    m = CheckpointManager(tmp_path, n_targets=3)
    m.save_async(7, state)
    assert m.wait_for_commit(7, 30)
    fresh = T.init_params(cfg, torch.Generator().manual_seed(2))
    step, got = m.restore((fresh, adamw_init(fresh)))
    assert step == 7
    _equal(state, got)
    m.close()
