"""Compressed cross-pod gradient reduction, the port's twin of
``repro/distributed/collectives.py``.

The inter-pod links are the gradient all-reduce's bottleneck at 1000+ node
scale, so int8 compression with error feedback is applied to the pod axis
only:

    within a pod: full-precision all-reduce over ``data``     (fast links)
    across pods:  int8 per-row quantization + error feedback,
                  all-gather over ``pod`` + local dequant-sum  (slow links)

The functions take each rank's own tensors, as JAX's run inside
``shard_map``: call ``cross_pod_grad_reduce`` on the local gradients of the
local batch, on every rank of the mesh. The groups are the mesh's ``pod``
and ``data`` dims (``mesh.get_group``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import mesh_shape
from repro_torch.tree import leaves, tree_map, unflatten


class CompressionState(NamedTuple):
    """Error-feedback residual, one f32 leaf per gradient leaf."""

    residual: Any


def init_compression(grads: Any) -> CompressionState:
    return CompressionState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads))


def _quantize(x: torch.Tensor):
    """Symmetric per-row int8. x: f32 (..., d). ``torch.round`` rounds half
    to even, as ``jnp.round``. The divisor 127 is a tensor: PyTorch's CUDA
    division by a Python number multiplies by its rounded reciprocal, which
    differs from the true quotient (the CPU's, JAX's) in the last bit."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-20) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _all_gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` of ``group``, in group rank order."""
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.reshape(n, *x.shape)


def _ef_leaf(g: torch.Tensor, res: torch.Tensor, group, n: int):
    """Error-feedback compressed sum of one leaf over ``group`` (n ranks):
    the int8 payloads and f32 scales are gathered and dequantised locally,
    a lossless sum after the quantization."""
    x = g.float() + res
    flat = x.reshape(-1, x.shape[-1]) if x.dim() > 1 else x.reshape(1, -1)
    q, scale = _quantize(flat)
    new_res = (flat - _dequantize(q, scale)).reshape(x.shape)
    summed = (_all_gather(q, group, n).float() * _all_gather(scale, group, n)).sum(dim=0)
    return summed.reshape(x.shape).to(g.dtype), new_res


def cross_pod_grad_reduce(grads: Any, state: CompressionState, mesh, *,
                          data_axis: str = "data", pod_axis: str = "pod",
                          compress: bool = True):
    """Mean-reduce each rank's ``grads`` over (pod, data): full precision
    within a pod, int8 + error feedback across pods. Returns (grads,
    new_state), both this rank's."""
    sizes = mesh_shape(mesh)
    n_pod, n_data = sizes.get(pod_axis, 1), sizes.get(data_axis, 1)

    def leaf(g, r):
        g = g.clone()
        if n_data > 1:
            dist.all_reduce(g, group=mesh.get_group(data_axis))
        if n_pod == 1:
            return g / n_data, r
        if not compress:
            dist.all_reduce(g, group=mesh.get_group(pod_axis))
            return g / (n_data * n_pod), r
        s, new_r = _ef_leaf(g, r, mesh.get_group(pod_axis), n_pod)
        return s / (n_data * n_pod), new_r

    outs = [leaf(g, r) for g, r in zip(leaves(grads), leaves(state.residual))]
    return (unflatten(grads, [o[0] for o in outs]),
            CompressionState(residual=unflatten(grads, [o[1] for o in outs])))


# ---------------------------------------------------------------------------
# Collectives inside ``local_map``, differentiated as JAX's ``shard_map``
# (``check_rep=False``) differentiates them: psum's transpose is psum,
# pmean's pmean, a tiled all-to-all's the reverse all-to-all.
# ---------------------------------------------------------------------------

def _reduce_over(x: torch.Tensor, groups, op=dist.ReduceOp.SUM) -> torch.Tensor:
    x = x.contiguous().clone()
    for g in groups:
        dist.all_reduce(x, op=op, group=g)
    return x


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, scale):
        ctx.groups, ctx.scale = groups, scale
        return _reduce_over(x, groups) * scale

    @staticmethod
    def backward(ctx, g):
        return _reduce_over(g, ctx.groups) * ctx.scale, None, None


def group_size(groups) -> int:
    n = 1
    for g in groups:
        n *= dist.get_world_size(g)
    return n


def psum(x: torch.Tensor, groups) -> torch.Tensor:
    """Sum of ``x`` over every rank of ``groups`` (one group per mesh axis)."""
    return _PSum.apply(x, tuple(groups), 1.0)


def pmean(x: torch.Tensor, groups) -> torch.Tensor:
    return _PSum.apply(x, tuple(groups), 1.0 / group_size(groups))


def pmax(x: torch.Tensor, groups) -> torch.Tensor:
    """Largest ``x`` over every rank of ``groups``; not differentiated (the
    decode's softmax combine only)."""
    return _reduce_over(x, groups, dist.ReduceOp.MAX)


def _experts_to_owners(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """(E, C, d) -> (E/n, n*C, d): rank j gets its E/n experts' rows from
    every rank, source-major along dim 1 (JAX's ``all_to_all(split_axis=0,
    concat_axis=1, tiled=True)``)."""
    e, c, d = x.shape
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out.reshape(n, e // n, c, d).transpose(0, 1).reshape(e // n, n * c, d)


def _rows_to_sources(y: torch.Tensor, group, n: int) -> torch.Tensor:
    """The inverse: (E/n, n*C, d) -> (E, C, d) (``split_axis=1,
    concat_axis=0``)."""
    el, nc, d = y.shape
    x = y.reshape(el, n, nc // n, d).transpose(0, 1).contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out.reshape(n * el, nc // n, d)


class _ExpertsToOwners(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _experts_to_owners(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _rows_to_sources(g, ctx.group, ctx.n), None, None


class _RowsToSources(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group, n):
        ctx.group, ctx.n = group, n
        return _rows_to_sources(y, group, n)

    @staticmethod
    def backward(ctx, g):
        return _experts_to_owners(g, ctx.group, ctx.n), None, None


def experts_to_owners(x: torch.Tensor, group, n: int) -> torch.Tensor:
    return _ExpertsToOwners.apply(x, group, n)


def rows_to_sources(y: torch.Tensor, group, n: int) -> torch.Tensor:
    return _RowsToSources.apply(y, group, n)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def scale_grad(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x`` whose gradient is multiplied by ``scale``: a ``local_map``
    output replicated over n ranks takes 1/n of the cotangent on each, as
    ``shard_map`` splits an unmapped output's cotangent."""
    return x if scale == 1.0 else _ScaleGrad.apply(x, scale)
