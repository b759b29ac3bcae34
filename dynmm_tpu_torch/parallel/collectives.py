"""The collectives of mesh training, with the gradients GSPMD gives them.

Every collective here is a ``torch.distributed.all_reduce`` (a sum), so one
code path runs wherever the port runs: gloo on CPU tensors (the tests), gloo
on CUDA tensors (several ranks on one card: NCCL refuses two ranks on one
device), and NCCL across cards. A gather is the all-reduce of a zero-filled
full tensor that holds this rank's slice in place (exact: x + 0 = x), so
every rank of a group receives the same bits.

* ``all_sum``: the sum over a group; its backward is the sum of the
  incoming gradients over the group (each rank's addend reaches every
  rank's result).
* ``gather_slices``: the full tensor from each rank's equal slice along
  ``dim``; its backward hands each rank its own slice of the gradient.
  Every rank of the group computes the same loss from the full tensor, so
  the gradient a rank receives is already the whole one; summing the
  ranks' copies (``torch.distributed.nn.functional.all_gather``'s
  backward) would count it once a rank.
* ``copy_to_group``: the identity whose backward sums the gradient over
  the group: the input of a layer whose output channels are split over the
  group, each rank's slice contributing its part of the input's gradient.
* ``sync_batch_norm``: train-mode BN over the batch of every rank of a
  group (the global batch): mean and variance from all-summed sums, the
  gradient through them, the running statistics from the global count.

A group of None is one rank: every function is then the local one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over the ranks of ``group`` of ``x`` (differentiable)."""
    if group is None:
        return x
    return _AllSum.apply(x, group)


def _zeros_like_full(local: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    shape = list(local.shape)
    shape[dim] *= n
    full = local.new_zeros(shape)
    if (local.dim() == 4 and not local.is_contiguous()
            and local.is_contiguous(memory_format=torch.channels_last)):
        full = full.contiguous(memory_format=torch.channels_last)
    return full


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, group, index, n, dim):
        ctx.index, ctx.dim, ctx.size = index, dim, local.shape[dim]
        full = _zeros_like_full(local, dim, n)
        full.narrow(dim, index * ctx.size, ctx.size).copy_(local)
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, g):
        own = g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size)
        return own.clone(), None, None, None, None


def gather_slices(local: torch.Tensor, group, index: int,
                  dim: int = 0) -> torch.Tensor:
    """The full tensor of the equal slices along ``dim`` that the ranks of
    ``group`` hold, rank ``index`` of the group holding slice ``index``
    (differentiable: each rank's gradient is its own slice)."""
    if group is None:
        return local
    return _Gather.apply(local, group, index, group_size(group), dim)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, whose gradient is summed over ``group`` in the backward."""
    if group is None:
        return x
    return _CopyIn.apply(x, group)


def sync_batch_norm(x: torch.Tensor, weight, bias, running_mean, running_var,
                    momentum: float, eps: float, group) -> torch.Tensor:
    """Train-mode BN of ``x`` (N, C, ...) over the rows of every rank of
    ``group``, each rank holding as many rows: the global batch's mean and
    biased variance (two passes: the mean, then the centred squares),
    normalised, scaled and shifted; the running statistics updated in place
    with the unbiased variance of the global count. A map below fp32 (bf16)
    is normalised in fp32 and rounded once, as the JAX BN computes it."""
    xf = x.float() if x.dtype.itemsize < 4 else x
    dims = [0] + list(range(2, x.dim()))
    shape = [1, -1] + [1] * (x.dim() - 2)
    n = (x.numel() // x.shape[1]) * group_size(group)
    mean = all_sum(xf.sum(dims), group) / n
    d = xf - mean.reshape(shape)
    var = all_sum((d * d).sum(dims), group) / n
    y = d * torch.rsqrt(var + eps).reshape(shape)
    if weight is not None:
        y = y * weight.reshape(shape) + bias.reshape(shape)
    with torch.no_grad():
        running_mean.mul_(1.0 - momentum).add_(momentum * mean)
        running_var.mul_(1.0 - momentum).add_(
            momentum * var * (n / max(n - 1, 1)))
    return y.to(x.dtype)
