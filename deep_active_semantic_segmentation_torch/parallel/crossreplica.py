"""Cross-replica batch-norm statistics and sums (parity: the JAX package's
parallel/crossreplica.py, itself the stand-in for the reference's
sync_batchnorm package).

Under the JAX package's jitted global step a plain BatchNorm already
computes the global batch's statistics. Here each rank holds its rows of
the global batch, so ``CrossReplicaBatchNorm2d``'s forward reduces the
ranks' (count, sum, sum of squares) per channel and its backward the
ranks' (sum dy, sum dy * (x - mean)). It is a ``BatchNorm2d`` (same
parameters, buffers and state_dict keys) and behaves as one in eval mode,
where it reads its running statistics and talks to no other rank. The
running variance takes the unbiased factor n / (n - 1) of the GLOBAL
count, as torch's BatchNorm2d does on one card.

The sums cross the ranks as each rank's count, mean and variance (one
fused pass over its rows, ``torch.var_mean``), every rank's row of one
(world, 2C + 1) f64 table that an all-reduce fills, and are merged there
exactly (Chan's formula), so E[x^2] - E[x]^2 never cancels; the output
is one ``F.batch_norm`` pass with the merged statistics. On a card the
same function runs on the fused CUDA batch-norm primitives that
``nn.SyncBatchNorm`` is built from (the ranks' (mean, invstd, count)
rows merged by ``batch_norm_gather_stats_with_counts``): a step with the
generic arithmetic's ~50 small launches per layer is bound on the host.

``nn.SyncBatchNorm`` itself is not used: it refuses CPU tensors, where
the tests run two gloo ranks, and gathers with all_gather, which gloo
does not run on CUDA tensors. It is this module's yardstick on the card.

Gradient convention (``cross_replica_sum``): every rank computes the
same global value; the backward of a sum all-reduce sums the ranks'
gradients, and DistributedDataParallel averages the parameters'
gradients, so the update is the gradient of the global value.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class _CrossReplicaSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad.clone()), None


def cross_replica_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks, on every rank, differentiable."""
    if mesh is None or not mesh.distributed:
        return x
    return _CrossReplicaSum.apply(x, mesh)


def cross_replica_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of ``x`` over the ranks (``jax.lax.pmean``)."""
    if mesh is None or not mesh.distributed:
        return x
    return cross_replica_sum(x, mesh) / mesh.world


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 for f32 and narrower activations (bf16 under autocast), f64
    for f64 ones."""
    return torch.promote_types(x.dtype, torch.float32)


def batch_norm_stats(x: torch.Tensor, mesh=None):
    """(mean, biased var, count) per channel of NCHW ``x`` over the global
    batch, in f64 (the JAX package's ``batch_norm_stats`` with
    ``axis_name``): each rank's count, mean and variance, merged over the
    ranks as (count, sum, sum of squares) are, without their
    cancellation."""
    c = x.shape[1]
    var, mean = torch.var_mean(x.detach().to(_compute_dtype(x)), dim=(0, 2, 3),
                               correction=0)
    n_local = x.numel() // c
    if mesh is None or not mesh.distributed:
        return mean.double(), var.double(), mean.new_tensor(n_local, dtype=torch.float64)
    table = torch.zeros((mesh.world, 2 * c + 1), dtype=torch.float64,
                        device=mean.device)
    table[mesh.rank, 0] = n_local
    table[mesh.rank, 1:c + 1] = mean
    table[mesh.rank, c + 1:] = var
    mesh.all_reduce(table)
    counts, means, variances = table[:, :1], table[:, 1:c + 1], table[:, c + 1:]
    n = counts.sum()
    mean = (counts * means).sum(0) / n
    var = (counts * (variances + (means - mean) ** 2)).sum(0) / n
    return mean, var, n


def _update_running(running_mean, running_var, momentum, mean, var, n):
    """The running statistics' update with the global batch's mean and
    unbiased variance (n / (n - 1) of the global count)."""
    running_mean.mul_(1 - momentum).add_(momentum * mean.to(running_mean.dtype))
    unbiased = var * (n / (n - 1).clamp_min(1.0))
    running_var.mul_(1 - momentum).add_(momentum * unbiased.to(running_var.dtype))


class _CrossReplicaBatchNorm(torch.autograd.Function):
    """The generic arithmetic, on any device (the CPU's, where the tests
    run): ``batch_norm_stats``, one ``F.batch_norm`` pass, and a two-pass
    input gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps,
                mesh):
        mean, var, n = batch_norm_stats(x, mesh)
        _update_running(running_mean, running_var, momentum, mean, var, n)
        cdt = _compute_dtype(x)
        invstd = torch.rsqrt(var + eps).to(cdt)
        mean = mean.to(cdt)
        y = F.batch_norm(x, mean, var.to(cdt), weight, bias, training=False,
                         momentum=0.0, eps=eps)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.mesh, ctx.n = mesh, n
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd = ctx.saved_tensors
        cdt = _compute_dtype(x)
        dyc = dy.to(cdt)
        xmu = x.to(cdt) - mean[None, :, None, None]
        c = x.shape[1]
        sums = torch.cat([dyc.sum((0, 2, 3)), (dyc * xmu).sum((0, 2, 3))])
        dbias, dweight = sums[:c].clone(), sums[c:] * invstd
        if ctx.mesh is not None and ctx.mesh.distributed:
            ctx.mesh.all_reduce(sums)
        # dx = w invstd (dy - mean(dy) - (x - mean) invstd^2 mean(dy (x - mean))),
        # the global means over every rank's rows, in two fused passes
        n = ctx.n.to(cdt)
        scale = weight * invstd
        dx = torch.addcmul((-scale * sums[:c] / n)[None, :, None, None], dyc,
                           scale[None, :, None, None])
        dx.addcmul_(xmu, (-scale * invstd * invstd * sums[c:] / n)[None, :, None, None])
        return dx.to(x.dtype), dweight, dbias, None, None, None, None, None


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the fused primitives take it: contiguous, or channels-last."""
    if t.is_contiguous() or t.is_contiguous(memory_format=torch.channels_last):
        return t
    return t.contiguous()


class _CudaCrossReplicaBatchNorm(torch.autograd.Function):
    """The same function on the card through the fused CUDA batch-norm
    primitives that ``nn.SyncBatchNorm`` is built from (one kernel for the
    rank's mean and invstd, one merging the ranks' and updating the running
    statistics, one normalizing; one reducing the backward's sums, one for
    the input gradient): a few launches per layer where the generic
    arithmetic makes ~50 small ones, and a step with it is bound by them on
    the host. The ranks' (mean, invstd, count) rows cross as one all-reduce
    of a zero table, which gloo runs on CUDA tensors too."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps,
                mesh):
        x = _dense(x)
        c = x.shape[1]
        mean, invstd = torch.batch_norm_stats(x, eps)
        row = torch.cat([mean, invstd, mean.new_full((1,), x.numel() // c)])
        table = row.new_zeros((mesh.world, 2 * c + 1))
        table[mesh.rank] = row
        mesh.all_reduce(table)
        means, invstds, counts = torch.split(table, [c, c, 1], dim=1)
        mean, invstd = torch.batch_norm_gather_stats_with_counts(
            x, means, invstds, running_mean, running_var, momentum, eps,
            counts.reshape(-1))
        ctx.save_for_backward(x, weight, mean, invstd,
                              counts.reshape(-1).to(torch.int32))
        ctx.mesh = mesh
        return torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd, counts = ctx.saved_tensors
        dy = _dense(dy)
        sum_dy, sum_dy_xmu, dweight, dbias = torch.batch_norm_backward_reduce(
            dy, x, mean, invstd, weight, True, True, True)
        sums = torch.cat([sum_dy, sum_dy_xmu])
        ctx.mesh.all_reduce(sums)
        sum_dy, sum_dy_xmu = torch.split(sums, x.shape[1])
        dx = torch.batch_norm_backward_elemt(dy, x, mean, invstd, weight, sum_dy,
                                             sum_dy_xmu, counts)
        return dx, dweight, dbias, None, None, None, None, None


class CrossReplicaBatchNorm2d(nn.BatchNorm2d):
    """``BatchNorm2d`` whose training-mode statistics are the global
    batch's over ``mesh``'s ranks (see the module docstring): the fused
    CUDA primitives on a card, the generic arithmetic elsewhere."""

    def __init__(self, num_features: int, mesh, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.mesh = mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        fn = _CudaCrossReplicaBatchNorm if x.is_cuda else _CrossReplicaBatchNorm
        return fn.apply(x, self.weight, self.bias, self.running_mean,
                        self.running_var, self.momentum, self.eps, self.mesh)

    def extra_repr(self) -> str:
        return super().extra_repr() + f", world={self.mesh.world}"


def convert_cross_replica_bn(module: nn.Module, mesh) -> nn.Module:
    """Every ``layers.batch_norm`` (a plain ``BatchNorm2d``) in ``module``
    replaced, in place, by a ``CrossReplicaBatchNorm2d`` holding its
    tensors; a no-op without a process group. Returns ``module``."""
    if mesh is None or not mesh.distributed:
        return module
    for name, child in module.named_children():
        if type(child) is nn.BatchNorm2d:
            new = CrossReplicaBatchNorm2d(child.num_features, mesh,
                                          eps=child.eps, momentum=child.momentum)
            new.load_state_dict(child.state_dict())
            new.train(child.training)
            setattr(module, name, new.to(child.weight.device))
        else:
            convert_cross_replica_bn(child, mesh)
    return module

