"""The wire calls of the collective ops, over ``torch.distributed``.

Each call takes a tensor and a process group and returns a new tensor;
none writes its input but ``all_reduce_``.  NCCL groups move CUDA
tensors card to card.  A gloo group takes CPU and CUDA tensors alike
(torch 2.11 and later: all_to_all_single, all_gather, reduce_scatter,
all_reduce and broadcast), moving a CUDA tensor through host memory
itself; that is the transport of ranks that share a card (NCCL refuses
two ranks on one device), whose compute stays on the card.
"""

import torch
import torch.distributed as dist

# reduce_scatter_single where this torch has it (reduce_scatter_tensor
# is its older name)
_REDUCE_SCATTER = getattr(dist, 'reduce_scatter_single', None) or \
    dist.reduce_scatter_tensor


def all_reduce(x, group, op=dist.ReduceOp.SUM):
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=group)
    return y


def all_reduce_(x, group, op=dist.ReduceOp.SUM):
    """all_reduce in place, over a contiguous x the caller owns (a flat
    bucket)."""
    dist.all_reduce(x, op=op, group=group)
    return x


class _AllReduceSum(torch.autograd.Function):
    """The sum over the group, whose backward sums the cotangents over
    the group: on every rank the gradient of the ranks' summed loss
    reaching this rank's input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def all_reduce_sum_grad(x, group):
    """all_reduce (sum) with a gradient (_AllReduceSum)."""
    return _AllReduceSum.apply(x, group)


def all_to_all(x, group):
    """x [n, ...] -> [n, ...]: block r of the result is block `rank` of
    rank r's x."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_gather(x, group):
    """x [k, ...] -> [n * k, ...], the ranks' x in rank order."""
    x = x.contiguous()
    n = dist.get_world_size(group)
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather(list(out.chunk(n)), x, group=group)
    return out


def reduce_scatter(x, group):
    """x [n * k, ...] -> [k, ...]: the sum over ranks of block `rank`."""
    x = x.contiguous()
    n = dist.get_world_size(group)
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _REDUCE_SCATTER(out, x, group=group)
    return out


def broadcast(x, group, root):
    """Group rank `root`'s x on every rank."""
    y = x.clone(memory_format=torch.contiguous_format)
    dist.broadcast(y, src=dist.get_global_rank(group, root), group=group)
    return y
