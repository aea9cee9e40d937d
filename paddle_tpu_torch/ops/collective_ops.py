"""Collective communication ops over ``torch.distributed``.

Reference: paddle/fluid/operators/collective/ (c_allreduce_{sum,max,
min,prod}, c_allgather, c_reducescatter, c_broadcast, c_gen_nccl_id,
c_comm_init, c_sync_{calc,comm}_stream) and the JAX package's
ops/collective_ops.py, which lowers them to jax.lax collectives over a
mesh axis inside shard_map.

Here each rank is a process, and every ring is the process group of
the lowering context (``LowerCtx.group``: the world group of a program
the collective transpiler marked, see fluid/executor.py), as every ring
is the 'dp' mesh axis in the JAX package.  Where there is no group, or
the group has one rank, every collective is the identity (the
reference's nranks == 1).

A ``c_allreduce_sum`` or ``c_allreduce_fused`` with ``plan`` set (the
planned GradAllReduce rewrite) takes the arm that fluid/comms_plan.py
``decide`` picks for its payload and group size: one all-reduce, a
reduce-scatter + all-gather, or the block-scaled int8 all-reduce (K8,
ops/kernels/quant_collective.py); fluid/comms.py counts the arm.  The
wire calls are distributed/wire.py's.  The stream-sync ops are the
identity (PyTorch orders a stream's work); the rendezvous ops are
no-ops (``init_distributed`` makes the group), and ``barrier`` waits
for the group.  The model-parallel ops (c_concat, c_split, c_embedding,
c_identity, mp_allreduce_sum) are not ported (ROADMAP Queue 1 item 13).
"""

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..distributed import wire
from ..fluid import comms, comms_plan
from .kernels import quant_collective
from .registry import register, register_host


def _group(ctx):
    """(group, participants) of every ring, or (None, 1) where the
    collective is the identity: no group, or a group of one rank."""
    group = ctx.group
    if group is None:
        return None, 1
    n = dist.get_world_size(group)
    return (group, n) if n > 1 else (None, 1)


# ---------------------------------------------------- planned reductions
def _quant_allreduce(x, group, n, block):
    """The quantized arm: K8's quantize, an int8 all_to_all, K8's
    dequant-reduce-requant, an int8 all_gather, the dequantize."""
    return quant_collective.quant_allreduce(x, group, n, block)


def _rs_ag_allreduce(x, group, n):
    """A dense all-reduce as reduce-scatter + all-gather of the flat
    payload padded to n equal chunks."""
    flat = x.reshape(-1)
    size = flat.numel()
    chunk = -(-size // n)
    if chunk * n > size:
        flat = F.pad(flat, (0, chunk * n - size))
    g = wire.all_gather(wire.reduce_scatter(flat, group), group)
    return g[:size].reshape(x.shape)


def _planned_allreduce(x, group, n, attrs):
    """The planner's arm for x's payload over the group's n ranks, run
    and counted; None where the collective is the identity."""
    if group is None:
        return None
    itemsize = x.element_size()
    d = comms_plan.decide(float(x.numel() * itemsize), itemsize, n,
                          forced_arm=attrs.get('plan_arm'))
    if d['arm'] == 'quant':
        out, arm = _quant_allreduce(x, group, n, d['block']), 'quant'
    elif d['strategy'] == 'rs_ag':
        out, arm = _rs_ag_allreduce(x, group, n), 'rs_ag'
    else:
        out, arm = wire.all_reduce(x, group), 'dense'
    comms.count_arm(arm)
    return out


@register('c_allreduce_sum')
def c_allreduce_sum(ctx, ins, attrs):
    x = ins['X'][0]
    planned = attrs.get('plan') or attrs.get('plan_arm')
    group, n = _group(ctx)
    if group is None:
        return {'Out': [x]}
    if planned:
        # a multi-ring reduce is one planned reduce a ring, every ring
        # the same group (as the JAX package reduces over 'dp' a ring)
        for _ in attrs.get('ring_ids') or [0]:
            x = _planned_allreduce(x, group, n, attrs)
        return {'Out': [x]}
    return {'Out': [wire.all_reduce(x, group)]}


@register('c_allreduce_fused')
def c_allreduce_fused(ctx, ins, attrs):
    """A fused gradient bucket: the flat gradients concatenated, one
    planned collective over the buffer, the result split back.  Out[i]
    is X[i]'s variable, as in the in-place c_allreduce_sum."""
    xs = list(ins['X'])
    group, n = _group(ctx)
    if group is None:
        return {'Out': xs}
    if len(xs) == 1:
        return {'Out': [_planned_allreduce(xs[0], group, n, attrs)]}
    flats = [x.reshape(-1) for x in xs]
    red = _planned_allreduce(torch.cat(flats), group, n, attrs)
    parts = red.split([f.numel() for f in flats])
    return {'Out': [p.reshape(x.shape) for p, x in zip(parts, xs)]}


def _reduce(op):
    def fn(ctx, ins, attrs):
        x = ins['X'][0]
        group, _ = _group(ctx)
        if group is None:
            return {'Out': [x]}
        return {'Out': [wire.all_reduce(x, group, op=op)]}
    return fn


register('c_allreduce_max')(_reduce(dist.ReduceOp.MAX))
register('c_allreduce_min')(_reduce(dist.ReduceOp.MIN))
register('c_allreduce_prod')(_reduce(dist.ReduceOp.PRODUCT))


@register('c_allgather')
def c_allgather(ctx, ins, attrs):
    """The ranks' X concatenated along dim 0, in rank order."""
    x = ins['X'][0]
    group, _ = _group(ctx)
    if group is None:
        return {'Out': [x]}
    return {'Out': [wire.all_gather(x, group)]}


@register('c_reducescatter')
def c_reducescatter(ctx, ins, attrs):
    """This rank's block of dim 0 of the sum over ranks."""
    x = ins['X'][0]
    group, _ = _group(ctx)
    if group is None:
        return {'Out': [x]}
    return {'Out': [wire.reduce_scatter(x, group)]}


@register('c_broadcast')
def c_broadcast(ctx, ins, attrs):
    x = ins['X'][0]
    group, _ = _group(ctx)
    if group is None:
        return {'Out': [x]}
    return {'Out': [wire.broadcast(x, group, int(attrs.get('root', 0)))]}


@register('c_sync_calc_stream')
def c_sync_calc_stream(ctx, ins, attrs):
    return {'Out': [ins['X'][0]]}


@register('c_sync_comm_stream')
def c_sync_comm_stream(ctx, ins, attrs):
    return {'Out': list(ins['X'])}


@register('barrier')
def barrier(ctx, ins, attrs):
    group, _ = _group(ctx)
    if group is not None:
        dist.barrier(group=group)
    return {'Out': list(ins.get('X', []))}


def _rendezvous(ctx, ins, attrs):
    pass  # init_distributed makes the group


for _type in ('c_gen_nccl_id', 'c_comm_init', 'c_comm_init_all'):
    register_host(_type)(_rendezvous)
