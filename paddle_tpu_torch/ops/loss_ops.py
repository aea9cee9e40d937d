"""The op types of the JAX package's ops/loss_ops.py that the port
lowers so far: `size`."""

import torch

from .registry import register


@register('size', no_grad_out_slots=('Out',))
def size(ctx, ins, attrs):
    """Input's element count as an int64 [1] (the reference's dtype,
    which the layer declares; the JAX package, with x64 off, holds it in
    int32)."""
    return {'Out': [torch.full((1,), ins['Input'][0].numel(),
                               dtype=torch.int64, device=ctx.device)]}
