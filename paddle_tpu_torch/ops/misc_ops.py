"""Ops that size themselves from their input's runtime length: the
Transformer's sinusoidal position encoding and the additive causal
bias (the JAX package's ops/misc_ops.py).  One Program then serves
every length bucket of a padded batch.

Reference: operators/add_position_encoding_op.cc computed the encoding
per LoD batch on the host.
"""

import torch

from .registry import register


@register('position_encoding')
def position_encoding(ctx, ins, attrs):
    """[B, T, D] -> [1, T, D]: sin(pos / 10000^(2 floor(i/2) / D)) at
    even i, cos at odd i.  Computed in f32 in the JAX package's order
    of operations (its angles are pos / power(10000, 2 floor(i/2) / D)
    with each step rounded to f32), never in f64 and rounded."""
    x = ins['X'][0]
    t, d = x.shape[1], attrs['d_model']
    dev = x.device
    pos = torch.arange(t, dtype=torch.float32, device=dev)[:, None]
    i = torch.arange(d, dtype=torch.float32, device=dev)[None, :]
    angle = pos / torch.pow(10000.0, (2.0 * torch.floor(i / 2.0)) / d)
    even = (torch.arange(d, device=dev) % 2 == 0)[None, :]
    pe = torch.where(even, torch.sin(angle), torch.cos(angle))
    return {'Out': [pe[None].to(x.dtype)]}


@register('causal_mask_like')
def causal_mask_like(ctx, ins, attrs):
    """[B, T, D] -> the additive causal bias [1, 1, T, T]: -1e9 above
    the diagonal, 0 on and below it."""
    x = ins['X'][0]
    t = x.shape[1]
    m = torch.triu(torch.full((t, t), -1e9, dtype=torch.float32,
                              device=x.device), diagonal=1)
    return {'Out': [m[None, None].to(x.dtype)]}
