"""Fused op lowerings.

Reference: paddle/fluid/operators/fused/multihead_matmul_op.cu.  The
attention chain runs as the hand-written flash-attention kernel
(ops/kernels/flash_attention.py).
"""

from .registry import register


@register('fused_multihead_attention', stochastic=True)
def fused_multihead_attention(ctx, ins, attrs):
    """Q,K,V: [B, T, H, D] (+ optional KeyBias [B, T] additive score
    bias, e.g. a padding mask) -> Out [B, T, H, D].

    attrs['dropout_rate'] > 0 applies attention-probability dropout
    inside the kernels, with the counter-hash mask keyed on
    ctx.dropout_seed(attrs) (op seed and step), so the backward and any
    replay regenerate it; skipped in test mode (clone(for_test) stamps
    is_test), like the dropout op.  In data parallel rank r of local
    batch B passes the head-index offset r * B * H, so its masks are
    rows [r * B, (r + 1) * B) of the global batch's (the JAX package's
    one global computation)."""
    from .kernels.flash_attention import flash_attention
    q = ins['Q'][0]
    k = ins['K'][0]
    v = ins['V'][0]
    bias = ins['KeyBias'][0] if ins.get('KeyBias') else None
    rate = float(attrs.get('dropout_rate', 0.0) or 0.0)
    seed = ctx.dropout_seed(attrs) if rate else None
    if seed is None:
        rate = 0.0
    rep = ctx.data_parallel()
    g_offset = rep.rank * q.shape[0] * q.shape[2] if rep and rate else 0
    return {'Out': [flash_attention(q, k, v,
                                    causal=attrs.get('causal', False),
                                    key_bias=bias, dropout_rate=rate,
                                    dropout_seed=seed,
                                    dropout_g_offset=g_offset)]}
