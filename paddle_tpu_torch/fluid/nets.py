"""Composite networks.  Reference: python/paddle/fluid/nets.py; each
appends the layers the JAX package's fluid/nets.py appends."""

from . import layers


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type='max',
                         global_pooling=False, conv_stride=1,
                         conv_padding=0, conv_dilation=1, conv_groups=1,
                         param_attr=None, bias_attr=None, act=None,
                         use_cudnn=True):
    """conv2d (with bias and act), then pool2d."""
    conv_out = layers.conv2d(input=input, num_filters=num_filters,
                             filter_size=filter_size, stride=conv_stride,
                             padding=conv_padding, dilation=conv_dilation,
                             groups=conv_groups, param_attr=param_attr,
                             bias_attr=bias_attr, act=act)
    return layers.pool2d(input=conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride,
                         pool_padding=pool_padding,
                         global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type='max', use_cudnn=True):
    """A conv2d per entry of conv_num_filter, each optionally followed
    by batch_norm (with the act) and dropout, then one pool2d (the VGG
    block)."""
    tmp = input
    if isinstance(conv_num_filter, int):
        conv_num_filter = [conv_num_filter]
    for i, nf in enumerate(conv_num_filter):
        tmp = layers.conv2d(input=tmp, num_filters=nf,
                            filter_size=conv_filter_size,
                            padding=conv_padding, param_attr=param_attr,
                            act=None if conv_with_batchnorm else conv_act)
        if conv_with_batchnorm:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            rate = conv_batchnorm_drop_rate
            if isinstance(rate, (list, tuple)):
                rate = rate[i]
            if rate > 0:
                tmp = layers.dropout(x=tmp, dropout_prob=rate)
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act='sigmoid', pool_type='max', mask=None):
    """A context-window conv over time, then a sequence pool (reference
    nets.py sequence_conv_pool).  On the padded+mask representation pass
    `mask` ([B, T], e.g. from layers.sequence_mask) so padded steps
    neither convolve nor pool."""
    conv = layers.sequence_conv(input, num_filters,
                                filter_size=filter_size,
                                param_attr=param_attr, act=act,
                                mask=mask)
    return layers.sequence_pool(conv, pool_type, mask=mask)


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head attention as the naive chain (reference nets.py
    scaled_dot_product_attention): the heads split by reshape and
    transpose, Q K^T scaled by d_key^-0.5 in one matmul, softmax, the
    optional dropout, the product with V and the heads merged back.
    As in the JAX package, the merge names the [B, T, H, D] context's
    dims (b, h, t, d), so the result is [B, H, T D] holding the
    context's elements in the order of [B, T, H D] (the reference's
    shape where T equals H): reshape it to [0, T, H D] for the
    reference's."""
    d_key = queries.shape[-1] // num_heads

    def _split_heads(x):
        b, t, c = x.shape
        x = layers.reshape(x, [0, 0, num_heads, c // num_heads])
        return layers.transpose(x, perm=[0, 2, 1, 3])

    q = _split_heads(queries)
    k = _split_heads(keys)
    v = _split_heads(values)
    product = layers.matmul(q, k, transpose_y=True,
                            alpha=d_key ** -0.5)
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    ctx = layers.matmul(weights, v)
    ctx = layers.transpose(ctx, perm=[0, 2, 1, 3])
    b, h, t, d = ctx.shape
    return layers.reshape(ctx, [0, t if t > 0 else 0, h * d])
