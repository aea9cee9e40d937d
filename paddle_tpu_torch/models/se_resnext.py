"""SE-ResNeXt for ImageNet.

The model the reference uses to exercise distributed training
(python/paddle/fluid/tests/unittests/dist_se_resnext.py) and
ParallelExecutor parity fixtures: ResNeXt grouped-conv bottlenecks
(cardinality splits) plus Squeeze-and-Excitation channel gating.
Built with the port's fluid layers into the same Program the JAX
package builds (models/se_resnext.py).
"""

from .. import fluid

DEPTH_CFG = {
    50: [3, 4, 6, 3],
    101: [3, 4, 23, 3],
    152: [3, 8, 36, 3],
}


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None, is_test=False):
    conv = fluid.layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=stride, padding=(filter_size - 1) // 2, groups=groups,
        act=None, bias_attr=False)
    return fluid.layers.batch_norm(input=conv, act=act, is_test=is_test)


def squeeze_excitation(input, num_channels, reduction_ratio=16):
    pool = fluid.layers.pool2d(input, pool_type='avg',
                               global_pooling=True)
    squeeze = fluid.layers.fc(pool, num_channels // reduction_ratio,
                              act='relu')
    excitation = fluid.layers.fc(squeeze, num_channels, act='sigmoid')
    return fluid.layers.elementwise_mul(input, excitation, axis=0)


def bottleneck_block(input, num_filters, stride, cardinality=32,
                     reduction_ratio=16, is_test=False):
    conv0 = conv_bn_layer(input, num_filters, 1, act='relu',
                          is_test=is_test)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride,
                          groups=cardinality, act='relu', is_test=is_test)
    conv2 = conv_bn_layer(conv1, num_filters * 2, 1, act=None,
                          is_test=is_test)
    scale = squeeze_excitation(conv2, num_filters * 2, reduction_ratio)

    ch_in = input.shape[1]
    if ch_in != num_filters * 2 or stride != 1:
        short = conv_bn_layer(input, num_filters * 2, 1, stride,
                              is_test=is_test)
    else:
        short = input
    return fluid.layers.elementwise_add(short, scale, act='relu')


def se_resnext(input, class_dim=1000, depth=50, cardinality=32,
               reduction_ratio=16, is_test=False,
               stage_filters=(128, 256, 512, 1024)):
    layers = DEPTH_CFG[depth]
    conv = conv_bn_layer(input, 64, 7, stride=2, act='relu',
                         is_test=is_test)
    conv = fluid.layers.pool2d(conv, pool_size=3, pool_stride=2,
                               pool_padding=1, pool_type='max')
    for stage, num_blocks in enumerate(layers):
        for i in range(num_blocks):
            conv = bottleneck_block(
                conv, stage_filters[stage],
                stride=2 if i == 0 and stage != 0 else 1,
                cardinality=cardinality,
                reduction_ratio=reduction_ratio, is_test=is_test)
    pool = fluid.layers.pool2d(conv, pool_type='avg', global_pooling=True)
    drop = fluid.layers.dropout(pool, dropout_prob=0.5, is_test=is_test)
    return fluid.layers.fc(drop, class_dim, act='softmax')


def build(image_shape=(3, 224, 224), class_dim=1000, depth=50,
          cardinality=32, reduction_ratio=16, is_test=False,
          stage_filters=(128, 256, 512, 1024)):
    """Feeds + softmax output + avg CE loss + accuracy (the shape the
    reference dist tests train)."""
    img = fluid.layers.data('image', shape=list(image_shape),
                            dtype='float32')
    label = fluid.layers.data('label', shape=[1], dtype='int64')
    out = se_resnext(img, class_dim, depth, cardinality, reduction_ratio,
                     is_test, stage_filters)
    cost = fluid.layers.cross_entropy(input=out, label=label)
    loss = fluid.layers.mean(cost)
    acc = fluid.layers.accuracy(input=out, label=label)
    return [img, label], out, loss, acc
