"""ResNet for ImageNet (BASELINE.json config 1, ResNet-50: the north
star), built with the port's fluid layers into the same Program the JAX
package builds (models/resnet.py).

Reference model definition style: the fluid image-classification model
used by reference distributed tests (dist_se_resnext.py and the classic
models repo ResNet): conv_bn blocks + bottleneck residuals, NCHW or
NHWC.
"""

from .. import fluid

DEPTH_CFG = {
    18: ([2, 2, 2, 2], 'basic'),
    34: ([3, 4, 6, 3], 'basic'),
    50: ([3, 4, 6, 3], 'bottleneck'),
    101: ([3, 4, 23, 3], 'bottleneck'),
    152: ([3, 8, 36, 3], 'bottleneck'),
}


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None, is_test=False, data_format='NCHW'):
    conv = fluid.layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=stride, padding=(filter_size - 1) // 2, groups=groups,
        act=None, bias_attr=False, data_format=data_format)
    return fluid.layers.batch_norm(input=conv, act=act, is_test=is_test,
                                   data_layout=data_format)


def shortcut(input, ch_out, stride, is_test, data_format='NCHW'):
    ch_in = input.shape[1 if data_format == 'NCHW' else 3]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, is_test=is_test,
                             data_format=data_format)
    return input


def bottleneck_block(input, num_filters, stride, is_test,
                     data_format='NCHW'):
    conv0 = conv_bn_layer(input, num_filters, 1, act='relu',
                          is_test=is_test, data_format=data_format)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride,
                          act='relu', is_test=is_test,
                          data_format=data_format)
    conv2 = conv_bn_layer(conv1, num_filters * 4, 1, act=None,
                          is_test=is_test, data_format=data_format)
    short = shortcut(input, num_filters * 4, stride, is_test,
                     data_format)
    return fluid.layers.elementwise_add(short, conv2, act='relu')


def basic_block(input, num_filters, stride, is_test,
                data_format='NCHW'):
    conv0 = conv_bn_layer(input, num_filters, 3, stride=stride,
                          act='relu', is_test=is_test,
                          data_format=data_format)
    conv1 = conv_bn_layer(conv0, num_filters, 3, act=None,
                          is_test=is_test, data_format=data_format)
    short = shortcut(input, num_filters, stride, is_test, data_format)
    return fluid.layers.elementwise_add(short, conv1, act='relu')


def resnet(input, class_dim=1000, depth=50, is_test=False,
           data_format='NCHW'):
    layers_cfg, block_type = DEPTH_CFG[depth]
    num_filters = [64, 128, 256, 512]
    conv = conv_bn_layer(input, 64, 7, stride=2, act='relu',
                         is_test=is_test, data_format=data_format)
    conv = fluid.layers.pool2d(conv, pool_size=3, pool_stride=2,
                               pool_padding=1, pool_type='max',
                               data_format=data_format)
    block_fn = bottleneck_block if block_type == 'bottleneck' \
        else basic_block
    for stage, count in enumerate(layers_cfg):
        for i in range(count):
            stride = 2 if i == 0 and stage != 0 else 1
            conv = block_fn(conv, num_filters[stage], stride, is_test,
                            data_format)
    pool = fluid.layers.pool2d(conv, pool_type='avg',
                               global_pooling=True, pool_size=1,
                               data_format=data_format)
    out = fluid.layers.fc(pool, size=class_dim)
    return out


def build(image_shape=(3, 224, 224), class_dim=1000, depth=50,
          is_test=False, data_format='NCHW'):
    """(feeds {'image', 'label'}, logits [N, class_dim], mean softmax
    cross-entropy loss, accuracy); image_shape is CHW and is turned to
    HWC for NHWC."""
    if data_format == 'NHWC' and image_shape[0] in (1, 3):
        image_shape = (image_shape[1], image_shape[2], image_shape[0])
    img = fluid.layers.data('image', shape=list(image_shape),
                            dtype='float32')
    label = fluid.layers.data('label', shape=[1], dtype='int64')
    logits = resnet(img, class_dim, depth, is_test, data_format)
    loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, label))
    acc = fluid.layers.accuracy(fluid.layers.softmax(logits), label)
    return {'image': img, 'label': label}, logits, loss, acc
