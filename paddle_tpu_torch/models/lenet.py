"""LeNet-5 for MNIST (BASELINE.json config 0), built with the port's
fluid layers into the same Program the JAX package builds
(models/lenet.py).

Reference model: python/paddle/fluid/tests/book/test_recognize_digits.py
(conv-pool x2 + fc-softmax).
"""

from .. import fluid


def build(img=None, label=None):
    """(feeds {'img', 'label'}, prediction [N, 10], mean cross-entropy
    loss, accuracy) of 1 x 28 x 28 images and [N, 1] int64 labels."""
    if img is None:
        img = fluid.layers.data('img', shape=[1, 28, 28], dtype='float32')
    if label is None:
        label = fluid.layers.data('label', shape=[1], dtype='int64')
    conv1 = fluid.nets.simple_img_conv_pool(
        input=img, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act='relu')
    conv2 = fluid.nets.simple_img_conv_pool(
        input=conv1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act='relu')
    prediction = fluid.layers.fc(input=conv2, size=10, act='softmax')
    loss = fluid.layers.mean(
        fluid.layers.cross_entropy(input=prediction, label=label))
    acc = fluid.layers.accuracy(input=prediction, label=label)
    return {'img': img, 'label': label}, prediction, loss, acc
