"""MobileNetV3-Large (Howard et al., "Searching for MobileNetV3", ICCV
2019) trained by the paper's recipe, as PaddleClas ships it
(``MobileNetV3_large_x1_0``, ppcls/modeling/architectures/
mobilenet_v3.py).

The network (``build_train``), at Table 1's widths in ``BASE``:

- a 3 x 3 stride-2 stem of 16 channels, batch_norm, hard_swish;
- 15 bneck blocks (``BLOCKS``: kernel, expansion, output, SE,
  nonlinearity, stride), each a 1 x 1 expansion (conv + batch_norm +
  relu or hard_swish; PaddleClas keeps it in the first block too, where
  the expansion equals the input width), a depthwise k x k convolution
  (+ batch_norm + the same nonlinearity; ``depthwise_conv2d``), the
  squeeze-and-excite gate where the block has one, a linear 1 x 1
  projection (+ batch_norm), and the residual add where the block keeps
  its width and stride 1;
- the SE gate: global average pool, 1 x 1 conv to a quarter of the
  expansion + relu, 1 x 1 conv back + hard_sigmoid(slope 1/6, offset
  0.5), which is the paper's h-sigmoid relu6(x + 3) / 6, then
  ``elementwise_mul(axis=0)`` on the block's activation;
- the head: 1 x 1 conv to 960 + batch_norm + hard_swish, global
  average pool, 1 x 1 conv to 1280 without bias or batch_norm +
  hard_swish, dropout 0.2, fc to the classes;
- the loss: ``softmax_with_cross_entropy`` and ``mean``.

The convolutions have no bias (batch_norm follows them), as in
PaddleClas.  BASE has 5,480,206 trainable parameters at 1000 classes
(Table 3: 5.4M).

The recipe (paper section 6.1): ``RMSPropOptimizer`` with momentum 0.9
and rho (decay) 0.9; the learning rate 0.1 at batch 4096 scaled
linearly to the batch, 0.1 * 128 / 4096 at BASE's 128, under
``exponential_decay(..., staircase=True)`` with rate 0.99 every 3
epochs (the paper's "decay rate of 0.01 every 3 epochs"); L2 weight
decay 1e-5 on every parameter (``L2Decay`` as the optimizer's
regularization); and ``ExponentialMovingAverage(0.9999).update()``
after ``minimize``.  Values the paper does not fix: RMSProp's epsilon
0.001, the TensorFlow TPU reference models' default
(models/official/efficientnet/utils.py ``build_optimizer``); 3 epochs as
3 * ceil(1,281,167 / 128) = 30,030 steps of ImageNet-1k's training set
at batch 128 (``decay_steps``).

``TINY`` keeps the block structure (an expansion equal to its input,
5 x 5 depthwise kernels, stride 2, SE gates, both nonlinearities, a
residual) at narrow widths and 32 x 32 images for the CPU tests.

As in models/seq2seq.py and label_semantic_roles.py, each builder
takes the `fluid` module it builds with as its first argument and uses
nothing else, so the tests build the same Program in both packages.  Images and labels are drawn
from a seed (``synthetic_batch``): ImageNet is not in the repository.
"""

import collections
import math

import numpy as np

MobileNetV3Config = collections.namedtuple(
    'MobileNetV3Config', ['stem', 'blocks', 'squeeze', 'expand', 'classes',
                          'image', 'batch', 'dropout', 'lr', 'decay_steps',
                          'decay_rate', 'rho', 'momentum', 'epsilon',
                          'weight_decay', 'ema_decay'])

# Table 1 of the paper: (kernel, expansion, output, SE, nonlinearity,
# stride)
BLOCKS = (
    (3, 16, 16, False, 'relu', 1),
    (3, 64, 24, False, 'relu', 2),
    (3, 72, 24, False, 'relu', 1),
    (5, 72, 40, True, 'relu', 2),
    (5, 120, 40, True, 'relu', 1),
    (5, 120, 40, True, 'relu', 1),
    (3, 240, 80, False, 'hard_swish', 2),
    (3, 200, 80, False, 'hard_swish', 1),
    (3, 184, 80, False, 'hard_swish', 1),
    (3, 184, 80, False, 'hard_swish', 1),
    (3, 480, 112, True, 'hard_swish', 1),
    (3, 672, 112, True, 'hard_swish', 1),
    (5, 672, 160, True, 'hard_swish', 2),
    (5, 960, 160, True, 'hard_swish', 1),
    (5, 960, 160, True, 'hard_swish', 1),
)

IMAGENET_TRAIN = 1281167

BASE = MobileNetV3Config(
    stem=16, blocks=BLOCKS, squeeze=960, expand=1280, classes=1000,
    image=224, batch=128, dropout=0.2, lr=0.1 * 128 / 4096,
    decay_steps=3 * int(math.ceil(IMAGENET_TRAIN / 128.0)),
    decay_rate=0.99, rho=0.9, momentum=0.9, epsilon=1e-3,
    weight_decay=1e-5, ema_decay=0.9999)

TINY = BASE._replace(
    stem=8,
    blocks=((3, 8, 8, False, 'relu', 1),
            (3, 16, 12, False, 'relu', 2),
            (5, 24, 12, True, 'relu', 1),
            (3, 32, 16, True, 'hard_swish', 2),
            (5, 48, 16, True, 'hard_swish', 1)),
    squeeze=48, expand=64, classes=10, image=32, batch=4, lr=0.01,
    decay_steps=2, ema_decay=0.9)


def _act(fluid, x, act):
    if act == 'relu':
        return fluid.layers.relu(x)
    if act == 'hard_swish':
        return fluid.layers.hard_swish(x)
    return x


def _conv_bn(fluid, x, filters, size, stride=1, groups=1, act=None):
    conv = fluid.layers.conv2d(x, filters, size, stride=stride,
                               padding=(size - 1) // 2, groups=groups,
                               bias_attr=False)
    return _act(fluid, fluid.layers.batch_norm(conv), act)


def _se(fluid, x, channels):
    pool = fluid.layers.pool2d(x, pool_type='avg', global_pooling=True)
    squeeze = fluid.layers.conv2d(pool, channels // 4, 1, act='relu')
    gate = fluid.layers.hard_sigmoid(
        fluid.layers.conv2d(squeeze, channels, 1), slope=1.0 / 6,
        offset=0.5)
    return fluid.layers.elementwise_mul(x, gate, axis=0)


def _bneck(fluid, x, in_ch, block):
    k, exp, out, se, act, stride = block
    h = _conv_bn(fluid, x, exp, 1, act=act)
    h = _conv_bn(fluid, h, exp, k, stride=stride, groups=exp, act=act)
    if se:
        h = _se(fluid, h, exp)
    h = _conv_bn(fluid, h, out, 1)
    if in_ch == out and stride == 1:
        return fluid.layers.elementwise_add(x, h)
    return h


def network(fluid, cfg, image):
    """The logits [N, classes] of `image` [N, 3, H, W]."""
    h = _conv_bn(fluid, image, cfg.stem, 3, stride=2, act='hard_swish')
    ch = cfg.stem
    for block in cfg.blocks:
        h = _bneck(fluid, h, ch, block)
        ch = block[2]
    h = _conv_bn(fluid, h, cfg.squeeze, 1, act='hard_swish')
    h = fluid.layers.pool2d(h, pool_type='avg', global_pooling=True)
    h = fluid.layers.hard_swish(
        fluid.layers.conv2d(h, cfg.expand, 1, bias_attr=False))
    h = fluid.layers.dropout(h, dropout_prob=cfg.dropout)
    return fluid.layers.fc(h, cfg.classes)


def build_train(fluid, cfg):
    """Inside a program_guard: (image, label, loss, logits) of one
    training step, with the recipe's optimizer and EMA appended."""
    image = fluid.layers.data('image', [3, cfg.image, cfg.image],
                              dtype='float32')
    label = fluid.layers.data('label', [1], dtype='int64')
    logits = network(fluid, cfg, image)
    loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, label))
    lr = fluid.layers.exponential_decay(cfg.lr, cfg.decay_steps,
                                        cfg.decay_rate, staircase=True)
    opt = fluid.optimizer.RMSProp(
        lr, rho=cfg.rho, epsilon=cfg.epsilon, momentum=cfg.momentum,
        regularization=fluid.regularizer.L2Decay(cfg.weight_decay))
    opt.minimize(loss)
    fluid.optimizer.ExponentialMovingAverage(cfg.ema_decay).update()
    return image, label, loss, logits


def synthetic_batch(cfg, rng):
    """{'image': f32 [cfg.batch, 3, H, W] ~ N(0, 1), 'label': int64
    [cfg.batch, 1] uniform over the classes} from `rng`."""
    n = cfg.batch
    return {'image': rng.standard_normal(
                (n, 3, cfg.image, cfg.image)).astype(np.float32),
            'label': rng.randint(0, cfg.classes, (n, 1)).astype('int64')}


def count_parameters(program):
    """The trainable parameters' element count."""
    return int(sum(np.prod(p.shape)
                   for p in program.global_block().all_parameters()
                   if p.trainable))
