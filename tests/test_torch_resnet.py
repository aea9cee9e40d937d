"""The port's ResNet and SE-ResNeXt against the JAX package, on the CPU,
trained with Momentum from the JAX package's startup values on the same
seeded batches, in lockstep (tests/torch_image_cases.py ``lockstep``:
each step from the JAX package's state; the loss within rel 1e-4, the
parameters and moving statistics within 1e-4 of their largest, the
velocities within 1e-2, and why).

Shapes: test_models.py's ResNet-18 at 32 x 32 (batch 8, 10 classes,
Momentum(0.01, 0.9), a new batch each step; its NHWC twin is in
tests/test_torch_conv_pool.py); one ResNet-50 bottleneck (its 7 x 7
stem, max pool and first block with its projection shortcut) at
32 x 32, batch 2, Momentum(0.1, 0.9) with L2Decay(1e-4) as BASELINE's
ResNet-50 trains; test_se_resnext.py's tiny SE-ResNeXt (depth 8 = one
block a stage, cardinality 4, Momentum(0.05, 0.9)) with its dropout at
0 in both packages (the hidden dropout draws from jax threefry, which
torch does not reproduce); and the full ResNet-50 Program.
DEPTH_CFG[8] is put back by a fixture.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

from paddle_tpu.models import se_resnext as jse

from paddle_tpu_torch.models import se_resnext as tse

from torch_image_cases import (lockstep, programs, resnet18_lockstep,
                               same_block, se_resnext_tiny_build)

def test_resnet18_momentum_matches_jax():
    resnet18_lockstep('NCHW')


def test_resnet50_bottleneck_step_matches_jax():
    def build(fluid, resnet, _):
        img = fluid.layers.data('image', shape=[3, 32, 32])
        label = fluid.layers.data('label', shape=[1], dtype='int64')
        conv = resnet.conv_bn_layer(img, 64, 7, stride=2, act='relu')
        conv = fluid.layers.pool2d(conv, pool_size=3, pool_stride=2,
                                   pool_padding=1, pool_type='max')
        conv = resnet.bottleneck_block(conv, 64, 1, False)
        pool = fluid.layers.pool2d(conv, pool_type='avg',
                                   global_pooling=True, pool_size=1)
        logits = fluid.layers.fc(pool, size=10)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.Momentum(
            0.1, 0.9,
            regularization=fluid.regularizer.L2Decay(1e-4)).minimize(loss)
        return loss, [logits]
    rng = np.random.RandomState(1)
    feeds = [{'image': rng.randn(2, 3, 32, 32).astype('float32'),
              'label': rng.randint(0, 10, (2, 1)).astype('int64')}]
    progs = programs(build)
    types = [op.type for op in progs['torch'][0].global_block().ops]
    # the stem, the block's three convs and its projection shortcut
    assert types.count('conv2d') == 5 and types.count('batch_norm') == 5
    lockstep(progs, feeds, 0.1)


@pytest.fixture
def tiny_se_resnext(monkeypatch):
    monkeypatch.setitem(jse.DEPTH_CFG, 8, [1, 1, 1, 1])
    monkeypatch.setitem(tse.DEPTH_CFG, 8, [1, 1, 1, 1])


def test_se_resnext_tiny_matches_jax(tiny_se_resnext):
    rng = np.random.RandomState(0)
    feeds = []
    for _ in range(3):
        img = rng.rand(8, 3, 32, 32).astype('float32')
        lab = (img.mean(axis=(1, 2, 3)) * 4).astype('int64') % 4
        feeds.append({'image': img, 'label': lab.reshape(-1, 1)})
    progs = programs(se_resnext_tiny_build(), seed=5)
    types = [op.type for op in progs['torch'][0].global_block().ops]
    assert 'cross_entropy' in types and 'sigmoid' in types
    convs = [op for op in progs['torch'][0].global_block().ops
             if op.type == 'conv2d' and op.attrs['groups'] == 4]
    assert len(convs) == 4  # the grouped 3 x 3 conv of each block
    lockstep(progs, feeds, 0.05)


def test_resnet50_programs_serialize_like_jax():
    """ResNet-50 at 224 x 224 with Momentum and L2Decay(1e-4), its
    clone(for_test=True) (batch_norm in test mode, no backward or update
    ops) and its startup program: the same ops, attributes and
    variables in both packages."""
    def build(fluid, resnet, _):
        feeds, logits, loss, acc = resnet.build()
        fluid.optimizer.Momentum(
            0.1, 0.9,
            regularization=fluid.regularizer.L2Decay(1e-4)).minimize(loss)
        return loss, [logits, acc]
    progs = programs(build, seed=1)
    jm, js, _, _ = progs['jax']
    tm, ts, _, (logits, _) = progs['torch']
    assert tuple(logits.shape) == (-1, 1000)
    same_block(jm.to_dict()['blocks'][0], tm.to_dict()['blocks'][0])
    same_block(js.to_dict()['blocks'][0], ts.to_dict()['blocks'][0])
    jt = jm.clone(for_test=True).to_dict()['blocks'][0]
    tt = tm.clone(for_test=True).to_dict()['blocks'][0]
    same_block(jt, tt)
    assert all(o['attrs']['is_test'] for o in tt['ops']
               if o['type'] == 'batch_norm')
    types = [op.type for op in tm.global_block().ops]
    assert types.count('conv2d') == 53 and types.count('batch_norm') == 53
    params = [p for p in tm.all_parameters() if p.trainable]
    assert types.count('momentum') == len(params) == 161
    assert sum(int(np.prod(p.shape)) for p in params) == 25557032
