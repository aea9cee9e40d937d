"""The layers of ROADMAP Queue 1 item 11b's groups A and B
(fluid/layers/extras.py, the new more_layers.py layers and
fluid/layers/distributions.py) through whole programs on the CPU: each
program is built by one function in both packages
(torch_program_cases.build_both) and must serialize alike, main and
startup (same_program), then runs from the JAX package's startup state
on the same numpy feeds (run_both).

Tolerance (assert_runs_close): integer fetches bitwise, float fetches
within rtol TOL = 1e-5 plus 1e-5 of their largest magnitude, gradients
(fluid.gradients) within GRAD_TOL = 1e-4.  The draws of sampling_id,
random_crop and a distribution's sample (the port's counter hash, not
jax threefry) are compared by program, shape and range.  The JAX
package's continuous_value_model layer names an output its op does not
write, so its program cannot run; the port's op writes it, and its
values are the cvm layer's.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.fluid as tfluid

from torch_program_cases import (assert_runs_close, build_both, run_both,
                                 same_program)

TOL = 1e-5
GRAD_TOL = 1e-4


def _both(build, feeds, tol=TOL, seed=3, run=True):
    progs = build_both(build, seed=seed)
    same_program(progs['jax'][0], progs['torch'][0])
    same_program(progs['jax'][1], progs['torch'][1])
    if not run:
        return progs, None
    out = run_both(progs, feeds)
    assert_runs_close(out, tol)
    return progs, out


def _f(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        'float32')


def _data(fluid, name, shape, dtype='float32', grad=False):
    v = fluid.layers.data(name, shape, dtype=dtype)
    v.stop_gradient = not grad
    return v


def test_conv3d_and_pool3d_layers_and_their_gradients():
    def build(fluid):
        L = fluid.layers
        x = _data(fluid, 'x', [4, 5, 6, 6], grad=True)
        a = L.conv3d(x, 6, 3, padding=1, act='relu')
        b = L.conv3d(x, 4, [3, 1, 2], stride=[1, 2, 1], padding=[1, 0, 0],
                     groups=2, bias_attr=False)
        c = L.conv3d_transpose(x, 3, 2, stride=2)
        p = L.pool3d(a, pool_size=[1, 2, 2], pool_stride=[1, 2, 2])
        q = L.pool3d(a, pool_size=2, pool_type='avg', pool_padding=[0, 1, 1])
        r = L.adaptive_pool3d(x, [2, 2, 2], pool_type='max')
        g = L.pool3d(b, global_pooling=True)
        total = L.sums([L.mean(v) for v in (c, p, q, r, g)])
        return [a, b, c, p, q, r, g] + fluid.gradients(total, [x])
    _both(build, [{'x': _f((2, 4, 5, 6, 6), 1)}], GRAD_TOL)


def test_resize_and_rearrangement_layers():
    def build(fluid):
        L = fluid.layers
        v = _data(fluid, 'v', [3, 3, 4, 5], grad=True)
        x = _data(fluid, 'x', [12, 6, 4], grad=True)
        outs = [L.resize_trilinear(v, [5, 7, 4]),
                L.resize_trilinear(v, [2, 3, 8], align_corners=False),
                L.pixel_shuffle(x, 2), L.shuffle_channel(x, 3),
                L.space_to_depth(x, 2),
                L.unfold(x, [3, 2], strides=[1, 2], paddings=1),
                L.spp(x, pyramid_height=2),
                L.spp(x, pyramid_height=2, pool_type='avg')]
        total = L.sums([L.mean(L.square(o)) for o in outs])
        return outs + fluid.gradients(total, [v, x])
    _both(build, [{'v': _f((2, 3, 3, 4, 5), 2), 'x': _f((2, 12, 6, 4), 3)}],
          GRAD_TOL)


def test_affine_layers():
    def build(fluid):
        L = fluid.layers
        x = _data(fluid, 'x', [5, 3, 4])
        theta = _data(fluid, 'theta', [2, 3])
        scale = L.create_parameter([5], 'float32', name='ac_scale')
        bias = L.create_parameter([5], 'float32', name='ac_bias',
                                  is_bias=True)
        return [L.affine_channel(x, scale, bias),
                L.affine_grid(theta, [2, 1, 3, 5])]
    _both(build, [{'x': _f((2, 5, 3, 4), 4), 'theta': _f((2, 2, 3), 5)}])


def test_crop_layers():
    def build(fluid):
        L = fluid.layers
        x = _data(fluid, 'x', [5, 6])
        return [L.crop(x, shape=[2, 3, 4], offsets=[1, 2, 1]),
                L.crop_tensor(x, shape=[-1, 2, 5], offsets=[0, 3, 1]),
                L.crop_tensor(x, shape=[1, 5, 6])]
    _both(build, [{'x': _f((3, 5, 6), 6)}], 0)


def test_deformable_conv_layer():
    def build(fluid):
        L = fluid.layers
        x = _data(fluid, 'x', [4, 6, 5], grad=True)
        off = _data(fluid, 'off', [18, 6, 5], grad=True)
        mask = _data(fluid, 'mask', [9, 6, 5])
        a = L.deformable_conv(x, off, mask, 6, 3, padding=1)
        b = L.deformable_conv(x, off, None, 4, 3, padding=1,
                              modulated=False, bias_attr=False)
        total = L.sums([L.mean(L.square(a)), L.mean(b)])
        return [a, b] + fluid.gradients(total, [x, off])
    rng = np.random.RandomState(7)
    _both(build, [{'x': _f((2, 4, 6, 5), 8),
                   'off': rng.uniform(-2, 2, (2, 18, 6, 5)).astype('float32'),
                   'mask': rng.rand(2, 9, 6, 5).astype('float32')}],
          GRAD_TOL)


def test_ranking_and_distillation_loss_layers():
    def build(fluid):
        L = fluid.layers
        label = _data(fluid, 'label', [1])
        pm = _data(fluid, 'pm', [1])
        left = _data(fluid, 'left', [1], grad=True)
        right = _data(fluid, 'right', [1], grad=True)
        logits = _data(fluid, 'logits', [5], grad=True)
        cls = _data(fluid, 'cls', [1], dtype='int64')
        outs = [L.rank_loss(label, left, right),
                L.margin_rank_loss(pm, left, right, margin=0.2),
                L.hinge_loss(left, L.cast(L.greater_than(
                    label, L.fill_constant([1], 'float32', 0.5)),
                    'float32')),
                L.bpr_loss(logits, cls),
                L.modified_huber_loss(left, label),
                L.teacher_student_sigmoid_loss(left, pm)]
        total = L.sums([L.mean(o) for o in outs])
        return outs + fluid.gradients(total, [left, right, logits])
    rng = np.random.RandomState(9)
    feeds = [{'label': rng.rand(6, 1).astype('float32'),
              'pm': np.sign(_f((6, 1), 10)),
              'left': _f((6, 1), 11), 'right': _f((6, 1), 12),
              'logits': _f((6, 5), 13),
              'cls': rng.randint(0, 5, (6, 1)).astype('int64')}]
    _both(build, feeds, GRAD_TOL)


def test_center_loss_and_npair_loss_layers():
    def build(fluid):
        L = fluid.layers
        x = _data(fluid, 'x', [4], grad=True)
        y = _data(fluid, 'y', [4], grad=True)
        cls = _data(fluid, 'cls', [1], dtype='int64')
        closs = L.center_loss(x, cls, 5, alpha=0.3)
        npair = L.npair_loss(x, y, L.cast(cls, 'float32'))
        total = L.sums([L.mean(closs), npair])
        return [closs, npair] + fluid.gradients(total, [x, y])
    rng = np.random.RandomState(14)
    _both(build, [{'x': _f((6, 4), 15), 'y': _f((6, 4), 16),
                   'cls': rng.randint(0, 5, (6, 1)).astype('int64')}],
          GRAD_TOL)


def test_ctr_layers():
    def build(fluid):
        L = fluid.layers
        x = _data(fluid, 'x', [7], grad=True)
        dense = _data(fluid, 'dense', [3], grad=True)
        ids = _data(fluid, 'ids', [4], dtype='int64')
        outs = [L.cvm(x), L.cvm(x, use_cvm=False), L.data_norm(dense),
                L.data_norm(dense, act='relu', epsilon=1e-4, name='dn')]
        total = L.sums([L.mean(o) for o in outs])
        return outs + [L.hash(ids, 1000, num_hash=3),
                       L.shard_index(ids, 100, 3, 1)] + \
            fluid.gradients(total, [x, dense])
    rng = np.random.RandomState(17)
    _both(build, [{'x': np.abs(_f((5, 7), 18)) * 3,
                   'dense': _f((5, 3), 19, 5.0),
                   'ids': rng.randint(0, 100, (5, 4)).astype('int64')}],
          GRAD_TOL)


def test_continuous_value_model_layer():
    """Both programs alike but the output's shape (the JAX op writes
    Y, not the Out its layer names, so its inference leaves it
    unknown); the JAX run has no value for it; the port's is the cvm
    layer's."""
    def build(fluid, layer):
        L = fluid.layers
        x = _data(fluid, 'x', [7])
        cvm = L.slice(x, axes=[1], starts=[0], ends=[2])
        if layer == 'cvm':
            return [L.cvm(x)]
        return [L.continuous_value_model(x, cvm)]
    progs = build_both(lambda fluid: build(fluid, 'continuous_value_model'))
    jm, tm = progs['jax'][0], progs['torch'][0]
    assert [op.type for op in jm.global_block().ops] == \
        [op.type for op in tm.global_block().ops]
    out = progs['torch'][2][0]
    assert tuple(progs['jax'][2][0].shape) == ()
    assert tuple(out.shape) == (-1, 7)
    feed = {'x': np.abs(_f((4, 7), 20)) * 3}
    with jfluid.scope_guard(jfluid.Scope()):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(progs['jax'][1])
        with pytest.raises(Exception):
            exe.run(jm, feed=feed, fetch_list=[progs['jax'][2][0].name])
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(tfluid.CPUPlace())
        got, = exe.run(tm, feed=feed, fetch_list=[out])
    want = run_both(build_both(lambda fluid: build(fluid, 'cvm')),
                    [feed])['jax'][0][0]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * 10)


def test_misc_layers():
    def build(fluid):
        L = fluid.layers
        a = _data(fluid, 'a', [3], grad=True)
        b = _data(fluid, 'b', [4], grad=True)
        img = _data(fluid, 'img', [3, 4, 5], grad=True)
        img2 = _data(fluid, 'img2', [2, 4, 5], grad=True)
        seq = _data(fluid, 'seq', [6, 8], grad=True)
        sel = _data(fluid, 'sel', [1], dtype='int32')
        pred = _data(fluid, 'pred', [1], dtype='int32')
        lab = _data(fluid, 'lab', [1], dtype='int32')
        ref = _data(fluid, 'ref', [3], grad=True)
        index = fluid.layers.data('index', [5, 1], dtype='int64',
                                  append_batch_size=False)
        upd = fluid.layers.data('upd', [5, 3], dtype='float32',
                                append_batch_size=False)
        upd.stop_gradient = False
        w = L.create_parameter([4, 3], 'float32', name='sn_w')
        miou, wrong, correct = L.mean_iou(pred, lab, 4)
        outs = [L.multiplex([a, ref], sel),
                L.bilinear_tensor_product(a, b, 5, act='tanh'),
                L.scatter_nd_add(L.fill_constant([6, 3], 'float32', 1.0),
                                 index, upd),
                L.scatter_nd(index, upd, [6, 3]),
                L.pad_constant_like(img, img2, pad_value=-1.0),
                L.fsp_matrix(img, img2),
                L.add_position_encoding(seq, alpha=0.5, beta=2.0),
                L.similarity_focus(img, 1, [0, 2]),
                L.spectral_norm(w, dim=1, power_iters=2)]
        total = L.sums([L.mean(o) for o in outs])
        return outs + [miou, wrong, correct] + \
            fluid.gradients(total, [a, b, img, img2, seq, ref, upd])
    rng = np.random.RandomState(21)
    feeds = [{'a': _f((4, 3), 22), 'b': _f((4, 4), 23),
              'img': _f((4, 3, 4, 5), 24), 'img2': _f((4, 2, 4, 5), 25),
              'seq': _f((4, 6, 8), 26),
              'sel': rng.randint(0, 2, (4, 1)).astype('int32'),
              'pred': rng.randint(0, 4, (4, 1)).astype('int32'),
              'lab': rng.randint(0, 4, (4, 1)).astype('int32'),
              'ref': _f((4, 3), 27),
              'index': np.array([[1], [5], [1], [0], [2]], 'int64'),
              'upd': _f((5, 3), 28)}]
    _both(build, feeds, GRAD_TOL)


def test_sampling_layers_programs_and_ranges():
    def build(fluid):
        L = fluid.layers
        p = _data(fluid, 'p', [6])
        x = _data(fluid, 'x', [3, 9, 8])
        return [L.sampling_id(L.softmax(p)), L.random_crop(x, [5, 4])]
    progs, _ = _both(build, [], run=False)
    feed = {'p': _f((50, 6), 30), 'x': _f((50, 3, 9, 8), 31)}
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(progs['torch'][1])
        ids, crop = exe.run(progs['torch'][0], feed=feed,
                            fetch_list=progs['torch'][2])
    assert ids.shape == (50,) and ids.dtype == np.int64
    assert ids.min() >= 0 and ids.max() <= 5
    assert crop.shape == (50, 3, 5, 4)
    for k in range(0, 50, 7):
        hits = [(i, j) for i in range(5) for j in range(5)
                if np.array_equal(crop[k], feed['x'][k, :, i:i + 5,
                                                     j:j + 4])]
        assert hits, k


def test_unique_layers_programs():
    def build(fluid):
        x = _data(fluid, 'x', [1], dtype='int64')
        return list(fluid.layers.unique(x)) + \
            list(fluid.layers.unique_with_counts(x))
    progs, _ = _both(build, [], run=False)
    assert [op.type for op in progs['torch'][0].global_block().ops] == \
        ['unique', 'unique_with_counts']


def test_distributions():
    def build(fluid):
        L = fluid.layers
        lo = _data(fluid, 'lo', [3])
        hi = _data(fluid, 'hi', [3])
        v = _data(fluid, 'v', [3])
        logits = _data(fluid, 'logits', [4])
        logits2 = _data(fluid, 'logits2', [4])
        u = L.Uniform(lo, hi)
        n1, n2 = L.Normal(lo, hi), L.Normal(v, hi)
        c1, c2 = L.Categorical(logits), L.Categorical(logits2)
        loc = L.assign(np.array([0.5, -1.0], 'float32'))
        m1 = L.MultivariateNormalDiag(loc, L.assign(np.diag(
            [1.5, 0.5]).astype('float32')))
        m2 = L.MultivariateNormalDiag(L.assign(np.zeros(2, 'float32')),
                                      L.assign(np.eye(2, dtype='float32')))
        return [u.entropy(), u.log_prob(v), n1.entropy(), n1.log_prob(v),
                n1.kl_divergence(n2), c1.entropy(), c1.kl_divergence(c2),
                m1.entropy(), m1.kl_divergence(m2)]
    rng = np.random.RandomState(32)
    lo = rng.rand(5, 3).astype('float32')
    feeds = [{'lo': lo, 'hi': lo + 0.5 + rng.rand(5, 3).astype('float32'),
              'v': lo + 0.25, 'logits': _f((5, 4), 33),
              'logits2': _f((5, 4), 34)}]
    _both(build, feeds)

    def sample(fluid):
        L = fluid.layers
        return [L.Uniform(0.0, 2.0).sample([1000, 4]),
                L.Normal(1.0, 0.5).sample([1000, 4])]
    progs, _ = _both(sample, [], run=False)
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(progs['torch'][1])
        us, ns = exe.run(progs['torch'][0], fetch_list=progs['torch'][2])
    assert us.shape == ns.shape == (1000, 4)
    assert us.min() >= 0.0 and us.max() < 2.0 and abs(us.mean() - 1.0) < 0.05
    assert abs(ns.mean() - 1.0) < 0.05 and abs(ns.std() - 0.5) < 0.03
