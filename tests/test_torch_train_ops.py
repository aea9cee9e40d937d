"""The port's lowerings that BERT pretraining adds, on the CPU: the
hidden `dropout` op (held to statistics: it draws from a
torch.Generator, the JAX package from jax threefry), and
softmax_with_cross_entropy, mean and slice against the JAX package's
lowerings, forward and through the synthesized grad op (the registry's
<type>_grad, torch.autograd over the forward lowering), at rtol 1e-5 /
atol 1e-6: f32 on both sides, log-sum-exp and means summed in another
order.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from paddle_tpu.ops import registry as jregistry

import torch

from paddle_tpu_torch.ops import registry as tregistry

TOL = dict(rtol=1e-5, atol=1e-6)


def _ctx(step=1, op_seed=5, random_seed=3):
    return tregistry.LowerCtx(step, op_seed, random_seed=random_seed)


def _dropout(x, ctx, **attrs):
    a = {'dropout_prob': 0.1, 'dropout_implementation': 'upscale_in_train'}
    a.update(attrs)
    return tregistry.get('dropout').run(ctx, {'X': [x]}, a)


def test_dropout_keep_rate_and_upscale():
    x = torch.ones(400, 500)
    out = _dropout(x, _ctx())
    kept = out['Mask'][0].mean().item()
    # 200000 draws: the keep rate's standard deviation is 6.7e-4
    assert abs(kept - 0.9) < 0.004
    vals = out['Out'][0].unique()
    assert vals.tolist() == [0.0, pytest.approx(1 / 0.9)]
    assert torch.equal(out['Out'][0] == 0, out['Mask'][0] == 0)
    # the expectation is kept: upscale_in_train divides by 1 - p
    assert abs(out['Out'][0].mean().item() - 1.0) < 0.005


def test_dropout_keep_rate_is_the_jax_ops():
    """Both packages keep 1 - p of the elements (different bits)."""
    x = np.ones((400, 500), 'float32')
    attrs = {'dropout_prob': 0.25, 'is_test': False,
             'dropout_implementation': 'upscale_in_train'}
    want = jregistry.get('dropout').run(jregistry.LowerCtx(1, 5),
                                        {'X': [jnp.asarray(x)]}, attrs)
    got = _dropout(torch.from_numpy(x), _ctx(), dropout_prob=0.25)
    jkeep = float(np.asarray(want['Mask'][0]).mean())
    tkeep = got['Mask'][0].mean().item()
    assert abs(jkeep - 0.75) < 0.005 and abs(tkeep - 0.75) < 0.005
    np.testing.assert_allclose(
        sorted(set(np.asarray(want['Out'][0]).ravel().tolist())),
        sorted(set(got['Out'][0].numpy().ravel().tolist())), rtol=1e-7)


def test_dropout_mask_is_keyed_on_seed_op_and_step():
    x = torch.ones(64, 64)
    a = _dropout(x, _ctx())['Mask'][0]
    assert torch.equal(a, _dropout(x, _ctx())['Mask'][0])
    for other in (_ctx(step=2), _ctx(op_seed=6), _ctx(random_seed=4)):
        assert not torch.equal(a, _dropout(x, other)['Mask'][0])


def test_dropout_in_test_mode_and_downgrade_in_infer():
    x = torch.randn(8, 8)
    out = _dropout(x, _ctx(), is_test=True)
    assert torch.equal(out['Out'][0], x)
    out = _dropout(x, _ctx(), is_test=True,
                   dropout_implementation='downgrade_in_infer')
    torch.testing.assert_close(out['Out'][0], x * 0.9)
    out = _dropout(x, _ctx(), dropout_implementation='downgrade_in_infer')
    torch.testing.assert_close(out['Out'][0], x * out['Mask'][0])


def test_dropout_grad_op_replays_the_mask():
    x = torch.randn(32, 16)
    g = torch.randn(32, 16)
    mask = _dropout(x, _ctx())['Mask'][0]
    grads = tregistry.get('dropout_grad').run(
        _ctx(), {'X': [x], 'GRAD::Out': [g]},
        {'dropout_prob': 0.1, 'dropout_implementation': 'upscale_in_train'})
    torch.testing.assert_close(grads['GRAD::X'][0], g * mask / 0.9)


def _swce_case(kind):
    rng = np.random.RandomState(0)
    if kind == 'mlm':
        logits = rng.randn(2, 6, 11).astype('float32') * 3
        label = rng.randint(0, 11, (2, 6, 1)).astype('int64')
        label[0, :3, 0] = -1
        return logits, label, {'ignore_index': -1, 'axis': -1,
                               'soft_label': False}
    logits = rng.randn(5, 2).astype('float32')
    label = rng.randint(0, 2, (5, 1)).astype('int64')
    return logits, label, {'ignore_index': -100, 'axis': -1,
                           'soft_label': False}


@pytest.mark.parametrize('kind', ['mlm', 'nsp'])
def test_softmax_with_cross_entropy_matches_jax(kind):
    logits, label, attrs = _swce_case(kind)
    want = jregistry.get('softmax_with_cross_entropy').run(
        jregistry.LowerCtx(1), {'Logits': [jnp.asarray(logits)],
                                'Label': [jnp.asarray(label)]}, attrs)
    got = tregistry.get('softmax_with_cross_entropy').run(
        _ctx(), {'Logits': [torch.from_numpy(logits)],
                 'Label': [torch.from_numpy(label)]}, attrs)
    for slot in ('Loss', 'Softmax'):
        np.testing.assert_allclose(got[slot][0].numpy(),
                                   np.asarray(want[slot][0]), err_msg=slot,
                                   **TOL)
    if kind == 'mlm':
        assert np.all(got['Loss'][0].numpy()[0, :3] == 0.0)


@pytest.mark.parametrize('kind', ['mlm', 'nsp'])
def test_softmax_with_cross_entropy_grad_matches_jax(kind):
    logits, label, attrs = _swce_case(kind)
    g = np.random.RandomState(1).randn(*label.shape).astype('float32')
    want = jregistry.get('softmax_with_cross_entropy_grad').run(
        jregistry.LowerCtx(1),
        {'Logits': [jnp.asarray(logits)], 'Label': [jnp.asarray(label)],
         'GRAD::Loss': [jnp.asarray(g)]}, attrs)
    got = tregistry.get('softmax_with_cross_entropy_grad').run(
        _ctx(), {'Logits': [torch.from_numpy(logits)],
                 'Label': [torch.from_numpy(label)],
                 'GRAD::Loss': [torch.from_numpy(g)]}, attrs)
    np.testing.assert_allclose(got['GRAD::Logits'][0].numpy(),
                               np.asarray(want['GRAD::Logits'][0]), **TOL)
    # integer labels get a zero cotangent, as in the JAX package
    assert not got['GRAD::Label'][0].any()


@pytest.mark.parametrize('axes,starts,ends', [([1], [0], [1]),
                                              ([0, 2], [1, -3], [3, 100]),
                                              ([2], [-2], [-1])])
def test_slice_and_its_grad_match_jax(axes, starts, ends):
    x = np.random.RandomState(2).randn(4, 5, 6).astype('float32')
    attrs = {'axes': axes, 'starts': starts, 'ends': ends,
             'decrease_axis': []}
    want = jregistry.get('slice').run(jregistry.LowerCtx(1),
                                      {'Input': [jnp.asarray(x)]}, attrs)
    got = tregistry.get('slice').run(_ctx(), {'Input': [torch.from_numpy(x)]},
                                     attrs)
    np.testing.assert_array_equal(got['Out'][0].numpy(),
                                  np.asarray(want['Out'][0]))
    g = np.ones(got['Out'][0].shape, 'float32')
    dx = tregistry.get('slice_grad').run(
        _ctx(), {'Input': [torch.from_numpy(x)],
                 'GRAD::Out': [torch.from_numpy(g)]}, attrs)
    jdx = jregistry.get('slice_grad').run(
        jregistry.LowerCtx(1), {'Input': [jnp.asarray(x)],
                                'GRAD::Out': [jnp.asarray(g)]}, attrs)
    np.testing.assert_array_equal(dx['GRAD::Input'][0].numpy(),
                                  np.asarray(jdx['GRAD::Input'][0]))


def test_mean_and_sum_match_jax():
    xs = [np.random.RandomState(i).randn(3, 7).astype('float32')
          for i in range(3)]
    for op, ins in (('mean', {'X': xs[:1]}), ('sum', {'X': xs})):
        want = jregistry.get(op).run(
            jregistry.LowerCtx(1),
            {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}, {})
        got = tregistry.get(op).run(
            _ctx(), {k: [torch.from_numpy(a) for a in v]
                     for k, v in ins.items()}, {})
        assert tuple(got['Out'][0].shape) == tuple(want['Out'][0].shape)
        np.testing.assert_allclose(got['Out'][0].numpy(),
                                   np.asarray(want['Out'][0]), **TOL)


def test_grad_op_convention():
    """A synthesized grad op returns GRAD::<slot> for every input slot,
    zeros where an input gets no gradient."""
    assert tregistry.is_registered('layer_norm_grad')
    assert not tregistry.is_registered('no_such_op_grad')
    x = torch.randn(4, 6)
    scale = torch.ones(6)
    out = tregistry.get('layer_norm_grad').run(
        _ctx(), {'X': [x], 'Scale': [scale],
                 'GRAD::Y': [torch.ones(4, 6)]}, {'begin_norm_axis': 1})
    assert set(out) == {'GRAD::X', 'GRAD::Scale'}
    assert out['GRAD::X'][0].shape == x.shape
    out = tregistry.get('elementwise_add_grad').run(
        _ctx(), {'X': [x], 'Y': [scale]}, {'axis': -1})
    assert not out['GRAD::X'][0].any() and not out['GRAD::Y'][0].any()


def test_meta_shape_inference_of_the_new_ops():
    specs = tregistry.infer_shapes(
        'softmax_with_cross_entropy',
        {'Logits': [((-1, 512, 30522), 'float32')],
         'Label': [((-1, 512, 1), 'int64')]}, {'ignore_index': -1})
    assert specs['Loss'][0] == ((-1, 512, 1), torch.float32)
    specs = tregistry.infer_shapes('dropout', {'X': [((-1, 8), 'float32')]},
                                   {'dropout_prob': 0.1})
    assert specs['Out'][0][0] == (-1, 8) and specs['Mask'][0][0] == (-1, 8)
    specs = tregistry.infer_shapes('mean', {'X': [((-1, 8), 'float32')]}, {})
    assert specs['Out'][0][0] == ()
