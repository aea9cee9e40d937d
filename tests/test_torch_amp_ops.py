"""The port's mixed-precision ops against the JAX package's, on the CPU:
check_finite_and_unscale and update_loss_scaling (the dynamic
loss-scaling state machine), square_error_cost, and the AMP marks'
lowerings (bf16 products and convolutions, the f32 loss of
softmax_with_cross_entropy, the gray and black casts of OpDef.run).

Inputs come from a seed with numpy.  Tolerances: the loss-scaling ops
exact (IEEE division and comparisons on both sides); square_error_cost
exact forward and gradient; a bf16 product or convolution within one
bf16 rounding (rtol 2^-8 plus 2^-8 of the largest magnitude: both
accumulate in f32, in other orders, and round once to bf16); an f32
loss from bf16 logits within rel 1e-6 (both in f32 from the same bf16
values).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from paddle_tpu.ops import registry as jreg

import torch

from paddle_tpu_torch.ops import registry as treg

from torch_attention_cases import check

R = np.random.RandomState(0)
BF16_TOL = 2.0 ** -8


def _f(*shape):
    return R.randn(*shape).astype('float32')


def _jax_in(a, bf16=False):
    x = jnp.asarray(a)
    return x.astype(jnp.bfloat16) if bf16 else x


def _torch_in(a, bf16=False):
    x = torch.from_numpy(np.ascontiguousarray(a))
    return x.to(torch.bfloat16) if bf16 else x


def _np(x):
    """numpy of a JAX or torch array, bf16 widened to f32 (exact)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    if x.dtype == jnp.bfloat16:
        x = x.astype(jnp.float32)
    return np.asarray(x)


def run_both(op, ins, attrs, bf16=()):
    """(JAX outputs, port outputs, port dtypes) of `op`; the slots in
    `bf16` are fed as bf16."""
    jctx = jreg.LowerCtx(step=0, op_seed=0, prefer_test=True)
    jout = jreg.get(op).run(jctx, {s: [_jax_in(a, s in bf16) for a in v]
                                   for s, v in ins.items()}, attrs)
    tctx = treg.LowerCtx(step=0, op_seed=0, prefer_test=True, device='cpu')
    tout = treg.get(op).run(tctx, {s: [_torch_in(a, s in bf16) for a in v]
                                   for s, v in ins.items()}, attrs)
    assert jout.keys() == tout.keys()
    dtypes = {s: [x.dtype for x in v] for s, v in tout.items()}
    jd = {s: [str(x.dtype) for x in v] for s, v in jout.items()}
    assert {s: [str(d).replace('torch.', '') for d in v]
            for s, v in dtypes.items()} == jd
    return ({s: [_np(x) for x in v] for s, v in jout.items()},
            {s: [_np(x) for x in v] for s, v in tout.items()}, dtypes)


def _grads(bad):
    gs = [_f(3, 4) * 1e3, _f(17), _f(2, 2, 5) * 1e-3]
    if bad is not None:
        gs[1][11] = float(bad)
    return gs


@pytest.mark.parametrize('bad', [None, 'inf', '-inf', 'nan'])
def test_check_finite_and_unscale_matches_jax(bad):
    """Out and FoundInfinite bitwise, at a power-of-two scale and at 3:
    X / scale where every gradient is finite, zeros everywhere where
    one element of one is not."""
    for scale in (1024.0, 3.0):
        ins = {'X': _grads(bad), 'Scale': [np.array([scale], 'float32')]}
        want, got, dtypes = run_both('check_finite_and_unscale', ins, {})
        assert bool(got['FoundInfinite'][0]) == (bad is not None)
        assert dtypes['FoundInfinite'] == [torch.bool]
        for s in want:
            for g, w in zip(got[s], want[s]):
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('flags,attrs', [
    # three good steps grow the scale, two bad ones halve it
    ([0, 0, 0, 0, 1, 1, 0, 0, 0, 1, 0, 1, 1],
     {'incr_every_n_steps': 3, 'decr_every_n_nan_or_inf': 2,
      'incr_ratio': 2.0, 'decr_ratio': 0.5}),
    # every bad step shrinks by 0.25 down to the min clamp
    ([1] * 8 + [0, 1],
     {'incr_every_n_steps': 1000, 'decr_every_n_nan_or_inf': 1,
      'incr_ratio': 2.0, 'decr_ratio': 0.25, 'min_loss_scaling': 0.5}),
    # the defaults (1000 / 2), the default min clamp of 1
    ([1] * 30, {}),
    # growth by 3 every good step, a bad step between
    ([0, 0, 1, 0, 0], {'incr_every_n_steps': 1, 'incr_ratio': 3.0,
                       'decr_every_n_nan_or_inf': 1, 'decr_ratio': 0.5}),
], ids=['both_thresholds', 'min_clamp', 'defaults', 'every_step'])
def test_update_loss_scaling_state_machine_matches_jax(flags, attrs):
    """The scale and both counters after every step, bitwise, each
    step from the port's own state (which equals the JAX package's)."""
    state = {'PrevLossScaling': [np.array([8.0], 'float32')],
             'InGoodSteps': [np.array([0], 'int32')],
             'InBadSteps': [np.array([0], 'int32')]}
    scales = []
    for f in flags:
        ins = dict(state, FoundInfinite=[np.array(bool(f))])
        want, got, dtypes = run_both('update_loss_scaling', ins, attrs)
        assert dtypes == {'LossScaling': [torch.float32],
                          'OutGoodSteps': [torch.int32],
                          'OutBadSteps': [torch.int32]}
        for s in want:
            np.testing.assert_array_equal(got[s][0], want[s][0])
            assert got[s][0].shape == (1,)
        state = {'PrevLossScaling': got['LossScaling'],
                 'InGoodSteps': got['OutGoodSteps'],
                 'InBadSteps': got['OutBadSteps']}
        scales.append(float(got['LossScaling'][0][0]))
    assert min(scales) >= attrs.get('min_loss_scaling', 1.0)
    assert len(set(scales)) > 1


@pytest.mark.parametrize('shape', [(6, 1), (3, 4, 5)])
def test_square_error_cost_matches_jax(shape):
    """(X - Y)^2 and its gradients, bitwise."""
    check('square_error_cost', {'X': [_f(*shape)], 'Y': [_f(*shape)]}, {},
          0)


def test_square_error_cost_layer_builds_the_op():
    import paddle_tpu_torch.fluid as tfluid
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data('x', shape=[3], dtype='float32')
        y = tfluid.layers.data('y', shape=[3], dtype='float32')
        out = tfluid.layers.square_error_cost(x, y)
    op = main.global_block().ops[-1]
    assert op.type == 'square_error_cost' and out.shape == (-1, 3)
    assert op.input('X') == [x.name] and op.input('Y') == [y.name]


def _close_bf16(got, want):
    np.testing.assert_allclose(got, want, rtol=BF16_TOL,
                               atol=BF16_TOL * float(np.abs(want).max()))


@pytest.mark.parametrize('op,ins,attrs,bf16', [
    ('mul', {'X': [_f(2, 5, 12)], 'Y': [_f(12, 7)]},
     {'x_num_col_dims': 2, '__amp__': True}, ()),
    ('mul', {'X': [_f(6, 40)], 'Y': [_f(40, 3)]}, {'__amp__': True},
     ('X',)),
    ('matmul', {'X': [_f(2, 3, 9, 8)], 'Y': [_f(2, 3, 9, 8)]},
     {'transpose_Y': True, 'alpha': 0.125, '__amp__': True}, ()),
    ('matmul_v2', {'X': [_f(4, 16)], 'Y': [_f(16, 5)]},
     {'trans_x': False, '__amp__': True}, ()),
    ('conv2d', {'Input': [_f(2, 3, 9, 9)], 'Filter': [_f(4, 3, 3, 3)]},
     {'strides': [2, 2], 'paddings': [1, 1], '__amp__': True}, ()),
    ('conv2d', {'Input': [_f(2, 8, 8, 3)], 'Filter': [_f(5, 3, 3, 3)]},
     {'data_format': 'NHWC', 'padding_algorithm': 'SAME',
      '__amp__': True}, ('Input',)),
], ids=['mul_f32_in', 'mul_bf16_in', 'matmul', 'matmul_v2', 'conv_nchw',
        'conv_nhwc'])
def test_white_ops_run_in_bf16_like_jax(op, ins, attrs, bf16):
    """A white op takes bf16 operands (f32 inputs cast down) and gives a
    bf16 output, within one bf16 rounding of the JAX package's."""
    want, got, dtypes = run_both(op, ins, attrs, bf16)
    out = 'Output' if op == 'conv2d' else 'Out'
    assert dtypes[out] == [torch.bfloat16]
    _close_bf16(got[out][0], want[out][0])


@pytest.mark.parametrize('mark,softmax', [
    ('__amp_black_out__', torch.bfloat16), ('__amp_black__', torch.float32)])
def test_swce_loss_is_f32_under_the_black_rule(mark, softmax):
    """bf16 logits: Loss in f32 (taken before any rounding) as the JAX
    package gives it; Softmax in bf16 under the exemption's
    __amp_black_out__ (the mark decorate gives the op), in f32 under
    __amp_black__ (its input cast up); without a mark both bf16."""
    ins = {'Logits': [_f(6, 11)],
           'Label': [R.randint(0, 11, (6, 1)).astype('int64')]}
    want, got, dtypes = run_both('softmax_with_cross_entropy', ins,
                                 {mark: True}, ('Logits',))
    assert dtypes == {'Softmax': [softmax], 'Loss': [torch.float32]}
    np.testing.assert_allclose(got['Loss'][0], want['Loss'][0], rtol=1e-6)
    _close_bf16(got['Softmax'][0], want['Softmax'][0])
    _, _, plain = run_both('softmax_with_cross_entropy', ins, {},
                           ('Logits',))
    assert plain['Loss'] == [torch.bfloat16]


def test_gray_and_black_casts_of_opdef_run():
    """A gray op casts its f32 inputs down to a bf16 input's dtype (the
    bias add stays bf16), a black op casts bf16 inputs up to f32, and a
    grad op replays its forward with the casts inside autograd, so the
    f32 bias's gradient comes back f32."""
    x, b = _f(4, 6), _f(6)
    want, got, dtypes = run_both('elementwise_add', {'X': [x], 'Y': [b]},
                                 {'axis': -1, '__amp_gray__': True}, ('X',))
    assert dtypes['Out'] == [torch.bfloat16]
    np.testing.assert_array_equal(got['Out'][0], want['Out'][0])
    want, got, dtypes = run_both('mean', {'X': [x]},
                                 {'__amp_black__': True}, ('X',))
    assert dtypes['Out'] == [torch.float32]
    np.testing.assert_allclose(got['Out'][0], want['Out'][0], rtol=1e-6)
    ctx = treg.LowerCtx(step=0, device='cpu')
    grads = treg.get('elementwise_add_grad').run(
        ctx, {'X': [_torch_in(x, True)], 'Y': [_torch_in(b)],
              'GRAD::Out': [torch.ones(4, 6, dtype=torch.bfloat16)]},
        {'axis': -1, '__amp_gray__': True})
    assert grads['GRAD::X'][0].dtype == torch.bfloat16
    assert grads['GRAD::Y'][0].dtype == torch.float32
    np.testing.assert_array_equal(grads['GRAD::Y'][0].numpy(),
                                  np.full(6, 4.0, 'float32'))
