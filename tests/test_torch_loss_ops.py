"""The losses and misc op types (ROADMAP Queue 1 item 11b-B: the JAX
package's ops/loss_ops.py and add_position_encoding,
continuous_value_model, hash, scatter_nd, similarity_focus and unique
of its ops/misc_ops.py) on the CPU against the JAX package's lowerings,
from the same numpy inputs (torch_attention_cases.check, the
cotangents drawn from a seed no input is drawn from).

Tolerances: f32 forward within rtol FWD = 1e-5 plus 1e-5 of the
output's largest magnitude, gradients within GRAD = 1e-4 of theirs;
bitwise for the integer results (hash, mean_iou's counts, shard_index,
unique and unique_with_counts) and the copies (multiplex,
pad_constant_like).  The draws of sampling_id and random_crop (the
port's counter hash, not jax threefry) are held by a chi-square over
their outcomes.  data_norm's statistics are the layer's parameters:
their gradients are held as any input's.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.ops import registry as jreg

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.ops import registry as treg

from torch_attention_cases import check, close
from torch_image_cases import run_jax, run_torch

FWD = 1e-5
GRAD = 1e-4
CT_SEED = 97  # the cotangents' seed
CHI2_999 = {15: 37.70, 18: 42.31}  # chi-square's 0.999 quantiles


def _x(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        'float32')


def _labels(shape, lo, hi, seed, dtype='int64'):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(dtype)


def test_ranking_losses():
    left, right = _x(8, 1, seed=1), _x(8, 1, seed=2)
    label01 = np.random.RandomState(3).rand(8, 1).astype('float32')
    check('rank_loss', {'Label': [label01], 'Left': [left],
                        'Right': [right]}, {}, FWD, GRAD, seed=CT_SEED)
    pm = np.where(label01 > 0.5, 1.0, -1.0).astype('float32')
    for margin in (0.0, 0.3):
        check('margin_rank_loss', {'Label': [pm], 'X1': [left],
                                   'X2': [right]}, {'margin': margin},
              FWD, GRAD, seed=CT_SEED)
    check('hinge_loss', {'Logits': [_x(8, 3, seed=4)],
                         'Labels': [(_x(8, 3, seed=5) > 0).astype(
                             'float32')]}, {}, FWD, GRAD, seed=CT_SEED)
    check('bpr_loss', {'X': [_x(6, 5, seed=6)],
                       'Label': [_labels((6, 1), 0, 5, 7)]}, {}, FWD, GRAD,
          seed=CT_SEED)


def test_huber_and_distillation_losses():
    x = _x(12, 1, seed=8, scale=2.0)
    y = (_x(12, 1, seed=9) > 0).astype('float32')
    check('modified_huber_loss', {'X': [x], 'Y': [y]}, {}, FWD, GRAD,
          seed=CT_SEED)
    label = np.array([-2.5, -1.5, -0.5, -0.25, 0.0, 0.3, 0.9, 1.0, 1.4,
                      1.99, -1.0, 0.5], 'float32').reshape(12, 1)
    check('teacher_student_sigmoid_loss', {'X': [x], 'Label': [label]}, {},
          FWD, GRAD, seed=CT_SEED)


@pytest.mark.parametrize('need_update,rate', [(True, None), (False, None),
                                              (True, 0.2)])
def test_center_loss(need_update, rate):
    ins = {'X': [_x(16, 4, seed=10)],
           'Label': [_labels((16, 1), 0, 5, 11)],   # repeated classes
           'Centers': [_x(6, 4, seed=12)]}
    if rate is not None:
        ins['CenterUpdateRate'] = [np.array([rate], 'float32')]
    check('center_loss', ins, {'alpha': 0.5, 'need_update': need_update},
          FWD, GRAD, seed=CT_SEED)


def test_cvm_and_continuous_value_model():
    """continuous_value_model is cvm under the layer's name; the port's
    op writes the layer's slot Out beside Y (the JAX op writes Y alone:
    ROADMAP Queue 3), so its Y is held to the JAX op's and Out is Y."""
    x = np.abs(_x(6, 7, seed=13)) * 5
    for use_cvm in (True, False):
        check('cvm', {'X': [x]}, {'use_cvm': use_cvm}, FWD, GRAD,
              seed=CT_SEED)
        ins = {'X': [x], 'CVM': [x[:, :2].copy()]}
        want = run_jax('continuous_value_model', ins, {'use_cvm': use_cvm})
        got = run_torch('continuous_value_model', ins, {'use_cvm': use_cvm})
        assert set(want) == {'Y'} and set(got) == {'Y', 'Out'}
        close(got['Y'][0], want['Y'][0], FWD)
        np.testing.assert_array_equal(got['Out'][0], got['Y'][0])
        np.testing.assert_array_equal(
            got['Y'][0], run_torch('cvm', ins, {'use_cvm': use_cvm})['Y'][0])


def test_fsp_l1_norm_bilinear_tensor_product():
    check('fsp', {'X': [_x(2, 3, 4, 5, seed=14)],
                  'Y': [_x(2, 6, 4, 5, seed=15)]}, {}, FWD, GRAD,
          seed=CT_SEED)
    check('l1_norm', {'X': [_x(5, 7, seed=16)]}, {}, FWD, GRAD,
          seed=CT_SEED)
    base = {'X': [_x(4, 3, seed=17)], 'Y': [_x(4, 5, seed=18)],
            'Weight': [_x(6, 3, 5, seed=19)]}
    check('bilinear_tensor_product', base, {}, FWD, GRAD, seed=CT_SEED)
    check('bilinear_tensor_product', dict(base, Bias=[_x(1, 6, seed=20)]),
          {}, FWD, GRAD, seed=CT_SEED)


def test_mean_iou_and_shard_index_exact():
    pred = _labels((4, 50), 0, 6, 21, 'int32')
    label = _labels((4, 50), 0, 6, 22, 'int32')
    label[0, :10] = pred[0, :10]
    for n in (6, 8):   # 8: two classes absent
        ins = {'Predictions': [pred], 'Labels': [label]}
        want = run_jax('mean_iou', ins, {'num_classes': n})
        got = run_torch('mean_iou', ins, {'num_classes': n})
        for s in ('OutWrong', 'OutCorrect'):
            assert got[s][0].dtype == np.int32
            np.testing.assert_array_equal(got[s][0], want[s][0])
        close(got['OutMeanIou'][0], want['OutMeanIou'][0], FWD)
    ids = _labels((7, 1), -3, 40, 23)
    for shard in (0, 2, 3):
        attrs = {'index_num': 40, 'nshards': 3, 'shard_id': shard,
                 'ignore_value': -1}
        np.testing.assert_array_equal(
            run_torch('shard_index', {'X': [ids]}, attrs)['Out'][0],
            run_jax('shard_index', {'X': [ids]}, attrs)['Out'][0])


def test_multiplex_and_pad_constant_like():
    xs = [_x(5, 3, seed=24 + k) for k in range(3)]
    check('multiplex', {'Ids': [_labels((5, 1), 0, 3, 27, 'int32')],
                        'X': xs}, {}, 0, 0, seed=CT_SEED)
    for value in (0.0, -1.5):
        check('pad_constant_like', {'X': [_x(4, 5, 6, seed=28)],
                                    'Y': [_x(2, 5, 3, seed=29)]},
              {'pad_value': value}, 0, 0, seed=CT_SEED)


def test_scatter_nd_add_and_scatter_nd():
    x = _x(5, 4, 3, seed=30)
    index = np.array([[1, 2], [4, 0], [1, 2], [0, 3], [1, 2]], 'int64')
    check('scatter_nd_add', {'X': [x], 'Index': [index],
                             'Updates': [_x(5, 3, seed=31)]}, {}, FWD, GRAD,
          seed=CT_SEED)
    rows = np.array([[3], [0], [3], [3]], 'int64')
    check('scatter_nd_add', {'X': [x], 'Index': [rows],
                             'Updates': [_x(4, 4, 3, seed=32)]}, {}, FWD,
          GRAD, seed=CT_SEED)
    check('scatter_nd', {'Index': [index], 'Updates': [_x(5, 3, seed=33)]},
          {'shape': [5, 4, 3]}, FWD, GRAD, seed=CT_SEED)


def test_spectral_norm():
    for dim, iters, shape in ((0, 1, (6, 4)), (1, 3, (3, 5, 2, 2)),
                              (0, 0, (4, 3, 3))):
        w = _x(*shape, seed=34)
        h = shape[dim]
        check('spectral_norm', {'Weight': [w], 'U': [_x(h, seed=35)],
                                'V': [_x(w.size // h, seed=36)]},
              {'dim': dim, 'power_iters': iters, 'eps': 1e-12}, FWD, GRAD,
              seed=CT_SEED)


def test_data_norm():
    x = _x(16, 5, seed=37, scale=3.0) + 1.0
    ins = {'X': [x], 'BatchSize': [np.full(5, 1e4, 'float32')],
           'BatchSum': [_x(5, seed=38) * 100],
           'BatchSquareSum': [np.full(5, 1e4, 'float32') +
                              np.abs(_x(5, seed=39)) * 1e3]}
    for eps in (1e-4, 1e-5):
        check('data_norm', ins, {'epsilon': eps}, FWD, GRAD, seed=CT_SEED)


def test_add_position_encoding_and_similarity_focus():
    for alpha, beta in ((1.0, 1.0), (0.5, 2.0)):
        check('add_position_encoding', {'X': [_x(2, 7, 8, seed=40)]},
              {'alpha': alpha, 'beta': beta}, FWD, GRAD, seed=CT_SEED)
    x = np.round(_x(2, 4, 5, 6, seed=41), 1)   # ties at the maxima
    for indexes in ([0], [1, 3]):
        check('similarity_focus', {'X': [x]}, {'axis': 1,
                                               'indexes': indexes},
              0, 0, seed=CT_SEED)


def test_hash_is_the_jax_mix_bit_for_bit():
    ids = np.random.RandomState(42).randint(-2 ** 31, 2 ** 31, (64, 3))
    ids[0] = [0, -1, 2 ** 31 - 1]
    for dtype in ('int32', 'int64'):
        for num_hash, mod_by in ((1, 1000001), (4, 97), (2, 2 ** 31 - 1)):
            attrs = {'num_hash': num_hash, 'mod_by': mod_by}
            ins = {'X': [ids.astype(dtype)]}
            want = run_jax('hash', ins, attrs)['Out'][0]
            got = run_torch('hash', ins, attrs)['Out'][0]
            assert got.dtype == np.int32 and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def _host_run(fluid, op_type, x, outs):
    main = fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main,
                                                        fluid.Program()):
        xv = fluid.layers.data('x', list(x.shape), dtype=str(x.dtype),
                               append_batch_size=False)
        res = getattr(fluid.layers, op_type)(xv)
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(fluid.CPUPlace())
        return [np.asarray(v) for v in exe.run(
            main, feed={'x': x}, fetch_list=list(res)[:outs])]


def test_unique_and_unique_with_counts_host_ops_exact():
    x = np.random.RandomState(43).randint(-5, 9, (40,)).astype('int64')
    for op, outs in (('unique', 2), ('unique_with_counts', 3)):
        want = _host_run(jfluid, op, x, outs)
        got = _host_run(tfluid, op, x, outs)
        assert len(got) == len(want) == outs
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert got[1].dtype == np.int32
    assert treg.get('unique').host and treg.get('unique_with_counts').host


def _chi2(counts, probs):
    want = probs * counts.sum()
    return float(((counts - want) ** 2 / want).sum())


def test_sampling_id_draws_by_chi_square():
    """20,000 rows of one unnormalized probability row: each column's
    count against its share (18 degrees of freedom over the 19 live
    columns); a zero column never
    drawn; another step draws anew, the same step the same."""
    p = np.random.RandomState(44).rand(20).astype('float32')
    p[4] = 0.0
    x = np.tile(p, (20000, 1))

    def draw(step):
        ctx = treg.LowerCtx(step=step, op_seed=5, device='cpu')
        return treg.get('sampling_id').run(
            ctx, {'X': [torch.from_numpy(x)]}, {'seed': 0})['Out'][0].numpy()
    got = draw(1)
    assert got.dtype == np.int64 and got.shape == (20000,)
    counts = np.bincount(got, minlength=20).astype('float64')
    assert counts[4] == 0
    live = np.arange(20) != 4
    assert _chi2(counts[live], p[live] / p[live].sum()) < CHI2_999[18]
    want = run_jax('sampling_id', {'X': [x]}, {})['Out'][0]
    jc = np.bincount(want, minlength=20).astype('float64')
    assert _chi2(jc[live], p[live] / p[live].sum()) < CHI2_999[18]
    np.testing.assert_array_equal(draw(1), got)
    assert not np.array_equal(draw(2), got)


def test_random_crop_windows_by_chi_square():
    """Each sample's window is a window of its own input; the starts of
    4,000 samples uniform over the 4 x 6 offsets (15 degrees of freedom
    of the 16 start pairs of a [7, 6] crop of [10, 9])."""
    n = 4000
    x = np.arange(n * 10 * 9, dtype='float32').reshape(n, 1, 10, 9)
    ctx = treg.LowerCtx(step=3, op_seed=2, device='cpu')
    out = treg.get('random_crop').run(ctx, {'X': [torch.from_numpy(x)]},
                                      {'shape': [7, 6]})
    got = out['Out'][0].numpy()
    assert got.shape == (n, 1, 7, 6) and out['SeedOut'][0].shape == (1,)
    start = got[:, 0, 0, 0] - x[:, 0, 0, 0]
    sy, sx = (start // 9).astype(int), (start % 9).astype(int)
    assert sy.min() >= 0 and sy.max() <= 3 and sx.min() >= 0 and \
        sx.max() <= 3
    for k in range(0, n, 397):
        np.testing.assert_array_equal(
            got[k, 0], x[k, 0, sy[k]:sy[k] + 7, sx[k]:sx[k] + 6])
    counts = np.bincount(sy * 4 + sx, minlength=16).astype('float64')
    assert _chi2(counts, np.full(16, 1 / 16.0)) < CHI2_999[15]
    want = run_jax('random_crop', {'X': [x]}, {'shape': [7, 6]})['Out'][0]
    assert want.shape == got.shape


def test_shape_inference_as_the_jax_package():
    cases = [
        ('rank_loss', {'Label': [((-1, 1), 'float32')],
                       'Left': [((-1, 1), 'float32')],
                       'Right': [((-1, 1), 'float32')]}, {}),
        ('bpr_loss', {'X': [((-1, 5), 'float32')],
                      'Label': [((-1, 1), 'int64')]}, {}),
        ('center_loss', {'X': [((-1, 4), 'float32')],
                         'Label': [((-1, 1), 'int64')],
                         'Centers': [((6, 4), 'float32')]},
         {'need_update': True}),
        ('cvm', {'X': [((-1, 12), 'float32')]}, {'use_cvm': True}),
        ('cvm', {'X': [((-1, 12), 'float32')]}, {'use_cvm': False}),
        ('fsp', {'X': [((-1, 3, 4, 5), 'float32')],
                 'Y': [((-1, 6, 4, 5), 'float32')]}, {}),
        ('bilinear_tensor_product', {'X': [((-1, 3), 'float32')],
                                     'Y': [((-1, 5), 'float32')],
                                     'Weight': [((6, 3, 5), 'float32')]},
         {}),
        ('data_norm', {'X': [((-1, 13), 'float32')],
                       'BatchSize': [((13,), 'float32')],
                       'BatchSum': [((13,), 'float32')],
                       'BatchSquareSum': [((13,), 'float32')]}, {}),
        ('hash', {'X': [((-1, 1), 'int64')]},
         {'num_hash': 4, 'mod_by': 100}),
        ('add_position_encoding', {'X': [((-1, 7, 8), 'float32')]}, {}),
        ('shard_index', {'X': [((-1, 1), 'int64')]},
         {'index_num': 40, 'nshards': 3, 'shard_id': 1}),
        ('spectral_norm', {'Weight': [((6, 4), 'float32')],
                           'U': [((6,), 'float32')],
                           'V': [((4,), 'float32')]}, {}),
        ('pad_constant_like', {'X': [((4, 5, 6), 'float32')],
                               'Y': [((2, 5, 3), 'float32')]}, {}),
        ('scatter_nd', {'Index': [((5, 2), 'int64')],
                        'Updates': [((5, 3), 'float32')]},
         {'shape': [5, 4, 3]}),
    ]
    for op, specs, attrs in cases:
        want = jreg.infer_shapes(op, specs, attrs)
        got = treg.infer_shapes(op, specs, attrs)
        assert got.keys() == want.keys(), op
        for s in want:
            assert [tuple(sh) for sh, _ in got[s]] == \
                [tuple(sh) for sh, _ in want[s]], (op, s)
