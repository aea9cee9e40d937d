"""The detection host ops of item 11b-C (the JAX package's
ops/detection_host_ops.py and bipartite_match of ops/vision_ops.py)
through one-op programs in both packages on the CPU: the same program
(same_program), the same numpy feeds, every output bitwise the JAX
package's (the port keeps its numpy code: the RandomState(seed)
permutations, the unstable argsorts and bipartite_match's Python
loops), integer outputs by value (the JAX package narrows int64 to
int32).
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.fluid as tfluid

from torch_program_cases import same_program


def _program(fluid, op, ins, attrs, outs):
    """A program of one `op`: a data variable for each input array, the
    output slots `outs` ({slot: count})."""
    main = fluid.Program()
    main.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main,
                                                        fluid.Program()):
        block = main.global_block()
        inputs = {slot: [fluid.layers.data(
            '%s_%d' % (slot.lower(), i), list(a.shape), dtype=str(a.dtype),
            append_batch_size=False) for i, a in enumerate(vals)]
            for slot, vals in sorted(ins.items())}
        outputs = {slot: [block.create_var(
            name='%s_out_%d' % (slot.lower(), i), dtype='float32')
            for i in range(n)] for slot, n in sorted(outs.items())}
        block.append_op(type=op, inputs=inputs, outputs=outputs,
                        attrs=dict(attrs))
    return main, [v.name for s in sorted(outputs) for v in outputs[s]]


def _run_both(op, ins, attrs, outs):
    feed = {'%s_%d' % (slot.lower(), i): a for slot, vals in ins.items()
            for i, a in enumerate(vals)}
    got = {}
    for key, fluid in (('jax', jfluid), ('torch', tfluid)):
        main, fetch = _program(fluid, op, ins, attrs, outs)
        got[key + '_program'] = main
        with fluid.scope_guard(fluid.Scope()):
            exe = fluid.Executor(fluid.CPUPlace())
            got[key] = [np.asarray(v) for v in exe.run(
                main, feed=feed, fetch_list=fetch)]
    same_program(got['jax_program'], got['torch_program'])
    assert len(got['jax']) == len(got['torch'])
    for w, g in zip(got['jax'], got['torch']):
        assert w.shape == g.shape, (w.shape, g.shape)
        if np.issubdtype(w.dtype, np.integer):
            assert np.issubdtype(g.dtype, np.integer)
            np.testing.assert_array_equal(g, w)
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    return got['torch']


def _boxes(n, seed, h=96.0, w=128.0, side=(4.0, 40.0)):
    rng = np.random.RandomState(seed)
    bw, bh = rng.uniform(*side, n), rng.uniform(*side, n)
    x1, y1 = rng.uniform(0, 1, n) * (w - bw), rng.uniform(0, 1, n) * (h - bh)
    return np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype('float32')


def _anchors(seed):
    rng = np.random.RandomState(seed)
    cx, cy = np.meshgrid(np.arange(8) * 16 + 8.0, np.arange(6) * 16 + 8.0)
    out = []
    for s in (16.0, 32.0, 48.0):
        half = s / 2 + rng.uniform(-1, 1, cx.shape)
        out.append(np.stack([cx - half, cy - half, cx + half, cy + half], -1))
    return np.stack(out, 2).astype('float32')            # [6, 8, 3, 4]


ASSIGN_OUTS = {'LocationIndex': 1, 'ScoreIndex': 1, 'TargetLabel': 1,
               'TargetBBox': 1, 'BBoxInsideWeight': 1}


@pytest.mark.parametrize('op,attrs', [
    ('rpn_target_assign', {'rpn_batch_size_per_im': 32,
                           'rpn_fg_fraction': 0.5, 'seed': 3}),
    ('rpn_target_assign', {'rpn_batch_size_per_im': 256,
                           'rpn_positive_overlap': 0.5,
                           'rpn_negative_overlap': 0.2}),
    ('retinanet_target_assign', {'rpn_positive_overlap': 0.5,
                                 'rpn_negative_overlap': 0.4, 'seed': 1}),
])
def test_target_assigns(op, attrs):
    """Anchors and gt boxes flattened over the batch; 32 a batch cuts
    the foreground and the background, 256 keeps every candidate."""
    gts = _boxes(6, 4).reshape(2, 3, 4)
    out = _run_both(op, {'Anchor': [_anchors(5)], 'GtBoxes': [gts]}, attrs,
                    ASSIGN_OUTS)
    # outputs by slot name: BBoxInsideWeight, LocationIndex, ScoreIndex,
    # TargetBBox, TargetLabel
    loc, score, label = out[1], out[2], out[4]
    assert len(loc) > 0 and len(score) > len(loc)
    np.testing.assert_array_equal(label[:len(loc), 0], 1)


@pytest.mark.parametrize('seed,batch', [(0, 16), (7, 64)])
def test_generate_proposal_labels(seed, batch):
    rois = np.concatenate([_boxes(40, 8), np.zeros((5, 4), 'float32')])
    gts = _boxes(3, 9, side=(20.0, 40.0))
    out = _run_both('generate_proposal_labels',
                    {'RpnRois': [rois[None]], 'GtClasses': [
                        np.array([[3], [1], [7]], 'int32')],
                     'GtBoxes': [gts]},
                    {'batch_size_per_im': batch, 'fg_fraction': 0.25,
                     'fg_thresh': 0.5, 'bg_thresh_hi': 0.5,
                     'bg_thresh_lo': 0.0, 'seed': seed},
                    {'Rois': 1, 'LabelsInt32': 1, 'BboxTargets': 1,
                     'BboxInsideWeights': 1, 'BboxOutsideWeights': 1})
    labels = out[3]                       # LabelsInt32
    assert labels.shape[1] == 1 and (labels > 0).sum() >= 3


def test_generate_mask_labels():
    _run_both('generate_mask_labels', {'Rois': [_boxes(5, 10)]},
              {'resolution': 7},
              {'MaskRois': 1, 'RoiHasMaskInt32': 1, 'MaskInt32': 1})


def test_distribute_and_collect_fpn_proposals():
    rois = _boxes(60, 11, h=800.0, w=1333.0, side=(8.0, 700.0))
    out = _run_both('distribute_fpn_proposals', {'FpnRois': [rois]},
                    {'min_level': 2, 'max_level': 5, 'refer_level': 4,
                     'refer_scale': 224},
                    {'MultiFpnRois': 4, 'RestoreIndex': 1})
    assert sum(len(v) for v in out[:4]) == 60
    np.testing.assert_array_equal(np.concatenate(out[:4])[out[4][:, 0]],
                                  rois)
    rng = np.random.RandomState(12)
    scores = [rng.rand(len(v), 1).astype('float32') for v in out[:4]]
    scores[1][:3] = scores[0][:1]              # ties between levels
    _run_both('collect_fpn_proposals',
              {'MultiLevelRois': list(out[:4]), 'MultiLevelScores': scores},
              {'post_nms_topN': 25}, {'FpnRois': 1})


def test_locality_aware_nms():
    rng = np.random.RandomState(13)
    quads = rng.uniform(0, 100, (1, 30, 8)).astype('float32')
    scores = rng.rand(1, 1, 30).astype('float32')
    scores[0, 0, 5] = scores[0, 0, 9]          # a tie
    for keep in (10, -1):
        _run_both('locality_aware_nms', {'BBoxes': [quads],
                                         'Scores': [scores]},
                  {'nms_threshold': 0.3, 'keep_top_k': keep}, {'Out': 1})


def test_roi_perspective_transform():
    rng = np.random.RandomState(14)
    b = _boxes(6, 15, h=20.0, w=24.0, side=(2.0, 12.0))
    quads = np.stack([b[:, 0], b[:, 1], b[:, 2], b[:, 1], b[:, 2], b[:, 3],
                      b[:, 0], b[:, 3]], 1)
    quads[5] = [30, 30, 40, 30, 40, 40, 30, 40]    # outside: zeros
    out = _run_both('roi_perspective_transform',
                    {'X': [rng.randn(1, 3, 20, 24).astype('float32')],
                     'ROIs': [quads]},
                    {'transformed_height': 4, 'transformed_width': 6,
                     'spatial_scale': 1.0}, {'Out': 1})
    assert (out[0][5] == 0).all() and (out[0][:5] != 0).any()


@pytest.mark.parametrize('match_type', ['bipartite', 'per_prediction'])
def test_bipartite_match(match_type):
    dist = np.random.RandomState(16).rand(4, 9).astype('float32')
    dist[1, 3] = dist[2, 3] = 0.99               # a tie for one column
    out = _run_both('bipartite_match', {'DistMat': [dist]},
                    {'match_type': match_type, 'dist_threshold': 0.6},
                    {'ColToRowMatchIndices': 1, 'ColToRowMatchDist': 1})
    assert (out[0] >= 0).sum() >= 4
