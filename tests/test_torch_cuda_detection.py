"""The detection slice on the card (phase 22 of chip_smoke.py at small
sizes):

- the device op types of item 11b-C: each op's outputs and the
  gradients of its float inputs under seeded cotangents, launched twice
  (bitwise: no float atomics) and held against the same lowering on the
  CPU (integers exact, floats within 1e-5 of the largest magnitude);
- detection_output (softmax, box decode, the greedy NMS) replayed from
  a CUDA graph bitwise its eager run, its picks exactly the CPU's and
  its scores and boxes within 1e-5 of the largest magnitude;
- SSD-tiny (chip_smoke.ssd_build) trained 3 steps on CUDAPlace(0), the
  replayed steps bitwise an eager-only run, step 1's loss within 1e-5 of
  the CPU's from the same state;
- R-CNN-tiny (chip_smoke.rcnn_build) trained 3 steps twice from one
  start, bitwise, with K6 and K6b launched each step.

Marked `cuda`: every test skips where torch has no CUDA device.  Run on
a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_*.py

This file imports torch and the port only.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.ops.kernels import common

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    yield torch.device('cuda', 0)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _boxes(rng, n, h, w, lo, hi):
    bw, bh = rng.uniform(lo, hi, n), rng.uniform(lo, hi, n)
    x1, y1 = rng.uniform(0, 1, n) * (w - bw), rng.uniform(0, 1, n) * (h - bh)
    return np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype('float32')


def _cases():
    r = np.random.RandomState(0)
    f = lambda *s: r.randn(*s).astype('float32')  # noqa: E731
    batch = np.array([0, 1, 1, 0, 1, 0], 'int32')
    pooled = {'pooled_height': 3, 'pooled_width': 2, 'spatial_scale': 0.5}
    gt = np.zeros((2, 4, 4), 'float32')
    gt[:, :3, :2] = r.uniform(0.1, 0.9, (2, 3, 2))
    gt[:, :3, 2:] = r.uniform(0.1, 0.5, (2, 3, 2))
    deltas = f(1, 6, 4, 4, 5) * 0.2
    deltas[:, :, 2:] = 0.0
    anchors = np.tile(_boxes(r, 6, 64, 80, 8, 30), (4, 5, 1, 1))
    return [
        ('prior_box', {'Input': [f(1, 2, 4, 5)], 'Image': [f(1, 3, 40, 50)]},
         {'min_sizes': [8.0], 'max_sizes': [12.0], 'aspect_ratios': [2.0],
          'flip': True, 'clip': True}),
        ('box_coder', {'PriorBox': [_boxes(r, 6, 1, 1, 0.1, 0.5)],
                       'PriorBoxVar': [np.abs(f(6, 4)) + 0.1],
                       'TargetBox': [f(3, 6, 4) * 0.3]},
         {'code_type': 'decode_center_size'}),
        ('iou_similarity', {'X': [_boxes(r, 5, 20, 20, 1, 9)],
                            'Y': [_boxes(r, 7, 20, 20, 1, 9)]}, {}),
        ('yolo_box', {'X': [f(2, 27, 4, 5)],
                      'ImgSize': [np.full((2, 2), 128, 'int32')]},
         {'anchors': [10, 13, 16, 30, 33, 23], 'class_num': 4,
          'conf_thresh': 0.3, 'downsample_ratio': 32}),
        ('multiclass_nms', {'BBoxes': [np.stack(
            [_boxes(r, 30, 30, 30, 1, 9), _boxes(r, 30, 30, 30, 1, 9)])],
                            'Scores': [r.rand(2, 3, 30).astype('float32')]},
         {'score_threshold': 0.3, 'nms_top_k': 20, 'keep_top_k': 40,
          'nms_threshold': 0.4}),
        ('generate_proposals', {'Scores': [r.rand(1, 6, 4, 5).astype(
            'float32')], 'BboxDeltas': [deltas.reshape(1, 24, 4, 5)],
            'ImInfo': [np.array([[64, 80, 1.0]], 'float32')],
            'Anchors': [anchors], 'Variances': [np.ones_like(anchors)]},
         {'pre_nms_topN': 80, 'post_nms_topN': 60, 'nms_thresh': 0.5,
          'min_size': 2.0}),
        ('sigmoid_focal_loss', {'X': [f(6, 4)], 'Label': [r.randint(
            0, 5, (6, 1)).astype('int32')], 'FgNum': [np.array([3], 'int32')]},
         {}),
        ('yolov3_loss', {'X': [f(2, 16, 4, 4)], 'GTBox': [gt],
                         'GTLabel': [r.randint(0, 3, (2, 4)).astype('int32')]},
         {'anchors': [10, 13, 16, 30, 33, 23, 30, 61], 'anchor_mask': [1, 2],
          'class_num': 3, 'ignore_thresh': 0.5, 'downsample_ratio': 8}),
        ('ssd_loss', {'Location': [f(2, 12, 4) * 0.3],
                      'Confidence': [f(2, 12, 5)],
                      'GtBox': [np.stack([_boxes(r, 3, 1, 1, 0.1, 0.4)] * 2)],
                      'GtLabel': [r.randint(1, 5, (2, 3)).astype('int32')],
                      'PriorBox': [_boxes(r, 12, 1, 1, 0.1, 0.4)]},
         {'overlap_threshold': 0.3}),
        ('box_decoder_and_assign', {'PriorBox': [_boxes(r, 5, 30, 30, 2, 9)],
                                    'TargetBox': [f(5, 12) * 0.3],
                                    'BoxScore': [f(5, 3)]}, {}),
        ('roi_align', {'X': [f(2, 3, 8, 9)],
                       'ROIs': [_boxes(r, 6, 16, 18, 1, 12)],
                       'RoisBatch': [batch]},
         dict(pooled, sampling_ratio=0)),
        ('roi_pool', {'X': [f(2, 3, 8, 9)],
                      'ROIs': [_boxes(r, 6, 16, 18, 1, 12)],
                      'RoisBatch': [batch]}, pooled),
        ('psroi_pool', {'X': [f(2, 12, 8, 9)],
                        'ROIs': [_boxes(r, 6, 16, 18, 1, 12)],
                        'RoisBatch': [batch]},
         dict(pooled, output_channels=2)),
        ('prroi_pool', {'X': [f(2, 3, 8, 9)],
                        'ROIs': [_boxes(r, 6, 16, 18, 1, 12)],
                        'BatchRoINums': [batch]}, pooled),
        ('deformable_roi_pooling', {'X': [f(2, 3, 8, 9)],
                                    'ROIs': [_boxes(r, 6, 16, 18, 1, 12)],
                                    'RoisBatch': [batch],
                                    'Trans': [f(6, 2, 3, 2) * 0.1]},
         dict(pooled, trans_std=0.1)),
        ('anchor_generator', {'Input': [f(1, 2, 4, 5)]},
         {'anchor_sizes': [32.0, 64.0], 'aspect_ratios': [0.5, 1.0, 2.0],
          'stride': [16.0, 16.0]}),
        ('density_prior_box', {'Input': [f(1, 2, 4, 5)],
                               'Image': [f(1, 3, 40, 50)]},
         {'fixed_sizes': [8.0, 16.0], 'fixed_ratios': [1.0],
          'densities': [2, 1]}),
        ('box_clip', {'Input': [_boxes(r, 8, 40, 40, 1, 20) - 5],
                      'ImInfo': [np.array([[24.0, 30.0, 1.2]], 'float32')]},
         {}),
        ('polygon_box_transform', {'Input': [f(2, 8, 3, 4)]}, {}),
        ('target_assign', {'X': [f(2, 4, 3)], 'MatchIndices': [
            r.randint(-1, 4, (2, 7)).astype('int32')]}, {}),
    ]


def _run(op, ins, attrs, device):
    ctx = registry.LowerCtx(step=1, op_seed=0, device=device)
    opdef = registry.get(op)
    with torch.enable_grad():
        tins = {s: [torch.as_tensor(a, device=device) for a in v]
                for s, v in ins.items()}
        xs = [x.requires_grad_() for v in tins.values() for x in v
              if x.is_floating_point()]
        outs = opdef.run(ctx, tins, attrs)
        ys = [y for s, v in sorted(outs.items()) for y in v
              if s not in opdef.no_grad_out_slots and y.requires_grad]
        gen = np.random.RandomState(7)
        cts = [torch.as_tensor(gen.randn(*y.shape).astype('float32'),
                               device=device) for y in ys]
        grads = torch.autograd.grad(ys, xs, cts, allow_unused=True) \
            if ys and xs else []
    return [y.detach().cpu() for s in sorted(outs) for y in outs[s]] + \
        [g.cpu() for g in grads if g is not None]


def test_detection_ops_on_the_card_match_the_cpu(dev):
    for op, ins, attrs in _cases():
        first, second = _run(op, ins, attrs, dev), _run(op, ins, attrs, dev)
        want = _run(op, ins, attrs, 'cpu')
        assert len(first) == len(want), op
        for a, b, c in zip(first, second, want):
            assert torch.equal(a, b), op
            assert a.shape == c.shape and a.dtype == c.dtype, op
            if a.is_floating_point() and a.numel():
                err = (a - c).abs().max() / c.abs().max().clamp_min(1e-30)
                assert err <= TOL, (op, err.item())
            else:
                assert torch.equal(a, c), op


def test_detection_output_replays_from_a_cuda_graph(dev):
    cs = _chip_smoke()
    r = np.random.RandomState(1)
    prog = fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog,
                                                        fluid.Program()):
        L = fluid.layers
        vs = [L.data(n, s, append_batch_size=False) for n, s in (
            ('locs', [2, 40, 4]), ('confs', [2, 40, 5]), ('box', [40, 4]),
            ('var', [40, 4]))]
        det = cs.ssd_detect(fluid, *vs)
    feed = {'locs': r.randn(2, 40, 4).astype('float32') * 0.2,
            'confs': r.randn(2, 40, 5).astype('float32'),
            'box': _boxes(r, 40, 1, 1, 0.05, 0.5),
            'var': np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (40, 1))}
    scope, exe = fluid.Scope(), fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(scope):
        eager = cs.eager_run(exe, prog, feed, [det], return_numpy=False)[0]
        got = [exe.run(prog, feed=feed, fetch_list=[det],
                       return_numpy=False)[0].clone() for _ in range(3)]
        assert not cs.graph_refusals(prog, scope)
    for g in got:
        assert torch.equal(g, eager)
    cpu = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        want = cpu.run(prog, feed=feed, fetch_list=[det])[0]
    got = eager.cpu().numpy()
    # the picks exact; the softmaxed scores and the decoded boxes (exp)
    # within TOL of the largest magnitude
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_ssd_tiny_replays_bitwise_and_matches_the_cpu(dev):
    cs = _chip_smoke()
    cfg = dict(cs.MOBILENET_SSD, image=32, gts=1, first=4,
               blocks=((4, 8, 2), (8, 8, 1)), blocks2=((8, 16, 2),),
               extras=((8, 16),), min_sizes=[8.0, 14.0, 20.0],
               max_sizes=[[], 16.0, 26.0],
               aspect_ratios=[[2.0], [2.0, 3.0], [2.0, 3.0]],
               steps=[8, 16, 32])
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, _, _, _, loss = cs.ssd_build(fluid, cfg)
        fluid.optimizer.RMSProp(cs.SSD_LR).minimize(loss)
    feeds = cs.voc_ssd_batches(cfg, 4, 3)
    names = weights.startup_names(startup)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for eager in (False, True):
            exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
            with fluid.scope_guard(scope):
                exe.run(startup)
                if runs:
                    for n in names:
                        scope.set_var(n, runs[0]['start'][n].clone())
                start = {n: scope.find_var(n).clone() for n in names}
                out = [(cs.eager_run(exe, main, f, [loss],
                                     return_numpy=False) if eager else
                        exe.run(main, feed=f, fetch_list=[loss],
                                return_numpy=False))[0].clone()
                       for f in feeds]
                runs.append({'start': start, 'out': out, 'state': {
                    n: scope.find_var(n).clone() for n in names}})
    finally:
        torch.backends.cudnn.deterministic = saved
    for a, b in zip(runs[0]['out'], runs[1]['out']):
        assert torch.equal(a, b)
    for n in names:
        assert torch.equal(runs[0]['state'][n], runs[1]['state'][n]), n
    place = fluid.CPUPlace()
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(place)
        exe.run(startup)
        weights.load_numpy_params(fluid.global_scope(), {
            n: v.cpu().numpy() for n, v in runs[0]['start'].items()},
            place, startup)
        want = exe.run(main, feed=feeds[0], fetch_list=[loss])[0]
    got = float(runs[0]['out'][0])
    assert abs(got - float(want)) <= TOL * abs(float(want)), (got, want)


def test_rcnn_tiny_twice_bitwise_with_the_gather_kernels(dev):
    cs = _chip_smoke()
    cfg = dict(cs.RCNN, channels=8, map=(6, 8), image=(96, 128), gts=3,
               classes=5, anchor_sizes=[16.0, 32.0], pre_nms=60,
               post_nms=20, rpn_batch=16, rois=12, pool=2, rpn_channels=8)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, losses, _, _ = cs.rcnn_build(fluid, cfg)
        fluid.optimizer.Momentum(cs.RCNN_LR, 0.9).minimize(losses[0])
    feed = cs.rcnn_inputs(cfg, np.random.RandomState(4))
    names = weights.startup_names(startup)
    runs, start = [], None
    for _ in range(2):
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            if start is None:
                start = {n: scope.find_var(n).clone() for n in names}
            for n in names:
                scope.set_var(n, start[n].clone())
            steps = []
            for _ in range(3):
                common.reset_launches()
                out = exe.run(main, feed=feed, fetch_list=losses,
                              return_numpy=False)
                torch.cuda.synchronize()
                steps.append(([v.clone() for v in out],
                              common.launches('embedding_lookup'),
                              common.launches('embedding_scatter_add')))
            runs.append(steps)
    for (a, k6, k6b), (b, _, _) in zip(*runs):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert k6 >= 1 and k6b >= 1
        assert all(torch.isfinite(x).all() for x in a)
