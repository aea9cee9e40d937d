"""The slice's two card programs cut to a few layers and narrow widths,
built by chip_smoke.py's own ssd_build and rcnn_build in the port and
passed to the JAX package through Program.to_dict / from_dict (the JAX
package's multi_box_head and its host-op layers cannot build them:
tests/test_torch_detection_layers.py), then trained in lockstep on the
CPU: each of 3 steps from the JAX package's state (its startup program
run from the dict), the losses, the gradients of every trainable
parameter and every parameter after the step (batch norm's moving
statistics included) compared.

SSD-tiny: MobileNet-SSD's structure on 32 x 32 images (a conv_bn, three
separable blocks, one extra block), multi_box_head over 8^2, 4^2 and
2^2 maps (312 priors), VOC's 21 classes, the summed ssd_loss, RMSProp with
L2Decay, batches of the VOC2012 stand-in, from batch norm scales and
shifts drawn around 1 and 0 (at shift 0 the gradient of a scale whose
relu output feeds another batch norm is 0 but for rounding: the next
batch norm removes the scale); then the for_test clone's
detection_output.  R-CNN-tiny: the RPN and RoI head on an 8-channel 6 x
8 map of a 96 x 128 image, 3 gt boxes, 5 classes, 20 proposals, 12
sampled rois, momentum with L2Decay.

Tolerances: losses within rtol FWD = 1e-5, gradients within GRAD = 1e-4
of their largest magnitude, the parameters after each step within FWD
of their largest magnitude (rtol FWD); the detections' labels bitwise
and their scores and boxes within FWD.
"""

import importlib.util
import os

import numpy as np

import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights

from torch_attention_cases import close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD = 1e-5
GRAD = 1e-4


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
SSD_TINY = dict(
    CS.MOBILENET_SSD, image=32, gts=2, first=4,
    blocks=((4, 8, 2), (8, 8, 1)), blocks2=((8, 16, 2),),
    extras=((8, 16),), min_sizes=[8.0, 14.0, 20.0],
    max_sizes=[[], 16.0, 26.0], aspect_ratios=[[2.0], [2.0, 3.0],
                                               [2.0, 3.0]],
    steps=[8, 16, 32], priors=312)
RCNN_TINY = dict(
    CS.RCNN, channels=8, map=(6, 8), image=(96, 128), gts=3, classes=5,
    anchor_sizes=[16.0, 32.0], pre_nms=60, post_nms=20, rpn_batch=16,
    rois=12, pool=2, rpn_channels=8)


def _lockstep(main, startup, fetch, grads, feeds, start=None):
    """Per step {'jax' / 'torch': (fetched values, the state after)},
    each step from the JAX package's state before it; `start` (name ->
    array) overrides startup values first."""
    jmain = jfluid.Program.from_dict(main.to_dict())
    jstart = jfluid.Program.from_dict(startup.to_dict())
    names = weights.startup_names(startup)
    fetch = [getattr(v, 'name', v) for v in fetch] + \
        [main._grad_name_map[p] for p in grads]
    steps = []
    with jfluid.scope_guard(jfluid.Scope()):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(jstart)
        for n, v in (start or {}).items():
            jfluid.global_scope().set_var(n, v)
        for feed in feeds:
            before = weights.numpy_state(jfluid.global_scope(), names)
            out = [np.asarray(v) for v in exe.run(jmain, feed=feed,
                                                  fetch_list=fetch)]
            steps.append({'before': before, 'jax': (out, weights.numpy_state(
                jfluid.global_scope(), names))})
    place = tfluid.CPUPlace()
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(place)
        exe.run(startup)
        for feed, step in zip(feeds, steps):
            weights.load_numpy_params(tfluid.global_scope(), step['before'],
                                      place, startup)
            out = [np.asarray(v) for v in exe.run(main, feed=feed,
                                                  fetch_list=fetch)]
            step['torch'] = (out, weights.numpy_state(tfluid.global_scope(),
                                                      names))
    return steps


def _hold(steps, n_loss, params, what):
    for k, step in enumerate(steps):
        (jo, js), (to, ts) = step['jax'], step['torch']
        for i, (w, g) in enumerate(zip(jo, to)):
            tol = FWD if i < n_loss else GRAD
            close(g.reshape(w.shape), w, tol, '%s step %d fetch %d' % (
                what, k + 1, i))
        for n in params:
            close(ts[n], js[n], FWD, '%s step %d %s' % (what, k + 1, n))
    first = [float(np.ravel(s['jax'][0][0])[0]) for s in steps]
    assert np.isfinite(first).all()
    return first


def _ssd_feeds(n):
    out = []
    for b in CS.voc_ssd_batches(SSD_TINY, 4, n):
        b['gt_box'] = np.concatenate([b['gt_box'],
                                      np.zeros_like(b['gt_box'])], 1)
        b['gt_label'] = np.concatenate([b['gt_label'],
                                        np.zeros_like(b['gt_label'])], 1)
        out.append(b)
    return out


def test_ssd_tiny_trains_and_detects_like_jax():
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 3
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        feeds, locs, confs, box, var, loss = CS.ssd_build(tfluid, SSD_TINY)
        test = main.clone(for_test=True)
        tfluid.optimizer.RMSProp(CS.SSD_LR, regularization=tfluid.regularizer
                                 .L2Decay(CS.SSD_DECAY)).minimize(loss)
    with tfluid.program_guard(test, tfluid.Program()):
        with tfluid.unique_name.guard('infer'):
            det = CS.ssd_detect(tfluid, locs, confs, box, var)
    assert tuple(box.shape) == (SSD_TINY['priors'], 4)
    types = [op.type for op in main.global_block().ops]
    assert types.count('prior_box') == 3 and 'ssd_loss_grad' in types
    params = sorted(p.name for p in main.all_parameters())
    grads = [n for n in params if n in main._grad_name_map]
    rng = np.random.RandomState(5)
    start = {p.name: (float(p.name.endswith('.w_0')) + 0.2 * rng.randn(
        *p.shape)).astype('float32') for p in main.all_parameters()
        if p.name.startswith('batch_norm') and p.name in grads}
    feed = _ssd_feeds(3)
    steps = _lockstep(main, startup, [loss], grads, feed, start)
    losses = _hold(steps, 1, params, 'SSD-tiny')
    assert losses[0] > 0 and len(set(losses)) == 3
    # the for_test clone's detections from the state after step 3
    state = steps[-1]['jax'][1]
    outs = {}
    for key, fluid, prog, start in (
            ('jax', jfluid, jfluid.Program.from_dict(test.to_dict()),
             jfluid.Program.from_dict(startup.to_dict())),
            ('torch', tfluid, test, startup)):
        with fluid.scope_guard(fluid.Scope()):
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(start)
            for n, v in state.items():
                fluid.global_scope().set_var(n, v)
            outs[key] = np.asarray(exe.run(prog, feed=feed[0],
                                           fetch_list=[det.name])[0])
    np.testing.assert_array_equal(outs['torch'][..., 0], outs['jax'][..., 0])
    close(outs['torch'], outs['jax'], FWD, 'detections')
    assert (outs['torch'][..., 0] >= 0).sum() > 0


def test_rcnn_tiny_trains_like_jax():
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 3
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        feeds, losses, rois, s_rois = CS.rcnn_build(tfluid, RCNN_TINY)
        tfluid.optimizer.Momentum(CS.RCNN_LR, 0.9, regularization=tfluid
                                  .regularizer.L2Decay(CS.RCNN_DECAY)
                                  ).minimize(losses[0])
    types = [op.type for op in main.global_block().ops]
    for t in ('anchor_generator', 'rpn_target_assign', 'generate_proposals',
              'generate_proposal_labels', 'roi_align', 'roi_align_grad',
              'box_coder'):
        assert t in types, t
    params = sorted(p.name for p in main.all_parameters())
    feed = CS.rcnn_inputs(RCNN_TINY, np.random.RandomState(4))
    steps = _lockstep(main, startup, losses + [s_rois], params, [feed] * 3)
    first = _hold(steps, len(losses) + 1, params, 'R-CNN-tiny')
    assert first[-1] < first[0]
    assert steps[0]['torch'][0][len(losses)].shape == (RCNN_TINY['rois'], 4)
