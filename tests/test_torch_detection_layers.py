"""The 32 detection layers of item 11b-C (the JAX package's
layers/detection.py, its extras.py roi_pool, psroi_pool,
anchor_generator, density_prior_box, box_clip and bipartite_match, and
its more_layers.py roi_align, prroi_pool and deformable_roi_pooling)
built in both packages from the same calls: the same program, op for
op, variable for variable (same_program), wherever the JAX layer
builds.

Where it does not, the port departs, as the reference would build it,
and each test names the variables whose shapes differ:

1. prior_box: the JAX layer declares no shape (its op is appended with
   infer_shape=False), so its boxes are () and multi_box_head's
   reshape(box, [-1, 4]) fails; the port infers [H, W, priors, 4].
2. multi_box_head: the JAX layer counts len(ratios) x (2 with flip) +
   (1 with a max size) predictions a cell, which leaves out the ratio-1
   prior that prior_box always adds; the port takes box.shape[2], as
   the reference does (1,917 priors and predictions at MobileNet-SSD's
   config, where the JAX count gives 1,417).
3. The host-op layers declare no shape in the JAX package, so a shaped
   layer on their outputs (roi_align on generate_proposal_labels' rois)
   fails its shape inference; the port declares the reference's shapes
   ([-1, 4] rois, [-1, 1] labels, -1 rows wherever the count depends on
   the data).
"""

import copy

import pytest

import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.fluid as tfluid

from torch_program_cases import build_both, same_program


class _Dict(object):
    def __init__(self, d):
        self.d = d

    def to_dict(self):
        return self.d


def _same_but(progs, differ):
    """same_program but for the variables of `differ` ({name or its
    unique prefix: (the JAX package's shape, the port's)}), whose shapes
    are checked apart: the names that matched."""
    jd = progs['jax'][0].to_dict()
    td = copy.deepcopy(progs['torch'][0].to_dict())
    seen = set()
    jvars = {v['name']: v for v in jd['blocks'][0]['vars']}
    for v in td['blocks'][0]['vars']:
        for key, (jshape, tshape) in differ.items():
            if v['name'] == key or v['name'].startswith(key + '.tmp'):
                assert tuple(jvars[v['name']]['shape']) == tuple(jshape), \
                    (v['name'], jvars[v['name']]['shape'])
                assert tuple(v['shape']) == tuple(tshape), (v['name'],
                                                            v['shape'])
                v['shape'] = jvars[v['name']]['shape']
                seen.add(key)
    assert seen == set(differ), set(differ) - seen
    same_program(_Dict(jd), _Dict(td))


def _data(fluid, name, shape, dtype='float32'):
    return fluid.layers.data(name, shape, dtype=dtype,
                             append_batch_size=False)


def _ssd_inputs(fluid):
    return (_data(fluid, 'loc', [2, 12, 4]), _data(fluid, 'conf', [2, 12, 5]),
            _data(fluid, 'prior', [12, 4]), _data(fluid, 'pvar', [12, 4]))


LAYERS = {
    'box_coder': lambda f, L: [
        L.box_coder(_data(f, 'p', [6, 4]), _data(f, 'v', [6, 4]),
                    _data(f, 't', [3, 6, 4]), 'decode_center_size'),
        L.box_coder(_data(f, 'p2', [6, 4]), [0.1, 0.1, 0.2, 0.2],
                    _data(f, 't2', [6, 4]))],
    'iou_similarity': lambda f, L: [L.iou_similarity(
        _data(f, 'x', [5, 4]), _data(f, 'y', [7, 4]))],
    'yolo_box': lambda f, L: list(L.yolo_box(
        _data(f, 'x', [2, 27, 4, 5]), _data(f, 'im', [2, 2], 'int32'),
        [10, 13, 16, 30, 33, 23], 4, 0.01, 32)),
    'yolov3_loss': lambda f, L: [L.yolov3_loss(
        _data(f, 'x', [2, 16, 4, 4]), _data(f, 'gt', [2, 3, 4]),
        _data(f, 'lab', [2, 3], 'int32'), [10, 13, 16, 30, 33, 23, 30, 61],
        [1, 2], 3, 0.5, 8)],
    'multiclass_nms': lambda f, L: [L.multiclass_nms(
        _data(f, 'b', [2, 30, 4]), _data(f, 's', [2, 3, 30]), 0.05, 20, 10)],
    'sigmoid_focal_loss': lambda f, L: [L.sigmoid_focal_loss(
        _data(f, 'x', [6, 4]), _data(f, 'l', [6, 1], 'int32'),
        _data(f, 'fg', [1], 'int32'))],
    'generate_proposals': lambda f, L: list(L.generate_proposals(
        _data(f, 's', [1, 6, 4, 5]), _data(f, 'd', [1, 24, 4, 5]),
        _data(f, 'im', [1, 3]), _data(f, 'a', [4, 5, 6, 4]),
        _data(f, 'v', [4, 5, 6, 4]), 80, 40, 0.5, 4.0)),
    'detection_output': lambda f, L: [L.detection_output(
        *_ssd_inputs(f), nms_threshold=0.45, nms_top_k=8, keep_top_k=6)],
    'ssd_loss': lambda f, L: (lambda loc, conf, prior, _: [L.ssd_loss(
        loc, conf, _data(f, 'gt', [2, 3, 4]), _data(f, 'gl', [2, 3], 'int32'),
        prior)])(*_ssd_inputs(f)),
    'target_assign': lambda f, L: list(L.target_assign(
        _data(f, 'x', [2, 4, 3]), _data(f, 'm', [2, 7], 'int32'),
        mismatch_value=0)),
    'polygon_box_transform': lambda f, L: [L.polygon_box_transform(
        _data(f, 'x', [2, 8, 3, 4]))],
    'retinanet_detection_output': lambda f, L: [
        L.retinanet_detection_output(
            [_data(f, 'b0', [1, 20, 4]), _data(f, 'b1', [1, 5, 4])],
            [_data(f, 's0', [1, 20, 3]), _data(f, 's1', [1, 5, 3])],
            _data(f, 'im', [1, 3]))],
    'box_decoder_and_assign': lambda f, L: list(L.box_decoder_and_assign(
        _data(f, 'p', [5, 4]), _data(f, 'v', [4]), _data(f, 't', [5, 12]),
        _data(f, 's', [5, 3]), 4.135)),
    'roi_pool': lambda f, L: [L.roi_pool(
        _data(f, 'x', [2, 3, 8, 9]), _data(f, 'r', [6, 4]), 2, 3, 0.5,
        rois_batch=_data(f, 'b', [6], 'int32'))],
    'psroi_pool': lambda f, L: [L.psroi_pool(
        _data(f, 'x', [2, 12, 8, 9]), _data(f, 'r', [6, 4]), 2, 0.5, 2, 3)],
    'anchor_generator': lambda f, L: list(L.anchor_generator(
        _data(f, 'x', [1, 2, 5, 7]), [32.0, 64.0], [0.5, 1.0, 2.0],
        [16.0, 16.0])),
    'density_prior_box': lambda f, L: list(L.density_prior_box(
        _data(f, 'x', [1, 2, 4, 5]), _data(f, 'im', [1, 3, 64, 80]),
        [8.0, 16.0], [1.0, 2.0], [2, 1])),
    'box_clip': lambda f, L: [L.box_clip(
        _data(f, 'x', [2, 4, 4]), _data(f, 'im', [2, 3]))],
    'bipartite_match': lambda f, L: list(L.bipartite_match(
        _data(f, 'd', [4, 9]), 'per_prediction', 0.6)),
    'roi_align': lambda f, L: [L.roi_align(
        _data(f, 'x', [2, 3, 8, 9]), _data(f, 'r', [6, 4]), 2, 3, 0.5, 0,
        rois_num=_data(f, 'b', [6], 'int32'))],
    'prroi_pool': lambda f, L: [L.prroi_pool(
        _data(f, 'x', [2, 3, 8, 9]), _data(f, 'r', [6, 4]), 0.5, 2, 3,
        batch_roi_nums=_data(f, 'b', [6], 'int32'))],
    'deformable_roi_pooling': lambda f, L: [L.deformable_roi_pooling(
        _data(f, 'x', [2, 3, 8, 9]), _data(f, 'r', [6, 4]),
        _data(f, 't', [6, 2, 2, 3]), spatial_scale=0.5, pooled_height=2,
        pooled_width=3, trans_std=0.2)],
}


@pytest.mark.parametrize('group', [
    ('box_coder', 'iou_similarity', 'yolo_box', 'yolov3_loss',
     'multiclass_nms', 'sigmoid_focal_loss', 'generate_proposals'),
    ('detection_output', 'ssd_loss', 'target_assign',
     'polygon_box_transform', 'retinanet_detection_output',
     'box_decoder_and_assign'),
    ('roi_pool', 'psroi_pool', 'anchor_generator', 'density_prior_box',
     'box_clip', 'bipartite_match'),
    ('roi_align', 'prroi_pool', 'deformable_roi_pooling'),
])
def test_layers_build_the_jax_program(group):
    for name in group:
        progs = build_both(lambda f: LAYERS[name](f, f.layers))
        same_program(progs['jax'][0], progs['torch'][0])
        types = [op.type for op in progs['torch'][0].global_block().ops]
        assert types, name


def test_prior_box_infers_its_shape():
    """Fault 1: the port's boxes and variances are [H, W, priors, 4]."""
    def build(f):
        return list(f.layers.prior_box(
            _data(f, 'x', [-1, 8, 19, 19]), _data(f, 'im', [-1, 3, 300, 300]),
            [60.0], aspect_ratios=[2.0], flip=True))
    progs = build_both(build)
    _same_but(progs, {'prior_box_0': ((), (19, 19, 3, 4))})
    assert tuple(progs['torch'][2][0].shape) == (19, 19, 3, 4)


SSD_HEAD = dict(
    min_sizes=[60.0, 105.0, 150.0], max_sizes=[[], 150.0, 195.0],
    aspect_ratios=[[2.0], [2.0, 3.0], [2.0, 3.0]], steps=[8, 16, 32])


def _head(f, maps=((19, 8), (10, 16), (5, 8))):
    L = f.layers
    image = L.data('image', [3, 300, 300])
    ins = [L.data('m%d' % i, [c, s, s]) for i, (s, c) in enumerate(maps)]
    return L.multi_box_head(ins, image, 300, 21, min_ratio=20, max_ratio=90,
                            offset=0.5, flip=True, **SSD_HEAD)


def test_multi_box_head_builds_in_the_port_only():
    """Faults 1 and 2: the JAX layer cannot reshape its () boxes; the
    port's predictions a cell are its priors a cell (3 with ratio 1,
    2 and 1/2; 6 with 3, 1/3 and a max size), which the JAX count makes
    2 and 5."""
    with jfluid.unique_name.guard(), jfluid.program_guard(
            jfluid.Program(), jfluid.Program()):
        with pytest.raises(Exception, match='reshape'):
            _head(jfluid)
    main = tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(
            main, tfluid.Program()):
        locs, confs, box, var = _head(tfluid)
    priors = 19 * 19 * 3 + 10 * 10 * 6 + 5 * 5 * 6
    assert tuple(box.shape) == tuple(var.shape) == (priors, 4)
    assert tuple(locs.shape) == (-1, priors, 4)
    assert tuple(confs.shape) == (-1, priors, 21)
    jax_count = 19 * 19 * 2 + 10 * 10 * 5 + 5 * 5 * 5
    assert jax_count != priors
    convs = [op for op in main.global_block().ops if op.type == 'conv2d']
    widths = [main.global_block().var(op.input('Filter')[0]).shape[0]
              for op in convs]
    assert widths == [3 * 4, 3 * 21, 6 * 4, 6 * 21, 6 * 4, 6 * 21]


HOST = {
    'rpn_target_assign': (
        lambda f, L: list(L.rpn_target_assign(
            _data(f, 'bp', [1, 24, 4, 5]), _data(f, 'cl', [1, 6, 4, 5]),
            _data(f, 'a', [4, 5, 6, 4]), _data(f, 'v', [4, 5, 6, 4]),
            _data(f, 'g', [1, 3, 4]), rpn_batch_size_per_im=64)),
        [(-1,), (-1,), (-1, 1), (-1, 4), (-1, 4)]),
    'retinanet_target_assign': (
        lambda f, L: list(L.retinanet_target_assign(
            _data(f, 'bp', [1, 24, 4, 5]), _data(f, 'cl', [1, 6, 4, 5]),
            _data(f, 'a', [4, 5, 6, 4]), _data(f, 'v', [4, 5, 6, 4]),
            _data(f, 'g', [1, 3, 4]), _data(f, 'gl', [1, 3, 1], 'int32'),
            None, None, num_classes=3)[:5]),
        [(-1,), (-1,), (-1, 1), (-1, 4), (-1, 4)]),
    'generate_proposal_labels': (
        lambda f, L: list(L.generate_proposal_labels(
            _data(f, 'r', [1, 40, 4]), _data(f, 'gc', [3, 1], 'int32'), None,
            _data(f, 'gb', [3, 4]), None, batch_size_per_im=16)),
        [(-1, 4), (-1, 1), (-1, 4), (-1, 4), (-1, 4)]),
    'generate_mask_labels': (
        lambda f, L: list(L.generate_mask_labels(
            None, None, None, None, _data(f, 'r', [5, 4]), None, 3, 7)),
        [(-1, 4), (-1, 1), (-1, 49)]),
    'distribute_fpn_proposals': (
        lambda f, L: (lambda o: o[0] + [o[1]])(L.distribute_fpn_proposals(
            _data(f, 'r', [60, 4]), 2, 5, 4, 224)),
        [(-1, 4)] * 4 + [(-1, 1)]),
    'collect_fpn_proposals': (
        lambda f, L: [L.collect_fpn_proposals(
            [_data(f, 'r%d' % i, [10, 4]) for i in range(2)],
            [_data(f, 's%d' % i, [10, 1]) for i in range(2)], 2, 3, 8)],
        [(-1, 4)]),
    'locality_aware_nms': (
        lambda f, L: [L.locality_aware_nms(
            _data(f, 'b', [1, 30, 8]), _data(f, 's', [1, 1, 30]), 0.1, 20,
            10)], [(-1, 6)]),
    'roi_perspective_transform': (
        lambda f, L: [L.roi_perspective_transform(
            _data(f, 'x', [1, 3, 20, 24]), _data(f, 'r', [6, 8]), 4, 6)],
        [(-1, 3, 4, 6)]),
}


@pytest.mark.parametrize('name', sorted(HOST))
def test_host_op_layers_declare_the_reference_shapes(name):
    """Fault 3: each output's shape, () in the JAX program, is the
    reference's in the port's; the rest of the program is the same."""
    build, shapes = HOST[name]
    progs = build_both(lambda f: build(f, f.layers))
    outs = progs['torch'][2]
    assert [tuple(v.shape) for v in outs] == shapes
    _same_but(progs, {v.name: ((), tuple(v.shape)) for v in outs})


def test_roi_align_on_sampled_rois_builds_in_the_port_only():
    """Fault 3: roi_align's shape inference on generate_proposal_labels'
    () rois fails in the JAX package; the port's rois are [-1, 4]."""
    def build(f):
        L = f.layers
        rois = L.generate_proposal_labels(
            _data(f, 'r', [1, 40, 4]), _data(f, 'gc', [3, 1], 'int32'),
            None, _data(f, 'gb', [3, 4]), None, batch_size_per_im=16)[0]
        return L.roi_align(_data(f, 'x', [1, 8, 6, 7]), rois, 2, 2, 0.25)
    with jfluid.unique_name.guard(), jfluid.program_guard(
            jfluid.Program(), jfluid.Program()):
        with pytest.raises(RuntimeError, match='roi_align'):
            build(jfluid)
    with tfluid.unique_name.guard(), tfluid.program_guard(
            tfluid.Program(), tfluid.Program()):
        assert tuple(build(tfluid).shape) == (-1, 8, 2, 2)
