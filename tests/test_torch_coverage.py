"""The port's coverage of the JAX package, counted from the two
registries and the two packages' exports (``tools/check_*_coverage.py``
compare against the reference's sources, which are not in this
repository; this test replaces nothing of theirs).

It asserts that every op type, layer, optimizer class and `fluid` name
of the core slice (Queue 1 item 11a) is in the port, that the port
registers no op type and exports no layer or optimizer name the JAX
package lacks (the three `fluid` names of its own are listed), and it
lists what is still missing by ROADMAP Queue 1 item: each missing name
is assigned to an item here, and each item's count of missing names may
shrink but not grow.  It also checks that chip_smoke.py's phase 17 (c)
runs every op type of the core slice on the card, phase 20 (c) every
op type of the nn slice (NN_SLICE_OPS: item 11b's nn_ops group and the
four op types item 11a's layers emit), and phase 21 (c) every op type
of item 11b's groups A (VISION_OPS) and B (LOSS_MISC_OPS), whose
layers (VISION_LAYERS, LOSS_MISC_LAYERS) the port has too, and phase
22 (c) every op type of group C (DETECTION_OPS, with DETECTION_LAYERS).
"""

import collections
import functools
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# counted in a fresh process: in a test worker other files register ops
# of their own and import submodules, which become attributes of fluid
_PROBE = r"""
import importlib, inspect, json, sys
sys.path.insert(0, ROOT)
out = {}
for key, pkg in (('jax', 'paddle_tpu'), ('torch', 'paddle_tpu_torch')):
    importlib.import_module(pkg + '.ops')
    reg = importlib.import_module(pkg + '.ops.registry')
    fluid = importlib.import_module(pkg + '.fluid')
    layers = fluid.layers

    def public(mod):
        return sorted(n for n in dir(mod) if not n.startswith('_'))

    def layer(n):
        o = getattr(layers, n)
        return ((inspect.isfunction(o) or inspect.isclass(o)) and
                o.__module__.split('.')[-2:-1] == ['layers'])
    opt = fluid.optimizer
    out[key] = {
        'ops': {t: reg.get(t).fn.__module__.rsplit('.', 1)[-1]
                for t in reg.registered_ops()},
        'fluid': public(fluid),
        'layers': {n: getattr(layers, n).__module__.rsplit('.', 1)[-1]
                   for n in public(layers) if layer(n)},
        'optimizer': public(opt),
        'optimizer_classes': [
            n for n in public(opt) if isinstance(getattr(opt, n), type) and
            getattr(opt, n).__module__.endswith('optimizer')],
    }
print(json.dumps(out))
"""


@functools.lru_cache(maxsize=None)
def exports():
    """{'jax' / 'torch': {'ops': {type: module}, 'fluid': [names],
    'layers': {layer: module}, 'optimizer': [names],
    'optimizer_classes': [names]}} of a fresh process."""
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    out = subprocess.run([sys.executable, '-c', 'ROOT = %r\n' % ROOT +
                          _PROBE], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


SLICE_OPS = {
    # ops/math_ops.py
    'reduce_mean', 'reduce_max', 'reduce_min', 'reduce_prod', 'reduce_all',
    'reduce_any', 'dot', 'isfinite', 'isinf', 'isnan', 'p_norm', 'arg_min',
    'top_k_v2', 'argsort', 'norm', 'cholesky', 'inverse',
    # ops/activation_ops.py
    'abs', 'acos', 'asin', 'atan', 'brelu', 'ceil', 'cosh', 'elu', 'erf',
    'hard_shrink', 'hard_sigmoid', 'hard_swish', 'leaky_relu', 'log10',
    'log1p', 'log2', 'logsigmoid', 'maxout', 'mish', 'prelu', 'relu6',
    'round', 'rsqrt', 'selu', 'silu', 'sin', 'sinh', 'soft_shrink',
    'softplus', 'softshrink', 'softsign', 'square', 'stanh', 'swish',
    'tan', 'tanh_shrink', 'thresholded_relu',
    # ops/tensor_ops.py
    'coalesce_tensor', 'cumsum', 'diag', 'embedding', 'expand_as',
    'flatten', 'flatten2', 'flatten_contiguous_range', 'flip',
    'gather_nd', 'index_select', 'minus', 'pad', 'pad2d', 'reverse',
    'roll', 'scatter', 'share_data', 'shuffle_batch', 'split_byref',
    'strided_slice', 'tile', 'tril_triu', 'truncated_gaussian_random',
    'uniform_random_batch_size_like', 'unstack', 'where', 'where_index',
    # ops/optimizer_ops.py and three of ops/misc_ops.py
    'adadelta', 'adamax', 'dgc', 'dpsgd', 'ftrl', 'lars_momentum',
    'proximal_gd', 'rmsprop', 'decayed_adagrad', 'eye',
    'tensor_array_to_tensor',
}

# the nn slice: the JAX package's ops/nn_ops.py beyond the port's first
# ops, and size (ops/loss_ops.py), rank, soft_relu and
# gaussian_random_batch_size_like (ops/misc_ops.py)
NN_SLICE_OPS = {
    'conv2d_transpose', 'depthwise_conv2d_transpose', 'instance_norm',
    'group_norm', 'huber_loss', 'smooth_l1_loss', 'log_loss', 'kldiv_loss',
    'mse_loss', 'auc', 'nearest_interp', 'interp_nearest',
    'bilinear_interp', 'grid_sampler', 'temporal_shift', 'lrn',
    'max_pool2d_with_index', 'max_pool3d_with_index', 'unpool',
    'conv_shift', 'size', 'rank', 'soft_relu',
    'gaussian_random_batch_size_like',
}

# item 11b-A, dense vision: JAX ops/vision_ops.py but its ROI and anchor
# ops, and their layers of layers/extras.py and more_layers.py
VISION_OPS = {
    'conv3d', 'conv3d_transpose', 'pool3d', 'trilinear_interp',
    'pixel_shuffle', 'shuffle_channel', 'space_to_depth', 'affine_channel',
    'affine_grid', 'unfold', 'crop_tensor', 'crop', 'spp',
    'deformable_conv', 'deformable_conv_v1',
}
VISION_LAYERS = {
    'conv3d', 'conv3d_transpose', 'pool3d', 'resize_trilinear',
    'pixel_shuffle', 'shuffle_channel', 'space_to_depth', 'unfold', 'spp',
    'affine_channel', 'affine_grid', 'adaptive_pool3d', 'crop',
    'crop_tensor', 'deformable_conv',
}

# item 11b-B, losses and misc: JAX ops/loss_ops.py (but size) and six
# op types of ops/misc_ops.py, with their layers and the distributions
LOSS_MISC_OPS = {
    'bilinear_tensor_product', 'bpr_loss', 'center_loss', 'cvm',
    'data_norm', 'fsp', 'hinge_loss', 'l1_norm', 'margin_rank_loss',
    'mean_iou', 'modified_huber_loss', 'multiplex', 'pad_constant_like',
    'random_crop', 'rank_loss', 'sampling_id', 'scatter_nd_add',
    'shard_index', 'spectral_norm', 'teacher_student_sigmoid_loss',
    'unique_with_counts', 'add_position_encoding',
    'continuous_value_model', 'hash', 'scatter_nd', 'similarity_focus',
    'unique',
}
LOSS_MISC_LAYERS = {
    'rank_loss', 'margin_rank_loss', 'hinge_loss', 'bpr_loss',
    'modified_huber_loss', 'teacher_student_sigmoid_loss', 'center_loss',
    'cvm', 'npair_loss', 'mean_iou', 'shard_index', 'multiplex',
    'bilinear_tensor_product', 'sampling_id', 'random_crop',
    'scatter_nd_add', 'pad_constant_like', 'fsp_matrix',
    'add_position_encoding', 'continuous_value_model', 'data_norm', 'hash',
    'scatter_nd', 'similarity_focus', 'spectral_norm', 'unique',
    'unique_with_counts', 'Uniform', 'Normal', 'Categorical',
    'MultivariateNormalDiag',
}

# item 11b-C, detection: JAX ops/detection_ops.py and
# ops/detection_host_ops.py, the ROI and anchor ops of ops/vision_ops.py
# and three of ops/misc_ops.py, with their layers
DETECTION_OPS = {
    'prior_box', 'box_coder', 'iou_similarity', 'yolo_box', 'multiclass_nms',
    'roi_align', 'generate_proposals', 'sigmoid_focal_loss', 'yolov3_loss',
    'ssd_loss', 'rpn_target_assign', 'retinanet_target_assign',
    'generate_proposal_labels', 'generate_mask_labels',
    'distribute_fpn_proposals', 'collect_fpn_proposals',
    'locality_aware_nms', 'roi_perspective_transform',
    'box_decoder_and_assign', 'roi_pool', 'psroi_pool', 'anchor_generator',
    'density_prior_box', 'box_clip', 'bipartite_match', 'prroi_pool',
    'polygon_box_transform', 'target_assign', 'deformable_roi_pooling',
}
DETECTION_LAYERS = {
    'prior_box', 'box_coder', 'iou_similarity', 'yolo_box', 'yolov3_loss',
    'multiclass_nms', 'sigmoid_focal_loss', 'generate_proposals',
    'detection_output', 'multi_box_head', 'ssd_loss', 'target_assign',
    'polygon_box_transform', 'rpn_target_assign', 'retinanet_target_assign',
    'retinanet_detection_output', 'generate_proposal_labels',
    'generate_mask_labels', 'distribute_fpn_proposals',
    'collect_fpn_proposals', 'locality_aware_nms',
    'roi_perspective_transform', 'box_decoder_and_assign', 'roi_pool',
    'psroi_pool', 'anchor_generator', 'density_prior_box', 'box_clip',
    'bipartite_match', 'roi_align', 'prroi_pool', 'deformable_roi_pooling',
}

SLICE_LAYERS = {
    'mul', 'elementwise_pow', 'reduce_mean', 'reduce_max', 'reduce_min',
    'reduce_prod', 'reduce_all', 'reduce_any', 'clip', 'clip_by_norm',
    'l2_normalize', 'flatten', 'where', 'cond_select', 'leaky_relu',
    'prelu', 'pad', 'gather_nd', 'scatter', 'unstack', 'dice_loss', 'gelu',
    'elu', 'relu6', 'swish', 'hard_sigmoid', 'hard_swish', 'cumsum', 'abs',
    'acos', 'asin', 'atan', 'ceil', 'cosh', 'erf', 'log10', 'log1p', 'log2',
    'logsigmoid', 'round', 'rsqrt', 'silu', 'sin', 'sinh', 'softplus',
    'softsign', 'square', 'tan', 'tanh_shrink', 'create_global_var',
    'argmin', 'argsort', 'create_tensor', 'diag', 'eye', 'has_inf',
    'has_nan', 'isfinite', 'linspace', 'reverse', 'tensor_array_to_tensor',
    'uniform_random', 'uniform_random_batch_size_like', 'gaussian_random',
    'strided_slice', 'expand_as', 'pad2d', 'maxout',
    'autoincreased_step_counter', 'brelu', 'selu', 'stanh',
}

SLICE_OPTIMIZERS = {
    'LarsMomentum', 'LarsMomentumOptimizer', 'Adamax', 'AdamaxOptimizer',
    'Adadelta', 'AdadeltaOptimizer', 'RMSProp', 'RMSPropOptimizer', 'Ftrl',
    'FtrlOptimizer', 'Dpsgd', 'DpsgdOptimizer', 'DecayedAdagrad',
    'DecayedAdagradOptimizer', 'DGCMomentumOptimizer', 'ModelAverage',
    'ExponentialMovingAverage', 'LookaheadOptimizer',
}

SLICE_FLUID_NAMES = {'gradients', 'name_scope', 'WeightNormParamAttr',
                     'is_compiled_with_cuda', 'require_version',
                     'init_on_cpu', 'load_op_library'}

# the JAX module of a missing op type -> its ROADMAP Queue 1 item
OP_MODULE_ITEM = {
    'vision_ops': '11b', 'loss_ops': '11b', 'nn_ops': '11b',
    'misc_ops': '11b', 'detection_ops': '11b', 'detection_host_ops': '11b',
    'fused_ops': '11b', 'quant_ops': '11b', 'collective_ops': '13',
    'parallel_ops': '13', 'host_ops': '14', 'sparse_embedding': '14',
}

# the most that may be missing, by item: the counts at this slice
MISSING_OPS = {'11b': 17, '13': 7, '14': 10}

# the JAX layers module of a missing layer -> its item
LAYER_MODULE_ITEM = {
    'detection': '11b', 'distributions': '11b', 'extras': '11b',
    'more_layers': '11b', 'nn': '11b', 'parallel_layers': '13',
}
MISSING_LAYERS = {'11b': 2, '13': 2}  # the most, as MISSING_OPS

FLUID_NAME_ITEM = {
    'DistributeTranspiler': '14', 'DistributeTranspilerConfig': '14',
    'SelectedRows': '14', 'dygraph': '15', 'enable_dygraph': '15',
    'disable_dygraph': '15', 'in_dygraph_mode': '15', 'elastic': '17',
    'supervisor': '17',
    # the TPU place and its device list: the port's place is CUDAPlace
    'XLAPlace': 'tpu-only', 'xla_places': 'tpu-only',
}
FLUID_PORT_ONLY = {'Parameter', 'comms_plan', 'paddle_format'}


def missing_by_item(kind, module_item):
    """{item: [names]} of the JAX package's `kind` ('ops' / 'layers')
    that the port lacks, each by its JAX module's item; every such
    module must have one."""
    j, t = exports()['jax'][kind], exports()['torch'][kind]
    out = collections.defaultdict(list)
    for n in sorted(set(j) - set(t)):
        assert j[n] in module_item, (n, j[n])
        out[module_item[j[n]]].append(n)
    return dict(out)


def assert_missing_does_not_grow(kind, module_item, most):
    missing = missing_by_item(kind, module_item)
    got = {k: len(v) for k, v in missing.items()}
    print('missing %s by ROADMAP Queue 1 item: %s' % (kind, got))
    assert set(got) <= set(most), missing
    for item, n in got.items():
        assert n <= most[item], (item, missing[item])


def test_op_types_of_the_slice_and_none_of_the_port_alone():
    jt, tt = set(exports()['jax']['ops']), set(exports()['torch']['ops'])
    assert len(SLICE_OPS) == 93
    assert SLICE_OPS <= tt
    assert tt <= jt, sorted(tt - jt)
    print('op types: %d of %d' % (len(tt), len(jt)))
    assert_missing_does_not_grow('ops', OP_MODULE_ITEM, MISSING_OPS)


def test_layers_of_the_slice_and_none_of_the_port_alone():
    jl = set(exports()['jax']['layers'])
    tl = set(exports()['torch']['layers'])
    assert SLICE_LAYERS <= tl
    assert tl <= jl, sorted(tl - jl)
    print('layers: %d of %d' % (len(tl), len(jl)))
    assert_missing_does_not_grow('layers', LAYER_MODULE_ITEM,
                                 MISSING_LAYERS)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_runs_every_op_type_of_the_slice():
    mod = _chip_smoke()
    cases = {op for op, _, _ in mod.core_op_cases(np.random.RandomState(0))}
    assert SLICE_OPS <= cases, sorted(SLICE_OPS - cases)


def test_nn_slice_ops_in_the_port_and_on_the_card():
    assert len(NN_SLICE_OPS) == 24
    tt = set(exports()['torch']['ops'])
    assert NN_SLICE_OPS <= tt, sorted(NN_SLICE_OPS - tt)
    assert all(exports()['jax']['ops'][t] in ('nn_ops', 'loss_ops',
                                              'misc_ops')
               for t in NN_SLICE_OPS)
    cases = {op for op, _, _ in _chip_smoke().nn_op_cases(
        np.random.RandomState(0))}
    assert NN_SLICE_OPS <= cases, sorted(NN_SLICE_OPS - cases)


def test_vision_and_loss_groups_in_the_port_and_on_the_card():
    """Item 11b's groups A and B: every op type has a case in
    chip_smoke.py's vision_op_cases or loss_op_cases (the two host ops
    among them run through a program), and the port has the groups'
    layers and nets.scaled_dot_product_attention."""
    assert (len(VISION_OPS), len(VISION_LAYERS)) == (15, 15)
    assert (len(LOSS_MISC_OPS), len(LOSS_MISC_LAYERS)) == (27, 31)
    jops = exports()['jax']['ops']
    assert {jops[t] for t in VISION_OPS} == {'vision_ops'}
    assert {jops[t] for t in LOSS_MISC_OPS} == {'loss_ops', 'misc_ops'}
    tt = set(exports()['torch']['ops'])
    assert VISION_OPS | LOSS_MISC_OPS <= tt, sorted(
        (VISION_OPS | LOSS_MISC_OPS) - tt)
    tl = set(exports()['torch']['layers'])
    assert VISION_LAYERS | LOSS_MISC_LAYERS <= tl, sorted(
        (VISION_LAYERS | LOSS_MISC_LAYERS) - tl)
    mod = _chip_smoke()
    rng = np.random.RandomState(0)
    cases = {op for op, _, _ in mod.vision_op_cases(rng)}
    assert VISION_OPS <= cases, sorted(VISION_OPS - cases)
    cases = {op for op, _, _ in mod.loss_op_cases(rng)}
    assert LOSS_MISC_OPS <= cases, sorted(LOSS_MISC_OPS - cases)
    from paddle_tpu_torch.fluid import nets
    assert callable(nets.scaled_dot_product_attention)


def test_detection_group_in_the_port_and_on_the_card():
    """Item 11b's group C: the port has its op types and layers, and
    chip_smoke.py's detection_op_cases has a case of every op type (the
    host ops among them run through a program)."""
    assert (len(DETECTION_OPS), len(DETECTION_LAYERS)) == (29, 32)
    jops = exports()['jax']['ops']
    assert {jops[t] for t in DETECTION_OPS} == {
        'detection_ops', 'detection_host_ops', 'vision_ops', 'misc_ops'}
    tt = set(exports()['torch']['ops'])
    assert DETECTION_OPS <= tt, sorted(DETECTION_OPS - tt)
    jl = exports()['jax']['layers']
    assert {jl[n] for n in DETECTION_LAYERS} == {'detection', 'extras',
                                                  'more_layers'}
    tl = set(exports()['torch']['layers'])
    assert DETECTION_LAYERS <= tl, sorted(DETECTION_LAYERS - tl)
    cases = {op for op, _, _ in _chip_smoke().detection_op_cases(
        np.random.RandomState(0))}
    assert DETECTION_OPS <= cases, sorted(DETECTION_OPS - cases)


def test_optimizer_classes():
    jo, to = (set(exports()[k]['optimizer']) for k in ('jax', 'torch'))
    classes = set(exports()['jax']['optimizer_classes'])
    assert SLICE_OPTIMIZERS <= to
    assert classes - to == {'PipelineOptimizer'}  # item 13
    assert {n for n in to if n[0].isupper()} <= jo


def test_fluid_names():
    jn, tn = (set(exports()[k]['fluid']) for k in ('jax', 'torch'))
    assert SLICE_FLUID_NAMES <= tn
    assert tn - jn == FLUID_PORT_ONLY
    assert jn - tn == set(FLUID_NAME_ITEM), sorted((jn - tn) ^
                                                   set(FLUID_NAME_ITEM))
