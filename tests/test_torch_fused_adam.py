"""The port's multi-tensor Adam / AdamW (its plain version, on the CPU)
against the JAX package's fused optimizer run in interpret mode
(``fused_optimizer.apply`` with FLAGS_pallas_force) and its per-tensor
dense lowerings, and the executor's grouping of optimizer runs.

Tolerance rtol 2e-6 / atol 3e-7, the JAX package's own bound between
its fused kernel and the dense chain (tests/test_pallas_kernels.py):
1-2 ulp where one side contracts a multiply-add the other rounds
twice.  The fixture restores every FLAGS_pallas_* flag of the JAX
package and the port's grouping flags.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from paddle_tpu.fluid.flags import _DEFAULTS as J_DEFAULTS
from paddle_tpu.fluid.flags import set_flags as j_set_flags
from paddle_tpu.ops import optimizer_ops as jopt
from paddle_tpu.ops import registry as jregistry
from paddle_tpu.ops.pallas import fused_optimizer as jfused

import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.fluid import flags as tflags
from paddle_tpu_torch.ops import optimizer_ops as topt
from paddle_tpu_torch.ops import registry as tregistry
from paddle_tpu_torch.ops.kernels import common
from paddle_tpu_torch.ops.kernels import fused_optimizer as tfused

TOL = dict(rtol=2e-6, atol=3e-7)
SLOTS = ('Param', 'Grad', 'Moment1', 'Moment2', 'LearningRate', 'Beta1Pow',
         'Beta2Pow')
OUT_SLOTS = ('ParamOut', 'Moment1Out', 'Moment2Out', 'Beta1PowOut',
             'Beta2PowOut')
_PORT_FLAGS = ('FLAGS_torch_opt_fuse', 'FLAGS_torch_opt_min_tensors')


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = tflags.get_flags(list(_PORT_FLAGS))
    yield
    j_set_flags({k: v for k, v in J_DEFAULTS.items()
                 if k.startswith('FLAGS_pallas_')})
    tflags.set_flags(saved)


def _arrays(n_tensors, seed):
    rng = np.random.RandomState(seed)
    shapes = [(33, 47), (128,), (5, 8, 13), (257,), (1,)][:n_tensors]
    out = {k: [] for k in SLOTS}
    for i, s in enumerate(shapes):
        out['Param'].append(rng.randn(*s).astype('float32'))
        out['Grad'].append(rng.randn(*s).astype('float32'))
        out['Moment1'].append(rng.randn(*s).astype('float32'))
        out['Moment2'].append(np.abs(rng.randn(*s)).astype('float32'))
        out['LearningRate'].append(np.float32([0.001 * (i + 1)]))
        out['Beta1Pow'].append(np.float32([0.9 ** (i + 1)]))
        out['Beta2Pow'].append(np.float32([0.999 ** (i + 1)]))
    return out


def _jax(arrays):
    return {k: [jnp.asarray(a) for a in v] for k, v in arrays.items()}


def _torch(arrays):
    return {k: [torch.from_numpy(a.copy()) for a in v]
            for k, v in arrays.items()}


ATTRS = {'adam': {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8},
         'adamw': {'beta1': 0.85, 'beta2': 0.99, 'epsilon': 1e-6,
                   'coeff': 0.02}}


@pytest.mark.parametrize('kind', ['adam', 'adamw'])
@pytest.mark.parametrize('seed', [3, 11])
def test_fused_matches_pallas_interpret(kind, seed):
    arrays = _arrays(5, seed)
    j_set_flags({'FLAGS_pallas_force': True})
    want = jfused.apply(kind, jregistry.LowerCtx(0), _jax(arrays),
                        ATTRS[kind])
    before = common.launches('fused_adam')
    got = tfused.apply(kind, None, _torch(arrays), ATTRS[kind])
    assert common.launches('fused_adam') == before  # CPU: plain
    for slot in OUT_SLOTS:
        assert len(got[slot]) == len(want[slot]) == 5
        for g, w in zip(got[slot], want[slot]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg='%s %s' % (kind, slot), **TOL)


def _odd_arrays(sizes, seed):
    """_arrays over 1-D `sizes` (the CUDA kernel's scalar heads and
    tails, tiles past 8192), each with its own step's schedule."""
    rng = np.random.RandomState(seed)
    out = {k: [] for k in SLOTS}
    for i, n in enumerate(sizes):
        out['Param'].append(rng.randn(n).astype('float32'))
        out['Grad'].append(rng.randn(n).astype('float32'))
        out['Moment1'].append(rng.randn(n).astype('float32'))
        out['Moment2'].append(np.abs(rng.randn(n)).astype('float32'))
        out['LearningRate'].append(np.float32([0.001 * (1 + i % 7)]))
        out['Beta1Pow'].append(np.float32([0.9 ** (i + 1)]))
        out['Beta2Pow'].append(np.float32([0.999 ** (i + 1)]))
    return out


def _torch_views(arrays, offset):
    """Each array as a contiguous view at element `offset` of a larger
    CPU buffer, as the CUDA kernel's unaligned cases take them."""
    out = {}
    for k, v in arrays.items():
        out[k] = []
        for a in v:
            if k in SLOTS[:4]:
                buf = torch.zeros(a.size + 4)
                buf[offset:offset + a.size] = torch.from_numpy(a)
                out[k].append(buf[offset:offset + a.size])
            else:
                out[k].append(torch.from_numpy(a.copy()))
    return out


@pytest.mark.parametrize('kind', ['adam', 'adamw'])
@pytest.mark.parametrize('sizes', [[1, 3, 5, 8191, 8193],
                                   [1 + (7 * i) % 40 for i in range(40)]],
                         ids=['odd-sizes', '40-tiny'])
def test_plain_matches_pallas_interpret_at_odd_sizes(kind, sizes):
    """Sizes that are not multiples of 4 or of the tile, and a run of
    tiny tensors, as views at element offset 3 of their buffers."""
    arrays = _odd_arrays(sizes, len(sizes))
    j_set_flags({'FLAGS_pallas_force': True})
    want = jfused.apply(kind, jregistry.LowerCtx(0), _jax(arrays),
                        ATTRS[kind])
    got = tfused.apply(kind, None, _torch_views(arrays, 3), ATTRS[kind])
    for slot in OUT_SLOTS:
        assert len(got[slot]) == len(want[slot]) == len(sizes)
        for g, w in zip(got[slot], want[slot]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg='%s %s' % (kind, slot), **TOL)


@pytest.mark.parametrize('kind', ['adam', 'adamw'])
def test_per_tensor_lowering_matches_jax_dense(kind):
    arrays = _arrays(4, 5)
    fn_j = {'adam': jopt.adam, 'adamw': jopt.adamw}[kind]
    fn_t = {'adam': topt.adam, 'adamw': topt.adamw}[kind]
    for i in range(4):
        one = {k: [v[i]] for k, v in arrays.items()}
        want = fn_j(jregistry.LowerCtx(0), _jax(one), ATTRS[kind])
        got = fn_t(None, _torch(one), ATTRS[kind])
        for slot in OUT_SLOTS:
            np.testing.assert_allclose(got[slot][0].numpy(),
                                       np.asarray(want[slot][0]),
                                       err_msg=slot, **TOL)


def test_fused_plain_is_the_per_tensor_loop_bitwise():
    arrays = _arrays(5, 7)
    got = tfused.apply('adam', None, _torch(arrays), ATTRS['adam'])
    for i in range(5):
        one = _torch({k: [v[i]] for k, v in arrays.items()})
        want = topt.adam(None, one, ATTRS['adam'])
        for slot in OUT_SLOTS:
            assert torch.equal(got[slot][i], want[slot][0]), (i, slot)


def test_shared_beta_pow_is_advanced_once():
    arrays = _arrays(3, 1)
    ins = _torch(arrays)
    shared = torch.tensor([0.81])
    ins['Beta1Pow'] = [shared] * 3
    out = tfused.pow_outputs(ins, {'beta1': 0.9, 'beta2': 0.999})
    assert out['Beta1PowOut'][0] is out['Beta1PowOut'][2]
    np.testing.assert_allclose(out['Beta1PowOut'][1].numpy(),
                               np.float32(0.81) * np.float32(0.9))
    assert out['Beta2PowOut'][0] is not out['Beta2PowOut'][1]


def test_kernel_check_rejects_what_it_does_not_take():
    ins = _torch(_arrays(2, 0))
    ins['Moment2'][1] = ins['Moment2'][1].double()
    with pytest.raises(TypeError, match='f32 tensors on one device'):
        tfused._check(ins)
    ins = _torch(_arrays(2, 0))
    ins['Grad'][0] = ins['Grad'][0].t()
    with pytest.raises(ValueError, match='not contiguous'):
        tfused._check(ins)


def _mlp_program(opt):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=[6], dtype='float32')
        h = fluid.layers.fc(x, size=5, act='gelu')
        h = fluid.layers.fc(h, size=4)
        loss = fluid.layers.mean(h)
        opt.minimize(loss)
    return main, startup, loss


def test_grouping_makes_one_run_of_the_adam_ops():
    main, _, _ = _mlp_program(fluid.optimizer.Adam(0.01))
    ops = [op for op in main.global_block().ops
           if op.type not in tregistry.HOST_OPS]
    first = [op.type for op in ops].index('adam')
    run = texecutor._fused_opt_run(ops, first)
    assert [op.type for op in run] == ['adam'] * 4
    assert [op.type for op in ops[first + 4:]] == ['scale', 'scale']
    tflags.set_flags({'FLAGS_torch_opt_min_tensors': 5})
    assert texecutor._fused_opt_run(ops, first) is None
    tflags.set_flags({'FLAGS_torch_opt_min_tensors': 2,
                      'FLAGS_torch_opt_fuse': False})
    assert texecutor._fused_opt_run(ops, first) is None
    tflags.set_flags({'FLAGS_torch_opt_fuse': True})
    # a member reading what an earlier one wrote ends the run
    ops[first + 2].inputs['Grad'] = list(ops[first].outputs['ParamOut'])
    assert len(texecutor._fused_opt_run(ops, first)) == 2
    assert texecutor._fused_opt_run(ops, first - 1) is None


@pytest.mark.parametrize('opt', ['adam', 'adamw'])
def test_grouped_steps_equal_ungrouped_bitwise(opt):
    make = {'adam': lambda: fluid.optimizer.Adam(0.01),
            'adamw': lambda: fluid.optimizer.AdamW(0.01,
                                                   weight_decay=0.1)}[opt]
    main, startup, loss = _mlp_program(make())
    feed = {'x': np.random.RandomState(0).randn(3, 6).astype('float32')}
    results = []
    for fuse in (True, False):
        tflags.set_flags({'FLAGS_torch_opt_fuse': fuse})
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            losses = [exe.run(main, feed=feed, fetch_list=[loss])[0]
                      for _ in range(3)]
            results.append((losses, {n: scope.find_var(n).clone()
                                     for n in scope.local_var_names()}))
    (la, sa), (lb, sb) = results
    np.testing.assert_array_equal(la, lb)
    assert sa.keys() == sb.keys()
    for n in sa:
        assert torch.equal(sa[n], sb[n]), n
