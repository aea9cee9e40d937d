"""The port's sparse Adagrad row update (the plain version of K7, on the
CPU) against the JAX package's ``_update_kernel`` run in interpret mode
(``embedding.apply_update`` with FLAGS_pallas_force; every table has at
least FLAGS_pallas_embedding_min_rows = 512 rows, so the JAX gate lets
the kernel run), with colliding ids, padding_idx, out-of-range ids, a
D = 1 table and the [..., 1] ids of a v1 lookup_table.

Tolerance rtol = atol = 2e-6, the JAX package's own bound between its
kernel and its dense path (tests/test_pallas_kernels.py): 1-2 ulp where
XLA contracts a multiply-add.  Rows no id names, and the padding row
(whose gradient rows are zeroed first, so it takes a zero step), come
out bit for bit as they went in.  The fixture restores the JAX
package's FLAGS_pallas_* flags.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from paddle_tpu.fluid.flags import _DEFAULTS as J_DEFAULTS
from paddle_tpu.fluid.flags import set_flags as j_set_flags
from paddle_tpu.ops import registry as jregistry
from paddle_tpu.ops.pallas import common as jcommon
from paddle_tpu.ops.pallas import embedding as jemb

import torch

from paddle_tpu_torch.ops import optimizer_ops as topt
from paddle_tpu_torch.ops import registry as tregistry
from paddle_tpu_torch.ops.kernels import common
from paddle_tpu_torch.ops.kernels import embedding as temb

TOL = dict(rtol=2e-6, atol=2e-6)


@pytest.fixture(autouse=True)
def _restore_flags():
    yield
    j_set_flags({k: v for k, v in J_DEFAULTS.items()
                 if k.startswith('FLAGS_pallas_')})


def _case(name):
    """(ins as numpy, attrs) of one update."""
    rng = np.random.RandomState(2)
    if name == 'collisions_padding':  # the JAX package's own case
        v, d = 530, 8
        ids = np.array([7, 7, 7, 1, 0, 529, 1, 7], 'int64')
        pad = 1
    elif name == 'out_of_range':
        v, d = 600, 16
        ids = np.array([5, -3, 600, 10 ** 6, 599, 0, 5, -1], 'int64')
        pad = -1
    elif name == 'wide_d1':
        v, d = 700, 1
        ids = rng.randint(0, 40, (64, 26)).astype('int64')
        pad = 3
    elif name == 'lookup_v1_ids':
        v, d = 512, 4
        ids = rng.randint(0, 20, (30, 1)).astype('int64')
        pad = -1
    else:  # 'ctr_fields': a batch of 26 fields, many rows hit often
        v, d = 1000, 16
        ids = rng.randint(0, 1000, (256, 26)).astype('int64')
        ids[:, 0] = 17
        pad = 0
    g_shape = (ids.shape[0], d) if name == 'lookup_v1_ids' \
        else ids.shape + (d,)
    ins = {'Param': [rng.randn(v, d).astype('float32')],
           'Moment': [np.abs(rng.randn(v, d)).astype('float32')],
           'Ids': [ids], 'Grad': [rng.randn(*g_shape).astype('float32')],
           'LearningRate': [np.float32([0.1])]}
    return ins, {'epsilon': 1e-6, 'padding_idx': pad}


CASES = ['collisions_padding', 'out_of_range', 'wide_d1', 'lookup_v1_ids',
         'ctr_fields']


def _touched(ins, attrs):
    v = ins['Param'][0].shape[0]
    return set(np.clip(ins['Ids'][0].ravel(), 0, v - 1).tolist())


@pytest.mark.parametrize('name', CASES)
def test_update_matches_pallas_interpret(name):
    ins, attrs = _case(name)
    j_set_flags({'FLAGS_pallas_force': True})
    want = jemb.apply_update(
        jregistry.LowerCtx(0),
        {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}, attrs)
    assert jcommon._LAST['embedding_update']['reason'] == 'forced_interpret'
    before = common.launches('embedding_update')
    got = tregistry.get('fused_emb_update').run(
        None, {k: [torch.from_numpy(a.copy()) for a in v]
               for k, v in ins.items()}, attrs)
    assert common.launches('embedding_update') == before  # CPU: plain
    touched = _touched(ins, attrs)
    for slot, src in (('ParamOut', 'Param'), ('MomentOut', 'Moment')):
        g, w = got[slot][0].numpy(), np.asarray(want[slot][0])
        np.testing.assert_allclose(g, w, err_msg=slot, **TOL)
        rows = np.arange(g.shape[0])
        untouched = np.array([r not in touched for r in rows])
        assert untouched.any()
        np.testing.assert_array_equal(g[untouched], ins[src][0][untouched])
        pad = attrs['padding_idx']
        if pad >= 0:
            np.testing.assert_array_equal(g[pad], ins[src][0][pad])
        # every touched row but the padding row moved
        moved = [r for r in touched if r != pad]
        assert not np.any(np.all(g[moved] == ins[src][0][moved], axis=1))


def test_plain_equals_the_dense_adagrad_bitwise():
    """The sorted-order row sums scattered into a zero table, then the
    adagrad lowering over the whole table: the same function (a zero
    gradient row takes an exact zero step), bit for bit."""
    ins, attrs = _case('ctr_fields')
    t = {k: [torch.from_numpy(a.copy()) for a in v] for k, v in ins.items()}
    w, ids, g = t['Param'][0], t['Ids'][0], t['Grad'][0]
    got_w, got_m = temb.update_plain(w, t['Moment'][0], ids.reshape(-1),
                                     g.reshape(-1, 16), t['LearningRate'][0],
                                     1e-6)
    dense = temb.scatter_add_plain(w.shape[0], ids.reshape(-1),
                                   g.reshape(-1, 16))
    want = topt.adagrad(None, {'Param': [w], 'Grad': [dense],
                               'Moment': [t['Moment'][0]],
                               'LearningRate': t['LearningRate']},
                        {'epsilon': 1e-6})
    assert torch.equal(got_w, want['ParamOut'][0])
    assert torch.equal(got_m, want['MomentOut'][0])


def test_adagrad_lowering_matches_jax():
    rng = np.random.RandomState(5)
    ins = {'Param': [rng.randn(6, 7).astype('float32')],
           'Grad': [rng.randn(6, 7).astype('float32')],
           'Moment': [np.abs(rng.randn(6, 7)).astype('float32')],
           'LearningRate': [np.float32([0.05])]}
    want = jregistry.get('adagrad').run(
        jregistry.LowerCtx(0),
        {k: [jnp.asarray(a) for a in v] for k, v in ins.items()},
        {'epsilon': 1e-6})
    got = tregistry.get('adagrad').run(
        None, {k: [torch.from_numpy(a) for a in v] for k, v in ins.items()},
        {'epsilon': 1e-6})
    for slot in ('ParamOut', 'MomentOut'):
        np.testing.assert_allclose(got[slot][0].numpy(),
                                   np.asarray(want[slot][0]), rtol=1e-6,
                                   atol=1e-7, err_msg=slot)


def test_cpu_update_leaves_its_inputs_alone():
    ins, attrs = _case('collisions_padding')
    t = {k: [torch.from_numpy(a.copy()) for a in v] for k, v in ins.items()}
    got = temb.apply_update(None, t, attrs)
    assert got['ParamOut'][0] is not t['Param'][0]
    np.testing.assert_array_equal(t['Param'][0].numpy(), ins['Param'][0])
    np.testing.assert_array_equal(t['Moment'][0].numpy(), ins['Moment'][0])


def test_kernel_wrapper_rejects_what_it_does_not_take():
    w = torch.zeros(8, 4)
    ids = torch.zeros(3, dtype=torch.int64)
    g = torch.zeros(3, 4)
    lr = torch.ones(1)
    with pytest.raises(ValueError, match='w and mom'):
        temb.update_kernel(w, torch.zeros(8, 5), ids, g, lr, 1e-6)
    with pytest.raises(TypeError, match='f32 tensors on one device'):
        temb.update_kernel(w, w.clone(), ids, g.double(), lr, 1e-6)
    with pytest.raises(ValueError, match='contiguous'):
        temb.update_kernel(torch.zeros(4, 8).t(), w.clone(), ids, g, lr,
                           1e-6)
    info = common.kernels()['embedding_update']
    assert info['source'] == 'embedding_update.cu'
    assert info['replaces'].startswith(
        'paddle_tpu/ops/pallas/embedding.py:165')
    assert info['op_types'] == ('fused_emb_update',)
