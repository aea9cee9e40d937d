"""Edge cases of the sparse Adagrad row update (K7) on the CPU: the
port's plain version (``update_plain``) and its ``fused_emb_update`` op
against the JAX package's ``_update_kernel`` run in interpret mode
(``embedding.apply_update`` with FLAGS_pallas_force; every table has at
least the JAX gate's 512 rows), for one id, all ids equal, a 512-row
table, D = 1, 3 and 17, and a run of 600 equal ids among uniform ones;
and the kernel wrapper's refusal of tables and id counts past int32,
raised before any library is loaded.

Tolerance rtol = atol = 2e-6, the JAX package's own bound between its
kernel and its dense path (tests/test_pallas_kernels.py): 1-2 ulp where
XLA contracts a multiply-add.  Rows no id names come out bit for bit as
they went in.  The fixture restores the JAX package's FLAGS_pallas_*
flags.
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
    """(ins as numpy, attrs) of one update; ids [n], Grad [n, D]."""
    rng = np.random.RandomState(3)
    v, d = 600, 16
    if name == 'one_id':
        ids = np.array([7], 'int64')
    elif name == 'all_equal':
        ids = np.full(200, 555, 'int64')
    elif name == 'v512':
        v = 512
        ids = rng.randint(-5, 520, 300).astype('int64')
    elif name in ('d1', 'd3', 'd17'):
        d = int(name[1:])
        ids = rng.randint(-2, 603, 256).astype('int64')
    else:  # 'run600': a run of 600 equal ids among uniform ones
        v, d = 700, 4
        ids = rng.randint(0, 700, 900).astype('int64')
        ids[100:700] = 42
    ins = {'Param': [rng.randn(v, d).astype('float32')],
           'Moment': [np.abs(rng.randn(v, d)).astype('float32')],
           'Ids': [ids],
           'Grad': [rng.randn(ids.size, d).astype('float32')],
           'LearningRate': [np.float32([0.1])]}
    return ins, {'epsilon': 1e-6, 'padding_idx': -1}


CASES = ['one_id', 'all_equal', 'v512', 'd1', 'd3', 'd17', 'run600']


def _jax_update(ins, attrs):
    j_set_flags({'FLAGS_pallas_force': True})
    want = jemb.apply_update(
        jregistry.LowerCtx(0),
        {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}, attrs)
    assert jcommon._LAST['embedding_update']['reason'] == 'forced_interpret'
    return [np.asarray(want['ParamOut'][0]), np.asarray(want['MomentOut'][0])]


@pytest.mark.parametrize('entry', ['plain', 'op'])
@pytest.mark.parametrize('name', CASES)
def test_update_matches_pallas_interpret(name, entry):
    ins, attrs = _case(name)
    want = _jax_update(ins, attrs)
    t = {k: [torch.from_numpy(a.copy()) for a in v] for k, v in ins.items()}
    before = common.launches('embedding_update')
    if entry == 'plain':
        got = temb.update_plain(t['Param'][0], t['Moment'][0], t['Ids'][0],
                                t['Grad'][0], t['LearningRate'][0],
                                attrs['epsilon'])
    else:
        out = tregistry.get('fused_emb_update').run(None, t, attrs)
        got = (out['ParamOut'][0], out['MomentOut'][0])
    assert common.launches('embedding_update') == before  # CPU: plain
    v = ins['Param'][0].shape[0]
    touched = np.zeros(v, bool)
    touched[np.clip(ins['Ids'][0], 0, v - 1)] = True
    for slot, g, w, src in zip(('ParamOut', 'MomentOut'), got, want,
                               (ins['Param'][0], ins['Moment'][0])):
        g = g.numpy()
        np.testing.assert_allclose(g, w, err_msg=slot, **TOL)
        np.testing.assert_array_equal(g[~touched], src[~touched])
        assert not np.any(np.all(g[touched] == src[touched], axis=1))


def _refuse_library(monkeypatch):
    def refuse(source):
        raise AssertionError('loaded %s before checking sizes' % source)
    monkeypatch.setattr(common, 'library', refuse)


def test_kernel_refuses_tables_past_int32(monkeypatch):
    """Checked ahead of contiguity, so an expanded view stands in for
    the 2**31-row table."""
    _refuse_library(monkeypatch)
    w = torch.zeros(1, 1).expand(2 ** 31, 1)
    with pytest.raises(ValueError, match='fewer than 2\\*\\*31'):
        temb.update_kernel(w, w, torch.zeros(2, dtype=torch.int64),
                           torch.zeros(2, 1), torch.ones(1), 1e-6)


def test_kernel_refuses_id_counts_past_int32(monkeypatch):
    _refuse_library(monkeypatch)
    w = torch.zeros(4, 1)
    ids = torch.zeros(1, dtype=torch.int64).expand(2 ** 31)
    g = torch.zeros(1, 1).expand(2 ** 31, 1)
    with pytest.raises(ValueError, match='fewer than 2\\*\\*31'):
        temb.update_kernel(w, w.clone(), ids, g, torch.ones(1), 1e-6)
