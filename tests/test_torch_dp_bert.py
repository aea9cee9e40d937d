"""The port's data-parallel BERT slice against the JAX package's, on the
CPU: the attention-dropout masks at a rank's rows of the global batch,
and BERT pretraining under ``ReduceStrategy.Reduce`` with Adam.

- The keep mask with a head-index offset (``dropout_g_offset``, rank r
  of local batch B passes r * B * H) is bitwise the JAX package's
  ``dropout_keep_dense`` with ``g_off``, at offsets 0, 24 and 2**20.
- The plain flash forward and backward on a half batch with its offset
  are bitwise the full batch's rows: the same mask bits and the same
  arithmetic a row.
- BERT (2 layers, hidden 64, 4 heads, vocab 1000, positions 512) at
  seq 512, where the encoder takes the fused attention op (the flash
  route), attention dropout 0.1, hidden dropout 0, Adam (lr 1e-3,
  epsilon 1e-6) under ``ReduceStrategy.Reduce``: 3 steps on 2 gloo
  ranks of 2 rows, from the JAX package's startup values, against the
  JAX package's ``with_data_parallel`` over 2 devices of the global
  batch of 4.  The losses to rtol 1e-5 and the parameters to atol 1e-5,
  the single-card Adam parity test's bounds (tests/test_torch_train_
  parity.py, and why there); the ranks bitwise in sync after every
  step; each rank holding half the rows of every moment whose dim 0 is
  even.
- The dropout op under ``with_data_parallel`` draws a different mask
  on each rank, each keeping ~1 - p.
"""

import json
import os

import numpy as np
import pytest

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops.pallas import flash_attention as jfa

import torch

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

import torch_dist_cases

RATE = 0.1
SEQ = 512
BATCH = 4
STEPS = 3
SEED = 0x9E3779B9 ^ 4242

_NET = '''
def bert_cfg(bert):
    return bert.BertConfig(vocab_size=1000, hidden=64, layers=2, heads=4,
                           intermediate=128, max_pos=512, dropout=0.0,
                           attn_dropout=0.1)


def bert_program(fluid, bert):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = bert.build_pretrain(bert_cfg(bert), seq_len=512)
        fluid.optimizer.Adam(learning_rate=1e-3, epsilon=1e-6).minimize(loss)
    return main, startup, loss


def reduce_strategy(fluid):
    bs = fluid.BuildStrategy()
    bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
    return bs


def dropout_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=[256], dtype='float32')
        out = fluid.layers.dropout(x, 0.3)
    return main, out
'''
exec(_NET)


@pytest.mark.parametrize('g_offset', [0, 24, 2 ** 20])
def test_keep_mask_with_offset_is_the_jax_hash(g_offset):
    b, h, t = 2, 12, 64
    want = np.asarray(jfa.dropout_keep_dense(jnp.uint32(SEED), b, h, t, t,
                                             g_off=g_offset, rate=RATE))
    got = tfa.dropout_keep_plain(SEED, b, h, t, t, RATE,
                                 g_offset=g_offset).numpy()
    np.testing.assert_array_equal(got, want)
    assert abs(got.mean() - (1 - RATE)) < 0.02


def test_offset_masks_are_the_global_batch_rows():
    """Rank r's masks (local batch 2 of 4, offset r * 2 * H) are rows
    [2r, 2r + 2) of the global batch's."""
    b, h, t = 4, 3, 32
    whole = tfa.dropout_keep_plain(SEED, b, h, t, t, RATE)
    for r in range(2):
        part = tfa.dropout_keep_plain(SEED, 2, h, t, t, RATE,
                                      g_offset=r * 2 * h)
        assert torch.equal(part, whole[2 * r:2 * r + 2])


def _qkv(b, t, h, d, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, do = [torch.from_numpy(rng.randn(b, t, h, d).astype('float32'))
                   for _ in range(4)]
    bias = torch.from_numpy(np.where(rng.rand(b, t) < 0.2, -10000.0,
                                     0.0).astype('float32'))
    return q, k, v, do, bias


def test_plain_forward_and_backward_on_half_batches_are_bitwise_rows():
    b, t, h, d = 4, 64, 2, 16
    q, k, v, do, bias = _qkv(b, t, h, d)
    o, lse = tfa.flash_attention_plain(q, k, v, False, bias, RATE, SEED)
    grads = tfa.flash_attention_bwd_plain(q, k, v, bias, do, None, False,
                                          RATE, SEED, bias_grad=True)
    for r in range(2):
        rows = slice(2 * r, 2 * r + 2)
        po, plse = tfa.flash_attention_plain(
            q[rows], k[rows], v[rows], False, bias[rows], RATE, SEED,
            dropout_g_offset=r * 2 * h)
        assert torch.equal(po, o[rows]) and torch.equal(plse, lse[rows])
        part = tfa.flash_attention_bwd_plain(
            q[rows], k[rows], v[rows], bias[rows], do[rows], None, False,
            RATE, SEED, bias_grad=True, dropout_g_offset=r * 2 * h)
        for got, want in zip(part, grads):
            assert torch.equal(got, want[rows])


def test_offset_changes_the_masks():
    b, t, h, d = 2, 64, 2, 16
    q, k, v, _, bias = _qkv(b, t, h, d)
    o0, _ = tfa.flash_attention_plain(q, k, v, False, bias, RATE, SEED)
    o1, _ = tfa.flash_attention_plain(q, k, v, False, bias, RATE, SEED,
                                      dropout_g_offset=b * h)
    assert not torch.equal(o0, o1)


_WORKER = torch_dist_cases.PRELUDE + _NET + r'''
import json
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import bert
out_dir = sys.argv[1]
place = fluid.CPUPlace()
state = dict(np.load(os.path.join(out_dir, 'state.npz')))
batch = dict(np.load(os.path.join(out_dir, 'batch.npz')))
n = len(batch['src_ids']) // world
rows = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
main, startup, loss = bert_program(fluid, bert)
assert sum(op.type == 'fused_multihead_attention'
           for op in main.global_block().ops) == 2
params = sorted(p.name for p in main.all_parameters())
result = {'losses': [], 'synced': []}
exe, scope = fluid.Executor(place), fluid.Scope()
with fluid.scope_guard(scope):
    exe.run(startup)
    weights.load_numpy_params(scope, state, place, startup)
    prog = fluid.CompiledProgram(main).with_data_parallel(
        loss.name, build_strategy=reduce_strategy(fluid))
    for _ in range(3):
        result['losses'].append(float(exe.run(prog, feed=rows,
                                              fetch_list=[loss])[0]))
        flat = torch.cat([scope.find_var(p).reshape(-1) for p in params])
        every = [torch.empty_like(flat) for _ in range(world)]
        dist.all_gather(every, flat)
        result['synced'].append(all(torch.equal(e, every[0])
                                    for e in every))
    result['rows'] = {k: list(scope.find_var(k).shape) for k in state}
    final = weights.numpy_state(scope, sorted(state))
    result['step'] = exe._step
if rank == 0:
    np.savez(os.path.join(out_dir, 'final.npz'), **final)

# the dropout op: each rank its own mask
main, out = dropout_program(fluid)
exe = fluid.Executor(place)
prog = fluid.CompiledProgram(main).with_data_parallel()
x = np.ones((4, 256), 'float32')
with fluid.scope_guard(fluid.Scope()):
    got = exe.run(prog, feed={'x': x}, fetch_list=[out])[0]
result['dropout'] = got.tolist()
with open(os.path.join(out_dir, 'rank%d.json' % rank), 'w') as f:
    json.dump(result, f)
assert 'jax' not in sys.modules
'''


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp('dpbert'))
    batch = tbert.synthetic_batch(bert_cfg(tbert), BATCH, SEQ,
                                  np.random.RandomState(0))
    jmain, jstartup, jloss = bert_program(jfluid, jbert)
    names = weights.startup_names(bert_program(tfluid, tbert)[1])
    exe, scope = jfluid.Executor(jfluid.XLAPlace(0)), jfluid.Scope()
    ranks = None
    try:
        with jfluid.scope_guard(scope):
            exe.run(jstartup)
            state = weights.numpy_state(scope, names)
            np.savez(os.path.join(tmp, 'state.npz'), **state)
            np.savez(os.path.join(tmp, 'batch.npz'), **batch)
            ranks = torch_dist_cases.Ranks(tmp, _WORKER, 2, args=[tmp],
                                           timeout=200)
            prog = jfluid.CompiledProgram(jmain).with_data_parallel(
                jloss.name, build_strategy=reduce_strategy(jfluid),
                places=[jfluid.XLAPlace(i) for i in range(2)])
            losses = [float(np.asarray(exe.run(prog, feed=batch,
                                               fetch_list=[jloss])[0]))
                      for _ in range(STEPS)]
            final = weights.numpy_state(scope, names)
            jstep = exe._step
        ranks.wait()
    finally:
        if ranks is not None:
            ranks.kill()
    port = []
    for r in range(2):
        with open(os.path.join(tmp, 'rank%d.json' % r)) as f:
            port.append(json.load(f))
    return {'jax': {'losses': losses, 'final': final, 'step': jstep},
            'port': port, 'final': dict(np.load(os.path.join(tmp,
                                                             'final.npz')))}


def test_bert_reduce_losses_match_jax(runs):
    np.testing.assert_allclose(runs['port'][0]['losses'],
                               runs['jax']['losses'], rtol=1e-5)
    assert runs['port'][0]['step'] == runs['jax']['step'] == 1 + STEPS
    for res in runs['port']:
        assert res['synced'] == [True] * STEPS
        assert res['losses'] == runs['port'][0]['losses']


def test_bert_reduce_parameters_match_jax(runs):
    want, got = runs['jax']['final'], runs['final']
    params = [n for n in want if '_moment' not in n and '_pow_acc_' not in n
              and n != 'learning_rate_0']
    assert len(params) == 33
    for n in params:
        np.testing.assert_allclose(got[n], want[n], atol=1e-5, rtol=0,
                                   err_msg=n)


def test_bert_reduce_shards_the_moments(runs):
    full = runs['final']
    moments = [n for n in full if '_moment' in n]
    assert len(moments) == 2 * 33
    halved = 0
    for res in runs['port']:
        for n in moments:
            shape = list(full[n].shape)
            if shape[0] % 2 == 0 and shape[0] > 1:
                assert res['rows'][n] == [shape[0] // 2] + shape[1:], n
                halved += 1
            else:
                assert res['rows'][n] == shape, n
    # every moment but those of the 2-row sentence table's... none: its
    # dim 0 is 2, so all 66 are halved on both ranks
    assert halved == 2 * 66


def test_dropout_op_draws_per_rank(runs):
    """Both ranks feed ones: the fetched output, gathered in rank order,
    holds each rank's mask."""
    out = np.asarray(runs['port'][0]['dropout'])
    assert out.shape == (8, 256)
    assert np.array_equal(out, np.asarray(runs['port'][1]['dropout']))
    masks = out != 0
    assert not np.array_equal(masks[:4], masks[4:])
    for m in (masks[:4], masks[4:]):
        assert abs(m.mean() - 0.7) < 0.05
