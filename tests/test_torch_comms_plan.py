"""The port's collective planner, collective transpiler and c_* ops
against the JAX package's, on the CPU.

- ``decide``, ``quant_wire_bytes``, ``bucket_grads``,
  ``fuse_cutoff_bytes`` and ``order_axes`` return what the JAX
  package's return over a grid of payloads, participants, dtypes and
  flag settings (no cost model on either side).
- ``GradAllReduce`` over 8 endpoints rewrites an MLP (the one of
  tests/test_comms_plan.py, with Adam, since the port has no SGD yet)
  and a small BERT as the JAX package does, planned and with
  FLAGS_comms_plan off: the programs serialize alike op for op.
- c_allreduce_{sum,max,min,prod}, c_allreduce_fused, c_allgather,
  c_reducescatter and c_broadcast over 4 gloo ranks (the port's
  launcher) against numpy, through an Executor on CPUPlace; each
  planned arm runs and is counted.
- Without a process group every collective is the identity, and a step
  of the transpiled program at one endpoint is bitwise the untranspiled
  step.

Every flag a test sets, in either package, is put back by a fixture,
which also empties both packages' plan registries.
"""

import json
import os

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import comms_plan as jplan
from paddle_tpu.fluid.transpiler import GradAllReduce as JGradAllReduce
from paddle_tpu.models import bert as jbert

import torch

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import comms as tcomms
from paddle_tpu_torch.fluid import comms_plan as tplan
from paddle_tpu_torch.fluid.incubate.fleet.collective import (
    CollectiveOptimizer, DistributedStrategy)
from paddle_tpu_torch.fluid.transpiler import (
    DistributeTranspiler, DistributeTranspilerConfig, GradAllReduce, LocalSGD)
from paddle_tpu_torch.models import bert as tbert

import torch_dist_cases

ENDPOINTS = ['127.0.0.1:%d' % (6170 + i) for i in range(8)]
_FLAG_KEYS = ('FLAGS_comms_plan', 'FLAGS_comms_quantize',
              'FLAGS_comms_quantize_min_bytes', 'FLAGS_comms_quant_block',
              'FLAGS_comms_bucket_bytes', 'FLAGS_comms_fuse_grad_max_bytes',
              'FLAGS_comms_rs_ag_min_bytes', 'FLAGS_comms_model_path',
              'FLAGS_comms_hbm_budget_bytes')


@pytest.fixture(autouse=True)
def restore_flags():
    jkeys = _FLAG_KEYS + ('FLAGS_pallas_force',
                          'FLAGS_pallas_quant_collective')
    jsaved = jfluid.get_flags(list(jkeys))
    tsaved = tfluid.get_flags(list(_FLAG_KEYS))
    yield
    jfluid.set_flags(jsaved)
    tfluid.set_flags(tsaved)
    jplan.reset()
    tcomms.reset()
    tplan.reset()


def _set(flags):
    jfluid.set_flags(dict(flags))
    tfluid.set_flags(dict(flags))


FLAG_GRID = [
    {},
    {'FLAGS_comms_quantize': True},
    {'FLAGS_comms_quantize': True, 'FLAGS_comms_quantize_min_bytes': 256,
     'FLAGS_comms_quant_block': 64},
    {'FLAGS_comms_rs_ag_min_bytes': 1 << 16, 'FLAGS_comms_bucket_bytes': 0},
    {'FLAGS_comms_quant_block': 3, 'FLAGS_comms_quantize': True,
     'FLAGS_comms_fuse_grad_max_bytes': 1 << 20,
     'FLAGS_comms_bucket_bytes': 1 << 19},
]


@pytest.mark.parametrize('flags', FLAG_GRID, ids=range(len(FLAG_GRID)))
def test_decisions_match_jax(flags):
    _set(flags)
    for payload in (0, 100, 4096, 65535, 65536, 1 << 20, 8 << 20, 1e9):
        for itemsize in (1, 2, 4, 8):
            for n in (1, 2, 3, 8, 64):
                for forced in (None, 'quant', 'dense'):
                    assert tplan.decide(payload, itemsize, n, forced) == \
                        jplan.decide(payload, itemsize, n, forced), \
                        (payload, itemsize, n, forced)
                assert tplan.quant_wire_bytes(payload, itemsize, n) == \
                    jplan.quant_wire_bytes(payload, itemsize, n)
    assert tplan.fuse_cutoff_bytes() == jplan.fuse_cutoff_bytes()
    assert tplan.bucket_cap_bytes() == jplan.bucket_cap_bytes()
    assert tplan.quant_block() == jplan.quant_block()


@pytest.mark.parametrize('flags', FLAG_GRID[:1] + FLAG_GRID[3:],
                         ids=range(3))
def test_buckets_and_axis_order_match_jax(flags):
    _set(flags)
    rs = np.random.RandomState(5)
    grads = [('g%d' % i, int(b), dt) for i, (b, dt) in enumerate(zip(
        rs.choice([0, 4, 1024, 60000, 65536, 1 << 18, 3 << 20], size=60),
        rs.choice(['float32', 'float16', 'float32', 'bfloat16'], size=60)))]
    assert tplan.bucket_grads(grads) == jplan.bucket_grads(grads)
    for cap, cut in ((1 << 16, None), (1 << 20, 4096), (0, None)):
        assert tplan.bucket_grads(grads, cap, cut) == \
            jplan.bucket_grads(grads, cap, cut)
    axes = [('dp', 8), ('mp', 2), ('pp', 8), ('a', 1)]
    assert tplan.order_axes(axes) == jplan.order_axes(axes) == \
        ['dp', 'pp', 'mp', 'a']


def test_unported_gates_raise_and_buckets_are_verified():
    tfluid.set_flags({'FLAGS_comms_model_path': 'comms_model.json'})
    with pytest.raises(NotImplementedError, match='item 12'):
        tplan.decide(1 << 20, 4, 8)
    tfluid.set_flags({'FLAGS_comms_model_path': '',
                      'FLAGS_comms_hbm_budget_bytes': 1 << 30})
    with pytest.raises(NotImplementedError, match='memviz'):
        tplan.bucket_grads([('a', 4, 'float32')])
    tfluid.set_flags({'FLAGS_comms_hbm_budget_bytes': 0})
    main, _, _ = _mlp(tfluid)
    block = main.global_block()
    w = main.all_parameters()[0].name + '@GRAD'
    with pytest.raises(ValueError, match='reduce twice.*no block declares'):
        tplan.verify_buckets(block, [{'names': [w], 'bytes': 4,
                                      'dtype': 'float32'},
                                     {'names': [w, 'nope'], 'bytes': 8,
                                      'dtype': 'float32'}])


# ------------------------------------------------------------ rewrites
def _mlp(fluid, width=64, seed=3):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=[width], dtype='float32')
        h = fluid.layers.fc(x, width, act='relu')
        loss = fluid.layers.mean(fluid.layers.fc(h, 1))
        fluid.optimizer.Adam(0.1).minimize(loss)
    return main, startup, loss


def _small_bert(fluid, bert_mod):
    cfg = bert_mod.BertConfig(vocab_size=1000, hidden=64, layers=2, heads=4,
                              intermediate=128, max_pos=64, dropout=0.0,
                              attn_dropout=0.1)
    cfg.flash_min_len = 0
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = bert_mod.build_pretrain(cfg, seq_len=64)
        fluid.optimizer.Adam(learning_rate=1e-3, epsilon=1e-6).minimize(loss)
    return main, startup, loss


def _assert_same_ops(jprog, tprog):
    jb, tb = jprog.to_dict()['blocks'][0], tprog.to_dict()['blocks'][0]
    assert [o['type'] for o in jb['ops']] == [o['type'] for o in tb['ops']]
    for jo, to in zip(jb['ops'], tb['ops']):
        assert jo['inputs'] == to['inputs'], jo['type']
        assert jo['outputs'] == to['outputs'], jo['type']
        strip = ('__op_callstack__',)
        assert {k: v for k, v in jo['attrs'].items() if k not in strip} == \
            {k: v for k, v in to['attrs'].items() if k not in strip}, \
            jo['type']
    return [o['type'] for o in tb['ops']]


@pytest.mark.parametrize('model', ['mlp', 'bert'])
@pytest.mark.parametrize('planned', [True, False])
def test_grad_allreduce_serializes_like_jax(model, planned):
    _set({'FLAGS_comms_plan': planned})
    if model == 'mlp':
        jmain, jstartup, _ = _mlp(jfluid)
        tmain, tstartup, _ = _mlp(tfluid)
    else:
        jmain, jstartup, _ = _small_bert(jfluid, jbert)
        tmain, tstartup, _ = _small_bert(tfluid, tbert)
    JGradAllReduce().transpile(jstartup, jmain, 0, ENDPOINTS, ENDPOINTS[0])
    GradAllReduce().transpile(tstartup, tmain, 0, ENDPOINTS, ENDPOINTS[0])
    types = _assert_same_ops(jmain, tmain)
    n_adam = types.count('adam')
    if planned:
        assert types.count('c_allreduce_fused') >= 1
        n_coll = types.count('c_allreduce_fused') + \
            types.count('c_allreduce_sum')
        assert n_coll < n_adam
    else:
        assert types.count('c_allreduce_sum') == n_adam
        assert 'c_allreduce_fused' not in types
    assert tmain._collective_dp and jmain._collective_dp
    scales = [op.attrs['scale'] for op in tmain.global_block().ops
              if op.type == 'scale' and op.attrs['__op_role__'] == 'forward'
              and '@GRAD' in op.input('X')[0]]
    assert scales and set(scales) == {1.0 / 8}


def test_transpiled_bert_plan_matches_bucket_count():
    tmain, tstartup, _ = _small_bert(tfluid, tbert)
    GradAllReduce().transpile(tstartup, tmain, 0, ENDPOINTS, ENDPOINTS[0])
    (summary,) = tplan.program_plans()['programs'].values()
    ops = tmain.global_block().ops
    n_coll = sum(op.type in ('c_allreduce_sum', 'c_allreduce_fused')
                 for op in ops)
    assert len(summary['buckets']) == n_coll and summary['nranks'] == 8
    # the collectives sit between the last grad op and the first adam op
    idx = [i for i, op in enumerate(ops)
           if op.type in ('c_allreduce_sum', 'c_allreduce_fused')]
    last_grad = max(i for i, op in enumerate(ops)
                    if op.type.endswith('_grad') or op.type == 'sum')
    first_adam = min(i for i, op in enumerate(ops) if op.type == 'adam')
    assert last_grad < min(idx) and max(idx) < first_adam


def test_other_entry_points():
    """LocalSGD, the parameter-server transpiler modes and the unported
    fleet strategies raise; nccl2 mode marks the program; the fleet
    optimizer inserts un-planned all-reduces (nranks 1 without a
    group)."""
    main, startup, loss = _mlp(tfluid)
    with pytest.raises(NotImplementedError, match='item 12'):
        LocalSGD().transpile(startup, main, 0, ENDPOINTS, ENDPOINTS[0])
    cfg = DistributeTranspilerConfig()
    t = DistributeTranspiler(cfg)
    t.transpile(0, program=main, trainers=2)
    assert main._collective_dp and t.get_trainer_program() is main
    cfg.mode = 'pserver'
    with pytest.raises(NotImplementedError, match='item 14'):
        DistributeTranspiler(cfg).transpile(0, program=main)
    for field in ('use_amp', 'use_recompute', 'use_local_sgd'):
        s = DistributedStrategy()
        setattr(s, field, True)
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            CollectiveOptimizer(tfluid.optimizer.Adam(0.1), s).minimize(loss)
    fmain, fstartup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(fmain, fstartup):
        x = tfluid.layers.data('x', shape=[8], dtype='float32')
        floss = tfluid.layers.mean(tfluid.layers.fc(x, 1))
        _, pg = CollectiveOptimizer(tfluid.optimizer.Adam(0.1)).minimize(
            floss)
    types = [op.type for op in fmain.global_block().ops]
    assert types.count('c_allreduce_sum') == len(pg) == 2
    assert fmain._collective_dp
    ar = [op for op in fmain.global_block().ops
          if op.type == 'c_allreduce_sum']
    assert all('plan' not in op.attrs for op in ar)


# ---------------------------------------------------------- one rank
def _step(main, startup, loss, feed):
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        out = [exe.run(main, feed=feed, fetch_list=[loss])[0]
               for _ in range(2)]
        state = {p.name: scope.find_var(p.name).clone()
                 for p in main.all_parameters()}
    return out, state


def test_one_rank_is_the_identity():
    feed = {'x': np.random.RandomState(0).rand(4, 64).astype('float32')}
    base = _step(*_mlp(tfluid), feed)
    main, startup, loss = _mlp(tfluid)
    GradAllReduce().transpile(startup, main, 0, ENDPOINTS[:1], ENDPOINTS[0])
    assert {op.attrs['scale'] for op in main.global_block().ops
            if op.type == 'scale' and op.attrs['__op_role__'] == 'forward'} \
        == {1.0}
    got = _step(main, startup, loss, feed)
    assert [float(a) for a in got[0]] == [float(b) for b in base[0]]
    for n, v in base[1].items():
        assert torch.equal(got[1][n], v), n
    assert tcomms.arm_counts() == {'dense': 0, 'rs_ag': 0, 'quant': 0}
    from paddle_tpu_torch.ops import registry
    ctx = registry.LowerCtx(1)
    x = torch.arange(6.0).reshape(3, 2)
    for t in ('c_allreduce_sum', 'c_allreduce_max', 'c_allreduce_prod',
              'c_allgather', 'c_reducescatter', 'c_broadcast', 'barrier'):
        assert registry.get(t).run(ctx, {'X': [x]}, {})['Out'][0] is x, t
    assert registry.get('c_allreduce_fused').run(
        ctx, {'X': [x, x]}, {'plan': True})['Out'] == [x, x]


# --------------------------------------------------------- four ranks
_OPS_WORKER = torch_dist_cases.PRELUDE + r'''
import json
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import comms
rs = np.random.RandomState(rank)
feeds = {'x': (rs.rand(8, 3) + 0.5).astype('float32'),
         'y': rs.randn(5).astype('float32'),
         'z': rs.randn(300).astype('float32'),
         'w': rs.randn(6).astype('float32')}
if rank == 2:
    feeds['w'][0] = 0.0
main = fluid.Program()
block = main.global_block()
for n, v in feeds.items():
    block.create_var(name=n, shape=v.shape, dtype='float32')
outs = []

def op(type, ins, attrs, n_out=1):
    names = ['%s_%d' % (type, len(outs) + i) for i in range(n_out)]
    for n in names:
        block.create_var(name=n, shape=(), dtype='float32')
    block.append_op(type, inputs={'X': ins}, outputs={'Out': names},
                    attrs=attrs, infer_shape=False)
    outs.extend(names)

for t in ('c_allreduce_sum', 'c_allreduce_max', 'c_allreduce_min',
          'c_allreduce_prod', 'c_allgather', 'c_reducescatter',
          'c_sync_calc_stream'):
    op(t, ['x'], {'ring_id': 0})
op('c_broadcast', ['x'], {'ring_id': 0, 'root': 2})
op('c_allreduce_sum', ['x'], {'ring_id': 0, 'plan': True})
op('c_allreduce_sum', ['x'], {'ring_ids': [0], 'plan': True})
op('c_allreduce_sum', ['z'], {'ring_id': 0, 'plan_arm': 'quant'})
op('c_allreduce_fused', ['x', 'y'], {'ring_id': 0, 'plan': True}, 2)
op('c_sync_comm_stream', ['x', 'y'], {}, 2)
op('barrier', ['y'], {})
op('c_allreduce_prod', ['w'], {'ring_id': 0})
main._collective_dp = True
fluid.set_flags({'FLAGS_comms_quant_block': 64})
exe = fluid.Executor(fluid.CPUPlace())
got = exe.run(main, feed=feeds, fetch_list=outs)
arms = comms.arm_counts()
fluid.set_flags({'FLAGS_comms_rs_ag_min_bytes': 1})
rs_ag = exe.run(main, feed=feeds, fetch_list=outs[8:10])
arms_rs = comms.arm_counts()
np.savez(os.path.join(sys.argv[1], 'rank%d.npz' % rank),
         **{n: v for n, v in zip(outs, got)},
         **{'rs_ag_' + n: v for n, v in zip(outs[8:10], rs_ag)})
with open(os.path.join(sys.argv[1], 'rank%d.json' % rank), 'w') as f:
    json.dump({'names': outs, 'arms': arms, 'arms_rs': arms_rs}, f)
'''


@pytest.fixture(scope='module')
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('c_ops')
    torch_dist_cases.launch(tmp, _OPS_WORKER, 4, args=[str(tmp)])
    res = []
    for r in range(4):
        with open(os.path.join(str(tmp), 'rank%d.json' % r)) as f:
            meta = json.load(f)
        arrs = np.load(os.path.join(str(tmp), 'rank%d.npz' % r))
        res.append((meta, {k: arrs[k] for k in arrs.files}))
    return res


def _feeds(r):
    rs = np.random.RandomState(r)
    feeds = {'x': (rs.rand(8, 3) + 0.5).astype('float32'),
             'y': rs.randn(5).astype('float32'),
             'z': rs.randn(300).astype('float32'),
             'w': rs.randn(6).astype('float32')}
    if r == 2:
        feeds['w'][0] = 0.0
    return feeds


def test_c_ops_over_four_ranks_match_numpy(four_ranks):
    xs = np.stack([_feeds(r)['x'] for r in range(4)]).astype('float64')
    ys = np.stack([_feeds(r)['y'] for r in range(4)]).astype('float64')
    for r, (meta, got) in enumerate(four_ranks):
        v = [got[n] for n in meta['names']]
        np.testing.assert_allclose(v[0], xs.sum(0), rtol=1e-6)
        np.testing.assert_array_equal(v[1], xs.max(0).astype('float32'))
        np.testing.assert_array_equal(v[2], xs.min(0).astype('float32'))
        np.testing.assert_allclose(v[3], xs.prod(0), rtol=1e-6)
        np.testing.assert_array_equal(
            v[4], np.concatenate([_feeds(k)['x'] for k in range(4)]))
        np.testing.assert_allclose(v[5], xs.sum(0)[2 * r:2 * r + 2],
                                   rtol=1e-6)
        np.testing.assert_array_equal(v[6], _feeds(r)['x'])
        np.testing.assert_array_equal(v[7], _feeds(2)['x'])
        np.testing.assert_allclose(v[8], xs.sum(0), rtol=1e-6)
        np.testing.assert_allclose(v[9], xs.sum(0), rtol=1e-6)
        np.testing.assert_allclose(v[11], xs.sum(0), rtol=1e-6)
        np.testing.assert_allclose(v[12], ys.sum(0), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(v[13], _feeds(r)['x'])
        np.testing.assert_array_equal(v[15], _feeds(r)['y'])
        np.testing.assert_allclose(got['rs_ag_' + meta['names'][8]],
                                   xs.sum(0), rtol=1e-6)
        # the planned arms ran and were counted: 3 dense (sum, the
        # ring list, the fused bucket) and 1 quant a run; the second
        # run, with every dense payload past the rs_ag floor, adds 3
        # rs_ag and 1 quant
        assert meta['arms'] == {'dense': 3, 'rs_ag': 0, 'quant': 1}
        assert meta['arms_rs'] == {'dense': 3, 'rs_ag': 3, 'quant': 2}
        # every rank got the same sums
        for i in (0, 3, 8, 10, 11):
            np.testing.assert_array_equal(
                v[i], four_ranks[0][1][meta['names'][i]])


def test_quant_arm_over_four_ranks_is_near_the_sum(four_ranks):
    zs = np.stack([_feeds(r)['z'] for r in range(4)]).astype('float64')
    meta, got = four_ranks[1]
    q = got[meta['names'][10]]
    # block 64, 4 ranks: each rank's rounding and the requantize move an
    # element by at most half a step each
    step = np.abs(zs).max() / 127.0
    assert np.abs(q - zs.sum(0)).max() <= 5 * step / 2
    assert not np.allclose(q, zs.sum(0), rtol=1e-6, atol=0)


def test_c_allreduce_prod_takes_signs_and_zeros(four_ranks):
    """c_allreduce_prod over entries of both signs and a zero on one
    rank: numpy's product, as the reference's ncclProd gives it.  The
    JAX package's exp(psum(log x)) is no oracle here: it is NaN wherever
    a rank's entry is negative."""
    ws = np.stack([_feeds(r)['w'] for r in range(4)]).astype('float64')
    assert (ws < 0).any(axis=0).any() and (ws == 0).any()
    for meta, got in four_ranks:
        v = got[meta['names'][16]]
        np.testing.assert_allclose(v, ws.prod(0), rtol=1e-6, atol=0)
        assert v[0] == 0.0 and np.sign(v[1:]).tolist() == np.sign(
            ws.prod(0)[1:]).tolist()
