"""The port's collective data-parallel training slice against the JAX
package's, on the CPU.

The small BERT of tests/test_torch_train_parity.py (2 layers, hidden 64,
4 heads, vocab 1000, seq 64, the fused attention op with attention
dropout 0.1, hidden dropout 0) with Adam (lr 1e-3, epsilon 1e-6) is
rewritten by ``GradAllReduce`` over 8 endpoints and takes 3 steps on a
global batch of 8:

- in the JAX package, by the executor's ``run_collective`` on the
  conftest's 8-device CPU mesh (each device its batch row);
- in the port, on 8 gloo ranks started by its launcher, each fed its
  row and starting from the JAX package's startup values.

Both run once with ``FLAGS_comms_quantize`` on (floor 256 bytes, so
every planned collective takes the quantized arm; the JAX package runs
its dense element arm, bitwise its Pallas kernels per
tests/test_pallas_kernels.py) and once with it off (the dense arm:
flat all-reduce).  The step counters line up (startup is step 1), so
the attention-dropout masks are the same on every rank and in both
packages.

Tolerances, and why: the losses to rtol 1e-5, as in the single-card
parity test.  Dense arm: the parameters to the Adam parity test's atol
1e-5 (the ranks' sums in gloo's order against XLA's).  Quantized arm:
the same atol on all but a share of at most 1e-4 of the elements,
each within 3 lr: a gradient that differs by an f32 rounding between
the packages can put an element across a rounding boundary of the int8
codes, and Adam's first step moves a parameter by lr times the sign of
its gradient whatever its size, so one flipped code can move that
element by up to 2 lr a step.  The per-arm count shows the quantized
arm for every collective of every step, the two arms give different
parameters, and after every step every rank's parameters are bitwise
rank 0's.
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

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import bert as tbert

import torch_dist_cases

SEQ = 64
STEPS = 3
RANKS = 8
LR = 1e-3
ENDPOINTS = ['127.0.0.1:%d' % (6170 + i) for i in range(RANKS)]
ARMS = ('quant', 'dense')


def _cfg(bert_mod):
    cfg = bert_mod.BertConfig(vocab_size=1000, hidden=64, layers=2,
                              heads=4, intermediate=128, max_pos=64,
                              dropout=0.0, attn_dropout=0.1)
    cfg.flash_min_len = 0
    return cfg


def _build(fluid, bert_mod):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = bert_mod.build_pretrain(_cfg(bert_mod), seq_len=SEQ)
        fluid.optimizer.Adam(learning_rate=LR, epsilon=1e-6).minimize(loss)
    return main, startup, loss


def _flags(arm):
    return {'FLAGS_comms_quantize': arm == 'quant',
            'FLAGS_comms_quantize_min_bytes': 256}


_WORKER = torch_dist_cases.PRELUDE + r'''
import json
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.fluid import comms
from paddle_tpu_torch.fluid.transpiler import GradAllReduce
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.ops.kernels import common
out_dir = sys.argv[1]
state = dict(np.load(os.path.join(out_dir, 'state.npz')))
batch = dict(np.load(os.path.join(out_dir, 'batch.npz')))
cfg = bert.BertConfig(vocab_size=1000, hidden=64, layers=2, heads=4,
                      intermediate=128, max_pos=64, dropout=0.0,
                      attn_dropout=0.1)
cfg.flash_min_len = 0
main, startup = fluid.Program(), fluid.Program()
main.random_seed = startup.random_seed = 7
with fluid.unique_name.guard(), fluid.program_guard(main, startup):
    _, _, loss = bert.build_pretrain(cfg, seq_len=64)
    fluid.optimizer.Adam(learning_rate=%(lr)r, epsilon=1e-6).minimize(loss)
GradAllReduce().transpile(startup, main, rank,
                          os.environ['PADDLE_TRAINER_ENDPOINTS'].split(','),
                          os.environ['PADDLE_CURRENT_ENDPOINT'])
params = sorted(p.name for p in main.all_parameters())
shard = {k: v[rank:rank + 1] for k, v in batch.items()}
result = {'n_coll': sum(op.type in ('c_allreduce_sum', 'c_allreduce_fused')
                        for op in main.global_block().ops)}
for arm in ('quant', 'dense'):
    fluid.set_flags({'FLAGS_comms_quantize': arm == 'quant',
                     'FLAGS_comms_quantize_min_bytes': 256})
    comms.reset()
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    losses, synced = [], []
    with fluid.scope_guard(scope):
        exe.run(startup)
        weights.load_numpy_params(scope, state, fluid.CPUPlace(), startup)
        for _ in range(%(steps)d):
            losses.append(float(exe.run(main, feed=shard,
                                        fetch_list=[loss])[0]))
            flat = torch.cat([scope.find_var(n).reshape(-1) for n in params])
            every = [torch.empty_like(flat) for _ in range(world)]
            dist.all_gather(every, flat)
            synced.append(all(torch.equal(g, every[0]) for g in every))
        if rank == 0:
            np.savez(os.path.join(out_dir, 'final_%%s.npz' %% arm),
                     **{n: scope.find_var(n).numpy() for n in state})
    result[arm] = {'losses': losses, 'synced': synced,
                   'arms': comms.arm_counts(), 'step': exe._step}
result['launches'] = sum(common.launches(k) for k in common.KERNELS)
with open(os.path.join(out_dir, 'rank%%d.json' %% rank), 'w') as f:
    json.dump(result, f)
assert 'jax' not in sys.modules
''' % {'lr': LR, 'steps': STEPS}


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The port's 8 ranks run while the JAX package runs both arms."""
    tmp = str(tmp_path_factory.mktemp('collective_train'))
    batch = tbert.synthetic_batch(_cfg(tbert), RANKS, SEQ,
                                  np.random.RandomState(0))
    jsaved = jfluid.get_flags(['FLAGS_comms_quantize',
                               'FLAGS_comms_quantize_min_bytes',
                               'FLAGS_comms_plan', 'FLAGS_pallas_force'])
    names = weights.startup_names(_build(tfluid, tbert)[1])
    jax_runs = {}
    ranks = None
    try:
        jfluid.set_flags({'FLAGS_comms_plan': True,
                          'FLAGS_pallas_force': False})
        for arm in ARMS:
            jfluid.set_flags(_flags(arm))
            jmain, jstartup, jloss = _build(jfluid, jbert)
            JGradAllReduce().transpile(jstartup, jmain, 0, ENDPOINTS,
                                       ENDPOINTS[0])
            exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
            with jfluid.scope_guard(scope):
                exe.run(jstartup)
                state = {n: np.asarray(scope.find_var(n)) for n in names}
                if jax_runs:
                    first = jax_runs['quant']['state']
                    assert all(np.array_equal(state[n], first[n])
                               for n in names)
                if ranks is None:
                    np.savez(os.path.join(tmp, 'state.npz'), **state)
                    np.savez(os.path.join(tmp, 'batch.npz'), **batch)
                    ranks = torch_dist_cases.Ranks(tmp, _WORKER, RANKS,
                                                   args=[tmp], timeout=240)
                losses = [float(np.asarray(exe.run(
                    jmain, feed=batch, fetch_list=[jloss])[0]))
                    for _ in range(STEPS)]
                jax_runs[arm] = {
                    'losses': losses, 'state': state, 'step': exe._step,
                    'final': {n: np.asarray(scope.find_var(n))
                              for n in names}}
        ranks.wait()
    finally:
        jfluid.set_flags(jsaved)
        jplan.reset()
        if ranks is not None:
            ranks.kill()
    port = []
    for r in range(RANKS):
        with open(os.path.join(tmp, 'rank%d.json' % r)) as f:
            port.append(json.load(f))
    finals = {arm: dict(np.load(os.path.join(tmp, 'final_%s.npz' % arm)))
              for arm in ARMS}
    return {'jax': jax_runs, 'port': port, 'final': finals}


def _params(names):
    return [n for n in names if '_moment' not in n and '_pow_acc_' not in n
            and n != 'learning_rate_0']


@pytest.mark.parametrize('arm', ARMS)
def test_losses_match_jax(runs, arm):
    np.testing.assert_allclose(runs['port'][0][arm]['losses'],
                               runs['jax'][arm]['losses'], rtol=1e-5)
    assert runs['port'][0][arm]['step'] == runs['jax'][arm]['step'] == \
        1 + STEPS


def test_dense_parameters_match_jax(runs):
    want = runs['jax']['dense']['final']
    got = runs['final']['dense']
    params = _params(want)
    assert len(params) == 33
    for n in params:
        np.testing.assert_allclose(got[n], want[n], atol=1e-5, rtol=0,
                                   err_msg=n)


def test_quant_parameters_match_jax(runs):
    want = runs['jax']['quant']['final']
    got = runs['final']['quant']
    far, total = 0, 0
    for n in _params(want):
        d = np.abs(got[n] - want[n])
        assert d.max() <= 3 * LR, n
        far += int((d > 1e-5).sum())
        total += d.size
    assert far <= 1e-4 * total, (far, total)


def test_every_collective_took_its_arm(runs):
    for r, res in enumerate(runs['port']):
        n = res['n_coll']
        assert n >= 2
        assert res['quant']['arms'] == {'quant': STEPS * n, 'dense': 0,
                                        'rs_ag': 0}, r
        assert res['dense']['arms'] == {'quant': 0, 'dense': STEPS * n,
                                        'rs_ag': 0}, r
        assert res['launches'] == 0


def test_arms_differ(runs):
    q, d = runs['final']['quant'], runs['final']['dense']
    assert any(not np.array_equal(q[n], d[n]) for n in _params(q))
    assert runs['port'][0]['quant']['losses'][1:] != \
        runs['port'][0]['dense']['losses'][1:]


def test_ranks_stay_bitwise_in_sync(runs):
    for res in runs['port']:
        for arm in ARMS:
            assert res[arm]['synced'] == [True] * STEPS


def test_ranks_saw_their_own_rows(runs):
    """Each rank's loss is its own row's: the ranks' step-1 losses
    differ, and rank 0's is the JAX package's (its device 0's)."""
    first = [res['dense']['losses'][0] for res in runs['port']]
    assert len(set(first)) == RANKS
    assert abs(first[0] - runs['jax']['dense']['losses'][0]) <= \
        1e-5 * abs(first[0])
