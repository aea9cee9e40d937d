"""The port's profiler and opprof against the JAX package's: op_scope
names and layers of the same program, the attribution, rollups and
worklist of the same synthetic capture (the worklist naming the port's
counterpart of each kernel the JAX package names, ``covering_kernel``),
and the 'Serial' table of a LeNet-5 step (the same op types and call
counts; times are never compared).  Then the port alone: a
torch.profiler export's kernels attributed through their launches and
the autograd engine's sequence numbers (a synthetic export in the shape
CUPTI gives on the card), the device union over streams, a CPU
'Default' profile, the op-cost replay and start_trace."""

import json
import os

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.fluid import opprof as jopprof
from paddle_tpu.fluid import profiler as jprof
from paddle_tpu.models import lenet as jlenet
from paddle_tpu.ops.pallas import common as jkernels
from paddle_tpu_torch.fluid import monitor as tmon
from paddle_tpu_torch.fluid import opprof as topprof
from paddle_tpu_torch.fluid import profiler as tprof
from paddle_tpu_torch.fluid import trace as ttrace
from paddle_tpu_torch.models import lenet as tlenet
from paddle_tpu_torch.ops.kernels import common as tkernels

PKGS = (('jax', jfluid, jprof, jopprof, jlenet),
        ('torch', tfluid, tprof, topprof, tlenet))

# the port's kernels that stand for each JAX kernel
COUNTERPART = {'embedding_lookup': {'embedding_lookup'},
               'embedding_update': {'embedding_update'},
               'flash_attention': {'flash_attention', 'dropout'},
               'fused_optimizer': {'fused_adam', 'fused_lamb'},
               'quant_collective': {'quant_quantize'}}
# op types a JAX kernel covers that the port runs without a hand-written
# kernel: the attention chain (the port's K1 serves the fused op, and
# the chain below flash_min_len runs as torch ops), a lone optimizer op
# that the run grouping leaves unfused, and dense adagrad (K7 serves the
# fused_emb_update rewrite only).  The port's worklist must list them.
UNSERVED = {'matmul', 'scale', 'softmax', 'adam', 'adamw', 'lamb',
            'adagrad'}


def _port_answer_ok(op_type, jname, tname):
    """The port's covering kernel of `op_type` against the JAX
    package's `jname`: its counterpart, or none where the port runs
    the op type without a kernel."""
    if jname is None or op_type in UNSERVED:
        return tname is None
    return tname in COUNTERPART[jname]


@pytest.fixture(autouse=True)
def _clean():
    for _, fluid, prof, opp, _ in PKGS:
        prof.reset_profiler()
        opp.reset()
    yield
    for _, fluid, prof, opp, _ in PKGS:
        fluid.set_flags({'FLAGS_opprof': False,
                         'FLAGS_opprof_snapshot_steps': 16})
        prof.reset_profiler()
        opp.reset()
    ttrace.disable()
    ttrace.reset()


def _lenet(fluid, mod):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feeds, pred, loss, acc = mod.build()
        fluid.optimizer.Adam(1e-3).minimize(loss)
    return main, startup, loss


def _feed():
    rng = np.random.RandomState(0)
    return {'img': rng.randn(4, 1, 28, 28).astype('float32'),
            'label': rng.randint(0, 10, (4, 1)).astype('int64')}


def test_op_scopes_and_layers_match():
    out = []
    for _, fluid, _, opp, mod in PKGS:
        main, _, _ = _lenet(fluid, mod)
        ops = main.global_block().ops
        out.append(([opp.op_scope(op) for op in ops],
                    [opp.layer_of(op) for op in ops],
                    opp.op_scope(ops[-1], 'fused_adam'),
                    opp.split_instance('conv2d#3'),
                    [opp.want_snapshot(s) for s in range(4)]))
    assert out[0] == out[1]
    assert out[1][0][0].endswith('#0')


CAPTURE = [
    {'ph': 'X', 'name': 'f.0', 'dur': 40, 'args': {'tf_op': 'jit_s/adam#5'}},
    {'ph': 'X', 'name': 'f.1', 'dur': 35, 'args': {'tf_op': 'jit_s/adam#6'}},
    {'ph': 'X', 'name': 'f.2', 'dur': 30, 'args': {'tf_op': 'jit_s/adam#7'}},
    {'ph': 'X', 'name': 'f.3', 'dur': 20, 'args': {'tf_op': 'jit_s/relu#0'}},
    {'ph': 'X', 'name': 'f.4', 'dur': 10, 'args': {'tf_op': 'jit_s/adam#9'}},
    {'ph': 'X', 'name': 'g.1', 'dur': 64,
     'args': {'tf_op': 'jit_t/matmul#2;jit_t/softmax#3;jit_t/glue'}},
    {'ph': 'X', 'name': 'e.1', 'dur': 12,
     'args': {'tf_op': 'jit_t/lookup_table#1'}},
    {'ph': 'X', 'name': 'copy.9', 'dur': 9, 'args': {'tf_op': 'jit_t/x'}},
    {'ph': 'X', 'name': 'bad', 'dur': 1, 'args': {'tf_op': 123}},
    {'ph': 'C', 'name': 'counter', 'args': {}},
    'not a dict',
]


def test_capture_rollups_and_worklist_match():
    out = []
    for key, _, prof, opp, _ in PKGS:
        res = opp.record_capture(CAPTURE, program='cap', steps=2)
        wl = opp.kernel_worklist()
        covered = [(r['op_type'], r.pop('covered_by')) for r in wl]
        rep = opp.report()
        out.append((res, opp.rollup_by_type(), opp.rollup_by_layer(), wl,
                    rep['unattributed_ms'], rep['top'],
                    prof.attribute_trace_events(CAPTURE, with_stats=True,
                                                op_types={'adam', 'relu'}),
                    covered))
    assert out[0][:-1] == out[1][:-1]
    for (typ, jname), (_, tname) in zip(out[0][-1], out[1][-1]):
        assert _port_answer_ok(typ, jname, tname), (typ, jname, tname)
    # the runs only the JAX package serves stay on the port's worklist
    assert ('adam', None) in out[1][-1] and ('adam', 'fused_optimizer') \
        in out[0][-1]


def test_covering_kernel_names_the_port_counterpart():
    """For every op type the JAX package names a kernel for, the port
    names that kernel's counterpart, or none where it runs the op type
    without one; each counterpart covers the op types it declares."""
    jk = jkernels.kernels()
    types = set()
    for info in jk.values():
        types.update(info['op_types'])
    for t in sorted(types):
        j = jkernels.covering_kernel([t])
        p = tkernels.covering_kernel([t])
        assert _port_answer_ok(t, j, p), (t, j, p)
    tk = tkernels.kernels()
    for j in jk:
        for p in COUNTERPART[j]:
            assert tk[p]['op_types'], p
            assert tkernels.covering_kernel(tk[p]['op_types']) in \
                COUNTERPART[j], (j, p)
    assert tkernels.covering_kernel([]) is None
    assert tkernels.covering_kernel(['conv2d']) is None
    assert tkernels.covering_kernel(
        ['fused_multihead_attention']) == 'flash_attention'
    assert tkernels.covering_kernel(
        ['fused_multihead_attention_grad']) == 'flash_attention_bwd'


def test_serial_table_of_a_lenet_step_matches(capsys):
    tables = {}
    for key, fluid, prof, _, mod in PKGS:
        main, startup, loss = _lenet(fluid, mod)
        with fluid.scope_guard(fluid.Scope()):
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup)
            with prof.profiler('All', tracer_option='Serial'):
                exe.run(main, feed=_feed(), fetch_list=[loss])
        tables[key] = {t: r['calls']
                       for t, r in prof.summary_records().items()}
    capsys.readouterr()
    assert tables['jax'] == tables['torch'], tables
    assert tables['torch']['conv2d'] == 2 and tables['torch']['adam'] == 6
    assert tmon.counter_value('executor/plan_cache_bypass') >= 1
    assert tmon.counter_value('profiler/conv2d/calls') >= 2


def _kineto():
    """A synthetic torch.profiler export in CUPTI's shape: host ranges
    on thread 1, an autograd engine thread 2, kernels on two streams,
    and a CUDA-graph replay whose kernel no op range covers."""
    def x(cat, name, ts, dur, tid, **args):
        return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
                'pid': 1, 'tid': tid, 'args': args}
    return [
        x('user_annotation', 'prog1', 0, 100, 1),
        x('user_annotation', 'fused_multihead_attention', 10, 20, 1),
        x('cpu_op', 'FlashAttention', 11, 10, 1,
          **{'Sequence number': 7, 'Fwd thread id': 0}),
        x('cuda_runtime', 'cudaLaunchKernel', 12, 2, 1, correlation=1),
        x('user_annotation', 'mul', 40, 10, 1),
        x('cuda_runtime', 'cudaLaunchKernel', 42, 2, 1, correlation=2),
        x('cpu_op', 'autograd::engine::evaluate_function: FlashBackward',
          60, 20, 2, **{'Sequence number': 7, 'Fwd thread id': 1}),
        x('cuda_runtime', 'cudaLaunchKernel', 62, 2, 2, correlation=3),
        x('cuda_runtime', 'cudaGraphLaunch', 120, 2, 1, correlation=4),
        x('kernel', 'void flash_fwd_kernel<64>(float*)', 20, 30, 7,
          correlation=1),
        x('kernel', 'gemm_kernel', 45, 10, 8, correlation=2),
        x('kernel', 'void flash_bwd_dq_kernel<64>(float*)', 70, 40, 7,
          correlation=3),
        x('gpu_memcpy', 'Memcpy HtoD', 200, 5, 7, correlation=4),
    ]


def test_device_events_attributed_through_launches_and_autograd():
    ann = tprof.annotate_device_events(_kineto())
    recs, stats = tprof.attribute_trace_events(ann, with_stats=True)
    assert set(recs) == {'fused_multihead_attention',
                         'fused_multihead_attention_grad', 'mul',
                         'unattributed/Memcpy HtoD'}
    assert recs['fused_multihead_attention_grad'][1] == pytest.approx(40e-6)
    # every device event is one row's: the rows sum to the device time
    dev = tprof.device_time(_kineto())
    assert sum(r[1] for r in recs.values()) * 1e3 == pytest.approx(
        dev['sum_ms'])
    assert dev == {'sum_ms': pytest.approx(0.085),
                   'union_ms': pytest.approx(0.080), 'events': 4,
                   'streams': 2}
    assert stats['dropped'] == 0


def test_default_profile_on_the_cpu_attributes_host_ops(capsys, tmp_path):
    main, startup, loss = _lenet(tfluid, tlenet)
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        exe.run(main, feed=_feed(), fetch_list=[loss])
        path = str(tmp_path / 'table.txt')
        with tprof.profiler('All', tracer_option='Default',
                            profile_path=path):
            exe.run(main, feed=_feed(), fetch_list=[loss])
    capsys.readouterr()
    rows = tprof.summary_records()
    assert {'conv2d', 'pool2d', 'softmax', 'conv2d_grad',
            'fused_adam'} <= set(rows), sorted(rows)
    last = tprof.last_profile()
    assert last['device']['events'] == 0 and last['rows'] == rows
    assert os.path.exists(path + '.timeline.json')
    assert not tprof.op_ranges() and not tprof.is_enabled()


def test_op_cost_replay_normalizes_to_the_measured_step():
    tfluid.set_flags({'FLAGS_opprof': True, 'FLAGS_opprof_snapshot_steps': 2})
    main, startup, loss = _lenet(tfluid, tlenet)
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)            # step 1
        exe.run(main, feed=_feed(), fetch_list=[loss])   # step 2: snapshot
    snaps = topprof.snapshots()
    assert len(snaps) == 1
    (snap,) = snaps.values()
    assert snap['step'] == 2 and snap['measured_s'] > 0
    done = topprof.replay_all()
    assert list(done.values()) == [snap['ops']]
    rep = topprof.report(limit=64)
    seg = rep['segments'][0]
    assert seg['source'] == 'replay'
    assert seg['attributed_ms'] == pytest.approx(seg['measured_ms'],
                                                 rel=1e-3)
    assert 'conv2d' in rep['by_type'] and 'conv2d_grad' in rep['by_type']
    assert rep['top'][0]['instance'].count('#') == 1


def test_start_and_stop_trace_write_the_capture(tmp_path):
    d = str(tmp_path / 'cap')
    tprof.start_trace(d)
    with pytest.raises(RuntimeError):
        tprof.start_trace(d)
    main, startup, loss = _lenet(tfluid, tlenet)
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
    assert tprof.stop_trace() == d
    dev = json.load(open(os.path.join(d, 'device_trace.json')))
    host = json.load(open(os.path.join(d, 'host_trace.json')))
    assert any(e.get('name') == 'pt_clock_sync'
               for e in dev['traceEvents'])
    assert host['ptSync'] is not None and host['ptHostEvents']
    assert not ttrace.is_active()
