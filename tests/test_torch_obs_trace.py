"""The port's span tracer and the executor's and reader's hooks against
the JAX package's: LeNet-5 trained 3 steps from a DataLoader through
both packages records the same shared counters and the same set of
top-level step phases, the port's spans cover at least 90% of its step
wall, the export and the device-trace merge agree, and a NaN trip
carries the same first op and a flight-recorder dump.  Integer feeds
are left out of the byte counters: the JAX package turns int64 feeds
into int32 (x64 off), so its feed bytes differ there by design; they
are compared on a float-only program.  Times are never compared across
packages.  The fixture restores both packages' monitors, tracers and
flags."""

import json
import threading
import time

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.fluid import monitor as jmon
from paddle_tpu.fluid import trace as jtrace
from paddle_tpu.models import lenet as jlenet
from paddle_tpu_torch.dataset import mnist as tmnist
from paddle_tpu_torch.fluid import faultinject as tfi
from paddle_tpu_torch.fluid import monitor as tmon
from paddle_tpu_torch.fluid import trace as ttrace
from paddle_tpu_torch.models import lenet as tlenet

BATCH, STEPS = 16, 3
PKGS = (('jax', jfluid, jmon, jtrace, jlenet),
        ('torch', tfluid, tmon, ttrace, tlenet))


@pytest.fixture(autouse=True)
def _clean():
    for _, fluid, mon, tr, _ in PKGS:
        tr.disable()
        tr.reset()
        mon.reset()
    yield
    for _, fluid, mon, tr, _ in PKGS:
        fluid.set_flags({'FLAGS_check_nan_inf': False,
                         'FLAGS_trace_buffer_steps': 16})
        tr.disable()
        tr.reset()
        mon.reset()
    tfi.reset()


# ---------------------------------------------------------------- spans
def test_span_nesting_and_threads():
    ttrace.enable(buffer_steps=4)

    def worker():
        with ttrace.span('reader_h2d', nbytes=8):
            time.sleep(0.001)

    with ttrace.step_span(1):
        with ttrace.span('dispatch'):
            with ttrace.span('inner'):
                pass
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    rec = ttrace.steps()[0]
    by = {s[0]: s for s in rec['spans']}
    assert by['inner'][4] == by['dispatch'][4] + 1
    assert by['reader_h2d'][3] != by['dispatch'][3]
    assert by['reader_h2d'][5] == {'nbytes': 8}
    assert tmon.counter_value('trace/steps_recorded') == 1.0


def test_ring_buffer_evicts_at_flag_capacity():
    tfluid.set_flags({'FLAGS_trace_buffer_steps': 3})
    ttrace.enable()
    for i in range(5):
        with ttrace.step_span(i):
            with ttrace.span('phase'):
                pass
    assert [r['step'] for r in ttrace.steps()] == [2, 3, 4]
    assert tmon.counter_value('trace/steps_dropped') == 2.0


def test_disabled_mode_overhead_budget():
    """Off (the default), a span site is one function call + a global
    load: 10k call pairs stay far under a us-scale budget."""
    assert not ttrace.is_active()
    before = tmon.counter_value('trace/spans_recorded')
    n = 10000
    t0 = time.perf_counter()
    for _ in range(n):
        with ttrace.span('x'):
            pass
        with ttrace.span('y', nbytes=4096, vars=2):
            pass
        ttrace.record('z', 0.0, 1.0)
        with ttrace.step_span(3):
            pass
    per_site = (time.perf_counter() - t0) / (4 * n)
    assert per_site < 20e-6, 'disabled span site costs %.1fus' % (
        per_site * 1e6)
    assert ttrace.steps() == []
    assert tmon.counter_value('trace/spans_recorded') == before


def test_step_with_every_plane_off_reads_nothing_more(monkeypatch):
    """Every item-10 flag off: an uncached step (a plan built for the
    call, as under 'Serial') takes no snapshot, no parameter copy and no
    memory row; its records are the step's counters alone."""
    from paddle_tpu_torch.fluid import executor as texec
    from paddle_tpu_torch.fluid import memviz as tmemviz

    def never(*a, **k):
        raise AssertionError('called with every plane off')

    for name in ('_read_values', '_snapshot_inputs', '_param_copies',
                 '_summarize'):
        monkeypatch.setattr(texec.Executor, name, never)
    for name in ('run_begin', 'record_run', 'live_census'):
        monkeypatch.setattr(tmemviz, name, never)
    main, startup, loss, _ = _lenet(tfluid, tlenet)
    rng = np.random.RandomState(0)
    feed = {'img': rng.randn(4, 1, 28, 28).astype('float32'),
            'label': rng.randint(0, 10, (4, 1)).astype('int64')}
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        for cache in (False, False, True, True):
            exe.run(main, feed=feed, fetch_list=[loss],
                    use_program_cache=cache)
    assert tmemviz.report() == []
    assert ttrace.steps() == []
    assert tmon.counter_value('executor/run_calls') == 5.0
    assert tmon.counter_value('executor/plan_cache_bypass') == 2.0


def test_reports_and_merge_match_jax():
    rec = {'step': 9, 't0': 100.0, 't1': 100.010, 'tid': 1,
           'spans': [('bind', 100.0, 100.001, 1, 1, None),
                     ('dispatch', 100.001, 100.008, 1, 1, None),
                     ('compile', 100.002, 100.007, 1, 2, None),
                     ('fetch_d2h', 100.008, 100.0095, 1, 1, None),
                     ('reader_wait', 99.99, 100.0, 2, 0, None)]}
    host = [{'ph': 'X', 'pid': 0, 'tid': 0, 'ts': 5e15, 'dur': 3.0,
             'name': 'dispatch', 'cat': 'pt_host'}]
    device = [{'ph': 'X', 'pid': 3, 'tid': 7, 'ts': 1000.0, 'dur': 5.0,
               'name': 'pt_clock_sync'},
              {'ph': 'X', 'pid': 3, 'tid': 7, 'ts': 1500.0, 'dur': 80.0,
               'name': 'flash_fwd_kernel', 'cat': 'kernel'}]
    out = []
    for _, _, _, tr, _ in PKGS:
        rep = tr.report_from_records([rec, json.loads(json.dumps(rec))])
        out.append((rep, tr.format_step_report(rep),
                    tr.merge_device_trace(host, device, sync_host_us=7e15),
                    tr.merge_device_trace(host, device, capture_t0_us=1e6),
                    tr.job_skew_report({'0': tr.step_rollup_from([rec]),
                                        '1': {'count': 2,
                                              'wall_p50_ms': 30.0,
                                              'wall_p99_ms': 40.0,
                                              'phases_ms': {'x': 9.0}}})))
    assert out[0] == out[1]
    merged = out[1][2]
    sync = next(e for e in merged if e['name'] == 'pt_clock_sync')
    assert sync['ts'] == 7e15
    assert all(e['pid'] == 4 for e in merged if e.get('cat') == 'pt_host')


def test_dump_and_export_are_valid_chrome_json(tmp_path):
    ttrace.enable(buffer_steps=4)
    with ttrace.step_span(3):
        with ttrace.span('dispatch', ops=2):
            time.sleep(0.001)
    ttrace.counter('memviz/live_bytes', {'param': 10.0, 'other': 2.0})
    p = ttrace.dump(str(tmp_path / 'flight.json'), extra={'why': 'test'})
    doc = json.load(open(p))
    assert doc['ptSteps'][0]['step'] == 3 and doc['ptIncident'] == \
        {'why': 'test'}
    kinds = set(e['ph'] for e in doc['traceEvents'])
    assert {'M', 'X', 'C'} <= kinds
    for e in doc['traceEvents']:
        if e['ph'] == 'X':
            assert isinstance(e['ts'], float) and e['dur'] >= 0
    job = ttrace.collect_job(workers=[('1', 'w1'), ('2', 'bad')],
                             fetch=lambda ep: json.dumps(doc) if ep == 'w1'
                             else b'{not json', local='0')
    assert set(job['ptJob']['workers']) == {'0', '1'}
    assert '2' in job['ptJob']['skipped']
    assert tmon.counter_value('trace/collect_skipped') == 1.0


# ---------------------------------------------------- executor + reader
def _lenet(fluid, mod):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feeds, pred, loss, acc = mod.build()
        fluid.optimizer.Adam(1e-3).minimize(loss)
        loader = fluid.DataLoader.from_generator(
            feed_list=[feeds['img'], feeds['label']], capacity=4)
    return main, startup, loss, loader


def _batches():
    imgs, labels = tmnist._synthetic(BATCH * STEPS, 0)
    for i in range(STEPS):
        yield (imgs[i * BATCH:(i + 1) * BATCH].reshape(-1, 1, 28, 28),
               labels[i * BATCH:(i + 1) * BATCH].reshape(-1, 1))


SHARED = ('executor/run_calls', 'executor/plan_cache_hit',
          'executor/plan_cache_miss', 'executor/feed_vars',
          'executor/fetch_vars', 'executor/host_ops_run',
          'reader/batches_produced', 'reader/batches_consumed')


def _train_lenet(fluid, mon, tr, mod):
    main, startup, loss, loader = _lenet(fluid, mod)
    # the port's loader stages onto the rank's card unless told the CPU
    loader.set_batch_generator(
        _batches, places=fluid.CPUPlace() if fluid is tfluid else None)
    losses = []
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        for i, feed in enumerate(loader):
            if i == 1:
                # past the first step, which the JAX package compiles
                tr.enable(buffer_steps=8)
            losses.append(exe.run(main, feed=feed, fetch_list=[loss])[0])
        tr.disable()
    return losses


# the staging phase differs by design: the JAX loader stages its window
# onto its device ahead of the steps ('reader_h2d', mostly before the
# step that uses the batch), the port's CPU loader hands the host batch
# on (nothing staged on the CPU) and the executor moves it ('feed_h2d')
_STAGING = ('reader_h2d', 'feed_h2d')


def test_lenet_from_a_dataloader_counts_and_phases_like_jax():
    counts, phases, reps = {}, {}, {}
    for key, fluid, mon, tr, mod in PKGS:
        losses = _train_lenet(fluid, mon, tr, mod)
        assert len(losses) == STEPS
        counts[key] = {k: mon.counter_value(k) for k in SHARED}
        reps[key] = tr.step_report()
        phases[key] = set(n for s in reps[key]['steps']
                          for n in s['phases_ms'])
    assert counts['jax'] == counts['torch'], counts
    assert counts['torch']['reader/batches_consumed'] == STEPS
    assert phases['jax'] - set(_STAGING) == \
        phases['torch'] - set(_STAGING), phases
    assert {'bind', 'dispatch', 'feed_h2d', 'fetch_d2h',
            'state_release'} <= phases['torch']
    assert reps['torch']['rollup']['count'] == STEPS - 1
    # spans cover the step (JAX test_report_sums_approximate_step_wall)
    for s in reps['torch']['steps']:
        assert s['coverage'] >= 0.9, s


def _float_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=[12], dtype='float32')
        y = fluid.layers.data('y', shape=[1], dtype='float32')
        h = fluid.layers.fc(x, size=8, act='tanh')
        h = fluid.layers.Print(h, message='h', summarize=2)
        pred = fluid.layers.fc(h, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss, pred


def test_float_feed_and_fetch_bytes_and_host_ops_match_jax(capsys):
    rng = np.random.RandomState(1)
    feeds = [{'x': rng.randn(6, 12).astype('float32'),
              'y': rng.randn(6, 1).astype('float32')} for _ in range(3)]
    keys = ('executor/feed_bytes', 'executor/feed_vars',
            'executor/fetch_bytes', 'executor/fetch_vars',
            'executor/host_ops_run', 'executor/run_calls')
    out = {}
    for key, fluid, mon, tr, _ in PKGS:
        main, startup, loss, pred = _float_program(fluid)
        with fluid.scope_guard(fluid.Scope()):
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup)
            for f in feeds:
                exe.run(main, feed=f, fetch_list=[loss, pred])
        out[key] = {k: mon.counter_value(k) for k in keys}
    capsys.readouterr()
    assert out['jax'] == out['torch'], out
    assert out['torch']['executor/host_ops_run'] == 3.0
    assert out['torch']['executor/feed_bytes'] == 3 * 6 * 13 * 4


def _nan_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=[4], dtype='float32')
        h = fluid.layers.scale(x, scale=2.0)
        y = fluid.layers.log(h)        # log(0) -> -inf: the first op
        z = fluid.layers.scale(y, scale=3.0)
    return main, startup, z


def test_nan_trip_names_the_same_first_op_and_dumps():
    reports = {}
    for key, fluid, mon, tr, _ in PKGS:
        main, startup, z = _nan_program(fluid)
        fluid.set_flags({'FLAGS_check_nan_inf': True})
        tr.enable(buffer_steps=4)
        with fluid.scope_guard(fluid.Scope()):
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup)
            with pytest.raises(FloatingPointError) as ei:
                exe.run(main, feed={'x': np.zeros((2, 4), 'float32')},
                        fetch_list=[z])
        notes = '\n'.join(getattr(ei.value, '__notes__', []))
        reports[key] = notes
        assert mon.counter_value('health/nan_trips') == 1.0
        assert mon.counter_value('trace/dumps_written') == 1.0
        fluid.set_flags({'FLAGS_check_nan_inf': False})
    for key in reports:
        assert 'first non-finite value produced by op [log]' in \
            reports[key], reports[key]
        assert 'flight recorder' in reports[key]
    dump = reports['torch'].split('dumped to ')[-1].strip()
    doc = json.load(open(dump))
    assert doc['ptIncident']['nan_provenance']['op_type'] == 'log'
    assert doc['ptSteps']


def test_executor_step_fault_site_fires_on_the_nth_run():
    main, startup, loss, pred = _float_program(tfluid)
    tfi.configure('executor.step:raise@3')
    feed = {'x': np.ones((2, 12), 'float32'), 'y': np.ones((2, 1), 'float32')}
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        exe.run(main, feed=feed, fetch_list=[loss])
        with pytest.raises(tfi.FaultInjected):
            exe.run(main, feed=feed, fetch_list=[loss])
        exe.run(main, feed=feed, fetch_list=[loss])
    assert tfi.fired('executor.step') == 1
    assert tmon.counter_value('executor/run_calls') == 3.0
