"""The port's status plane, tensor health and memory plane against the
JAX package's: prom_lint verdicts and render_merged text on the same
inputs (exact), the tensor-health norms of the same weights, gradients
and previous weights (rel 1e-6), memviz's argument classes and
estimated rows on f32 state (exact), and, in the port alone, the HTTP
endpoints (on port 0, stopped by the fixture), the executor's
summaries hook and the census against the scope's own bytes."""

import json
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.fluid import health as jhealth
from paddle_tpu.fluid import memviz as jmemviz
from paddle_tpu.fluid import monitor as jmon
from paddle_tpu_torch.fluid import compile_cache
from paddle_tpu_torch.fluid import health as thealth
from paddle_tpu_torch.fluid import memviz as tmemviz
from paddle_tpu_torch.fluid import monitor as tmon
from paddle_tpu_torch.fluid import trace as ttrace

PKGS = (('jax', jfluid, jhealth, jmemviz, jmon),
        ('torch', tfluid, thealth, tmemviz, tmon))


@pytest.fixture(autouse=True)
def _clean():
    for _, fluid, health, memviz, mon in PKGS:
        health.reset_state()
        memviz.reset()
        mon.reset()
    yield
    thealth.stop()
    for _, fluid, health, memviz, mon in PKGS:
        fluid.set_flags({'FLAGS_health_summaries': False,
                         'FLAGS_memviz': False,
                         'FLAGS_status_ready_max_step_age': 0.0})
        health.reset_state()
        memviz.reset()
        mon.reset()
    ttrace.disable()
    ttrace.reset()


EXPOSITIONS = [
    '\n'.join(['# TYPE m counter', 'm 1', 'm 2', 'orphan 5',
               '# TYPE h histogram', '# HELP h h', 'h_bucket{le="1"} 5',
               'h_bucket{le="+Inf"} 3', 'h_sum 1.0', 'h_count 4']) + '\n',
    '\n'.join(['# HELP g g', '# TYPE g gauge', 'g 1', '# HELP g again',
               '# TYPE g gauge', 'g{a="1"} x']) + '\n',
    '\n'.join(['# HELP h h', '# TYPE h histogram', 'h_bucket{le="2"} 1',
               'h_bucket{le="1"} 2', 'h_bucket 3', 'h_sum 1']) + '\n',
    '# HELP\n# TYPE a bogus\n\n# just a comment\n',
]


def test_prom_lint_verdicts_match():
    for _, _, _, _, mon in PKGS:
        mon.add('executor/run_calls', 3)
        mon.set_gauge('reader/queue_depth', 2)
        mon.observe('executor/run_seconds', 0.02)
    texts = EXPOSITIONS + [jmon.prometheus_text()]
    got = [[h.prom_lint(t) for t in texts] for _, _, h, _, _ in PKGS]
    assert got[0] == got[1]
    assert got[1][-1] == [] and all(got[1][:-1])
    assert thealth.prom_lint(tmon.prometheus_text()) == []


def test_render_merged_matches():
    s1 = {'counters': {'executor/run_calls': 3.0},
          'gauges': {'reader/queue_depth': 2.0, 'odd"name': 1.0},
          'hists': {'executor/run_seconds': {
              'edges': [0.1, 1.0], 'counts': [2, 1, 0],
              'sum': 0.5, 'count': 3}}}
    s2 = {'counters': {'executor/run_calls': 4.0, 'rpc/calls': 1.0},
          'gauges': {'reader/queue_depth': 7.0},
          'hists': {'executor/run_seconds': {
              'edges': [0.1, 1.0], 'counts': [1, 0, 1],
              'sum': 1.5, 'count': 2},
              'other': {'edges': [1.0], 'counts': [1, 1], 'sum': 3.0,
                        'count': 2}}}
    s3 = {'counters': {}, 'gauges': {}, 'hists': {'other': {
        'edges': [5.0], 'counts': [4, 0], 'sum': 1.0, 'count': 4}}}
    states = [('0', s1), ('1', s2), ('w"2', s3)]
    texts = [h.render_merged(states) for _, _, h, _, _ in PKGS]
    assert texts[0] == texts[1]
    assert thealth.prom_lint(texts[1]) == []


def _norm_inputs():
    rng = np.random.RandomState(4)
    names = ['fc_0.w_0', 'fc_0.b_0', 'emb', 'frozen']
    shapes = [(16, 8), (8,), (30, 4), (3, 3)]
    w = {n: rng.randn(*s).astype('float32') for n, s in zip(names, shapes)}
    g = {n + '@GRAD': rng.randn(*s).astype('float32') * 1e-2
         for n, s in zip(names[:3], shapes[:3])}
    prev = {n: w[n] - rng.randn(*w[n].shape).astype('float32') * 1e-3
            for n in names[:2]}
    prev['frozen'] = w['frozen'].copy()
    gmap = {n: n + '@GRAD' for n in names}
    return names, w, g, prev, gmap


def test_summarize_step_norms_match():
    names, w, g, prev, gmap = _norm_inputs()
    keys = ('health/weight_norm/sum', 'health/grad_norm/sum',
            'health/update_ratio/sum', 'health/global_grad_norm/sum',
            'health/last_global_grad_norm', 'health/params_tracked',
            'health/weight_norm/count', 'health/update_ratio/count')
    out = {}
    for key, _, health, _, mon in PKGS:
        conv = (lambda a: jnp.asarray(a)) if key == 'jax' else \
            (lambda a: torch.from_numpy(a))
        step_out = {k: conv(v) for k, v in list(w.items()) + list(g.items())}
        health.summarize_step(1, step_out, {k: conv(v) for k, v in
                                            prev.items()}, names, gmap)
        flat = mon.flat()
        out[key] = [flat[k] for k in keys]
    np.testing.assert_allclose(out['torch'], out['jax'], rtol=1e-6)
    assert out['torch'][-2] == 4 and out['torch'][-1] == 3


def test_zero_update_and_spike_detectors_trip():
    tfluid.set_flags({'FLAGS_health_zero_update_steps': 2,
                      'FLAGS_health_spike_factor': 5.0})
    ttrace.enable(buffer_steps=4)
    w = {'p': torch.ones(4)}
    for step in range(3):
        thealth.summarize_step(step, dict(w, g=torch.full((4,), 0.1)),
                               {'p': torch.ones(4)}, ['p'], {'p': 'g'})
    assert tmon.counter_value('health/zero_update_trips') == 1.0
    thealth.summarize_step(9, dict(w, g=torch.full((4,), 100.0)),
                           {}, ['p'], {'p': 'g'})
    assert tmon.counter_value('health/grad_spikes') == 1.0
    tfluid.set_flags({'FLAGS_health_zero_update_steps': 3,
                      'FLAGS_health_spike_factor': 10.0})


def _train_prog():
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 2
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data('x', shape=[6], dtype='float32')
        h = tfluid.layers.fc(x, size=5, act='relu')
        loss = tfluid.layers.mean(tfluid.layers.fc(h, size=1))
        tfluid.optimizer.SGD(0.5).minimize(loss)
    return main, startup, loss


def test_executor_health_summaries_and_status_readiness():
    tfluid.set_flags({'FLAGS_health_summaries': True,
                      'FLAGS_status_ready_max_step_age': 3600.0})
    plane = compile_cache.plane()
    warmed, plane._warmed = plane._warmed, False   # another file's warmup
    try:
        assert thealth.status()['ready'] is False
    finally:
        plane._warmed = warmed
    main, startup, loss = _train_prog()
    feed = {'x': np.random.RandomState(0).randn(4, 6).astype('float32')}
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        for _ in range(2):
            exe.run(main, feed=feed, fetch_list=[loss])
    assert tmon.counter_value('health/summary_steps') == 2.0
    assert tmon.flat()['health/grad_norm/count'] == 8.0   # 4 params x 2
    assert tmon.gauge_value('health/last_global_grad_norm') > 0
    st = thealth.status()
    assert st['ready'] is True and st['steps'] == 3.0


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_status_server_endpoints():
    srv = thealth.serve(port=0)
    assert thealth.serve() is srv and srv.port > 0
    main, startup, loss = _train_prog()
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        exe.run(main, feed={'x': np.ones((2, 6), 'float32')},
                fetch_list=[loss])
    code, text = _get(srv.url + '/metrics')
    assert code == 200 and thealth.prom_lint(text) == []
    assert 'paddle_tpu_executor_run_calls 2' in text
    code, body = _get(srv.url + '/healthz')
    assert code == 200 and json.loads(body)['ready'] is True
    code, body = _get(srv.url + '/statusz')
    doc = json.loads(body)
    assert code == 200 and doc['versions']['torch'] == torch.__version__
    assert doc['caches']['plan_cache_miss'] == 2.0
    assert 'item 17' in doc['supervisor']['todo']
    assert 'item 16' in doc['fleet']['todo']
    assert 'item 13' in doc['auto_shard']['todo']
    for path in ('/metrics.json', '/trace/dump', '/alertz', '/opprof',
                 '/timeseries?name=executor/run_calls'):
        code, body = _get(srv.url + path)
        assert code in (200, 404), (path, code)
        json.loads(body)
    assert _get(srv.url + '/nope')[0] == 404
    srv.stop()
    assert thealth.server() is None


# ------------------------------------------------------------- memviz
def test_classify_args_and_estimated_rows_match():
    rng = np.random.RandomState(3)
    state = {'fc_0.w_0': rng.randn(8, 4).astype('float32'),
             'moment': rng.randn(8, 4).astype('float32'),
             'fc_0.b_0': rng.randn(4).astype('float32')}
    data = {'x': rng.randn(2, 8).astype('float32')}
    outs = {'loss': rng.randn(1).astype('float32'),
            'moment': state['moment']}
    rows = []
    for key, _, _, memviz, mon in PKGS:
        conv = (lambda a: jnp.asarray(a)) if key == 'jax' else \
            (lambda a: torch.from_numpy(a))
        memviz.note_params(['fc_0.w_0', 'fc_0.b_0'])
        st = {k: conv(v) for k, v in state.items()}
        da = {k: conv(v) for k, v in data.items()}
        cls = memviz._classify_args(st, da)
        row = memviz.record_segment_estimate(
            'progA', 'seg0', st, da, {k: conv(v) for k, v in outs.items()})
        row = {k: v for k, v in row.items() if k != 'ts'}
        rows.append((cls, row, memviz.peak_bytes('progA'),
                     memviz.top_contributors(3),
                     mon.gauge_value('memviz/program_peak_bytes/progA')))
    assert rows[0] == rows[1]
    assert rows[1][2] == (8 * 4 * 2 + 4 + 2 * 8 + 1) * 4


def test_executor_files_a_row_and_the_census_counts_the_scope():
    tfluid.set_flags({'FLAGS_memviz': True})
    main, startup, loss = _train_prog()
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        tmemviz.note_params(p.name for p in main.all_parameters())
        exe.run(main, feed={'x': np.ones((3, 6), 'float32')},
                fetch_list=[loss])
        label = tmemviz.program_label(main)
        row = [r for r in tmemviz.report() if r['program'] == label][0]
        assert row['estimated'] is True
        params = sum(int(np.prod(p.shape)) * 4
                     for p in main.all_parameters())
        assert row['classes']['param'] == params
        assert row['classes']['feed'] == 3 * 6 * 4
        census = tmemviz.live_census(scope)
        own = sum(v.untyped_storage().nbytes() for v in scope._vars.values()
                  if isinstance(v, torch.Tensor))
        assert census['total_bytes'] == own
        assert census['classes']['param'] == params
        assert sum(census['classes'].values()) == census['total_bytes']
    assert tmon.counter_value('memviz/samples') == 2.0
    assert tmon.gauge_value('memviz/live_bytes/param') == params


def test_oom_recognition_and_incident_note():
    assert tmemviz.is_oom_error(torch.cuda.OutOfMemoryError('x'))
    assert tmemviz.is_oom_error(RuntimeError('CUDA out of memory. Tried'))
    assert not tmemviz.is_oom_error(RuntimeError('model BLOOM failed'))
    assert tmemviz.budget_bytes() is None   # no card
    snap = {'census': {'classes': {'param': 3 << 20, 'other': 5.0},
                       'total_bytes': (3 << 20) + 5.0, 'arrays': 2},
            'segments': [{'program': 'p', 'segment': 's',
                          'peak_bytes': 1 << 30, 'argument_bytes': 10,
                          'temp_bytes': 20}],
            'top_buffers': [{'name': 'w', 'bytes': 2048, 'class': 'param'}],
            'serving_tenants': {'t': 100.0}, 'budget': None}
    j = jmemviz.format_incident(snap, '/tmp/x.json')
    t = tmemviz.format_incident(snap, '/tmp/x.json')
    assert t == j.replace('live HBM', 'live device memory').replace(
        'arrays', 'tensors')
    note = tmemviz.oom_incident(RuntimeError('CUDA out of memory'), step=3)
    assert note.startswith('device memory exhausted')
    assert tmon.counter_value('memviz/oom_incidents') == 1.0
