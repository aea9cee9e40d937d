"""The port's monitor, faultinject, timeseries and slo against the JAX
package's: the same scripted inputs through both give the same
registry, exposition, parsed clauses, firing sequence, windows and
alerts, exactly.  Both packages keep module globals (registries, flags,
hit counters); the fixture restores them after each test, since files
share a worker under ``-n 6 --dist loadfile``."""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.fluid import faultinject as jfi
from paddle_tpu.fluid import monitor as jmon
from paddle_tpu.fluid import slo as jslo
from paddle_tpu.fluid import timeseries as jts
from paddle_tpu.fluid import trace as jtrace
from paddle_tpu_torch.fluid import compile_cache as tcc
from paddle_tpu_torch.fluid import faultinject as tfi
from paddle_tpu_torch.fluid import monitor as tmon
from paddle_tpu_torch.fluid import slo as tslo
from paddle_tpu_torch.fluid import timeseries as tts
from paddle_tpu_torch.fluid import trace as ttrace

PKGS = ((jfluid, jmon, jfi, jts, jslo, jtrace),
        (tfluid, tmon, tfi, tts, tslo, ttrace))
_FLAGS = {'FLAGS_timeseries': False, 'FLAGS_timeseries_window': 512,
          'FLAGS_timeseries_sample_steps': 1, 'FLAGS_slo': '',
          'FLAGS_slo_fast_points': 12, 'FLAGS_slo_slow_points': 96,
          'FLAGS_slo_hysteresis': 3, 'FLAGS_faultinject': ''}


@pytest.fixture(autouse=True)
def _clean():
    for fluid, mon, fi, ts, slo, tr in PKGS:
        fi.reset()
        ts.reset()
        slo.reset()
        mon.reset()
    yield
    for fluid, mon, fi, ts, slo, tr in PKGS:
        fluid.set_flags(dict(_FLAGS))
        slo.reset()
        ts.reset()
        fi.reset()
        tr.disable()
        tr.reset()
        mon.reset()


def _script(mon):
    """One scripted sequence of counter adds, gauges and histogram
    observations (both bucket presets, a '/'-nested and a sanitized
    name, a re-bucketing attempt that must be ignored)."""
    rng = np.random.RandomState(0)
    for i in range(40):
        mon.add('executor/run_calls')
        mon.add('executor/feed_bytes', float(rng.randint(1, 1 << 20)))
        mon.observe('executor/run_seconds', float(rng.exponential(0.02)))
        mon.observe('reader/bytes', float(rng.randint(1, 1 << 30)),
                    mon.SIZE_BUCKETS)
        mon.set_gauge('reader/queue_depth', float(i % 7))
    mon.add('a/b-c', 2.5)
    mon.set_gauge('health/last_global_grad_norm', 3.25)
    mon.observe('health/grad_norm', 0.37, mon.NORM_BUCKETS)
    mon.observe('health/grad_norm', 12.0, mon.TIME_BUCKETS)
    mon.set_gauge('gone/soon', 1.0)
    mon.remove_gauge('gone/soon')


def test_monitor_registry_and_exposition_match():
    out = []
    for _, mon, _, _, _, _ in PKGS:
        _script(mon)
        out.append((mon.snapshot(), mon.flat(), mon.prometheus_text(),
                    mon.raw_state(), mon.histogram_value('health/grad_norm')))
    assert out[0] == out[1]
    # the default prefix renders the same family names in both
    assert 'paddle_tpu_executor_run_calls 40' in out[1][2]


def test_monitor_disabled_and_dump_jsonl(tmp_path):
    rows = []
    for k, (_, mon, _, _, _, _) in enumerate(PKGS):
        prev = mon.set_enabled(False)
        mon.add('x')
        mon.observe('y', 1.0)
        assert mon.set_enabled(prev) is False
        assert mon.flat() == {}
        _script(mon)
        path = str(tmp_path / ('d%d.jsonl' % k))
        mon.dump_jsonl(path, step=3, extra={'tag': 'a'})
        import json
        rec = json.loads(open(path).read())
        rec.pop('ts')
        rows.append(rec)
    assert rows[0] == rows[1]


def test_compile_plane_counters_live_in_the_monitor():
    """The plan cache's and the graphs' counters are fluid.monitor
    entries under the JAX package's names: one snapshot carries them."""
    tcc.count('executor/plan_cache_hit')
    tcc.count('executor/graph_pool_bytes', 4096)
    assert tmon.counter_value('executor/plan_cache_hit') == 1.0
    assert tcc.counter_value('executor/graph_pool_bytes') == 4096
    assert tmon.snapshot()['executor']['graph_pool_bytes'] == 4096.0
    stats = tcc.plane().stats()
    assert stats['plan_cache_hit'] == 1 and stats['graph_replays'] == 0


SPECS = [
    'executor.step:raise@2',
    'rpc.call:delay:0@1+;rpc.call:raise@3',
    'collective.dispatch:stall:0@2+ ; progcheck.mutate:mutate:3',
    'heartbeat.send:drop@1;elastic.shard_write:torn@2',
    'executor.dispatch:fail@4',
]


@pytest.mark.parametrize('spec', SPECS)
def test_faultinject_same_clauses_and_firing(spec):
    seqs = []
    for _, mon, fi, _, _, _ in PKGS:
        assert fi.configure(spec)
        seq = []
        for site in fi.SITES:
            for hit in range(5):
                try:
                    c = fi.check(site, step=hit)
                    seq.append((site, hit, None if c is None else
                                (c['action'], c['arg'], c['nth'],
                                 c['plus'])))
                except fi.FaultInjected:
                    seq.append((site, hit, 'FaultInjected'))
                except ConnectionError:
                    seq.append((site, hit, 'ConnectionError'))
        seqs.append((seq, fi.report(), fi.fired(), mon.flat()))
    assert seqs[0] == seqs[1]


def test_faultinject_malformed_specs_alike():
    """A malformed clause is refused (ValueError) alike in both."""
    out = []
    for _, _, fi, _, _, _ in PKGS:
        row = []
        for bad in ('nosuchsite:die', 'rpc.call:explode', 'rpc.call:die@x',
                    'rpc.call', ':die', 'rpc.call:delay:abc'):
            try:
                fi.configure(bad)
                row.append((bad, 'ok', fi.report()['spec']))
            except ValueError:
                row.append((bad, 'ValueError', fi.armed()))
            fi.reset()
        out.append(row)
    assert out[0] == out[1]
    assert any(r[1] == 'ValueError' for r in out[1])


def _feed_series(mon, ts, steps=30):
    """A scripted history: a counter with a reset, a gauge, a histogram,
    sampled at injected times."""
    for i in range(steps):
        if i == 17:
            mon.reset()   # a restarted worker's counters
        mon.add('executor/run_calls', 1.0 + (i % 3))
        mon.set_gauge('reader/queue_depth', float((i * 7) % 5))
        mon.observe('executor/run_seconds', 0.001 * (1 + (i % 11)))
        ts.sample(step=i, now=1000.0 + 0.5 * i)


def test_timeseries_windows_match():
    out = []
    for fluid, mon, _, ts, _, _ in PKGS:
        fluid.set_flags({'FLAGS_timeseries': True,
                         'FLAGS_timeseries_window': 24})
        _feed_series(mon, ts)
        w = {n: ts.window(n, points=20) for n in
             ('executor/run_calls', 'reader/queue_depth',
              'executor/run_seconds')}
        w2 = ts.window('executor/run_calls', seconds=5.0, now=1014.5,
                       resolution=3)
        pts = [(float(i), i, float(i * i % 13)) for i in range(40)]
        edges = (0.001, 0.01, 0.1)
        hpts = [(float(i), i, (i, 0.002 * i, [i, 2 * i, 0, i]))
                for i in range(8)]
        out.append((w, w2, ts.downsample(pts, 7), ts.downsample(pts, 40),
                    ts.hist_window(edges, hpts),
                    ts.percentile_from_counts(edges, [3, 5, 1, 1], 0.95),
                    ts.counter_deltas(pts[:6]), ts.gauge_stats(pts),
                    sorted(ts.names()), ts.report()['samples']))
    assert out[0] == out[1]


def test_timeseries_http_query_and_job_gaps_match():
    out = []
    for fluid, mon, _, ts, _, _ in PKGS:
        fluid.set_flags({'FLAGS_timeseries': True})
        _feed_series(mon, ts, steps=10)
        for r, t in ((0, 1.0), (1, 1.0), (0, 2.0)):
            ts.job_sample(r, mon.raw_state(), now=2000.0 + t)
        ts.job_gap(1, now=2003.0)
        code, doc = ts.http_query({'name': 'reader/queue_depth',
                                   'points': '8'})
        code2, doc2 = ts.http_query({'name': 'reader/queue_depth',
                                     'rank': '1'})
        code3, _ = ts.http_query({'name': 'no/such'})
        out.append((code, doc, code2, doc2, code3, ts.job_ranks()))
    assert out[0] == out[1]


CLAUSES = ['executor/run_seconds p99 < 5ms', 'reader/queue_depth < 3',
           'executor/run_calls rate == 0', 'executor/run_seconds mean < 20us']


def test_slo_states_and_alertz_match():
    out = []
    for fluid, mon, _, ts, slo, tr in PKGS:
        fluid.set_flags({'FLAGS_timeseries': True,
                         'FLAGS_slo_hysteresis': 2,
                         'FLAGS_slo_fast_points': 4,
                         'FLAGS_slo_slow_points': 8})
        for c in CLAUSES:
            slo.declare(c)
        trail = []
        for i in range(24):
            mon.add('executor/run_calls')
            mon.set_gauge('reader/queue_depth', 5.0 if 6 <= i < 14 else 1.0)
            mon.observe('executor/run_seconds', 0.05 if i < 12 else 0.001)
            ts.sample(step=i, now=3000.0 + i)
            trail.append(sorted((d['name'], d['state'])
                                for d in slo.objectives()))
        doc = slo.alertz(now=3030.0)
        for k in ('firing', 'pending', 'resolved', 'ok', 'resolved_trail'):
            for d in doc[k]:
                d.pop('since', None)
                d.pop('evaluated_at', None)
        out.append((trail, [slo.parse(c) for c in CLAUSES],
                    {k: doc[k] for k in ('objectives', 'hysteresis')},
                    sorted(d['name'] for d in doc['firing']),
                    sorted(d['name'] for d in doc['resolved']),
                    slo.report(),
                    {k: v for k, v in mon.flat().items()
                     if k.startswith('slo/')}))
    assert out[0] == out[1]


def test_slo_flag_clauses_and_bad_clause():
    for fluid, mon, _, ts, slo, _ in PKGS:
        fluid.set_flags({'FLAGS_slo': 'reader/queue_depth < 3; '
                                      'executor/run_calls rate == 0'})
        assert slo.maybe_evaluate(now=1.0)
        assert len(slo.objectives()) == 2
        with pytest.raises(ValueError):
            slo.parse('reader/queue_depth ~~ 3')
