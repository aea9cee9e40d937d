"""fluid.health — HTTP status plane, NaN provenance, tensor health.

The counters (fluid.monitor) and the step timeline (fluid.trace) end at
the process boundary without this module (JAX: fluid/health.py, whose
endpoints, aggregator, lint, provenance and summaries this module
keeps), in three coupled pieces:

**Status plane.**  ``serve(port)`` (or ``FLAGS_status_port``, read at
the first Executor construction) starts a stdlib ``http.server``
thread exposing ``/metrics`` (Prometheus text, merged across workers
on an aggregating server), ``/metrics.json`` (the raw registry the
aggregator scrapes), ``/healthz`` (liveness + readiness: a step done
or a warmup, the last step at most ``FLAGS_status_ready_max_step_age``
old; 200 when ready, 503 when not), ``/statusz`` (one JSON report:
step phases, the plan cache's and the CUDA graphs' counters, the
kernels' launches, memory, the verifier, flags, and torch / CUDA /
card versions), ``/trace/dump``, ``/timeseries``, ``/alertz`` and
``/opprof``.  With ``PADDLE_TPU_STATUS_WORKERS`` set, rank 0 is the
**aggregator**: a background prober scrapes every worker each
``FLAGS_health_heartbeat_seconds`` and its ``/metrics`` merges the job
(counters and histogram buckets sum, gauges keep per-worker
identity).  The JAX package's sections of modules the port does not
have yet say so and name their ROADMAP item.

**NaN provenance.**  ``nan_provenance(ops, state, data, step, device,
program)`` replays a failed step op by op through the executor's op
runner from the copies of the state and feeds it read
(``FLAGS_nan_replay``), naming the first op whose output went
non-finite, with input stats (min/max/l2/%nonfinite) — attached to the
FloatingPointError note and embedded in the flight-recorder dump
(``ptIncident``).

**Tensor health.**  Opt-in ``FLAGS_health_summaries`` computes per-step
weight / grad / update norms of every parameter the step updated on
the card, all fetched in ONE device-to-host copy, into monitor
histograms and a trace span, with spike (``FLAGS_health_spike_factor``
over the running EMA) and zero-update
(``FLAGS_health_zero_update_steps``) detectors that auto-dump the
flight recorder.  Off (the default) the executor pays one flag read
per step.

Hot-path discipline mirrors monitor/trace: torch is imported where a
tensor is touched, and nothing here runs per step unless a flag asked
for it.
"""

import json
import os
import threading
import time

from . import monitor
from . import trace
from .flags import get_flag

__all__ = [
    'serve', 'stop', 'ensure_serving', 'server', 'status', 'statusz',
    'prom_lint', 'render_merged', 'nan_provenance', 'tensor_stats',
    'summarize_step', 'reset_state', 'HealthServer',
]

_BIRTH = time.time()


# ------------------------------------------------------------- status
def status():
    """Liveness/readiness snapshot of THIS process (the /healthz
    body).  Ready means: the process finished warmup or completed at
    least one executor step, and (when FLAGS_status_ready_max_step_age
    bounds it) the last step is recent enough."""
    now = time.time()
    run_calls = monitor.counter_value('executor/run_calls')
    last_ts = monitor.gauge_value('executor/last_step_unix_ts', 0.0)
    warmed = False
    try:
        from . import compile_cache
        warmed = bool(getattr(compile_cache.plane(), '_warmed', False))
    except Exception:
        pass
    age = (now - last_ts) if last_ts else None
    reasons = []
    ready = bool(run_calls) or warmed
    if not ready:
        reasons.append('no step completed and no warmup done')
    max_age = float(get_flag('FLAGS_status_ready_max_step_age', 0.0)
                    or 0.0)
    if ready and max_age > 0 and age is not None and age > max_age:
        ready = False
        reasons.append('last step %.1fs ago exceeds max age %.1fs'
                       % (age, max_age))
    serving_ready = None
    srv = _serving_module()
    if srv is not None and hasattr(srv, 'readiness'):
        # a serving replica is ready only once its bucket ladder is
        # warm: routing to it earlier would run eagerly
        serving_ready, s_reasons = srv.readiness()
        if serving_ready is False:
            ready = False
            reasons.extend(s_reasons)
    # memory-pressure degradation (fluid.memviz budget watermarks):
    # /healthz stays 200 — a pressured trainer is still live — but the
    # body names the degradation so routers/operators can shed load
    # before the allocator fails
    memory = None
    try:
        from . import memviz
        memory = memviz.memory_pressure()
        if memory is not None and memory['degraded']:
            reasons.append(
                'device memory at %.0f%% of budget (watermark)'
                % (100.0 * memory['utilization']))
    except Exception:
        pass
    return {
        'alive': True,
        'ready': ready,
        'reasons': reasons,
        'pid': os.getpid(),
        'rank': _self_rank(),
        'uptime_s': round(now - _BIRTH, 3),
        'steps': run_calls,
        'warmed': warmed,
        'serving_ready': serving_ready,
        'memory': memory,
        'last_step_age_s': (round(age, 3) if age is not None else None),
    }


def _serving_module():
    """fluid.serving, if this process imported it — consulted lazily so
    plain trainers never pay for (or import) the serving plane."""
    import sys as _sys
    return _sys.modules.get(__package__ + '.serving')


# the JAX package's /statusz sections of modules the port has not got
# yet, and the ROADMAP item of the port that brings each
_UNPORTED_SECTIONS = {
    'auto_shard': 'ROADMAP Queue 1 item 13 (the auto-shard planner)',
    'supervisor': 'ROADMAP Queue 1 item 17 (the self-healing supervisor)',
    'autopilot': 'ROADMAP Queue 1 item 17 (the autopilot)',
    'fleet': 'ROADMAP Queue 1 item 16 (the serving fleet)',
}


def _versions():
    """torch, CUDA and the card (the JAX package reports jax, jaxlib and
    its backend here)."""
    out = {}
    try:
        import torch
        out['torch'] = torch.__version__
        out['cuda'] = str(torch.version.cuda)
        if torch.cuda.is_available():
            out['backend'] = 'cuda'
            out['device'] = torch.cuda.get_device_name(
                torch.cuda.current_device())
            out['capability'] = '%d.%d' % torch.cuda.get_device_capability(
                torch.cuda.current_device())
        else:
            out['backend'] = 'cpu'
    except Exception:
        pass
    return out


def statusz():
    """The /statusz body: one JSON report a human (or a dashboard)
    reads to answer 'what is this trainer doing' — step phases, cache
    behavior, memory, flags, versions."""
    caches = {}
    for key in ('executor/plan_cache_hit', 'executor/plan_cache_miss',
                'executor/plan_cache_bypass',
                'executor/plan_cache_evictions',
                'executor/graph_first_runs', 'executor/graph_captures',
                'executor/graph_replays', 'executor/graph_stale',
                'executor/graph_refused', 'executor/graph_pool_bytes'):
        caches[key.split('/', 1)[1]] = monitor.counter_value(key)
    try:
        from . import compile_cache
        caches['graphs_alive'] = compile_cache.plane().entry_count()
    except Exception:
        pass
    memory_section = None
    try:
        from . import memviz
        attribution = memviz.report(limit=16)
        if attribution or memviz.last_census() is not None:
            memory_section = {
                'attribution': attribution,
                'top_buffers': memviz.top_contributors(),
                'live': memviz.last_census(),
                'budget': memviz.memory_pressure(),
            }
    except Exception:
        pass
    # collective planner (fluid.comms_plan): the plan of each
    # transpiled program
    comms_plan_section = None
    try:
        from . import comms_plan
        rep = comms_plan.program_plans()
        if rep.get('programs'):
            comms_plan_section = rep
    except Exception:
        pass
    # fault injection (fluid.faultinject); the JAX package shows it in
    # its elastic section (ROADMAP item 17 of the port)
    faultinject_section = None
    try:
        from . import faultinject
        fi = faultinject.report()
        if fi.get('armed') or fi.get('fired'):
            faultinject_section = fi
    except Exception:
        pass
    verify_section = None
    try:
        from . import progcheck
        rep = progcheck.report()
        if rep.get('enabled') or rep['counters'].get('programs') or \
                rep.get('reports'):
            verify_section = rep
    except Exception:
        pass
    timeseries_section = None
    try:
        from . import timeseries
        if timeseries.enabled() or timeseries.report()['samples']:
            timeseries_section = timeseries.statusz_rollup()
    except Exception:
        pass
    slo_section = None
    try:
        from . import slo
        rep = slo.report()
        if rep.get('objectives'):
            slo_section = rep
    except Exception:
        pass
    # the hand-written kernels (ops/kernels/common.py): launches and
    # replayed launches of each — 'did the kernel actually run'
    kernels_section = None
    try:
        from ..ops.kernels import common as kernels_common
        rep = kernels_common.report()
        if rep.get('kernels'):
            kernels_section = rep
    except Exception:
        pass
    op_costs_section = None
    try:
        from . import opprof
        rep = opprof.report()
        if rep.get('enabled') or rep.get('top') or rep.get('snapshots'):
            op_costs_section = rep
    except Exception:
        pass
    job_section = None
    if _server is not None and _server.aggregator is not None:
        try:
            job_section = _server.aggregator.job_view()
        except Exception:
            pass
    raw = monitor.raw_state()
    out = {
        'status': status(),
        'step_report': trace.step_report(),
        'caches': caches,
        'memory': memory_section,
        'comms_plan': comms_plan_section,
        'faultinject': faultinject_section,
        'verify': verify_section,
        'timeseries': timeseries_section,
        'slo': slo_section,
        'kernels': kernels_section,
        'op_costs': op_costs_section,
        'job': job_section,
        'flags': _all_flags(),
        'versions': _versions(),
        'trace_active': trace.is_active(),
        'monitor': {'counters': len(raw['counters']),
                    'gauges': len(raw['gauges']),
                    'histograms': len(raw['hists'])},
    }
    for name, item in _UNPORTED_SECTIONS.items():
        out[name] = {'ported': False, 'todo': item}
    return out


def _all_flags():
    from . import flags as _flags_mod
    return dict(_flags_mod._flags)


def _self_rank():
    return os.environ.get('PADDLE_TRAINER_ID', '0')


# ---------------------------------------------------------- prom lint
def prom_lint(text):
    """Lint-check a Prometheus text exposition blob; returns a list of
    problem strings (empty = clean).  Checks the contract a real
    scraper depends on: HELP/TYPE metadata per family, no duplicate
    metadata or duplicate (name, labels) samples, and histogram
    bucket/_sum/_count consistency (cumulative non-decreasing buckets,
    +Inf == _count)."""
    problems = []
    helps, types = {}, {}
    samples = set()
    hist = {}   # family -> {'buckets': [(le, v)], 'sum': v, 'count': v}
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith('# HELP '):
            parts = line.split(' ', 3)
            if len(parts) < 3:
                problems.append('line %d: malformed HELP' % ln)
                continue
            name = parts[2]
            if name in helps:
                problems.append('duplicate HELP for %s' % name)
            helps[name] = parts[3] if len(parts) > 3 else ''
            continue
        if line.startswith('# TYPE '):
            parts = line.split(' ')
            if len(parts) != 4 or parts[3] not in (
                    'counter', 'gauge', 'histogram', 'summary',
                    'untyped'):
                problems.append('line %d: malformed TYPE' % ln)
                continue
            if parts[2] in types:
                problems.append('duplicate TYPE for %s' % parts[2])
            types[parts[2]] = parts[3]
            continue
        if line.startswith('#'):
            continue
        try:
            metric, val = line.rsplit(' ', 1)
            value = float(val)
        except ValueError:
            problems.append('line %d: unparsable sample %r' % (ln, line))
            continue
        if metric in samples:
            problems.append('duplicate series %r' % metric)
        samples.add(metric)
        name = metric.split('{', 1)[0]
        family = name
        for suffix in ('_bucket', '_sum', '_count'):
            if name.endswith(suffix) and \
                    name[:-len(suffix)] in types and \
                    types[name[:-len(suffix)]] == 'histogram':
                family = name[:-len(suffix)]
                h = hist.setdefault(family, {'buckets': [], 'sum': None,
                                             'count': None})
                if suffix == '_bucket':
                    le = None
                    if '{' in metric and 'le="' in metric:
                        le = metric.split('le="', 1)[1].split('"', 1)[0]
                    h['buckets'].append((le, value))
                elif suffix == '_sum':
                    h['sum'] = value
                else:
                    h['count'] = value
                break
        if family not in types:
            problems.append('sample %s has no TYPE metadata' % name)
        if family not in helps:
            problems.append('sample %s has no HELP metadata' % name)
    for family, h in hist.items():
        if not h['buckets']:
            problems.append('histogram %s has no _bucket series'
                            % family)
            continue
        prev = -1.0
        prev_le = None
        inf_v = None
        max_finite = None
        for le, v in h['buckets']:
            if le is None:
                problems.append('histogram %s bucket missing le label'
                                % family)
                continue
            if le == '+Inf':
                le_num = float('inf')
            else:
                try:
                    le_num = float(le)
                except ValueError:
                    problems.append('histogram %s bucket le=%r is not '
                                    'a number' % (family, le))
                    continue
            # le bounds must ascend with +Inf last: an out-of-order
            # bucket makes the cumulative check below meaningless
            if prev_le is not None and le_num <= prev_le:
                problems.append('histogram %s bucket le=%s out of '
                                'order' % (family, le))
            prev_le = le_num
            if v < prev:
                problems.append('histogram %s buckets not cumulative '
                                'at le=%s (per-bucket counts instead '
                                'of the running total?)' % (family, le))
            prev = v
            if le == '+Inf':
                inf_v = v
            elif max_finite is None or v > max_finite:
                max_finite = v
        if inf_v is None:
            problems.append('histogram %s missing +Inf bucket' % family)
        elif max_finite is not None and max_finite > inf_v:
            # a finite bucket above +Inf is the signature of a
            # per-bucket-count rendering whose +Inf kept only the
            # overflow count — cumulative buckets can never exceed it
            problems.append('histogram %s has a finite bucket above '
                            'the +Inf bucket (%g > %g): buckets are '
                            'not cumulative' % (family, max_finite,
                                                inf_v))
        if h['count'] is None:
            problems.append('histogram %s missing _count' % family)
        elif inf_v is not None and inf_v != h['count']:
            problems.append('histogram %s +Inf bucket %g != _count %g'
                            % (family, inf_v, h['count']))
        if h['sum'] is None:
            problems.append('histogram %s missing _sum' % family)
    return problems


# ------------------------------------------------------- merged render
def render_merged(states, prefix='paddle_tpu'):
    """Render multiple workers' ``monitor.raw_state()`` dicts as ONE
    exposition blob: counters and histogram buckets SUM across workers
    (they are job totals), gauges keep per-worker identity as
    ``worker``-labelled series (summing a queue depth with a device
    count would be nonsense).  `states` is a list of (worker_label,
    raw_state) pairs."""
    from .monitor import (_prom_name, _prom_num, _prom_block,
                          prom_histogram_lines, prom_sample)
    lines = []
    seen = set()
    counters = {}
    for label, st in states:
        for n, v in st.get('counters', {}).items():
            counters[n] = counters.get(n, 0.0) + float(v)
    for n in sorted(counters):
        m = _prom_name(n, prefix)
        _prom_block(lines, m, 'counter',
                    'job-summed counter %s' % n, seen)
        lines.append('%s %s' % (m, _prom_num(counters[n])))
    gauge_names = sorted(set(
        n for _label, st in states for n in st.get('gauges', {})))
    for n in gauge_names:
        m = _prom_name(n, prefix)
        _prom_block(lines, m, 'gauge',
                    'per-worker gauge %s' % n, seen)
        for label, st in states:
            if n in st.get('gauges', {}):
                lines.append(prom_sample(
                    m, [('worker', label)], st['gauges'][n]))
    hists = {}
    for _label, st in states:
        for n, h in st.get('hists', {}).items():
            cur = hists.get(n)
            if cur is None:
                hists[n] = {'edges': list(h['edges']),
                            'counts': list(h['counts']),
                            'sum': float(h['sum']),
                            'count': int(h['count'])}
            elif list(h['edges']) == cur['edges']:
                cur['counts'] = [a + b for a, b in
                                 zip(cur['counts'], h['counts'])]
                cur['sum'] += float(h['sum'])
                cur['count'] += int(h['count'])
            else:
                # first-seen bucketing wins; a mismatched worker still
                # contributes its sum/count so totals stay honest
                cur['counts'][-1] += sum(h['counts'])
                cur['sum'] += float(h['sum'])
                cur['count'] += int(h['count'])
    for n in sorted(hists):
        h = hists[n]
        m = _prom_name(n, prefix)
        _prom_block(lines, m, 'histogram',
                    'job-summed histogram %s' % n, seen)
        prom_histogram_lines(lines, m, h['edges'], h['counts'],
                             h['sum'], h['count'])
    return '\n'.join(lines) + '\n'


# ----------------------------------------------------------- aggregator
# '0=host:port,1=host:port' -> [(rank, endpoint), ...]; one parser for
# the PADDLE_TPU_STATUS_WORKERS wire format, shared with
# trace.collect_job so the two planes can never read one spec two ways
_parse_workers = trace._parse_worker_spec


def _http_get(url, timeout):
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read()


class _Aggregator(object):
    """Rank 0's merged view of the job: a background prober scrapes
    every worker's /metrics.json each heartbeat interval; /metrics and
    /healthz on the owning server read the cached results, so a dead
    worker flips readiness within ``FLAGS_heartbeat_misses`` intervals
    (default 3 — ONE dropped scrape of a previously-up worker is a
    flap, ``elastic/heartbeat_flaps``, not a death) without any
    request traffic."""

    def __init__(self, self_rank, workers, interval):
        self.self_rank = str(self_rank)
        self.all_workers = [(str(r), ep) for r, ep in workers]
        self.workers = [(r, ep) for r, ep in self.all_workers
                        if r != self.self_rank]
        self.interval = float(interval)
        self.misses = max(1, int(get_flag('FLAGS_heartbeat_misses', 3)
                                 or 3))
        self._miss = {r: 0 for r, _ep in self.workers}
        self._was_up = set()
        self._lock = threading.Lock()
        self._peers = {r: {'endpoint': ep, 'up': False, 'ready': False,
                           'state': None, 'status': None, 'error': None,
                           'rollup': None, 'ts': 0.0}
                       for r, ep in self.workers}
        self._last_skew = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name='pt_health_agg')
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            self.probe_once()
            self.check_skew()
            self._history_tick()
            self._stop.wait(self.interval)

    def _history_tick(self):
        """Heartbeat leg of the fluid.timeseries sampling cadence:
        retain this process's OWN registry in the job history (the
        prober only scrapes peers) and take a local sample — which is
        also what evaluates SLOs on an aggregator that is not
        stepping.  Never raises."""
        try:
            from . import timeseries
            if not timeseries.enabled():
                return
            timeseries.job_sample(self.self_rank, monitor.raw_state())
            timeseries.maybe_sample(source='heartbeat')
        except Exception:
            monitor.add('health/history_errors')

    def _probe_one(self, rank, ep):
        monitor.add('health/scrapes')
        rec = {'endpoint': ep, 'ts': time.time()}
        try:
            code, body = _http_get('http://%s/metrics.json' % ep,
                                   timeout=self.interval)
            doc = json.loads(body.decode('utf-8'))
            rec.update({'up': True,
                        'ready': bool(doc.get('status', {})
                                      .get('ready')),
                        'state': doc.get('state'),
                        'status': doc.get('status'),
                        'rollup': doc.get('step_rollup'),
                        'error': None})
        except Exception as e:
            monitor.add('health/scrape_errors')
            rec.update({'up': False, 'ready': False, 'state': None,
                        'status': None, 'rollup': None,
                        'error': str(e)})
        with self._lock:
            prev = self._peers[rank]
            if rec['up']:
                misses = self._miss.get(rank, 0)
                if 0 < misses < self.misses and rank in self._was_up:
                    # recovered short of the threshold: a flap, not a
                    # death-and-readmission
                    monitor.add('elastic/heartbeat_flaps')
                elif misses >= self.misses and rank in self._was_up:
                    # a worker declared down answering again is a
                    # RE-ADMISSION (restarted, or partition healed) —
                    # the heartbeat.py accounting, mirrored.  A fresh
                    # worker's slow boot is neither.
                    monitor.add('elastic/readmissions')
                self._was_up.add(rank)
                self._miss[rank] = 0
            else:
                self._miss[rank] = self._miss.get(rank, 0) + 1
                if prev['up'] and self._miss[rank] < self.misses:
                    # tolerated miss: keep the last good scrape's
                    # up/ready/state so one dropped packet does not
                    # flip job readiness (the error is still recorded)
                    rec = {'endpoint': rec['endpoint'],
                           'ts': rec['ts'], 'error': rec['error']}
            self._peers[rank].update(rec)
            up_now = self._peers[rank]['up']
        monitor.set_gauge('health/worker_up/%s' % rank,
                          1.0 if up_now else 0.0)
        # job-level history (fluid.timeseries): every heartbeat's
        # scrape lands in the per-worker ring; a failed scrape leaves
        # an explicit gap marker so a window over a dead worker shows
        # the hole instead of bridging its last level
        try:
            from . import timeseries
            if timeseries.enabled():
                if rec.get('state'):
                    timeseries.job_sample(rank, rec['state'],
                                          now=rec['ts'])
                else:
                    timeseries.job_gap(rank, now=rec['ts'])
        except Exception:
            monitor.add('health/history_errors')

    # ------------------------------------------- straggler / skew
    def skew(self):
        """Cross-rank skew report over the latest scraped step rollups
        (plus this process's own flight recorder); None until some
        rank has steps."""
        rollups = {}
        try:
            rollups[self.self_rank] = trace.step_rollup()
        except Exception:
            pass
        for r, p in self.peers().items():
            if p.get('rollup'):
                rollups[r] = p['rollup']
        return trace.job_skew_report(rollups)

    def check_skew(self):
        """One detector pass (called each heartbeat): publish the
        comms/skew_ratio gauge and, past FLAGS_straggler_factor, count
        the trip and auto-dump the flight recorder with the skew
        report embedded — rate-limited to one dump per ten heartbeats
        so a persistently skewed job cannot spam /tmp.  Never
        raises."""
        try:
            rep = self.skew()
        except Exception:
            return None
        self._last_skew = rep
        if rep is None:
            return None
        ratio = float(rep['wall']['skew_ratio'])
        monitor.set_gauge('comms/skew_ratio', ratio)
        factor = float(get_flag('FLAGS_straggler_factor', 0.0) or 0.0)
        if factor > 0 and ratio >= factor:
            monitor.add('comms/straggler_trips')
            path = trace.rate_limited_dump(
                'health/straggler', 10 * self.interval,
                tag='straggler',
                extra={'detector': 'straggler', 'skew': rep})
            if path:
                monitor.add('health/detector_dumps')
        return rep

    @staticmethod
    def _memory_view(gauges):
        """Per-worker memory rollup from scraped memviz gauges (None
        until that worker's sampler ran)."""
        total = gauges.get('memviz/live_bytes_total')
        if total is None:
            return None
        return {'live_bytes': total,
                'live_bytes_hwm': gauges.get('memviz/live_bytes_hwm'),
                'budget_utilization': gauges.get(
                    'memviz/budget_utilization'),
                'segment_peak_bytes': gauges.get(
                    'executor/segment_peak_bytes')}

    def job_view(self):
        """The /statusz 'job' section: per-rank liveness, per-rank
        memory (live HBM + budget utilization from the memviz
        sampler), and the last heartbeat's skew report."""
        own = status()
        now = time.time()
        workers = {self.self_rank: {
            'up': True, 'ready': own['ready'], 'endpoint': 'local',
            'steps': own['steps'], 'last_scrape_age_s': 0.0,
            'memory': self._memory_view(monitor.raw_state()['gauges'])}}
        for r, p in self.peers().items():
            workers[r] = {
                'up': p['up'], 'ready': p['ready'],
                'endpoint': p['endpoint'], 'error': p['error'],
                'steps': (p.get('status') or {}).get('steps'),
                'memory': self._memory_view(
                    (p.get('state') or {}).get('gauges') or {}),
                'last_scrape_age_s': (round(now - p['ts'], 3)
                                      if p['ts'] else None)}
        return {'workers': workers, 'skew': self._last_skew,
                'heartbeat_seconds': self.interval}

    def collect_job(self, out_path=None):
        """Job-wide trace collection (the tentpole): pull every
        worker's /trace/dump, fold in this process's own flight
        recorder, return ONE merged Perfetto timeline document."""
        return trace.collect_job(workers=self.all_workers,
                                 local=self.self_rank,
                                 timeout=max(self.interval, 5.0),
                                 out_path=out_path)

    def probe_once(self):
        # concurrent probes: a partitioned host times out after ONE
        # interval, not worker-count × interval — the within-one-
        # heartbeat readiness-flip promise holds at any job size
        threads = [threading.Thread(target=self._probe_one,
                                    args=(rank, ep), daemon=True)
                   for rank, ep in self.workers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(self.interval + 1.0)

    def stop(self):
        self._stop.set()

    def peers(self):
        with self._lock:
            return {r: dict(p) for r, p in self._peers.items()}

    def peer_health(self):
        """Per-worker liveness with the consecutive-miss state — the
        signal the self-healing supervisor consumes: `misses` is the
        current consecutive-miss run, `confirmed_down` flips only at
        the FLAGS_heartbeat_misses threshold (and only for a worker
        that was ever up: a fresh worker's slow boot is not a death),
        `up` is the last scrape's verdict."""
        with self._lock:
            out = {}
            for r, p in self._peers.items():
                misses = self._miss.get(r, 0)
                was_up = r in self._was_up
                out[r] = {
                    'up': bool(p['up']),
                    'ready': bool(p['ready']),
                    'endpoint': p['endpoint'],
                    'misses': misses,
                    'was_up': was_up,
                    'confirmed_down': bool(was_up and
                                           misses >= self.misses),
                }
            return out

    def healthz(self):
        own = status()
        peers = self.peers()
        workers = {self.self_rank: {'up': True, 'ready': own['ready'],
                                    'endpoint': 'local'}}
        for r, p in peers.items():
            workers[r] = {'up': p['up'], 'ready': p['ready'],
                          'endpoint': p['endpoint'],
                          'error': p['error']}
        ready = all(w['up'] and w['ready'] for w in workers.values())
        return {'aggregated': True, 'ready': ready,
                'workers': workers, 'self': own,
                'heartbeat_seconds': self.interval}

    def metrics_text(self):
        states = [(self.self_rank, monitor.raw_state())]
        peers = self.peers()
        for r in sorted(peers):
            if peers[r]['state']:
                states.append((r, peers[r]['state']))
        text = render_merged(states)
        from .monitor import _prom_name, prom_sample
        lines = []
        m = _prom_name('health/agg_worker_up', 'paddle_tpu')
        lines.append('# HELP %s 1 when the worker answered the last '
                     'health scrape' % m)
        lines.append('# TYPE %s gauge' % m)
        lines.append(prom_sample(m, [('worker', self.self_rank),
                                     ('endpoint', 'local')], 1.0))
        for r in sorted(peers):
            p = peers[r]
            lines.append(prom_sample(
                m, [('worker', r), ('endpoint', p['endpoint'])],
                1.0 if p['up'] else 0.0))
        return text + '\n'.join(lines) + '\n'


# ----------------------------------------------------------- http plane
class HealthServer(object):
    """Handle over the background status server: `.port`, `.url`,
    `.aggregator` (None on plain workers), `.stop()`."""

    def __init__(self, httpd, thread, aggregator):
        self._httpd = httpd
        self._thread = thread
        self.aggregator = aggregator
        self.host, self.port = httpd.server_address[:2]
        self.url = 'http://%s:%d' % (self.host, self.port)

    def stop(self):
        global _server
        if self.aggregator is not None:
            self.aggregator.stop()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        if _server is self:
            _server = None


_server = None
_serve_lock = threading.Lock()


def _make_handler(aggregator):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        # the status plane must never write request logs into a
        # trainer's stdout
        def log_message(self, fmt, *args):
            pass

        def _send(self, code, body, ctype):
            if isinstance(body, str):
                body = body.encode('utf-8')
            self.send_response(code)
            self.send_header('Content-Type', ctype)
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code, doc):
            self._send(code, json.dumps(doc, sort_keys=True,
                                        default=str),
                       'application/json')

        def do_GET(self):
            monitor.add('health/http_requests')
            parts = self.path.split('?', 1)
            path = parts[0].rstrip('/') or '/'
            try:
                if path == '/metrics':
                    if aggregator is not None:
                        text = aggregator.metrics_text()
                    else:
                        text = monitor.prometheus_text()
                    self._send(200, text,
                               'text/plain; version=0.0.4')
                elif path == '/metrics/local':
                    self._send(200, monitor.prometheus_text(),
                               'text/plain; version=0.0.4')
                elif path == '/metrics.json':
                    self._send_json(200, {'rank': _self_rank(),
                                          'state': monitor.raw_state(),
                                          'status': status(),
                                          'step_rollup':
                                              trace.step_rollup()})
                elif path == '/healthz':
                    if aggregator is not None:
                        doc = aggregator.healthz()
                    else:
                        doc = status()
                    self._send_json(200 if doc['ready'] else 503, doc)
                elif path == '/healthz/local':
                    doc = status()
                    self._send_json(200 if doc['ready'] else 503, doc)
                elif path == '/statusz':
                    self._send_json(200, statusz())
                elif path == '/trace/dump':
                    p = trace.dump()
                    with open(p) as f:
                        doc = json.load(f)
                    doc['ptDumpPath'] = p
                    self._send_json(200, doc)
                elif path == '/trace/collect':
                    if aggregator is None:
                        self._send_json(404, {
                            'error': 'not the aggregator rank; '
                                     'scrape rank 0'})
                    else:
                        self._send_json(200, aggregator.collect_job())
                elif path == '/timeseries':
                    from urllib.parse import parse_qs
                    from . import timeseries
                    qs = parse_qs(parts[1]) if len(parts) > 1 else {}
                    params = {k: v[-1] for k, v in qs.items()}
                    code, doc = timeseries.http_query(params)
                    self._send_json(code, doc)
                elif path == '/alertz':
                    from . import slo
                    self._send_json(200, slo.alertz())
                elif path == '/opprof':
                    # on-demand eager replay over the stashed steps +
                    # the ranked kernel worklist; bounded by the
                    # snapshot registry, runs on this handler thread
                    from . import opprof
                    self._send_json(200, opprof.http_report())
                else:
                    self._send_json(404, {
                        'error': 'unknown path %s' % path,
                        'paths': ['/metrics', '/metrics.json',
                                  '/metrics/local', '/healthz',
                                  '/healthz/local', '/statusz',
                                  '/timeseries', '/alertz', '/opprof',
                                  '/trace/dump', '/trace/collect']})
            except Exception as e:  # a broken handler must not kill
                monitor.add('health/http_errors')
                try:
                    self._send_json(500, {'error': str(e)})
                except Exception:
                    pass

    return Handler


def serve(port=None, host=None):
    """Start (or return) the process's status server.  `port=None`
    reads FLAGS_status_port; `port=0` binds an ephemeral port (read it
    back from `.port`).  `host=None` reads PADDLE_TPU_STATUS_HOST
    (loopback by default; the multi-node launcher sets 0.0.0.0 so the
    rank-0 aggregator can scrape across hosts).  When
    PADDLE_TPU_STATUS_WORKERS names the job's workers and this process
    is the aggregator rank (distributed/launch.py sets both), the
    server also merges the job: /metrics and /healthz become the
    single scrape target.  Idempotent: a second call returns the live
    server."""
    global _server
    with _serve_lock:
        if _server is not None:
            return _server
        if port is None:
            port = int(get_flag('FLAGS_status_port', 0) or 0)
        if host is None:
            host = os.environ.get('PADDLE_TPU_STATUS_HOST',
                                  '127.0.0.1')
        from http.server import ThreadingHTTPServer
        aggregator = None
        spec = os.environ.get('PADDLE_TPU_STATUS_WORKERS', '')
        agg_env = os.environ.get('PADDLE_TPU_STATUS_AGGREGATE')
        is_agg = (agg_env == '1') or (
            agg_env is None and spec and _self_rank() == '0')
        if spec and is_agg:
            aggregator = _Aggregator(
                _self_rank(), _parse_workers(spec),
                float(get_flag('FLAGS_health_heartbeat_seconds', 2.0)
                      or 2.0))
        httpd = ThreadingHTTPServer((host, int(port)),
                                    _make_handler(aggregator))
        httpd.daemon_threads = True
        thread = threading.Thread(target=httpd.serve_forever,
                                  daemon=True, name='pt_health_http')
        thread.start()
        _server = HealthServer(httpd, thread, aggregator)
        monitor.set_gauge('health/status_port', _server.port)
        return _server


def server():
    """The live HealthServer, or None."""
    return _server


def stop():
    """Stop the status server if one is running."""
    s = _server
    if s is not None:
        s.stop()


def ensure_serving():
    """FLAGS_status_port auto-start hook (called once per Executor
    construction — cheap when off or already serving)."""
    if _server is None and int(get_flag('FLAGS_status_port', 0) or 0):
        try:
            serve()
        except Exception as e:  # port taken etc: status is best-effort
            monitor.add('health/serve_errors')
            import warnings
            warnings.warn('status server failed to start: %s' % e)


# ------------------------------------------------------- NaN provenance
def tensor_stats(v):
    """Host-side summary of one tensor for incident reports:
    shape/dtype/min/max/l2/%nonfinite.  Post-mortem only — this copies
    the value to the host."""
    import numpy as np
    try:
        from . import core
        arr = core.to_numpy(v) if hasattr(core.as_array(v), 'device') \
            else np.asarray(v)
    except Exception as e:
        return {'error': str(e)}
    out = {'shape': list(arr.shape), 'dtype': str(arr.dtype)}
    if arr.size and (np.issubdtype(arr.dtype, np.floating) or
                     arr.dtype.name == 'bfloat16'):
        a64 = arr.astype(np.float64, copy=False)
        finite = np.isfinite(a64)
        out['nonfinite_pct'] = round(
            100.0 * (1.0 - float(finite.mean())), 4)
        if finite.any():
            f = a64[finite]
            out['min'] = float(f.min())
            out['max'] = float(f.max())
            out['l2'] = float(np.sqrt((f * f).sum()))
        else:
            out['min'] = out['max'] = out['l2'] = None
    return out


def nan_provenance(ops, state, data, step, device=None, program=None):
    """Replay a failed step op by op through the executor's op runner
    (the reference's nan_inf_utils_detail per-op sweep, run post-mortem
    instead of per step) and name the FIRST op whose output went
    non-finite.  `state`/`data` are the executor's copies of the scope
    values and feeds the step read; `ops` the step's ops in program
    order (grad ops included: each replays its forward op).  Returns a
    JSON-able report, or None when the replay stays finite.  Never
    raises — this runs inside an error path."""
    try:
        import torch
        from .executor import replay_ops
        env = dict(data)
        env.update(state)
        for rec in replay_ops(env, ops, step, device, program):
            bad = [n for n, v in rec['writes'].items()
                   if isinstance(v, torch.Tensor) and
                   v.is_floating_point() and
                   not bool(torch.isfinite(v).all())]
            if bad:
                op = rec['op']
                return {
                    'op_index': rec['index'],
                    'op_type': op.type,
                    'outputs': bad,
                    'output_stats': {n: tensor_stats(rec['writes'][n])
                                     for n in bad},
                    'input_stats': {n: tensor_stats(v)
                                    for n, v in rec['reads'].items()},
                    'op_callstack': list(
                        op.attrs.get('__op_callstack__') or [])[:8],
                }
        return None
    except Exception as e:
        return {'replay_error': str(e)}


def format_provenance(report):
    """Render a nan_provenance report as the FloatingPointError note
    block."""
    if report is None:
        return ('op-by-op replay stayed finite (the step diverged from '
                'the per-op path; inspect the flight-recorder dump)')
    if 'replay_error' in report:
        return 'op-by-op replay failed: %s' % report['replay_error']
    lines = ["first non-finite value produced by op [%s] (op #%d), "
             'outputs %r' % (report['op_type'], report['op_index'],
                             report['outputs'])]
    for n, st in sorted(report.get('output_stats', {}).items()):
        lines.append('  output %s: %s' % (n, _fmt_stats(st)))
    for n, st in sorted(report.get('input_stats', {}).items()):
        lines.append('  input  %s: %s' % (n, _fmt_stats(st)))
    stack = report.get('op_callstack') or []
    if stack:
        lines.append('op created at (most recent call first):')
        lines.extend('  ' + s for s in stack)
    return '\n'.join(lines)


def _fmt_stats(st):
    if 'error' in st:
        return 'unreadable (%s)' % st['error']
    base = 'shape=%s dtype=%s' % (tuple(st.get('shape', ())),
                                  st.get('dtype'))
    if 'nonfinite_pct' in st:
        base += ' min=%s max=%s l2=%s nonfinite=%s%%' % (
            st.get('min'), st.get('max'), st.get('l2'),
            st.get('nonfinite_pct'))
    return base


# ------------------------------------------------------- tensor health
_hstate = {'ema': None, 'zero_run': 0, 'last_dump_step': None}


def reset_state():
    """Reset the detectors' running state (tests, new training run).
    ``_hstate`` is SINGLE-WRITER per-step detector state (only the
    executor's step thread mutates it; /statusz never reads it), so
    it takes no lock."""
    _hstate['ema'] = None
    _hstate['zero_run'] = 0
    _hstate['last_dump_step'] = None


def _finite_or_zero(x):
    import math
    return x if math.isfinite(x) else 0.0


def summarize_step(step, out, prev_params, param_names, grad_map):
    """Per-step tensor-health summaries (FLAGS_health_summaries): for
    every parameter the step updated, weight / grad / update norms
    computed on the device, all of them stacked and fetched to the host
    in ONE copy (no ``.item()`` a parameter), recorded into monitor
    histograms, plus a global grad norm gauge + histogram.  `out` maps
    names to the step's tensors (parameters and their gradients),
    `prev_params` holds the executor's pre-step copies (update ratios
    need them; an empty dict degrades gracefully), `grad_map` maps a
    parameter to its gradient's name.  Detectors: a grad-norm spike
    over the running EMA or FLAGS_health_zero_update_steps consecutive
    zero-update steps auto-dump the flight recorder.  Never raises."""
    t0 = time.perf_counter()
    try:
        import math
        import torch
        keys = []   # (param, kind)
        vals = []   # 0-d f32 device tensors
        for p in param_names:
            w = out.get(p)
            if not isinstance(w, torch.Tensor) or \
                    not w.is_floating_point():
                continue
            wa = w.detach().float()
            keys.append((p, 'w'))
            vals.append(torch.linalg.vector_norm(wa))
            g = out.get(grad_map.get(p))
            if isinstance(g, torch.Tensor) and g.is_floating_point():
                keys.append((p, 'g'))
                vals.append(torch.linalg.vector_norm(g.detach().float()))
            prev = prev_params.get(p)
            if isinstance(prev, torch.Tensor) and prev.shape == w.shape:
                keys.append((p, 'u'))
                vals.append(torch.linalg.vector_norm(
                    wa - prev.detach().float().to(wa.device)))
        if not vals:
            return
        # every reduction is queued; one device-to-host copy of them all
        host = torch.stack([v.to(vals[0].device) for v in vals]).cpu() \
            .tolist()
        per = {}
        for (p, kind), v in zip(keys, host):
            per.setdefault(p, {})[kind] = float(v)
        gsq = 0.0
        saw_grads = False
        max_ratio = None
        for p, d in per.items():
            if 'w' in d:
                monitor.observe('health/weight_norm',
                                _finite_or_zero(d['w']),
                                monitor.NORM_BUCKETS)
            if 'g' in d:
                monitor.observe('health/grad_norm',
                                _finite_or_zero(d['g']),
                                monitor.NORM_BUCKETS)
                saw_grads = True
                gsq += d['g'] * d['g'] if math.isfinite(d['g']) else 0.0
            if 'u' in d and 'w' in d:
                ratio = d['u'] / (d['w'] + 1e-12)
                monitor.observe('health/update_ratio',
                                _finite_or_zero(ratio),
                                monitor.NORM_BUCKETS)
                max_ratio = ratio if max_ratio is None \
                    else max(max_ratio, ratio)
        monitor.set_gauge('health/params_tracked', len(per))
        monitor.add('health/summary_steps')
        if saw_grads:
            gnorm = math.sqrt(gsq)
            monitor.observe('health/global_grad_norm', gnorm,
                            monitor.NORM_BUCKETS)
            monitor.set_gauge('health/last_global_grad_norm', gnorm)
            ema = _hstate['ema']
            factor = float(get_flag('FLAGS_health_spike_factor', 10.0)
                           or 0.0)
            if ema is not None and ema > 0 and factor > 0 and \
                    gnorm > factor * ema:
                monitor.add('health/grad_spikes')
                _auto_dump(step, 'gradspike', {
                    'detector': 'grad_spike', 'step': step,
                    'global_grad_norm': gnorm, 'ema': ema,
                    'factor': factor})
            _hstate['ema'] = gnorm if ema is None else \
                0.9 * ema + 0.1 * gnorm
        k = int(get_flag('FLAGS_health_zero_update_steps', 3) or 0)
        if k > 0 and max_ratio is not None:
            if max_ratio <= 0.0:
                _hstate['zero_run'] += 1
                if _hstate['zero_run'] == k:
                    monitor.add('health/zero_update_trips')
                    _auto_dump(step, 'zeroupdate', {
                        'detector': 'zero_update', 'step': step,
                        'consecutive_steps': k})
            else:
                _hstate['zero_run'] = 0
    except Exception:
        monitor.add('health/summary_errors')
    finally:
        t1 = time.perf_counter()
        monitor.observe('health/summary_seconds', t1 - t0)
        trace.record('health_summaries', t0, t1)


def _auto_dump(step, tag, extra):
    """Detector incident dump, rate-limited to one per retained flight-
    recorder window so a persistently sick job doesn't spam /tmp."""
    last = _hstate['last_dump_step']
    window = int(get_flag('FLAGS_trace_buffer_steps', 16) or 16)
    if last is not None and step - last < window:
        return
    _hstate['last_dump_step'] = step
    path = trace.dump_on_error('%s_step%s' % (tag, step), extra=extra)
    if path:
        monitor.add('health/detector_dumps')
