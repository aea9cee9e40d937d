"""fluid.trace — always-available structured step timeline.

Reference: platform/profiler.h RecordEvent + tools/timeline.py turned
the C++ runtime's host spans and the CUPTI device trace into one
chrome://tracing file (JAX: fluid/trace.py, whose spans, flight
recorder, report and export this module keeps).  Between the counters
(fluid.monitor) and the device capture (torch.profiler with CUPTI,
fluid.profiler) this is the span plane that says WHERE inside a step
the milliseconds go: bind, feed staging, dispatch, the CUDA-graph
replay, the fetch, the host ops, the reader's wait.

- ``span(name, **args)`` / ``record(name, t0, t1)`` / ``@traced``:
  named, thread-aware host spans on the monotonic clock.  DISABLED (the
  default) a call site costs one function call + one global load;
  nothing locks, and the hottest per-step sites (bind, dispatch,
  fetch, state_release, step) pass no kwargs so they do not even
  allocate.  Spans sit at step, plan and segment level, never per op.

- a **ring-buffer flight recorder**: while enabled, every executor step
  closes one step record (its spans, wall time) into a deque holding
  the last ``FLAGS_trace_buffer_steps`` steps.  ``dump()`` writes them
  as chrome-trace JSON on demand; the executor dumps automatically when
  FLAGS_check_nan_inf trips or a step's dispatch fails, so the last N
  steps before an incident are always recoverable (``dump_on_error``).

- a **chrome-trace/Perfetto exporter + device-trace merger**:
  ``chrome_events()`` renders host spans as trace events;
  ``merge_device_trace()`` folds them into a torch.profiler chrome
  export on a shared clock (a ``pt_clock_sync`` record_function range
  emitted at capture start pins the offset; session-relative device
  clocks fall back to capture-start alignment).
  ``fluid.profiler.start_trace`` / ``stop_trace`` auto-attach this
  tracer, so one capture yields the combined host+device timeline.

- a **per-step report**: ``step_report()`` breaks each recorded step
  into its top-level phases (bind / feed_h2d / dispatch / reader_wait /
  fetch_d2h / state_release / host_op), with p50/p99 and slowest-step
  rollups.

Hot-path discipline mirrors fluid.monitor: plain list appends under the
GIL (losing a span to a racing step swap is a stats-grade race, never
corruption), NO torch imports, and every recording site also keeps its
monitor counter so the two planes agree.  Nothing here runs inside a
CUDA-graph capture: the executor records a replayed step around
``graph.replay()``.
"""

import collections
import os
import threading
import time

from . import monitor
from .flags import get_flag

__all__ = [
    'enable', 'disable', 'is_active', 'reset', 'span', 'record',
    'traced', 'step_span', 'step_tags', 'steps', 'step_report',
    'step_rollup', 'report_from_records', 'format_step_report',
    'counter', 'counters', 'chrome_events', 'merge_device_trace',
    'write_chrome', 'dump', 'dump_payload', 'dump_on_error',
    'rate_limited_dump', 'collect_job', 'job_skew_report', 'now_us',
]

# monotonic->epoch anchor: every span stores perf_counter floats; the
# exporter translates them to epoch microseconds with ONE fixed pair so
# all host events share a clock (and NTP steps mid-run cannot skew it)
_P0 = time.perf_counter()
_T0 = time.time()

_active = False
_events = []        # finished spans of the current step window
_counters = []      # (name, t, {series: value}) counter samples —
                    # the Perfetto counter tracks (memviz live-HBM)
_steps = None       # deque of closed step records (the flight recorder)
_capture = None     # device-capture session: {'t0_us', 'sync_us', 'events'}
_tls = threading.local()
_lock = threading.RLock()

# span tuple layout: (name, t0, t1, tid, depth, args_or_None)


def now_us(t=None):
    """Epoch microseconds of perf_counter time `t` (default: now)."""
    if t is None:
        t = time.perf_counter()
    return (_T0 + (t - _P0)) * 1e6


def is_active():
    return _active


def enable(buffer_steps=None):
    """Turn the span tracer + flight recorder on.  `buffer_steps`
    overrides FLAGS_trace_buffer_steps for the ring capacity;
    re-enabling with the same (or no explicit) capacity keeps the
    buffer untouched, and an explicit resize keeps the NEWEST records,
    counting any it discards in trace/steps_dropped — never a silent
    loss of the retained incident window."""
    global _active, _steps
    with _lock:
        if buffer_steps is None:
            buffer_steps = int(get_flag('FLAGS_trace_buffer_steps', 16)
                               or 16)
        n = max(1, int(buffer_steps))
        if _steps is None or _steps.maxlen != n:
            old = list(_steps or ())
            dropped = len(old) - n
            if dropped > 0:
                monitor.add('trace/steps_dropped', float(dropped))
            _steps = collections.deque(old, maxlen=n)
        _active = True


def disable():
    """Stop recording; retained step records stay readable until
    reset()."""
    global _active
    _active = False


def reset():
    """Drop every recorded span/step (tests, bench entry isolation).
    An ACTIVE tracer keeps recording into a fresh ring of the same
    capacity — reset must never silently kill the flight recorder —
    and an attached device-capture session keeps its identity (events
    cleared): detach_capture() must still run and restore the
    pre-capture enabled state."""
    global _events, _steps
    with _lock:
        _events = []
        del _counters[:]
        if _capture is not None:
            _capture['events'] = []
            _capture['counters'] = []
        if _active:
            n = _steps.maxlen if _steps is not None else max(
                1, int(get_flag('FLAGS_trace_buffer_steps', 16) or 16))
            _steps = collections.deque(maxlen=n)
        else:
            _steps = None
        _rate_limited.clear()


def _depth():
    return getattr(_tls, 'depth', 0)


# bound on the OPEN span window and on a capture session's event list:
# the step ring bounds sealed records, but an always-on tracer driving
# stepless work (standalone reader loops, ad-hoc spans) — or a capture
# never stopped — would otherwise grow these lists for the life of the
# process.  Overflow drops the oldest half and counts it.
_WINDOW_CAP = 65536
# counter-sample window (trace.counter): one sample per sampled step —
# 4096 retains hours of 1/step sampling while keeping incident dumps
# step-window-scaled, not run-length-scaled
_COUNTER_CAP = 4096


def _trim(ev, stat='trace/window_spans_dropped'):
    if len(ev) > _WINDOW_CAP:
        n = _WINDOW_CAP // 2
        del ev[:n]
        monitor.add(stat, float(n))


def _emit(rec):
    ev = _events
    ev.append(rec)
    _trim(ev)
    cap = _capture
    if cap is not None:
        cap['events'].append(rec)
        _trim(cap['events'])
    monitor.add('trace/spans_recorded')


def record(name, t0, t1, args=None):
    """Record one finished span from explicit perf_counter times — for
    sites that already time themselves (binder, blocked fetch).  No-op
    when the tracer is off."""
    if not _active:
        return
    _emit((name, t0, t1, threading.get_ident(), _depth(), args))


def counter(name, values, t=None):
    """Record one COUNTER TRACK sample — a named set of series values
    at one instant (the memviz live-HBM sampler's per-class bytes).
    The exporter renders these as Perfetto 'C' events, so counters and
    spans read on one time axis.  Off: a no-op; counters ride their
    own bounded window (spans' phase decomposition never sees them)."""
    if not _active:
        return
    if t is None:
        t = time.perf_counter()
    rec = (str(name), float(t),
           {str(k): float(v) for k, v in values.items()})
    _counters.append(rec)
    # counters keep a much smaller window than open spans: they are a
    # per-step time series, and a dump should stay bounded near the
    # flight recorder's step window, not carry the whole run's history.
    # Their evictions get their own drop signal (an operator debugging
    # span loss must not see counter evictions inflate span counters).
    if len(_counters) > _COUNTER_CAP:
        n = _COUNTER_CAP // 2
        del _counters[:n]
        monitor.add('trace/counter_samples_dropped', float(n))
    cap = _capture
    if cap is not None:
        cap.setdefault('counters', []).append(rec)
        _trim(cap['counters'], 'trace/counter_samples_dropped')
    monitor.add('trace/counter_samples')


def counters():
    """The retained counter samples, oldest first."""
    return list(_counters)


class _NullSpan(object):
    """Shared no-op span: the disabled-mode fast path allocates
    nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span(object):
    __slots__ = ('name', 'args', '_t0', '_depth')

    def __init__(self, name, args):
        self.name = name
        self.args = args

    def __enter__(self):
        d = _depth()
        self._depth = d
        _tls.depth = d + 1
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        _tls.depth = self._depth
        if _active:
            _emit((self.name, self._t0, t1, threading.get_ident(),
                   self._depth, self.args or None))
        return False


def span(name, **args):
    """Context manager timing one named span.  Off: returns a shared
    null object (one global load, no allocation)."""
    if not _active:
        return _NULL
    return _Span(name, args)


def traced(name=None):
    """Decorator form of span(): ``@traced('phase')`` or bare
    ``@traced()`` (uses the function name)."""
    def deco(fn):
        label = name or fn.__name__

        def wrapper(*a, **k):
            if not _active:
                return fn(*a, **k)
            with _Span(label, None):
                return fn(*a, **k)
        wrapper.__name__ = fn.__name__
        wrapper.__doc__ = fn.__doc__
        return wrapper
    return deco


class _StepTags(object):
    """Ambient per-thread tags merged into every step record sealed
    while the context is open — the serving plane wraps each coalesced
    batch's executor run in one so `step_report()` / the flight
    recorder attribute the step to its tenant and batch size."""

    __slots__ = ('_tags', '_prev')

    def __init__(self, tags):
        self._tags = tags

    def __enter__(self):
        prev = getattr(_tls, 'step_tags', None)
        self._prev = prev
        merged = dict(prev) if prev else {}
        merged.update(self._tags)
        _tls.step_tags = merged
        return self

    def __exit__(self, *exc):
        _tls.step_tags = self._prev
        return False


def step_tags(**tags):
    """Tag the step records sealed inside the context (nests: inner
    tags shadow outer ones).  Off: the shared null span."""
    if not _active:
        return _NULL
    return _StepTags(tags)


class _StepSpan(object):
    """Span over one executor step; closing it seals the current span
    window into a flight-recorder step record."""

    __slots__ = ('step', '_t0', '_depth', '_nested')

    def __init__(self, step):
        self.step = step

    def __enter__(self):
        # nested step spans (a pipeline step driving an inner run)
        # degrade to plain spans: only the outermost seals the record
        self._nested = getattr(_tls, 'in_step', False)
        _tls.in_step = True
        d = _depth()
        self._depth = d
        _tls.depth = d + 1
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        global _events
        t1 = time.perf_counter()
        _tls.depth = self._depth
        _tls.in_step = self._nested
        if not _active:
            return False
        if self._nested:
            _emit(('step', self._t0, t1, threading.get_ident(),
                   self._depth, {'step': self.step}))
            return False
        ev = _events
        _events = []    # swap: a racing append lands in the old list
        tags = getattr(_tls, 'step_tags', None)
        step_args = {'step': self.step}
        if tags:
            step_args.update(tags)
        cap = _capture
        if cap is not None:
            cap['events'].append(('step', self._t0, t1,
                                  threading.get_ident(), self._depth,
                                  step_args))
        with _lock:
            if _steps is not None:
                if _steps.maxlen and len(_steps) == _steps.maxlen:
                    monitor.add('trace/steps_dropped')
                rec = {'step': self.step, 't0': self._t0, 't1': t1,
                       'tid': threading.get_ident(), 'spans': ev}
                if tags:
                    rec['tags'] = dict(tags)
                _steps.append(rec)
        monitor.add('trace/steps_recorded')
        return False


def step_span(step):
    """Executor entry: wraps one step and seals its flight-recorder
    record on exit.  Off: the shared null span."""
    if not _active:
        return _NULL
    return _StepSpan(step)


def steps():
    """The flight recorder's retained step records, oldest first."""
    with _lock:
        return list(_steps or ())


# ---------------------------------------------------------------- report
def _span_fields(s):
    """(name, t0, t1, tid, depth, args) from a tuple or a JSON list."""
    return s[0], float(s[1]), float(s[2]), s[3], s[4], s[5]


def _top_level(spans):
    """Spans not strictly contained in a LONGER span of the same
    thread: the step's phase decomposition (nested detail — a compile
    inside a dispatch retry — stays out of the sums, so phases never
    double count).  Sorted interval sweep, O(n log n): incident dumps
    can hold a _WINDOW_CAP-sized partial record and a pairwise scan
    would take hours there."""
    by_tid = {}
    for s in spans:
        name, t0, t1, tid, _d, args = _span_fields(s)
        by_tid.setdefault(tid, []).append((name, t0, t1, tid, args))
    out = []
    for tid, rows in by_tid.items():
        # start asc, end desc: any container sorts before its contents
        rows.sort(key=lambda r: (r[1], -r[2]))
        max_end = None       # furthest end among earlier-starting spans
        max_end_start = None  # start of the span that set it
        for row in rows:
            _name, t0, t1, _tid, _args = row
            contained = max_end is not None and (
                max_end > t1 or (max_end == t1 and max_end_start < t0))
            if not contained:
                out.append(row)
            if max_end is None or t1 > max_end:
                max_end, max_end_start = t1, t0
    return out


def _pct(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def report_from_records(records):
    """Build the per-step report from step records (live tuples or the
    JSON lists a dump() file holds).

    Attribution convention: a step's record holds every span sealed
    since the PREVIOUS step — so work done between steps (reader
    waits, async-fetch resolution in user code) bills its full
    duration to the phase table of the step it delayed, the standard
    dataloader-time convention.  `coverage`/`accounted_ms` count only
    in-window time, so such spans widen the phase table without
    inflating coverage."""
    steps_out = []
    for rec in records:
        t0, t1 = float(rec['t0']), float(rec['t1'])
        wall = t1 - t0
        tid = rec.get('tid')
        phases = {}
        per_tid = {}
        for name, s0, s1, stid, _args in _top_level(rec['spans']):
            phases[name] = phases.get(name, 0.0) + (s1 - s0)
            # coverage counts ONE thread's spans clipped to the step
            # window: concurrent reader/compile threads must not push
            # "accounted" past 100%
            overlap = max(0.0, min(s1, t1) - max(s0, t0))
            per_tid[stid] = per_tid.get(stid, 0.0) + overlap
        if tid is not None:
            accounted = per_tid.get(tid, 0.0)
        else:
            # tid-less (partial/incident) record: take the busiest
            # single thread, still bounded by the window
            accounted = max(per_tid.values()) if per_tid else 0.0
        entry = {
            'step': rec.get('step'),
            'wall_ms': wall * 1e3,
            'phases_ms': {n: v * 1e3 for n, v in sorted(phases.items())},
            'accounted_ms': accounted * 1e3,
            'coverage': (accounted / wall) if wall > 0 else 0.0,
        }
        tags = rec.get('tags')
        if tags:
            entry['tags'] = dict(tags)
        steps_out.append(entry)
    walls = sorted(s['wall_ms'] for s in steps_out)
    phase_tot = {}
    for s in steps_out:
        for n, v in s['phases_ms'].items():
            phase_tot[n] = phase_tot.get(n, 0.0) + v
    slowest = max(steps_out, key=lambda s: s['wall_ms']) \
        if steps_out else None
    return {
        'steps': steps_out,
        'rollup': {
            'count': len(steps_out),
            'wall_p50_ms': _pct(walls, 0.50),
            'wall_p99_ms': _pct(walls, 0.99),
            'wall_max_ms': walls[-1] if walls else 0.0,
            'phases_ms': {n: v for n, v in sorted(phase_tot.items())},
            'slowest': slowest,
        },
    }


def step_report(last=None):
    """Report over the flight recorder's retained steps (`last` limits
    to the most recent N)."""
    recs = steps()
    if last:
        recs = recs[-int(last):]
    return report_from_records(recs)


def step_rollup(last=None):
    """Compact per-process rollup for cross-worker scrapes (the
    /metrics.json form the rank-0 aggregator's skew detector reads):
    step count, wall p50/p99/max, total phase milliseconds."""
    recs = steps()
    if last:
        recs = recs[-int(last):]
    return step_rollup_from(recs)


def _median(vals):
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _skew_reference(vals, slowest_key):
    """The skew denominator: median over the OTHER ranks.  Including
    the straggler itself would cap a 2-rank job's ratio at 2x no
    matter how slow the straggler is (the median of {fast, slow}
    contains half the straggler)."""
    others = [v for k, v in vals.items() if k != slowest_key]
    return _median(others) if others else vals[slowest_key]


# skew ratio when the reference is zero but the straggler is not (a
# phase only the straggler runs): a large FINITE sentinel — it trips
# any FLAGS_straggler_factor, and unlike inf it survives strict-JSON
# serialization of /statusz and collected job documents
_SKEW_UNBOUNDED = 1e9


def _skew_ratio(max_val, reference):
    if reference > 0:
        return max_val / reference
    return _SKEW_UNBOUNDED if max_val > 0 else 1.0


def job_skew_report(rollups):
    """Cross-rank straggler/skew analysis over per-rank step-report
    rollups ({rank: step_rollup()-shaped dict}).  Wall skew is the
    slowest rank's p50 over the median p50 of the REMAINING ranks (a
    single straggler cannot drag its own reference — see
    _skew_reference); each phase gets the same slowest-rank
    attribution over per-step phase milliseconds, so 'rank 3 spends
    2.1x the median step time, and the skew lives in dispatch' is one
    read.  Returns None when no rank has steps yet."""
    ranks = {str(r): roll for r, roll in (rollups or {}).items()
             if roll and roll.get('count')}
    if not ranks:
        return None
    wall = {r: float(roll.get('wall_p50_ms') or 0.0)
            for r, roll in ranks.items()}
    slowest = max(wall, key=lambda r: wall[r])
    med = _skew_reference(wall, slowest)
    per_rank = {}
    for r, roll in ranks.items():
        p50 = float(roll.get('wall_p50_ms') or 0.0)
        p99 = float(roll.get('wall_p99_ms') or 0.0)
        per_rank[r] = {
            'steps': int(roll['count']),
            'wall_p50_ms': p50,
            'wall_p99_ms': p99,
            'p99_over_p50': (p99 / p50) if p50 > 0 else 1.0,
        }
    phase_names = set()
    for roll in ranks.values():
        phase_names.update(roll.get('phases_ms') or {})
    phases = {}
    for name in sorted(phase_names):
        per_step = {r: float((roll.get('phases_ms') or {})
                             .get(name, 0.0)) / max(1, roll['count'])
                    for r, roll in ranks.items()}
        pslow = max(per_step, key=lambda r: per_step[r])
        pmed = _skew_reference(per_step, pslow)
        phases[name] = {
            'slowest_rank': pslow,
            'max_ms': per_step[pslow],
            'median_ms': pmed,
            'ratio': _skew_ratio(per_step[pslow], pmed),
        }
    return {
        'ranks': per_rank,
        'wall': {
            'slowest_rank': slowest,
            'max_p50_ms': wall[slowest],
            'median_p50_ms': med,
            'skew_ratio': _skew_ratio(wall[slowest], med),
        },
        'phases': phases,
    }


def format_step_report(report=None):
    """Render a report (default: the live one) as the per-step table
    tools/stat_summary.py --steps prints."""
    rep = report if report is not None else step_report()
    roll = rep['rollup']
    lines = ['steps: %d   wall p50 %.3f ms   p99 %.3f ms   max %.3f ms'
             % (roll['count'], roll['wall_p50_ms'], roll['wall_p99_ms'],
                roll['wall_max_ms'])]
    names = sorted(roll['phases_ms'],
                   key=lambda n: -roll['phases_ms'][n])
    lines.append('%-6s %10s %8s  %s'
                 % ('step', 'wall(ms)', 'cov%', 'phases(ms)'))
    for s in rep['steps']:
        ph = '  '.join('%s=%.3f' % (n, s['phases_ms'][n])
                       for n in names if n in s['phases_ms'])
        tags = s.get('tags')
        if tags:
            ph += '  [%s]' % ' '.join(
                '%s=%s' % (k, tags[k]) for k in sorted(tags))
        lines.append('%-6s %10.3f %7.0f%%  %s'
                     % (s['step'], s['wall_ms'],
                        100.0 * s['coverage'], ph))
    slow = roll.get('slowest')
    if slow is not None:
        lines.append('slowest: step %s at %.3f ms'
                     % (slow['step'], slow['wall_ms']))
    return '\n'.join(lines)


# ---------------------------------------------------------- chrome export
def _json_safe(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def chrome_events(span_tuples=None, pid=0, counter_samples=None):
    """Host spans -> chrome-trace 'X' events (epoch microseconds) plus
    process/thread metadata and counter-track 'C' events.  Default
    source: every span retained by the flight recorder + the current
    window, and the retained counter samples."""
    if span_tuples is None:
        span_tuples = []
        for rec in steps():
            span_tuples.extend(rec['spans'])
            step_args = {'step': rec.get('step')}
            step_args.update(rec.get('tags') or {})
            span_tuples.append(('step', rec['t0'], rec['t1'],
                                rec.get('tid'), 0, step_args))
        span_tuples.extend(list(_events))
        if counter_samples is None:
            counter_samples = counters()
    out = [{'ph': 'M', 'pid': pid, 'tid': 0, 'cat': 'pt_host',
            'name': 'process_name',
            'args': {'name': 'paddle_tpu host'}}]
    tid_map = {}
    for s in span_tuples:
        name, t0, t1, tid, _depth, args = _span_fields(s)
        if tid not in tid_map:
            tid_map[tid] = len(tid_map)
            out.append({'ph': 'M', 'pid': pid, 'tid': tid_map[tid],
                        'cat': 'pt_host', 'name': 'thread_name',
                        'args': {'name': 'host thread %d'
                                 % tid_map[tid]}})
        ev = {'ph': 'X', 'pid': pid, 'tid': tid_map[tid],
              'ts': now_us(t0), 'dur': max(0.0, (t1 - t0) * 1e6),
              'name': name, 'cat': 'pt_host'}
        if args:
            ev['args'] = {str(k): _json_safe(v) for k, v in args.items()}
        out.append(ev)
    # counter tracks (memviz live-HBM classes): Perfetto renders each
    # sample's args as stacked series under one named track, on the
    # same clock as the spans
    for name, t, values in (counter_samples or ()):
        out.append({'ph': 'C', 'pid': pid, 'tid': 0, 'cat': 'pt_counter',
                    'ts': now_us(t), 'name': name, 'args': values})
    return out


def merge_device_trace(host_events, device_events, sync_host_us=None,
                       capture_t0_us=None):
    """Merge host chrome events with a torch.profiler chrome export onto
    one clock.  Device timestamps are shifted into the host epoch-us
    clock: a 'pt_clock_sync' annotation in the device trace pins the
    offset exactly (torch.profiler renders the record_function range
    under that name); otherwise a session-relative device clock (small
    ts values) is aligned to the capture start; epoch-like device
    clocks pass through.  Host events are re-homed onto a pid above
    every device pid so processes never collide."""
    device_events = [e for e in device_events if isinstance(e, dict)]
    ts_vals = [e['ts'] for e in device_events
               if isinstance(e.get('ts'), (int, float))]
    offset = 0.0
    sync_ev = None
    if sync_host_us is not None:
        for e in device_events:
            if 'pt_clock_sync' in str(e.get('name', '')) and \
                    isinstance(e.get('ts'), (int, float)):
                sync_ev = e
                break
    if sync_ev is not None:
        offset = float(sync_host_us) - float(sync_ev['ts'])
    elif ts_vals and min(ts_vals) < 1e14:
        # session-relative device clock (epoch-us today is ~1.7e15)
        anchor = capture_t0_us
        if anchor is None:
            host_ts = [e['ts'] for e in host_events
                       if isinstance(e.get('ts'), (int, float))]
            anchor = min(host_ts) if host_ts else min(ts_vals)
        offset = float(anchor) - min(ts_vals)
    merged = []
    for e in device_events:
        if offset and isinstance(e.get('ts'), (int, float)):
            e = dict(e)
            e['ts'] = e['ts'] + offset
        merged.append(e)
    dev_pids = [e.get('pid') for e in device_events
                if isinstance(e.get('pid'), int)]
    host_pid = (max(dev_pids) + 1) if dev_pids else 1
    for e in host_events:
        e = dict(e)
        e['pid'] = host_pid
        merged.append(e)
    return merged


def write_chrome(path, events):
    """Write a chrome://tracing / Perfetto-loadable JSON file."""
    import json
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, 'w') as f:
        json.dump({'traceEvents': events, 'displayTimeUnit': 'ms'}, f)
    return path


# ------------------------------------------------------- flight recorder
def dump_payload(extra=None):
    """The flight-recorder dump as a dict: chrome events, raw step
    records ('ptSteps'), this worker's rank ('ptRank') and — the
    cross-worker merge anchor — 'ptClock': the unix wall clock and the
    exporter's epoch-us clock read AT THE SAME INSTANT.  Exported
    timestamps ride the (perf_counter, time.time) pair pinned at
    import; NTP steps since then drift every worker's export clock
    independently, so collect_job() re-homes each dump by
    (unix_us - export_us) — no guessing, per the job-merge contract."""
    recs = steps()
    open_spans = list(_events)
    if open_spans:
        recs.append({'step': 'partial',
                     't0': min(s[1] for s in open_spans),
                     't1': max(s[2] for s in open_spans),
                     'tid': None, 'spans': open_spans})
    def safe_args(a):
        if not a:
            return None
        return {str(k): _json_safe(v) for k, v in a.items()}

    payload = {
        'traceEvents': chrome_events(),
        'displayTimeUnit': 'ms',
        'ptRank': os.environ.get('PADDLE_TRAINER_ID', '0'),
        'ptClock': {'unix_us': time.time() * 1e6,
                    'export_us': now_us()},
        'ptSteps': [{'step': r['step'], 't0': r['t0'], 't1': r['t1'],
                     'tid': r.get('tid'), 'tags': r.get('tags'),
                     'spans': [[s[0], s[1], s[2], s[3], s[4],
                                safe_args(s[5])]
                               for s in r['spans']]}
                    for r in recs],
        'ptCounters': [[n, t, dict(v)] for n, t, v in counters()],
    }
    if extra:
        payload['ptIncident'] = extra
    return payload


def dump(path=None, extra=None):
    """Write the flight recorder (last N steps) as chrome-trace JSON;
    the same file carries the raw step records under 'ptSteps' so
    stat_summary.py --steps can rebuild the report offline.  The step
    IN FLIGHT (spans recorded since the last step sealed — exactly the
    step that failed, in the on-error path) is included as a partial
    record.  `extra` (a JSON-able dict — e.g. the executor's NaN
    provenance report) is embedded under 'ptIncident' so the dump that
    captures an incident also carries its diagnosis."""
    import json
    if path is None:
        import tempfile
        path = os.path.join(tempfile.gettempdir(),
                            'pt_trace_%d.json' % os.getpid())
    payload = dump_payload(extra=extra)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    # serialize BEFORE opening, write atomically: an incident dump
    # must never leave a truncated JSON at the target path
    blob = json.dumps(payload)
    tmp = path + '.tmp'
    with open(tmp, 'w') as f:
        f.write(blob)
    os.replace(tmp, path)
    monitor.add('trace/dumps_written')
    return path


def dump_on_error(tag, extra=None):
    """Incident hook (NaN-check trip, segment dispatch failure, health
    detectors): dump the last N steps if the tracer is live.  Returns
    the path or None; never raises — the original error must
    surface."""
    if not _active:
        return None
    try:
        import tempfile
        path = os.path.join(tempfile.gettempdir(),
                            'pt_trace_%d_%s.json'
                            % (os.getpid(), str(tag)))
        return dump(path, extra=extra)
    except Exception:
        return None


# one limiter for every periodic-incident dump site: per-key last-dump
# wall times, mutated only under the check-and-claim below
_rate_limited = {}


def rate_limited_dump(key, interval_s, tag=None, extra=None):
    """THE interval-checked incident-dump path.  The detectors that
    dump periodically (health spike/straggler, memviz watermark/OOM,
    SLO breaches, supervisor transitions) share this one limiter
    instead of each reimplementing last-timestamp bookkeeping: at most
    one dump per `key` per `interval_s` seconds (0 = no limit), the
    claim taken atomically so two concurrent trips produce ONE dump.
    Suppressed calls count trace/dumps_suppressed; the per-SITE
    counters stay the caller's job (a suppressed trip is still a
    trip).  Returns the dump path, or None (suppressed, tracer off,
    or dump failure — never raises)."""
    try:
        now = time.time()
        with _lock:
            last = _rate_limited.get(key)
            if interval_s > 0 and last is not None and \
                    now - last < interval_s:
                monitor.add('trace/dumps_suppressed')
                return None
            _rate_limited[key] = now
        return dump_on_error(tag if tag is not None else key,
                             extra=extra)
    except Exception:
        return None


def reset_rate_limits(prefix=None):
    """Forget limiter claims (a caller's reset path: memviz.reset
    drops 'memviz/' so its tests can dump again without waiting out
    the interval).  None drops everything."""
    with _lock:
        if prefix is None:
            _rate_limited.clear()
        else:
            for k in [k for k in _rate_limited
                      if k.startswith(prefix)]:
                del _rate_limited[k]


# ------------------------------------------------- device-capture attach
def attach_capture():
    """Called by fluid.profiler when a device trace starts: record
    every span from here to detach (independent of ring eviction) so
    the merged export covers the whole capture.  Enables the tracer if
    it was off; detach restores that."""
    global _capture
    with _lock:
        if _capture is not None:
            return _capture
        _capture = {'t0_us': now_us(), 'sync_us': None, 'events': [],
                    'counters': [], 'was_active': _active}
        if not _active:
            enable()
        return _capture


def mark_clock_sync():
    """Record the host clock at the instant the paired 'pt_clock_sync'
    device annotation is emitted (profiler.start_trace does both)."""
    cap = _capture
    if cap is not None:
        cap['sync_us'] = now_us()


def detach_capture():
    """End the capture session: returns {'events', 'sync_us', 't0_us'}
    (or None if no capture was attached) and restores the tracer's
    pre-capture enabled state."""
    global _capture, _active
    with _lock:
        cap, _capture = _capture, None
        if cap is None:
            return None
        if not cap.pop('was_active'):
            _active = False
        return cap


def write_host_trace(path, capture):
    """Persist a capture session next to the device trace (stop_trace
    does this) so tools/timeline.py can merge them offline."""
    import json
    with open(path, 'w') as f:
        json.dump({'ptHostEvents': chrome_events(
                       capture['events'],
                       counter_samples=capture.get('counters')),
                   'ptSync': capture['sync_us'],
                   'ptCaptureT0': capture['t0_us']}, f)
    return path


# --------------------------------------------------- job-wide collection
def _parse_worker_spec(spec):
    """'0=host:port,1=host:port' -> [(rank, endpoint), ...] (the
    PADDLE_TPU_STATUS_WORKERS wire format distributed/launch.py
    emits)."""
    out = []
    for part in (spec or '').split(','):
        part = part.strip()
        if not part:
            continue
        if '=' in part:
            rank, ep = part.split('=', 1)
        else:
            rank, ep = str(len(out)), part
        out.append((rank.strip(), ep.strip()))
    return out


def _http_fetch_dump(timeout):
    def fetch(endpoint):
        import urllib.request
        with urllib.request.urlopen(
                'http://%s/trace/dump' % endpoint,
                timeout=timeout) as resp:
            return resp.read()
    return fetch


def collect_job(workers=None, fetch=None, timeout=10.0, local=None,
                out_path=None):
    """Pull every worker's ``/trace/dump`` and merge the job into ONE
    Perfetto timeline with per-rank process tracks.

    - `workers`: [(rank, endpoint)] pairs, a
      'rank=host:port,...' spec string, or None to read
      PADDLE_TPU_STATUS_WORKERS (the launcher's wire format).
    - `fetch`: injectable ``fetch(endpoint) -> bytes`` (tests, file
      merges via tools/timeline.py --job); default is HTTP GET
      ``/trace/dump``.
    - `local`: optional rank label for THIS process — its own
      flight recorder is folded in without an HTTP round trip (the
      rank-0 aggregator passes its own rank).

    Clock re-homing: every dump carries 'ptClock' (unix wall clock +
    export clock read at the same instant), so each rank's events
    shift by (unix_us - export_us) onto the NTP-synced wall clock —
    two workers' dumps merge without guessing.  A dump missing the
    anchor (older build) falls back to capture-start alignment against
    the earliest anchored rank and is counted in
    trace/collect_unanchored.  A worker returning an empty, truncated
    or unparsable dump is SKIPPED and counted in trace/collect_skipped
    — a sick worker must never kill the aggregator's collection.

    Returns the merged job document ({'traceEvents', 'ptSteps' (each
    record tagged with its 'rank'), 'ptJob': {workers, skipped,
    skew}}); `out_path` additionally writes it as Perfetto-loadable
    JSON."""
    import json
    if workers is None:
        workers = os.environ.get('PADDLE_TPU_STATUS_WORKERS', '')
    if isinstance(workers, str):
        workers = _parse_worker_spec(workers)
    if fetch is None:
        fetch = _http_fetch_dump(timeout)
    docs = []       # (rank, doc, source)
    skipped = {}
    local_rank = str(local) if local is not None else None
    if local_rank is not None:
        docs.append((local_rank, dump_payload(), 'local'))
    remote = [(str(rank), ep) for rank, ep in workers
              if str(rank) != local_rank]

    def _fetch_one(rank, ep, out):
        try:
            raw = fetch(ep)
            if isinstance(raw, bytes):
                raw = raw.decode('utf-8')
            doc = json.loads(raw)
            if not isinstance(doc, dict) or \
                    not isinstance(doc.get('traceEvents'), list):
                raise ValueError('dump has no traceEvents list')
            out[rank] = (doc, None)
        except Exception as e:
            out[rank] = (None, '%s: %s' % (ep, e))

    # concurrent pulls, same rationale as the health aggregator's
    # probe fan-out: a partitioned host costs ONE timeout, not
    # worker-count x timeout — /trace/collect stays responsive at
    # any job size
    results = {}
    fetchers = [threading.Thread(target=_fetch_one,
                                 args=(rank, ep, results), daemon=True)
                for rank, ep in remote]
    for t in fetchers:
        t.start()
    for t in fetchers:
        t.join(timeout + 5.0)
    used_ranks = {r for r, _d, _s in docs}
    for rank, ep in remote:
        doc, err = results.get(rank) or \
            (None, '%s: fetch timed out' % ep)
        if doc is not None:
            # the dump's own ptRank is authoritative (file merges may
            # pass dumps in any order); the caller's label is the
            # fallback — and breaks ties when un-launched processes
            # all claim the default rank 0
            own = doc.get('ptRank')
            own = str(own) if own is not None else None
            label = own if own and own not in used_ranks else rank
            used_ranks.add(label)
            docs.append((label, doc, ep))
        else:
            monitor.add('trace/collect_skipped')
            skipped[rank] = err
    monitor.add('trace/collect_calls')

    # clock shifts: anchored dumps are exact; unanchored ones align
    # their earliest event to the earliest anchored rank's start
    def _anchor_shift(doc):
        clock = doc.get('ptClock')
        if isinstance(clock, dict) and \
                isinstance(clock.get('unix_us'), (int, float)) and \
                isinstance(clock.get('export_us'), (int, float)):
            return float(clock['unix_us']) - float(clock['export_us'])
        return None

    def _min_ts(doc):
        ts = [e.get('ts') for e in doc['traceEvents']
              if isinstance(e, dict) and
              isinstance(e.get('ts'), (int, float))]
        return min(ts) if ts else None

    anchored_starts = []
    shifts = {}
    for rank, doc, _src in docs:
        shift = _anchor_shift(doc)
        shifts[rank] = shift
        if shift is not None:
            t = _min_ts(doc)
            if t is not None:
                anchored_starts.append(t + shift)
    fallback_start = min(anchored_starts) if anchored_starts else None
    merged = []
    all_steps = []
    workers_meta = {}
    for idx, (rank, doc, src) in enumerate(docs):
        shift = shifts[rank]
        clock_mode = 'anchored'
        if shift is None:
            monitor.add('trace/collect_unanchored')
            clock_mode = 'aligned'
            t = _min_ts(doc)
            ref = fallback_start if fallback_start is not None else \
                (_min_ts(docs[0][1]) or 0.0)
            shift = (ref - t) if t is not None else 0.0
        # per-rank process tracks: remap every pid into a rank-owned
        # band and title the band, so Perfetto shows 'rank N ...'
        # processes side by side on the shared clock
        base = idx * 100
        pid_map = {}
        n_events = 0
        for e in doc['traceEvents']:
            if not isinstance(e, dict):
                continue
            e = dict(e)
            pid = e.get('pid')
            pid = pid if isinstance(pid, int) else 0
            if pid not in pid_map:
                pid_map[pid] = base + len(pid_map)
            e['pid'] = pid_map[pid]
            if isinstance(e.get('ts'), (int, float)):
                e['ts'] = e['ts'] + shift
            if e.get('ph') == 'M' and e.get('name') == 'process_name':
                args = dict(e.get('args') or {})
                args['name'] = 'rank %s %s' % (
                    rank, args.get('name') or 'process')
                e['args'] = args
            merged.append(e)
            n_events += 1
        for pid in sorted(pid_map.values()):
            merged.append({'ph': 'M', 'pid': pid, 'tid': 0,
                           'cat': 'pt_job', 'name': 'process_sort_index',
                           'args': {'sort_index': pid}})
        recs = doc.get('ptSteps')
        recs = recs if isinstance(recs, list) else []
        for rec in recs:
            if isinstance(rec, dict):
                rec = dict(rec)
                rec['rank'] = rank
                all_steps.append(rec)
        workers_meta[rank] = {'source': src, 'events': n_events,
                              'steps': len(recs), 'clock': clock_mode}
    per_rank = {}
    for rec in all_steps:
        per_rank.setdefault(rec['rank'], []).append(rec)
    rollups = {}
    for rank, recs in per_rank.items():
        try:
            rollups[rank] = step_rollup_from(recs)
        except Exception:
            pass
    out = {
        'traceEvents': merged,
        'displayTimeUnit': 'ms',
        'ptSteps': all_steps,
        'ptJob': {
            'workers': workers_meta,
            'skipped': skipped,
            'skew': job_skew_report(rollups),
        },
    }
    if out_path is not None:
        d = os.path.dirname(out_path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(out_path, 'w') as f:
            json.dump(out, f)
    return out


def step_rollup_from(records):
    """step_rollup() over explicit records (a collected rank's
    'ptSteps' list instead of the live flight recorder)."""
    roll = report_from_records(records)['rollup']
    return {'count': roll['count'],
            'wall_p50_ms': roll['wall_p50_ms'],
            'wall_p99_ms': roll['wall_p99_ms'],
            'wall_max_ms': roll['wall_max_ms'],
            'phases_ms': dict(roll['phases_ms'])}


# FLAGS_trace=1 in the environment turns the flight recorder on at
# import — the always-available production posture
if get_flag('FLAGS_trace'):
    enable()
