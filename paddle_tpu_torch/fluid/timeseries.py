"""fluid.timeseries — bounded windowed history over the monitor
registry.

Every signal fluid.monitor holds is a point-in-time snapshot; the SLO
plane (fluid/slo.py) and an operator reading a trend need *windowed*
history — rates, trends, percentiles-over-time (JAX:
fluid/timeseries.py, whose series, flags and window math this module
keeps).  The JAX package's supervisor, autopilot and serving fleet,
which also ride its sampling cadence there, are ROADMAP items 16 and
17 of the port.  This module is that substrate:

**Local history.**  ``maybe_sample(step)`` (called from the executor's
step boundary and the aggregator heartbeat) appends ONE point per
registry entry into a per-series ring bounded by
``FLAGS_timeseries_window`` points: counters keep their cumulative
value (per-step deltas and rates are derived at READ time with
counter-reset awareness, the prometheus ``rate()`` semantics), gauges
keep the sampled level, histograms keep the cumulative (count, sum,
bucket-counts) tuple so any window's p50/p95/p99 falls out of a
start/end subtraction.  Off (``FLAGS_timeseries``, the default) the
step boundary pays one flag read.

**Job history.**  The rank-0 aggregator feeds every heartbeat's
scraped ``raw_state`` through ``job_sample(rank, state)`` so per-
worker series are retained ACROSS heartbeats; a failed scrape appends
explicit gap markers to that worker's gauge series (``job_gap``) so a
window over a dead worker shows the hole instead of interpolating
through it.

**Read side.**  ``window(name, ...)`` answers one query — raw
(optionally downsampled) points plus the derived form: deltas /
rate_per_s / resets for counters, last/min/max/mean/gaps for gauges,
windowed count/sum/p50/p95/p99 for histograms.  ``http_query``
backs fluid.health's ``/timeseries`` endpoint; ``statusz_rollup``
renders the sparkline section of ``/statusz``.  The window math
(``counter_deltas``, ``rate_per_s``, ``percentile_from_counts``, ...)
is exposed on plain point lists so the tests drive it without a live
registry.

Hot-path discipline mirrors monitor/trace: NO torch imports, nothing
runs per step unless ``FLAGS_timeseries`` asked for it, and module
registries are only touched under the module ``_lock`` (sampler
thread, aggregator prober and HTTP readers race otherwise).
"""

import threading
import time
from collections import deque

from . import monitor
from .flags import get_flag

__all__ = [
    'enabled', 'maybe_sample', 'sample', 'job_sample', 'job_gap',
    'names', 'window', 'last', 'http_query', 'statusz_rollup',
    'counter_deltas', 'rate_per_s', 'gauge_stats',
    'percentile_from_counts', 'hist_window', 'spark', 'reset',
]

_lock = threading.Lock()

# name -> _Series (this process's registry, sampled at step boundary)
_local = {}
# rank -> {name: _Series} (aggregator-side job history, per worker)
_job = {}
_state = {'samples': 0, 'job_samples': 0, 'gap_points': 0}

_SPARK_GLYPHS = u'▁▂▃▄▅▆▇█'


class _Series(object):
    __slots__ = ('kind', 'points', 'edges')

    def __init__(self, kind, cap, edges=None):
        self.kind = kind
        self.points = deque(maxlen=cap)
        self.edges = edges


def enabled():
    return bool(get_flag('FLAGS_timeseries', False))


def _cap():
    return max(8, int(get_flag('FLAGS_timeseries_window', 512) or 512))


# ------------------------------------------------------------ sampling
def maybe_sample(step=None, source='step'):
    """The step-boundary / heartbeat hook: ONE flag read when the
    plane is off; when on, appends one point per registry entry
    (honoring the FLAGS_timeseries_sample_steps stride on the step
    path).  Never raises — history must not take a step down."""
    if not get_flag('FLAGS_timeseries', False):
        return False
    try:
        if source == 'step' and step is not None:
            stride = int(get_flag('FLAGS_timeseries_sample_steps', 1)
                         or 1)
            if stride > 1 and int(step) % stride:
                return False
        sample(step=step)
        return True
    except Exception:
        monitor.add('timeseries/sample_errors')
        return False


def sample(step=None, now=None):
    """Append one point per monitor registry entry to the LOCAL
    history (unconditional — maybe_sample is the flag-gated form)."""
    now = time.time() if now is None else float(now)
    st = monitor.raw_state()
    cap = _cap()
    with _lock:
        _append_state(_local, st, now, step, cap)
        _state['samples'] += 1
        n_series = len(_local)
    monitor.add('timeseries/samples')
    monitor.set_gauge('timeseries/series', float(n_series))
    # SLO objectives ride the same cadence: evaluated here (worker
    # step boundary) and on the aggregator heartbeat, never off a
    # thread of their own
    try:
        from . import slo
        slo.maybe_evaluate(now=now)
    except Exception:
        monitor.add('slo/eval_errors')


def job_sample(rank, state, now=None):
    """Aggregator heartbeat hook: retain one worker's scraped
    ``raw_state`` in the per-rank job history."""
    now = time.time() if now is None else float(now)
    cap = _cap()
    with _lock:
        store = _job.setdefault(str(rank), {})
        _append_state(store, state, now, None, cap)
        _state['job_samples'] += 1
    monitor.add('timeseries/job_samples')


def job_gap(rank, now=None):
    """A failed scrape of a previously-seen worker: append an explicit
    gap marker to each of its gauge series so window math reports the
    hole (``gaps``) instead of bridging the last level across it."""
    now = time.time() if now is None else float(now)
    added = 0
    with _lock:
        store = _job.get(str(rank))
        if not store:
            return 0
        for ser in store.values():
            if ser.kind == 'gauge':
                ser.points.append((now, None, None))
                added += 1
        _state['gap_points'] += added
    if added:
        monitor.add('timeseries/gap_points', added)
    return added


def _append_state(store, st, now, step, cap):
    """One raw_state -> one append per point (caller holds _lock)."""
    step = None if step is None else int(step)
    for n, v in (st.get('counters') or {}).items():
        ser = store.get(n)
        if ser is None or ser.kind != 'counter':
            ser = store[n] = _Series('counter', cap)
        ser.points.append((now, step, float(v)))
    for n, v in (st.get('gauges') or {}).items():
        ser = store.get(n)
        if ser is None or ser.kind != 'gauge':
            ser = store[n] = _Series('gauge', cap)
        ser.points.append((now, step, float(v)))
    for n, h in (st.get('hists') or {}).items():
        edges = tuple(h.get('edges') or ())
        ser = store.get(n)
        if ser is None or ser.kind != 'hist' or ser.edges != edges:
            ser = store[n] = _Series('hist', cap, edges=edges)
        ser.points.append((now, step, int(h.get('count') or 0),
                           float(h.get('sum') or 0.0),
                           tuple(h.get('counts') or ())))


# --------------------------------------------------------- window math
# All of these take PLAIN point lists (the tuples _append_state
# builds) so stat_summary --watch and the edge-case tests can run
# them on synthetic data with no live registry.

def counter_deltas(points):
    """Per-interval deltas with counter-reset awareness: a DECREASE
    means the process restarted mid-series, and the post-reset
    cumulative value itself is the interval's delta (prometheus
    ``rate()`` semantics).  Returns [(ts, step, delta), ...] with one
    entry per consecutive pair."""
    out = []
    prev = None
    for p in points:
        v = p[2]
        if v is None:
            continue
        if prev is not None:
            out.append((p[0], p[1], v - prev if v >= prev else v))
        prev = v
    return out


def counter_resets(points):
    vals = [p[2] for p in points if p[2] is not None]
    return sum(1 for a, b in zip(vals, vals[1:]) if b < a)


def rate_per_s(points):
    """Reset-aware rate over the whole point window; None when the
    window has fewer than two points or no elapsed wall time."""
    pts = [p for p in points if p[2] is not None]
    if len(pts) < 2:
        return None
    elapsed = pts[-1][0] - pts[0][0]
    if elapsed <= 0:
        return None
    total = sum(d for _t, _s, d in counter_deltas(pts))
    return total / elapsed


def gauge_stats(points):
    """last/min/max/mean over the sampled levels, plus the count of
    explicit gap markers (a dead worker's heartbeats)."""
    vals = [p[2] for p in points if p[2] is not None]
    gaps = sum(1 for p in points if p[2] is None)
    if not vals:
        return {'last': None, 'min': None, 'max': None, 'mean': None,
                'n': 0, 'gaps': gaps}
    return {'last': vals[-1], 'min': min(vals), 'max': max(vals),
            'mean': sum(vals) / len(vals), 'n': len(vals),
            'gaps': gaps}


def percentile_from_counts(edges, counts, q):
    """q-th percentile (0..1) from per-bucket counts (len(edges)+1,
    last = overflow), linearly interpolated inside the landing bucket;
    the overflow bucket pins to the last finite edge (the honest
    answer a fixed-bucket histogram can give).  None on empty."""
    total = sum(counts)
    if total <= 0:
        return None
    target = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if cum + c >= target:
            if i >= len(edges):        # overflow bucket
                return float(edges[-1]) if edges else None
            lo = float(edges[i - 1]) if i > 0 else 0.0
            hi = float(edges[i])
            frac = (target - cum) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        cum += c
    return float(edges[-1]) if edges else None


def hist_window(edges, points, qs=(0.5, 0.95, 0.99)):
    """Windowed histogram view: subtract the first cumulative
    (count, sum, buckets) from the last, then derive count/sum/mean
    and the requested percentiles over JUST the window's
    observations.  A count decrease (restart) falls back to the
    end-of-window cumulative state."""
    pts = [p for p in points if len(p) >= 5]
    if not pts:
        return {'count': 0, 'sum': 0.0, 'mean': None,
                'percentiles': {('p%g' % (100 * q)): None for q in qs}}
    first, final = pts[0], pts[-1]
    if len(pts) >= 2 and final[2] >= first[2]:
        count = final[2] - first[2]
        total = final[3] - first[3]
        counts = [b - a for a, b in zip(first[4], final[4])]
        if any(c < 0 for c in counts):      # torn by a mid-window reset
            count, total, counts = final[2], final[3], list(final[4])
    else:
        count, total, counts = final[2], final[3], list(final[4])
    out = {'count': int(count), 'sum': float(total),
           'mean': (float(total) / count if count else None)}
    out['percentiles'] = {
        ('p%g' % (100 * q)): percentile_from_counts(edges, counts, q)
        for q in qs}
    return out


def downsample(points, resolution):
    """Keep the LAST point of each `resolution`-second bucket —
    correct for cumulative kinds (counters, histograms) and the
    natural choice for sampled gauges."""
    if not resolution or resolution <= 0:
        return list(points)
    out = []
    bucket = None
    for p in points:
        b = int(p[0] // resolution)
        if b == bucket and out:
            out[-1] = p
        else:
            out.append(p)
            bucket = b
    return out


# ------------------------------------------------------------ querying
def _store(rank=None):
    if rank is None:
        return _local
    return _job.get(str(rank), {})


def names(rank=None):
    with _lock:
        return sorted(_store(rank))


def job_ranks():
    with _lock:
        return sorted(_job)


def last(name, rank=None):
    """The newest point of one series (the `point` query), or None."""
    with _lock:
        ser = _store(rank).get(name)
        if ser is None or not ser.points:
            return None
        return ser.points[-1]


def window(name, seconds=None, points=None, resolution=None,
           rank=None, now=None):
    """One window query: the series' raw points filtered to the last
    `seconds` (or last `points`), optionally downsampled to one point
    per `resolution` seconds, plus the kind-appropriate derived
    stats.  None when the series does not exist."""
    with _lock:
        ser = _store(rank).get(name)
        if ser is None:
            return None
        pts = list(ser.points)
        kind, edges = ser.kind, ser.edges
    now = time.time() if now is None else float(now)
    if seconds is not None:
        pts = [p for p in pts if p[0] >= now - float(seconds)]
    if points is not None and points > 0:
        pts = pts[-int(points):]
    pts = downsample(pts, resolution)
    doc = {'name': name, 'kind': kind,
           'rank': (None if rank is None else str(rank)),
           'n': len(pts),
           'points': [list(p) for p in pts]}
    if kind == 'counter':
        doc['derived'] = {
            'deltas': [list(d) for d in counter_deltas(pts)],
            'rate_per_s': rate_per_s(pts),
            'total_delta': sum(d for _t, _s, d in counter_deltas(pts)),
            'resets': counter_resets(pts)}
    elif kind == 'gauge':
        doc['derived'] = gauge_stats(pts)
    else:
        doc['edges'] = list(edges or ())
        hw = hist_window(edges or (), pts)
        hw['rate_per_s'] = None
        if len(pts) >= 2 and pts[-1][0] > pts[0][0]:
            hw['rate_per_s'] = hw['count'] / (pts[-1][0] - pts[0][0])
        doc['derived'] = hw
    return doc


def http_query(params):
    """The /timeseries endpoint body.  `params` is a {str: str} query
    dict: `name` (exact series; omitted = directory listing), `rank`
    (job history on the aggregator; omitted = local), `window`
    (seconds), `points` (last N), `resolution` (seconds/point),
    `point=1` (just the newest sample).  Returns (http_code, doc)."""
    def _num(key, cast=float):
        v = params.get(key)
        if v in (None, ''):
            return None
        try:
            return cast(float(v))
        except (TypeError, ValueError):
            raise ValueError('bad %s=%r' % (key, v))
    try:
        seconds = _num('window')
        npoints = _num('points', int)
        resolution = _num('resolution')
    except ValueError as e:
        return 400, {'error': str(e)}
    rank = params.get('rank') or None
    name = params.get('name') or None
    base = {'enabled': enabled(), 'samples': _state['samples'],
            'job_samples': _state['job_samples'],
            'ranks': job_ranks()}
    if not name:
        return 200, dict(base, series=names(rank=rank))
    if params.get('point'):
        p = last(name, rank=rank)
        if p is None:
            return 404, {'error': 'no series %r' % name,
                         'series': names(rank=rank)}
        return 200, dict(base, name=name, point=list(p))
    doc = window(name, seconds=seconds, points=npoints,
                 resolution=resolution, rank=rank)
    if doc is None:
        return 404, {'error': 'no series %r' % name,
                     'series': names(rank=rank)}
    return 200, dict(base, **doc)


# ------------------------------------------------------------ statusz
def spark(values, width=16):
    """Sparkline string over the last `width` values (min..max
    normalized to 8 glyph levels); '' on no data."""
    vals = [v for v in values if v is not None][-width:]
    if not vals:
        return ''
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return _SPARK_GLYPHS[0] * len(vals)
    out = []
    for v in vals:
        i = int((v - lo) / (hi - lo) * (len(_SPARK_GLYPHS) - 1))
        out.append(_SPARK_GLYPHS[i])
    return ''.join(out)


# the series /statusz leads with when present, in this order; anything
# else with history follows up to the row cap
_ROLLUP_PREFERRED = (
    'executor/run_seconds', 'executor/run_calls',
    'serving/admit_to_done_seconds', 'serving/requests',
    'comms/bytes_on_wire', 'executor/retraces',
    'memviz/budget_utilization', 'memviz/live_bytes_total',
    'reader/queue_depth', 'health/scrapes',
)


def statusz_rollup(max_series=12):
    """The /statusz 'timeseries' section: a sparkline-style trend row
    per key series (counters render their per-interval deltas, gauges
    their levels, histograms their windowed mean)."""
    with _lock:
        known = {n: (s.kind, list(s.points)[-64:])
                 for n, s in _local.items()}
        samples = _state['samples']
        job_ranks_ = sorted(_job)
    order = [n for n in _ROLLUP_PREFERRED if n in known]
    order += [n for n in sorted(known) if n not in order]
    rows = []
    for n in order[:max_series]:
        kind, pts = known[n]
        if kind == 'counter':
            vals = [d for _t, _s, d in counter_deltas(pts)]
        elif kind == 'gauge':
            vals = [p[2] for p in pts if p[2] is not None]
        else:
            vals = [b[2] - a[2] for a, b in zip(pts, pts[1:])
                    if b[2] >= a[2]]
        if not vals:
            continue
        rows.append({'name': n, 'kind': kind,
                     'last': vals[-1], 'min': min(vals),
                     'max': max(vals), 'spark': spark(vals)})
    return {'enabled': enabled(), 'samples': samples,
            'job_ranks': job_ranks_, 'series': rows}


def report():
    with _lock:
        return {'enabled': enabled(), 'samples': _state['samples'],
                'job_samples': _state['job_samples'],
                'gap_points': _state['gap_points'],
                'series': len(_local),
                'job_series': {r: len(s) for r, s in _job.items()}}


def reset():
    """Test isolation hook (mirrors monitor.reset)."""
    with _lock:
        _local.clear()
        _job.clear()
        _state.update(samples=0, job_samples=0, gap_points=0)
