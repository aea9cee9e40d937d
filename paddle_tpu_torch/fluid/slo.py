"""fluid.slo — declarative service-level objectives over any
fluid.timeseries series, with multi-window burn rates and hysteresis.

An objective is one clause::

    serving/admit_to_done_seconds p99 < 20ms
    executor/step_timeouts rate == 0
    memviz/budget_utilization < 0.9

``<series> [reducer] <op> <threshold>`` — the reducer defaults to
``value`` (last sample); ``rate`` is per-second over the window
(reset-aware), ``delta`` the window total, ``p50/p95/p99`` the
windowed percentile (histograms subtract cumulative bucket state,
gauges take the sample percentile), ``mean``/``count`` as named.
Thresholds take unit suffixes (``20ms``, ``5us``, ``3s``, ``90%``).
Declare programmatically with ``declare()`` or fleet-wide with
``FLAGS_slo`` (';'-separated clauses).

**Multi-window evaluation.**  Each objective is judged over a FAST
window (``FLAGS_slo_fast_points`` samples — the 5-minute analog) and
a SLOW window (``FLAGS_slo_slow_points`` — the 1-hour analog), both
*scaled to the step count actually recorded*: a short job shrinks the
slow window to the available history (reported as ``scaled``) instead
of staying blind for an hour of steps.  The burn rate is
measured/threshold (or the raw measure for ``== 0`` objectives) per
window — how fast the error budget is burning, not just whether it
burned.

**Hysteresis.**  State machine per objective: ``ok`` -> ``pending``
on a fast-window breach, ``pending`` -> ``firing`` only after
``FLAGS_slo_hysteresis`` consecutive both-window breaches, ``firing``
-> ``resolved`` only after the same run of clean fast windows, then
back to ``ok`` — a series oscillating across its threshold neither
fires nor resolves per sample.  Transitions count
``slo/alerts_fired``/``slo/alerts_resolved`` and leave a rate-limited
flight-recorder dump (the JAX package also logs them in its
supervisor's decision trail: ROADMAP item 17 of the port).  ``alertz()`` is the
``/alertz`` body: firing/pending/resolved plus the full per-objective
evaluation.

Evaluation runs on the sampling cadence (timeseries.sample calls
``maybe_evaluate``: the executor step boundary and the aggregator
heartbeat) — no thread of its own.  Same discipline as
monitor/timeseries: no torch imports, registry mutations only under the
module ``_lock``.
"""

import re
import threading
import time

from . import monitor
from . import timeseries
from .flags import get_flag

__all__ = [
    'declare', 'parse', 'clear', 'reset', 'objectives',
    'firing_count', 'maybe_evaluate', 'evaluate_all', 'alertz',
    'report',
]

_lock = threading.Lock()
_objectives = {}            # name -> _Objective
_state = {'evals': 0, 'flag_spec': None}
_RESOLVED_KEEP = 32
_resolved_log = []          # bounded trail of resolved alerts

_OPS = {
    '<': lambda v, t: v < t, '<=': lambda v, t: v <= t,
    '>': lambda v, t: v > t, '>=': lambda v, t: v >= t,
    '==': lambda v, t: v == t, '!=': lambda v, t: v != t,
}
_REDUCERS = ('value', 'rate', 'delta', 'mean', 'count',
             'p50', 'p95', 'p99')
_THR_RE = re.compile(r'^([-+]?[0-9.eE+-]+?)(us|ms|s|%)?$')


class _Objective(object):
    def __init__(self, name, series, reducer, op, threshold, clause):
        self.name = name
        self.series = series
        self.reducer = reducer
        self.op = op
        self.threshold = threshold
        self.clause = clause
        self.state = 'ok'
        self.since = None
        self.streak_bad = 0
        self.streak_good = 0
        self.fired = 0
        self.last = None        # newest evaluation doc

    def doc(self):
        d = {'name': self.name, 'clause': self.clause,
             'series': self.series, 'reducer': self.reducer,
             'op': self.op, 'threshold': self.threshold,
             'state': self.state, 'since': self.since,
             'fired': self.fired}
        if self.last:
            d.update(self.last)
        return d


def _parse_threshold(text):
    m = _THR_RE.match(text.strip())
    if not m:
        raise ValueError('bad SLO threshold %r' % text)
    v = float(m.group(1))
    unit = m.group(2)
    if unit == 'ms':
        v *= 1e-3
    elif unit == 'us':
        v *= 1e-6
    elif unit == '%':
        v *= 1e-2
    return v


def parse(clause):
    """'<series> [reducer] <op> <threshold>' -> (series, reducer, op,
    threshold).  Raises ValueError on a malformed clause (a typo'd
    fleet flag must fail loudly, not silently not alert)."""
    toks = clause.split()
    if len(toks) == 3:
        series, reducer, op, thr = toks[0], 'value', toks[1], toks[2]
    elif len(toks) == 4:
        series, reducer, op, thr = toks
    else:
        raise ValueError('bad SLO clause %r (want "<series> '
                         '[reducer] <op> <threshold>")' % clause)
    if reducer not in _REDUCERS:
        raise ValueError('bad SLO reducer %r in %r (one of %s)'
                         % (reducer, clause, ', '.join(_REDUCERS)))
    if op not in _OPS:
        raise ValueError('bad SLO comparator %r in %r' % (op, clause))
    return series, reducer, op, _parse_threshold(thr)


def declare(clause, name=None):
    """Register (or replace) one objective; returns its name."""
    series, reducer, op, thr = parse(clause)
    name = name or '%s_%s' % (series.replace('/', '_'), reducer)
    obj = _Objective(name, series, reducer, op, thr, clause.strip())
    with _lock:
        _objectives[name] = obj
    monitor.set_gauge('slo/objectives', float(len(_objectives)))
    return name


def clear():
    with _lock:
        _objectives.clear()
        _state['flag_spec'] = None
    monitor.set_gauge('slo/objectives', 0.0)


def reset():
    """Test isolation hook."""
    clear()
    with _lock:
        _state['evals'] = 0
        del _resolved_log[:]


def objectives():
    with _lock:
        return [o.doc() for o in _objectives.values()]


def firing_count():
    """Objectives currently firing — state only, no evaluation.  The
    autopilot's interlock: it freezes adaptations mid-incident rather
    than tune knobs while an SLO burns."""
    with _lock:
        return sum(1 for o in _objectives.values()
                   if o.state == 'firing')


def _configure_from_flag():
    spec = str(get_flag('FLAGS_slo', '') or '').strip()
    with _lock:
        if spec == _state['flag_spec']:
            return
        _state['flag_spec'] = spec
    for part in spec.split(';'):
        part = part.strip()
        if not part:
            continue
        try:
            declare(part)
        except ValueError:
            monitor.add('slo/bad_clauses')


# ---------------------------------------------------------- evaluation
def _windows():
    fast = max(2, int(get_flag('FLAGS_slo_fast_points', 12) or 12))
    slow = max(fast, int(get_flag('FLAGS_slo_slow_points', 96) or 96))
    return fast, slow


def _measure(obj, npoints):
    """(value, n_samples) of obj.reducer over the last `npoints`
    samples of the series; (None, n) when the window is empty or the
    reducer has nothing to say (no data neither fires nor resolves)."""
    doc = timeseries.window(obj.series, points=npoints)
    if doc is None or not doc['n']:
        return None, 0
    kind, derived, n = doc['kind'], doc['derived'], doc['n']
    r = obj.reducer
    if kind == 'counter':
        if r == 'rate':
            return derived['rate_per_s'], n
        if r == 'delta':
            return derived['total_delta'] if n >= 2 else None, n
        if r in ('value', 'mean', 'count'):
            return doc['points'][-1][2], n
        return None, n           # percentile of a counter: undefined
    if kind == 'gauge':
        vals = [p[2] for p in doc['points'] if p[2] is not None]
        if not vals:
            return None, n
        if r == 'value':
            return vals[-1], n
        if r == 'mean':
            return sum(vals) / len(vals), n
        if r == 'delta':
            return (vals[-1] - vals[0]) if len(vals) >= 2 else None, n
        if r == 'rate':
            return None, n
        if r == 'count':
            return float(len(vals)), n
        q = int(r[1:]) / 100.0
        vals = sorted(vals)
        return vals[min(len(vals) - 1,
                        int(q * (len(vals) - 1) + 0.5))], n
    # histogram
    if r in ('p50', 'p95', 'p99'):
        p = derived['percentiles'].get(r)
        return p, n
    if r == 'rate':
        return derived['rate_per_s'], n
    if r == 'count':
        return float(derived['count']), n
    if r == 'delta':
        return derived['sum'] if n >= 2 else None, n
    return derived['mean'], n    # value/mean -> windowed mean


def _burn(obj, value):
    """Burn rate: how fast the budget is burning.  measured/threshold
    for a bounded objective, the raw measure when the budget is zero
    (any breach is infinite-rate by definition — report the count)."""
    if value is None:
        return None
    if obj.threshold:
        return round(value / obj.threshold, 4)
    return round(value, 4)


def _hysteresis():
    return max(1, int(get_flag('FLAGS_slo_hysteresis', 3) or 3))


def _evaluate_one(obj, now):
    fast_n, slow_n = _windows()
    fast_v, n_fast = _measure(obj, fast_n)
    doc = timeseries.window(obj.series, points=slow_n)
    avail = doc['n'] if doc else 0
    scaled = avail < slow_n
    slow_v, n_slow = _measure(obj, max(min(slow_n, avail), fast_n))
    cmp_ = _OPS[obj.op]
    breach_fast = fast_v is not None and not cmp_(fast_v,
                                                 obj.threshold)
    breach_slow = slow_v is not None and not cmp_(slow_v,
                                                  obj.threshold)
    ev = {'measured_fast': fast_v, 'measured_slow': slow_v,
          'burn_fast': _burn(obj, fast_v),
          'burn_slow': _burn(obj, slow_v),
          'breach_fast': breach_fast, 'breach_slow': breach_slow,
          'window': {'fast_points': fast_n, 'slow_points': slow_n,
                     'available_points': avail, 'scaled': scaled},
          'evaluated_unix': now}
    if fast_v is None:
        ev['no_data'] = True
        obj.last = ev
        return None
    h = _hysteresis()
    if breach_fast and breach_slow:
        obj.streak_bad += 1
        obj.streak_good = 0
    elif breach_fast:
        obj.streak_good = 0
    else:
        obj.streak_good += 1
        obj.streak_bad = 0
    transition = None
    if obj.state in ('ok', 'resolved') and breach_fast:
        obj.state, obj.since = 'pending', now
        monitor.add('slo/alerts_pending')
    if obj.state == 'pending':
        if obj.streak_bad >= h:
            obj.state, obj.since = 'firing', now
            obj.fired += 1
            transition = 'fired'
        elif obj.streak_good >= h:
            obj.state, obj.since = 'ok', now
    elif obj.state == 'firing' and obj.streak_good >= h:
        obj.state, obj.since = 'resolved', now
        transition = 'resolved'
    elif obj.state == 'resolved' and obj.streak_good >= 2 * h:
        obj.state, obj.since = 'ok', now
    ev['streaks'] = {'bad': obj.streak_bad, 'good': obj.streak_good,
                     'hysteresis': h}
    obj.last = ev
    return transition


def _on_fired(obj):
    monitor.add('slo/alerts_fired')
    alert = obj.doc()
    try:
        from . import trace
        trace.rate_limited_dump(
            'slo/%s' % obj.name,
            float(get_flag('FLAGS_slo_dump_interval_s', 60.0) or 60.0),
            tag='slo_%s' % obj.name,
            extra={'incident': 'slo_breach', 'alert': alert})
    except Exception:
        pass


def _on_resolved(obj):
    monitor.add('slo/alerts_resolved')
    with _lock:
        _resolved_log.append(obj.doc())
        del _resolved_log[:-_RESOLVED_KEEP]


def maybe_evaluate(now=None):
    """The sampling-cadence hook: a no-op until something is declared
    (programmatically or via FLAGS_slo)."""
    _configure_from_flag()
    if not _objectives:
        return False
    evaluate_all(now=now)
    return True


def evaluate_all(now=None):
    """One evaluation pass over every objective (never raises)."""
    now = time.time() if now is None else float(now)
    with _lock:
        objs = list(_objectives.values())
    firing = 0
    for obj in objs:
        try:
            transition = _evaluate_one(obj, now)
        except Exception:
            monitor.add('slo/eval_errors')
            continue
        if transition == 'fired':
            _on_fired(obj)
        elif transition == 'resolved':
            _on_resolved(obj)
        if obj.state == 'firing':
            firing += 1
    with _lock:
        _state['evals'] += 1
        evals = _state['evals']
    monitor.add('slo/evals')
    monitor.set_gauge('slo/firing', float(firing))
    return evals


# ------------------------------------------------------------- surface
def alertz(now=None):
    """The /alertz body: a fresh evaluation, then the objectives split
    by state (firing first — pagers read top-down)."""
    _configure_from_flag()
    if _objectives:
        evaluate_all(now=now)
    docs = objectives()
    with _lock:
        resolved_trail = list(_resolved_log)
        evals = _state['evals']
    return {
        'firing': [d for d in docs if d['state'] == 'firing'],
        'pending': [d for d in docs if d['state'] == 'pending'],
        'resolved': [d for d in docs if d['state'] == 'resolved'],
        'ok': [d for d in docs if d['state'] == 'ok'],
        'resolved_trail': resolved_trail,
        'objectives': len(docs),
        'evals': evals,
        'hysteresis': _hysteresis(),
    }


def report():
    docs = objectives()
    return {'objectives': len(docs),
            'firing': sum(1 for d in docs if d['state'] == 'firing'),
            'states': {d['name']: d['state'] for d in docs}}
