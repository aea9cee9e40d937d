"""Runtime stats registry: always-on counters, gauges and histograms.

Reference: paddle/fluid/platform/monitor.h — StatRegistry + the
STAT_ADD/STAT_RESET macros that give the C++ runtime cheap, always-on
counters next to the on-demand profiler (JAX: fluid/monitor.py, whose
registry, names and exposition this module keeps, so the same registry
state renders the same text in both packages).  The executor (run
calls, plan cache, CUDA-graph captures and replays, feed and fetch
bytes, host ops), the reader pipeline (batches, queue depth, bytes
staged, the consumer's wait), the compile plane and the observability
modules record here.

Design constraints (the hot path runs per training step):

- plain module-level dicts + float adds; CPython's GIL makes the
  increments safe enough for stats (the reference uses relaxed atomics
  for the same reason — losing one increment under contention is an
  acceptable stats-grade race);
- NO torch imports and NO device calls: recording a stat never
  touches the card, never synchronizes a stream, and this module
  imports from anywhere in the package without cycles;
- fixed-bucket histograms (bisect into a precomputed edge list), so an
  observe() is O(log buckets) with zero allocation.

Key convention: '/'-separated paths ('executor/plan_cache_hit');
snapshot() nests on '/'.  Three export surfaces:

- snapshot(): nested dict for tests/tools;
- dump_jsonl(path, step=...): append ONE json line (trajectory files);
- prometheus_text(): text exposition format for scraping.
"""

import bisect
import json
import re
import time

__all__ = [
    'add', 'set_gauge', 'remove_gauge', 'observe', 'counter_value',
    'gauge_value',
    'histogram_value', 'reset', 'set_enabled', 'snapshot', 'flat',
    'dump_jsonl', 'prometheus_text', 'raw_state', 'serve',
    'prom_escape_help', 'prom_escape_label', 'prom_sample',
    'prom_histogram_lines',
    'TIME_BUCKETS', 'SIZE_BUCKETS', 'NORM_BUCKETS',
]

# histogram edge presets: seconds (compile/run/blocked latencies span
# ~us..minutes) and bytes (feeds span ~KB..GB)
TIME_BUCKETS = (0.0001, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5,
                1.0, 5.0, 10.0, 30.0, 60.0, 300.0)
SIZE_BUCKETS = (1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9, 1e10)
# norms/ratios (tensor-health summaries span ~1e-8 dead params to
# ~1e4 exploding grads)
NORM_BUCKETS = (1e-8, 1e-6, 1e-4, 1e-2, 0.1, 0.5, 1.0, 2.0, 5.0,
                10.0, 100.0, 1e3, 1e4)

_enabled = True
_counters = {}   # name -> float
_gauges = {}     # name -> float
# name -> [edges tuple, per-bucket counts (len(edges)+1), sum, count]
_hists = {}


def set_enabled(on):
    """Toggle recording; returns the previous setting.  Disabled cost
    is one global load + branch per call site."""
    global _enabled
    prev = _enabled
    _enabled = bool(on)
    return prev


def add(name, value=1.0):
    """STAT_ADD: bump counter `name` by `value` (monotonic by
    convention — use set_gauge for levels)."""
    if not _enabled:
        return
    _counters[name] = _counters.get(name, 0.0) + value


def set_gauge(name, value):
    """Record the current level of `name` (queue depth, device count)."""
    if not _enabled:
        return
    _gauges[name] = float(value)


def remove_gauge(name):
    """Drop gauge `name` from the registry — for per-entity gauge
    series (per-program peaks, per-tenant depths) whose entity went
    away: a frozen last value is misleading and the label set must
    stay bounded in long-running services."""
    _gauges.pop(name, None)


def observe(name, value, buckets=TIME_BUCKETS):
    """Account one sample into fixed-bucket histogram `name`.  The
    bucket edges are fixed by the FIRST observe of each name; later
    `buckets` arguments are ignored (prometheus histograms cannot
    re-bucket mid-flight)."""
    if not _enabled:
        return
    h = _hists.get(name)
    if h is None:
        edges = tuple(float(b) for b in buckets)
        h = _hists[name] = [edges, [0] * (len(edges) + 1), 0.0, 0]
    h[1][bisect.bisect_left(h[0], value)] += 1
    h[2] += value
    h[3] += 1


def counter_value(name, default=0.0):
    return _counters.get(name, default)


def gauge_value(name, default=0.0):
    return _gauges.get(name, default)


def histogram_value(name):
    """{'count', 'sum', 'buckets': {le(str): cumulative count}} or None."""
    h = _hists.get(name)
    if h is None:
        return None
    out, cum = {}, 0
    for edge, c in zip(h[0], h[1]):
        cum += c
        out['%g' % edge] = cum
    out['+Inf'] = cum + h[1][-1]
    return {'count': h[3], 'sum': h[2], 'buckets': out}


def reset():
    """Drop every stat (platform::StatRegistry has STAT_RESET per stat;
    tests and per-entry bench subprocesses want the whole registry)."""
    _counters.clear()
    _gauges.clear()
    _hists.clear()


# ---------------------------------------------------------------- export
def _nest(tree, name, leaf):
    parts = name.split('/')
    node = tree
    for p in parts[:-1]:
        nxt = node.get(p)
        if not isinstance(nxt, dict):
            nxt = node[p] = {}
        node = nxt
    node[parts[-1]] = leaf


def snapshot():
    """Nested dict over the '/' key paths.  Counter/gauge leaves are
    floats; histogram leaves are {'count', 'sum', 'buckets'} dicts."""
    tree = {}
    for n, v in sorted(_counters.items()):
        _nest(tree, n, v)
    for n, v in sorted(_gauges.items()):
        _nest(tree, n, v)
    for n in sorted(_hists):
        _nest(tree, n, histogram_value(n))
    return tree


def flat():
    """One flat {name: number} dict: counters and gauges as-is,
    histograms contribute '<name>/sum' and '<name>/count'."""
    out = dict(_counters)
    out.update(_gauges)
    for n, h in _hists.items():
        out[n + '/sum'] = h[2]
        out[n + '/count'] = float(h[3])
    return out


def raw_state():
    """JSON-able copy of the whole registry with RAW histogram buckets
    (edges + per-bucket counts, not the cumulative rendering) — the
    merge-friendly form fluid.health's aggregator ships between
    processes: counters/bucket counts/sums add, gauges keep per-worker
    identity."""
    return {
        'counters': dict(_counters),
        'gauges': dict(_gauges),
        'hists': {n: {'edges': list(h[0]), 'counts': list(h[1]),
                      'sum': h[2], 'count': h[3]}
                  for n, h in _hists.items()},
    }


def dump_jsonl(path, step=None, extra=None):
    """Append ONE json line holding the full registry — call once per
    step (or per bench entry) to build a trajectory file that
    tools/stat_summary.py renders or diffs."""
    rec = {'ts': time.time()}
    if step is not None:
        rec['step'] = int(step)
    if extra:
        rec.update(extra)
    rec['counters'] = {n: _counters[n] for n in sorted(_counters)}
    rec['gauges'] = {n: _gauges[n] for n in sorted(_gauges)}
    rec['histograms'] = {n: {'count': _hists[n][3], 'sum': _hists[n][2]}
                         for n in sorted(_hists)}
    with open(path, 'a') as f:
        f.write(json.dumps(rec, sort_keys=True) + '\n')
    return path


_PROM_BAD = re.compile(r'[^a-zA-Z0-9_:]')


def _prom_name(name, prefix):
    return _PROM_BAD.sub('_', prefix + '_' + name)


def _prom_num(v):
    return '%.10g' % v


def prom_escape_help(text):
    """HELP-line escaping per the text exposition format: backslash and
    newline must be escaped or a multi-line help string corrupts the
    whole scrape."""
    return str(text).replace('\\', '\\\\').replace('\n', '\\n')


def prom_escape_label(value):
    """Label-VALUE escaping (backslash, double-quote, newline) — the
    rule the aggregator's worker/endpoint labels and any future
    user-supplied label must go through; an unescaped quote in a label
    value truncates the series at scrape time."""
    return (str(value).replace('\\', '\\\\').replace('"', '\\"')
            .replace('\n', '\\n'))


def prom_sample(name, labels, value):
    """One exposition sample line with escaped label values; `labels`
    is a (key, value) sequence (ordered — prometheus treats label
    order as irrelevant but the lint wants deterministic output)."""
    if labels:
        body = ','.join('%s="%s"' % (_PROM_BAD.sub('_', str(k)),
                                     prom_escape_label(v))
                        for k, v in labels)
        return '%s{%s} %s' % (name, body, _prom_num(value))
    return '%s %s' % (name, _prom_num(value))


def prom_histogram_lines(lines, m, edges, counts, total, cnt):
    """THE cumulative histogram rendering — exposition-format
    conformant: running-total ``le`` buckets in ascending order, the
    ``+Inf`` bucket equal to ``_count``, then ``_sum``/``_count``.
    Both the local exposition (prometheus_text) and the job-merged
    one (fluid.health.render_merged) build bucket series HERE, so
    neither can drift back to raw per-bucket counts — that raw form
    is /metrics.json's contract, never /metrics's, and
    fluid.health.prom_lint rejects it.  `counts` are the registry's
    raw per-bucket counts (len(edges)+1 with the overflow last);
    `cnt` the total observation count."""
    cum = 0
    for edge, c in zip(edges, counts):
        cum += c
        lines.append('%s_bucket{le="%g"} %d' % (m, edge, cum))
    lines.append('%s_bucket{le="+Inf"} %d' % (m, cnt))
    lines.append('%s_sum %s' % (m, _prom_num(total)))
    lines.append('%s_count %d' % (m, cnt))


def _prom_block(lines, m, kind, help_text, seen):
    """Emit the # HELP / # TYPE preamble once per metric family.  Two
    registry names CAN sanitize to one exposition name ('a/b-c' and
    'a/b_c'); the second family must not re-emit the preamble — the
    fluid.health lint flags duplicate metadata as a scrape error."""
    if m in seen:
        return False
    seen.add(m)
    lines.append('# HELP %s %s' % (m, prom_escape_help(help_text)))
    lines.append('# TYPE %s %s' % (m, kind))
    return True


def prometheus_text(prefix='paddle_tpu'):
    """Prometheus text exposition format (one # HELP + # TYPE line per
    metric; histograms emit cumulative le-labelled buckets, _sum and
    _count) — fluid.health serves it at /metrics; any HTTP handler can
    serve it to scrape the process."""
    lines = []
    seen = set()
    for n in sorted(_counters):
        m = _prom_name(n, prefix)
        _prom_block(lines, m, 'counter',
                    'paddle_tpu runtime counter %s' % n, seen)
        lines.append('%s %s' % (m, _prom_num(_counters[n])))
    for n in sorted(_gauges):
        m = _prom_name(n, prefix)
        _prom_block(lines, m, 'gauge',
                    'paddle_tpu runtime gauge %s' % n, seen)
        lines.append('%s %s' % (m, _prom_num(_gauges[n])))
    for n in sorted(_hists):
        edges, counts, total, cnt = _hists[n]
        m = _prom_name(n, prefix)
        _prom_block(lines, m, 'histogram',
                    'paddle_tpu runtime histogram %s' % n, seen)
        prom_histogram_lines(lines, m, edges, counts, total, cnt)
    return '\n'.join(lines) + '\n'


def serve(port=None, host=None):
    """Start the HTTP status plane serving this registry (plus
    /healthz, /statusz, /trace/dump) on a background thread; returns
    the fluid.health server handle (`.port` holds the bound port —
    pass port=0 for an ephemeral one).  Idempotent per process."""
    from . import health
    return health.serve(port=port, host=host)
