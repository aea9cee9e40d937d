"""Profiler: per-op time summary and device-trace capture.

Reference: python/paddle/fluid/profiler.py:129 (profiler context
manager) over platform/profiler.h:166-175 EnableProfiler/
DisableProfiler, which print a per-op time table sorted by
`sorted_key` in {'calls','total','max','min','ave'} (JAX:
fluid/profiler.py, whose API, table and monitor fold this module
keeps).  The two tracer options:

- tracer_option='Serial': the executor runs each step eagerly, op by
  op (the per-op plan: every grad op replays its forward op, no fused
  optimizer runs), bypassing the plan cache and CUDA-graph replay
  (``executor/plan_cache_bypass``), and host-times each op to
  completion, synchronizing the card around it: the reference's
  RecordEvent semantics.  The JAX package instead compiles one segment
  per op; both measure the same op list.
- tracer_option='Default': the production path runs untouched under
  ``torch.profiler`` with CPU and CUDA activities (CUPTI).  The executor
  wraps each op's lowering in a ``record_function`` range named by its
  type (``type#block-index`` under FLAGS_opprof) inside one range named
  by the program (``progN``), the counterpart of the JAX package's
  ``jax.named_scope`` path in XLA's op metadata.  On stop the chrome
  export's device events (kernels, copies, memsets) are attributed
  back to op types (``annotate_device_events``): each kernel's launch
  (CUPTI correlation) lies on a host thread inside the op's range; a
  kernel the autograd engine launched in the backward pass lies inside
  an ``evaluate_function`` range whose sequence number names the
  forward op that recorded it, and is filed under that op's grad type
  (``fused_multihead_attention_grad`` for K2's kernels).  Kernels that
  no range covers (a CUDA-graph replay: its kernels carry the graph
  launch's correlation, not an op's) stay honest
  ``unattributed/<kernel>`` rows, so the rows sum to the profiled
  device time.  Device busy time is reported both as the sum of the
  device events and as the union of their intervals over all streams
  (``device_time``).  A CPU-only profile has no device events: its
  table is built from the host's top-level ops instead.

stop_profiler prints the sorted table; summary_records() /
summary_string() / last_profile() expose it programmatically.
start_trace()/stop_trace() keep the raw chrome capture with the host
spans of fluid.trace beside it.
"""

import contextlib
import json
import os
import re

import torch

_SORT_KEYS = ('calls', 'total', 'max', 'min', 'ave')

_enabled = False
_mode = 'Serial'         # 'Serial' | 'Default' (trace-derived)
_records = {}  # op type -> [calls, total, max, min]
_folded = False          # records already added to fluid.monitor
_trace_path = None       # logdir of a start_trace capture
_trace_prof = None       # its torch.profiler.profile
_prof = None             # the torch.profiler.profile of a 'Default' run
_last = None             # last_profile() of the last 'Default' stop
_last_events = []        # its annotated device events

# device-side chrome-trace categories (Kineto): what the card ran
_DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def is_enabled():
    """True when the executor must run op by op ('Serial' mode only:
    the trace-derived mode measures the production path)."""
    return _enabled and _mode == 'Serial'


def op_ranges():
    """True while a 'Default' profile or a start_trace capture runs:
    the executor then wraps each op in a record_function range."""
    return _prof is not None or _trace_prof is not None


def record_op(op_type, seconds):
    """Executor hook: account one timed execution of `op_type`."""
    rec = _records.get(op_type)
    if rec is None:
        _records[op_type] = [1, seconds, seconds, seconds]
    else:
        rec[0] += 1
        rec[1] += seconds
        rec[2] = max(rec[2], seconds)
        rec[3] = min(rec[3], seconds)


def reset_profiler():
    """Drop all accumulated per-op records (reference
    platform::ResetProfiler)."""
    global _folded
    _records.clear()
    _folded = False


def summary_records():
    """{op_type: {'calls', 'total', 'max', 'min', 'ave'}} (seconds)."""
    return {t: {'calls': c, 'total': tot, 'max': mx, 'min': mn,
                'ave': tot / c}
            for t, (c, tot, mx, mn) in _records.items()}


def summary_string(sorted_key='total'):
    """The reference's profiler table (profiler.h:166 prints Event
    rows sorted by sorted_key)."""
    if sorted_key not in (None,) + _SORT_KEYS:
        raise ValueError('sorted_key must be one of %s, got %r'
                         % (_SORT_KEYS, sorted_key))
    key = sorted_key or 'total'
    rows = sorted(summary_records().items(),
                  key=lambda kv: kv[1][key], reverse=True)
    lines = ['%-28s %8s %12s %12s %12s %12s'
             % ('Event', 'Calls', 'Total(ms)', 'Min(ms)', 'Max(ms)',
                'Ave(ms)')]
    for t, r in rows:
        lines.append('%-28s %8d %12.4f %12.4f %12.4f %12.4f'
                     % (t, r['calls'], r['total'] * 1e3,
                        r['min'] * 1e3, r['max'] * 1e3,
                        r['ave'] * 1e3))
    return '\n'.join(lines)


def _registered_op_types():
    """Every op type the registry lowers, grad types included (the port
    makes a grad op's lowering at its first use)."""
    from ..ops import registry
    types = set(registry._REGISTRY)
    return types | set(t + '_grad' for t in types
                       if not t.endswith('_grad'))


def _resolve_component(comp, op_types, per_instance):
    """One scope-path component -> attribution name or None.  Strips
    transform wrappers (transpose(jvp(relu))) and, in per-instance
    mode, resolves '<type>#<idx>' instance suffixes (the FLAGS_opprof
    range names) to the full instance name."""
    base = comp
    while '(' in base and base.endswith(')'):
        base = base[base.index('(') + 1:-1]
    for cand in (comp, base):
        if cand in op_types:
            return cand
        if per_instance and '#' in cand:
            typ = cand.rsplit('#', 1)[0]
            if typ in op_types:
                return cand
    return None


def _kernel_label(name):
    """A device event's short name for its unattributed row: the
    kernel's name without its return type, namespace, template and
    argument lists ('void (anonymous namespace)::flash_fwd<float, 64>
    (Params)' -> 'flash_fwd')."""
    name = str(name or '?')
    for prefix in ('void ', '(anonymous namespace)::'):
        if name.startswith(prefix):
            name = name[len(prefix):]
    for sep in ('<', '('):
        cut = name.find(sep)
        if cut > 0:
            name = name[:cut]
    return name.rsplit('::', 1)[-1].strip() or '?'


def attribute_trace_events(events, op_types=None, per_instance=False,
                           with_stats=False):
    """Map device events back to fluid op types (the JAX package's
    rule over its ``tf_op`` scope paths, which ``annotate_device_events``
    writes into a torch.profiler export).

    Each event's args['tf_op'] is a '/'-separated path of the
    record_function ranges over its launch ('prog3/relu' or, for a
    kernel of the backward pass, 'prog3/relu_grad').  Attribution: the
    first path component that names a registered op type; events with
    no such component land under 'unattributed/<name>'.  Returns
    {name: [calls, total_s, max_s, min_s]}.

    `per_instance=True` (the fluid.opprof mode) resolves the
    '<type>#<block-index>' instance ranges FLAGS_opprof emits, and
    splits an event whose tf_op carries several ';'/','-separated
    source paths equally among them, with the shares of unresolvable
    ones filed under the 'unattributed/<name>' bucket.

    Tolerant by contract: malformed rows are skipped or zero-timed,
    never raised on; `with_stats=True` returns (recs, {'events',
    'attributed', 'dropped'}) so skipped rows are counted."""
    op_types = op_types or _registered_op_types()
    recs = {}
    cache = {}   # tf_op -> tuple(resolved names) | () for negative
    n_events = n_attr = dropped = 0

    def _fold(name, sec, calls=1):
        rec = recs.get(name)
        if rec is None:
            recs[name] = [calls, sec, sec, sec]
        else:
            rec[0] += calls
            rec[1] += sec
            rec[2] = max(rec[2], sec)
            rec[3] = min(rec[3], sec)

    for e in events:
        if not isinstance(e, dict):
            dropped += 1
            continue
        if e.get('ph') != 'X':
            continue
        n_events += 1
        args = e.get('args') or {}
        tf_op = args.get('tf_op') if isinstance(args, dict) else None
        if not tf_op or not isinstance(tf_op, str):
            dropped += 1
            continue
        try:
            sec = float(e.get('dur') or 0) * 1e-6
        except (TypeError, ValueError):
            sec = 0.0
        hit = cache.get(tf_op)
        if hit is None:
            if per_instance:
                paths = [p for p in re.split('[;,]', tf_op) if p]
            else:
                paths = [tf_op]
            resolved = []
            for p in paths:
                name = None
                for comp in p.split('/'):
                    name = _resolve_component(comp, op_types,
                                              per_instance)
                    if name is not None:
                        break
                resolved.append(name)
            hit = tuple(resolved)
            cache[tf_op] = hit
        matched = [n for n in hit if n is not None]
        if not matched:
            _fold('unattributed/' +
                  str(e.get('name', '?')).split('.')[0], sec)
            continue
        n_attr += 1
        share = sec / len(hit)
        leftover = share * (len(hit) - len(matched))
        for name in matched:
            _fold(name, share)
        if leftover > 0:
            _fold('unattributed/' +
                  str(e.get('name', '?')).split('.')[0], leftover)
    if with_stats:
        return recs, {'events': n_events, 'attributed': n_attr,
                      'dropped': dropped}
    return recs


# ------------------------------------------------ torch.profiler exports
_EVAL_FN = 'autograd::engine::evaluate_function: '


def _covering(ranges, t):
    """The ranges of one thread (sorted by start) that contain time `t`,
    outermost first."""
    return [r for r in ranges if r[0] <= t <= r[1]]


def _x_events(events):
    return [e for e in events if isinstance(e, dict) and e.get('ph') == 'X'
            and isinstance(e.get('ts'), (int, float))]


def annotate_device_events(events, op_types=None):
    """The device work of a torch.profiler chrome export, each event a
    copy with args['tf_op'] set to the path of record_function ranges
    that attribute it (see the module docstring), for
    ``attribute_trace_events``.  On the card the device work is the
    kernels, copies and memsets; in a CPU-only export, the host's
    top-level ops (an aten op no other op encloses)."""
    op_types = op_types or _registered_op_types()
    xs = _x_events(events)
    device = [e for e in xs if e.get('cat') in _DEVICE_CATS]
    on_host = not device
    ranges = {}     # (pid, tid) -> [(t0, t1, name)] of op ranges
    cpu_ops = {}    # (pid, tid) -> [(t0, t1, event)]
    launches = {}   # correlation -> (pid, tid, ts)
    forward = {}    # sequence number -> [(ts, pid, tid)]
    for e in xs:
        cat = e.get('cat')
        key = (e.get('pid'), e.get('tid'))
        t0 = float(e['ts'])
        t1 = t0 + float(e.get('dur') or 0.0)
        args = e.get('args') or {}
        if cat == 'user_annotation':
            ranges.setdefault(key, []).append((t0, t1, str(e['name'])))
        elif cat == 'cpu_op':
            cpu_ops.setdefault(key, []).append((t0, t1, e))
            seq = args.get('Sequence number')
            if seq is not None and not str(e['name']).startswith(
                    _EVAL_FN) and not args.get('Fwd thread id'):
                forward.setdefault(seq, []).append((t0, key))
        elif cat in ('cuda_runtime', 'cuda_driver'):
            corr = args.get('correlation')
            if corr is not None:
                launches[corr] = (key, t0)
    for v in ranges.values():
        v.sort()
    for v in cpu_ops.values():
        v.sort(key=lambda r: (r[0], -r[1]))

    def path_at(key, t):
        return [r[2] for r in _covering(ranges.get(key, ()), t)]

    def grad_path(key, t):
        """The forward op's range path + '_grad' for work the autograd
        engine ran at time `t` on thread `key`, or None."""
        evals = [r[2] for r in _covering(cpu_ops.get(key, ()), t)
                 if str(r[2]['name']).startswith(_EVAL_FN)]
        if not evals:
            return None
        seq = (evals[-1].get('args') or {}).get('Sequence number')
        cands = [f for f in forward.get(seq, ()) if f[0] <= t]
        if not cands:
            return None
        ts, fkey = max(cands)
        path = path_at(fkey, ts)
        for i in range(len(path) - 1, -1, -1):
            base = path[i].rsplit('#', 1)
            grad = base[0] + '_grad'
            if grad in op_types:
                path[i] = grad + ('#' + base[1] if len(base) > 1 else '')
                return path[:i + 1]
            if base[0] in op_types:
                return path[:i + 1]
        return path

    def tf_op(key, t):
        p = grad_path(key, t)
        if p is None:
            p = path_at(key, t)
        return '/'.join(p)

    out = []
    if on_host:
        for key, ops in cpu_ops.items():
            end = None
            for t0, t1, e in ops:
                if end is not None and t0 < end:
                    continue  # enclosed by the previous top-level op
                end = t1
                ev = dict(e)
                ev['args'] = dict(e.get('args') or {},
                                  tf_op=tf_op(key, t0 + 1e-3) or 'host')
                out.append(ev)
        return out
    for e in device:
        args = e.get('args') or {}
        where = launches.get(args.get('correlation'))
        ev = dict(e)
        ev['name'] = _kernel_label(e.get('name'))
        path = tf_op(*where) if where else ''
        ev['args'] = dict(args, tf_op=path or 'device',
                          kernel=str(e.get('name')))
        out.append(ev)
    return out


def device_time(events):
    """{'sum_ms', 'union_ms', 'events', 'streams'} of the device events
    of a chrome export: their summed durations, and the length of the
    union of their intervals over all streams (the time the card was
    busy)."""
    spans = sorted((float(e['ts']), float(e['ts']) + float(e.get('dur')
                                                             or 0.0))
                   for e in _x_events(events)
                   if e.get('cat') in _DEVICE_CATS)
    total = sum(b - a for a, b in spans)
    union, cur = 0.0, None
    for a, b in spans:
        if cur is None or a > cur[1]:
            if cur is not None:
                union += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        union += cur[1] - cur[0]
    streams = set((e.get('pid'), e.get('tid')) for e in _x_events(events)
                  if e.get('cat') in _DEVICE_CATS)
    return {'sum_ms': total * 1e-3, 'union_ms': union * 1e-3,
            'events': len(spans), 'streams': len(streams)}


def _export_events(prof):
    """The chrome-trace events of a stopped torch.profiler.profile."""
    import tempfile
    fd, path = tempfile.mkstemp(prefix='pt_prof_', suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get('traceEvents', [])
    finally:
        os.unlink(path)


def _attach_span_tracer():
    """Auto-attach the fluid.trace span tracer to a starting device
    capture, and emit the paired clock-sync range (the capture records
    'pt_clock_sync' on ITS clock while the tracer notes the host
    epoch-us; merge_device_trace aligns on that offset)."""
    from . import trace as trace_mod
    trace_mod.attach_capture()
    try:
        with torch.profiler.record_function('pt_clock_sync'):
            trace_mod.mark_clock_sync()
    except Exception:
        pass


def _check_not_capturing():
    if torch.cuda.is_available() and \
            torch.cuda.is_current_stream_capturing():
        raise RuntimeError('torch.profiler cannot start inside a CUDA-graph '
                           'capture')


def _start_torch_profiler(state):
    from torch.profiler import ProfilerActivity
    _check_not_capturing()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and state != 'CPU':
        acts.append(ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def start_profiler(state='All', tracer_option='Serial'):
    """Enable profiling (reference EnableProfiler).  `state` 'CPU'
    leaves the CUDA activity out of a 'Default' capture.
    tracer_option='Serial' runs op by op and host-times each;
    'Default' captures the production path under torch.profiler and
    attributes device events back to ops on stop (reference
    DeviceTracer)."""
    global _enabled, _mode, _prof
    if state not in ('CPU', 'GPU', 'All'):
        raise ValueError("state must be 'CPU', 'GPU' or 'All'")
    if tracer_option not in ('Serial', 'Default', 'OpDetail',
                             'AllOpDetail'):
        raise ValueError('unknown tracer_option %r' % (tracer_option,))
    reset_profiler()
    if _prof is not None:
        # a 'Default' capture is still active (start called twice):
        # close it, or the capture runs for ever
        from . import trace as trace_mod
        try:
            _prof.stop()
        finally:
            _prof = None
            trace_mod.detach_capture()
    _mode = 'Serial' if tracer_option == 'Serial' else 'Default'
    if _mode == 'Default':
        if _trace_prof is not None:
            raise RuntimeError(
                'a start_trace capture owns the profiler: call '
                'stop_trace() before a Default profile')
        _prof = _start_torch_profiler(state)
        _attach_span_tracer()
    _enabled = True


def _fold_into_monitor():
    """Fold the per-op table into the always-on stats registry under
    'profiler/<op>/…' keys, so one monitor.snapshot() carries both the
    counters and the last profile's per-op accounting."""
    global _folded
    if _folded:
        return
    _folded = True
    from . import monitor
    for t, (c, tot, mx, mn) in _records.items():
        safe = t.replace('/', ':')
        monitor.add('profiler/%s/calls' % safe, float(c))
        monitor.add('profiler/%s/total_seconds' % safe, tot)


def last_events():
    """The last 'Default' profile's device events, each annotated with
    its ``tf_op`` path (``annotate_device_events``): the capture
    fluid.opprof.record_capture folds."""
    return list(_last_events)


def last_profile():
    """What the last 'Default' profile measured, or None:
    {'rows': summary_records(), 'device': device_time(...),
    'kernels': {op or unattributed row: sorted kernel names},
    'events', 'attributed', 'dropped'}."""
    return _last


def stop_profiler(sorted_key='total', profile_path=None):
    """Disable profiling and print the sorted per-op table (reference
    DisableProfiler).  profile_path, when given, receives the table as
    a text file and, after a 'Default' profile, the merged host+device
    chrome timeline as '<table path>.timeline.json' (a directory gets
    'profile_summary.txt' inside).  Returns the table string and folds
    the records into fluid.monitor under 'profiler/…'."""
    global _enabled, _mode, _prof, _last, _last_events
    _enabled = False
    device_events = []
    host_cap = None
    if _mode == 'Default' and _prof is not None:
        from . import monitor
        from . import trace as trace_mod
        try:
            _prof.stop()
            device_events = _export_events(_prof)
        finally:
            _prof = None
            host_cap = trace_mod.detach_capture()
        types = _registered_op_types()
        annotated = annotate_device_events(device_events, types)
        recs, stats = attribute_trace_events(annotated, types,
                                             with_stats=True)
        _records.update(recs)
        _last_events = annotated
        kernels = {}
        for e in annotated:
            row = attribute_trace_events([e], types)
            name = next(iter(row)) if row else 'unattributed/?'
            kernels.setdefault(name, set()).add(
                (e.get('args') or {}).get('kernel') or e.get('name'))
        _last = dict(stats, rows=summary_records(),
                     device=device_time(device_events),
                     kernels={k: sorted(v) for k, v in kernels.items()})
        if stats['dropped']:
            monitor.add('profiler/dropped_events', float(stats['dropped']))
    _mode = 'Serial'
    _fold_into_monitor()
    table = summary_string(sorted_key)
    print(table)
    if profile_path:
        if os.path.isdir(profile_path) or profile_path.endswith(os.sep):
            os.makedirs(profile_path, exist_ok=True)
            profile_path = os.path.join(profile_path,
                                        'profile_summary.txt')
        d = os.path.dirname(profile_path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(profile_path, 'w') as f:
            f.write(table + '\n')
        if host_cap is not None:
            from . import trace as trace_mod
            merged = trace_mod.merge_device_trace(
                trace_mod.chrome_events(host_cap['events']),
                device_events, sync_host_us=host_cap['sync_us'],
                capture_t0_us=host_cap['t0_us'])
            trace_mod.write_chrome(profile_path + '.timeline.json',
                                   merged)
    return table


@contextlib.contextmanager
def profiler(state='All', sorted_key='total', profile_path=None,
             tracer_option='Serial'):
    """Profiling scope.  tracer_option='Serial': ops run one by one and
    host-timed; 'Default': the production path runs under
    torch.profiler, device events attributed back to ops.  On exit the
    sorted table prints (and lands in profile_path when given)."""
    start_profiler(state, tracer_option=tracer_option or 'Serial')
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


@contextlib.contextmanager
def cuda_profiler(*a, **k):
    yield


def start_trace(logdir):
    """Raw device-trace capture under torch.profiler (CPU and CUDA
    activities).  The fluid.trace span tracer auto-attaches, so one
    capture yields host phase spans AND device kernels; stop_trace
    writes 'device_trace.json' and 'host_trace.json' into `logdir`."""
    global _trace_path, _trace_prof
    if _trace_path is not None:
        raise RuntimeError(
            'a trace capture is already active (logdir %r): call '
            'stop_trace() before starting another' % (_trace_path,))
    if _prof is not None:
        raise RuntimeError(
            "a profiler capture (tracer_option='Default') owns the "
            'profiler: call stop_profiler() before start_trace()')
    os.makedirs(logdir, exist_ok=True)
    _trace_prof = _start_torch_profiler('All')
    _trace_path = logdir
    _attach_span_tracer()


def stop_trace():
    """Stop the capture; returns the logdir, which holds the capture as
    'device_trace.json' and the attached span tracer's host events as
    'host_trace.json'."""
    global _trace_path, _trace_prof
    from . import trace as trace_mod
    prof, _trace_prof = _trace_prof, None
    try:
        if prof is not None:
            prof.stop()
    finally:
        host_cap = trace_mod.detach_capture()
    path, _trace_path = _trace_path, None
    if path is not None and prof is not None:
        prof.export_chrome_trace(os.path.join(path, 'device_trace.json'))
        if host_cap is not None:
            trace_mod.write_host_trace(
                os.path.join(path, 'host_trace.json'), host_cap)
    return path


record_event = torch.profiler.record_function
