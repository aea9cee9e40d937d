"""fluid.memviz — device-memory observability plane.

Reference: paddle/fluid/memory/ allocator stats behind STAT_ADD and the
FLAGS_fraction_of_gpu_memory_to_use arena (JAX: fluid/memviz.py, whose
registries, detectors, incident format and API this module keeps), in
four coupled pieces:

**Peak attribution.**  A program's first run (a plan-cache miss: the
executor's plan build, never the steady state) files one row under
(program, 'step'): on the card ``record_segment`` measures it, with
``torch.cuda.reset_peak_memory_stats`` before the run and
``max_memory_allocated`` after, and decomposes that peak into named
contributors: per-argument bytes split param / state / feed (the scope
tensors and feeds the program reads), the new outputs (fetches), the
run's transients (``temp_bytes``) and the device memory resident before
the run that the program does not read (``other_bytes``: other
programs, tensors the caller holds) — rows plus ``other`` sum to the
measured peak.  It runs only under ``FLAGS_memviz``: resetting the
peak statistics around a run is the one cost the plane adds.  Without
the flag, and on the CPU, ``record_segment_estimate`` builds the row
from the bound arguments and outputs themselves (peak = arguments +
outputs, a lower bound flagged ``estimated``), as the JAX package's
parallel runners do.  ``peak_bytes(program)`` reads the rows.

**Live accounting.**  ``live_census()`` walks the scopes' tensors (the
global scope, the running one and every registered provider's,
``register_scope_provider``) and classifies them ``param`` (registered
parameter names) or ``state``; on the card the rest of
``torch.cuda.memory_allocated`` is ``other`` (activations in flight,
fetches the caller holds, the CUDA graphs' pools), so the classes sum
to the allocator's count.  ``maybe_sample(step, scope)`` — the per-step
sampler behind ``FLAGS_memviz`` — emits ``memviz/live_bytes/<class>``
gauges, a high-watermark gauge and a counter track merged into the
trace timeline.  Off (the default) the executor pays one flag read per
step.

**OOM forensics.**  A failed dispatch whose error is an allocation
failure (``torch.cuda.OutOfMemoryError``, or the allocator's message)
goes through ``oom_incident``: a rate-limited flight-recorder dump
embedding the memory snapshot, and an error note naming the top
contributors.

**Budget watermarks.**  ``FLAGS_memviz_budget_bytes`` (default: the
card's memory) turns the census into a utilization gauge with a
watermark detector (``FLAGS_memviz_watermark``) and a growth-spike
detector (``FLAGS_memviz_spike_factor`` over the running EMA) that
auto-dump the snapshot BEFORE the OOM; ``/healthz`` carries the
degradation.

Hot-path discipline mirrors monitor/trace: torch is imported where a
census or a measurement needs it, attribution runs at plan-build time
only, and the sampler is flag-gated.
"""

import re as _re
import threading
import time

from . import monitor
from .flags import get_flag

__all__ = [
    'record_segment', 'record_segment_estimate', 'report',
    'peak_bytes', 'top_contributors',
    'program_label', 'program_scope', 'current_program',
    'note_params', 'live_census', 'last_census', 'maybe_sample',
    'budget_bytes', 'memory_pressure', 'is_oom_error', 'oom_incident',
    'format_incident', 'register_scope_provider', 'reset',
    'run_begin', 'record_run',
]

_lock = threading.Lock()
_tls = threading.local()

# (program_label, segment_label) -> attribution row; insertion-ordered
# and bounded like comms._MEMORY (distinct executables are bounded by
# the compile caches, but a retrace loop must not leak)
_SEGMENTS = {}
_SEGMENTS_CAP = 512
# program-object labeling: monotonic sequence, stamped on the Program
_prog_seq = [0]
# registered parameter names (census param-vs-state classification)
_PARAM_NAMES = set()
_PARAM_NAMES_CAP = 65536
# callables returning [(label, scope)] beyond the active scope — the
# serving plane registers its tenant table here
_SCOPE_PROVIDERS = []
# detector / incident state
_state = {'ema': None, 'hwm': 0.0, 'last_census': None,
          'budget_detected': None}

TOP_K = 8


def reset():
    """Drop the registries and detector state (tests, bench entry
    isolation).  Registered scope providers survive — they mirror
    module lifetime, not run lifetime."""
    with _lock:
        _SEGMENTS.clear()
        _PARAM_NAMES.clear()
        _state.update({'ema': None, 'hwm': 0.0, 'last_census': None,
                       'budget_detected': None})
    # the dump limiter moved into the shared trace-side helper; a
    # reset must still re-open the interval or back-to-back tests
    # (and bench entries) silently stop dumping
    from . import trace
    trace.reset_rate_limits('memviz/')


# ------------------------------------------------------- program labels
def program_label(program):
    """A stable human-readable label for a Program object, assigned on
    first sight ('prog3').  The label keys attribution rows and the
    ambient program_scope the planner's headroom gate reads."""
    label = getattr(program, '_memviz_label', None)
    if label is None:
        with _lock:
            label = getattr(program, '_memviz_label', None)
            if label is None:
                _prog_seq[0] += 1
                label = 'prog%d' % _prog_seq[0]
                try:
                    program._memviz_label = label
                except Exception:
                    pass
    return label


class _ProgramScope(object):
    __slots__ = ('_label', '_prev')

    def __init__(self, label):
        self._label = label

    def __enter__(self):
        self._prev = getattr(_tls, 'program', None)
        _tls.program = self._label
        return self

    def __exit__(self, *exc):
        _tls.program = self._prev
        return False


def program_scope(label_or_program):
    """Ambient 'this thread is planning/tracing/running THIS program'
    context: comms_plan.hbm_headroom_bytes() resolves the per-program
    peak through it.  Accepts a label string or a Program."""
    label = label_or_program if isinstance(label_or_program, str) \
        else program_label(label_or_program)
    return _ProgramScope(label)


def current_program():
    """The ambient program label, or None outside a program_scope."""
    return getattr(_tls, 'program', None)


def note_params(names):
    """Register parameter names for the census's param-vs-state split
    (the executor calls this once per program when sampling is on)."""
    with _lock:
        if len(_PARAM_NAMES) < _PARAM_NAMES_CAP:
            _PARAM_NAMES.update(str(n) for n in names)


# ------------------------------------------------------ peak attribution
def _nbytes_of_spec(spec):
    """Bytes of one boundary spec (ShapeDtypeStruct / array-like)."""
    try:
        n = getattr(spec, 'nbytes', None)
        if n is not None:
            return float(n)
        if isinstance(spec, tuple) and len(spec) == 2:
            from . import core
            import torch
            shape, dtype = spec
            size = 1
            for s in shape:
                size *= int(s)
            return float(size * torch.empty(
                (), dtype=core.convert_dtype(dtype)).element_size())
        import numpy as _np
        size = 1
        for s in getattr(spec, 'shape', ()):
            size *= int(s)
        return float(size * _np.dtype(spec.dtype).itemsize)
    except Exception:
        return 0.0


def run_begin(device):
    """Start measuring a run's peak on `device` (a torch device): None
    off the card; on it the card is synchronized, the allocated bytes
    read and the peak statistics reset.  ``record_run`` closes it."""
    if getattr(device, 'type', None) != 'cuda':
        return None
    import torch
    torch.cuda.synchronize(device)
    base = float(torch.cuda.memory_allocated(device))
    torch.cuda.reset_peak_memory_stats(device)
    return base


def _tensor_bytes(v):
    """Bytes of one scope or env value (0 for what holds no tensor)."""
    from . import core
    v = core.as_array(v)
    try:
        return float(v.numel() * v.element_size())
    except AttributeError:
        return float(getattr(v, 'nbytes', 0) or 0)


def _op_for_output(seg, name):
    """The op desc producing segment output `name` (attribution's
    'originating op'), or None for pass-through values."""
    if seg is None:
        return None
    try:
        for op in reversed(getattr(seg, 'ops', seg)):
            for out_name in op.output_arg_names:
                if out_name == name:
                    return op.type
    except Exception:
        pass
    return None


def _resolve_program(program):
    prog = program if isinstance(program, str) or program is None \
        else program_label(program)
    return prog or current_program() or 'unlabeled'


def _classify_args(state_specs, data_specs, param_names=None):
    """(contributors, classes) over the named boundary arguments:
    per-name bytes split param / state / feed."""
    if param_names is None:
        params = _PARAM_NAMES
    else:
        params = set(str(n) for n in param_names)
    contributors = []
    classes = {'param': 0.0, 'state': 0.0, 'feed': 0.0}
    for names_bytes, cls_of in (
            (state_specs or {},
             lambda n: 'param' if n in params else 'state'),
            (data_specs or {}, lambda n: 'feed')):
        for n, spec in names_bytes.items():
            b = _nbytes_of_spec(spec)
            cls = cls_of(n)
            classes[cls] += b
            contributors.append({'name': str(n), 'class': cls,
                                 'bytes': b, 'op': None})
    return contributors, classes


def _file_row(prog, row):
    key = (prog, row['segment'])
    evicted_prog = None
    with _lock:
        if key not in _SEGMENTS and len(_SEGMENTS) >= _SEGMENTS_CAP:
            (ep, _es) = next(iter(_SEGMENTS))
            _SEGMENTS.pop((ep, _es))
            # keep the per-program gauge label set bounded: when a
            # program's LAST row rotates out, its gauge goes too — a
            # frozen peak for a long-gone program misleads scrapes
            if not any(p == ep for (p, _s) in _SEGMENTS):
                evicted_prog = ep
        _SEGMENTS[key] = row
        prog_peak = max((r['peak_bytes'] for (p, _s), r
                         in _SEGMENTS.items() if p == prog),
                        default=0.0)
    if evicted_prog is not None and evicted_prog != prog:
        monitor.remove_gauge('memviz/program_peak_bytes/%s'
                             % evicted_prog)
    monitor.add('memviz/segments_attributed')
    monitor.set_gauge('memviz/program_peak_bytes/%s' % prog, prog_peak)
    return row


def record_segment(program, segment_label, measured, state_specs,
                   data_specs, seg=None, param_names=None):
    """Decompose one run's measured peak (`measured`: {'peak_bytes',
    'base_bytes', 'outputs'} from ``record_run``) into named
    contributors and file the row under (program, segment).  The rows
    sum: param + state + feed + output + temp + other == peak.  Runs
    once per plan build, NEVER per step."""
    prog = _resolve_program(program)
    contributors, classes = _classify_args(state_specs, data_specs,
                                           param_names)
    out_total = 0.0
    for n, v in (measured.get('outputs') or {}).items():
        b = _nbytes_of_spec(v)
        out_total += b
        contributors.append({'name': str(n), 'class': 'output',
                             'bytes': b or None,
                             'op': _op_for_output(seg, n)})
    named_args = classes['param'] + classes['state'] + classes['feed']
    peak = float(measured['peak_bytes'])
    # resident before the run and not read by it (device-side args
    # were resident already; feeds staged by the run are not)
    other = max(0.0, float(measured['base_bytes']) - classes['param'] -
                classes['state'] - float(measured.get('fed_resident')
                                         or 0.0))
    row = {
        'program': prog,
        'segment': str(segment_label),
        'peak_bytes': peak,
        'argument_bytes': named_args,
        'output_bytes': out_total,
        'temp_bytes': peak - named_args - out_total - other,
        'other_bytes': other,
        'generated_code_bytes': 0.0,
        'classes': classes,
        'arg_overhead_bytes': 0.0,
        'top_buffers': sorted(
            (c for c in contributors if c['bytes']),
            key=lambda c: -c['bytes'])[:TOP_K],
        'outputs': [c for c in contributors
                    if c['class'] == 'output'][:TOP_K],
        'ts': time.time(),
    }
    return _file_row(prog, row)


def record_run(program, device, base, state, data, outputs, ops):
    """Executor hook after a plan's first run: the measured row when
    ``run_begin`` measured (`base` not None), else the estimated one.
    `state` / `data` are the scope values and feeds the run read,
    `outputs` its fetches.  Never raises."""
    try:
        if base is None:
            return record_segment_estimate(program, 'step', state, data,
                                           outputs, seg=ops)
        import torch
        from . import core
        torch.cuda.synchronize(device)
        resident = sum(_tensor_bytes(v) for v in data.values()
                       if getattr(core.as_array(v), 'is_cuda', False))
        measured = {'peak_bytes': float(
            torch.cuda.max_memory_allocated(device)),
            'base_bytes': base, 'fed_resident': resident,
            'outputs': {n: v for n, v in outputs.items()
                        if n not in state}}
        return record_segment(program, 'step', measured, state, data,
                              seg=ops)
    except Exception:
        monitor.add('memviz/attribution_errors')
        return None


def record_segment_estimate(program, segment_label, state, data,
                            outputs=None, seg=None):
    """ESTIMATED attribution (the CPU, or FLAGS_memviz off): the row is
    built from the bound argument and output tensors themselves — peak =
    arguments + outputs, temps unknown (a LOWER bound, flagged
    ``estimated``).  Runs at a plan's first run only."""
    prog = _resolve_program(program)
    contributors, classes = _classify_args(state, data)
    out_total = 0.0
    state_names = set(state or {})
    for n, v in (outputs or {}).items():
        # state written in place is the SAME memory as its argument
        # and must not count twice — only genuinely new outputs add
        b = 0.0 if n in state_names else _nbytes_of_spec(v)
        out_total += b
        contributors.append({'name': str(n), 'class': 'output',
                             'bytes': b or None,
                             'op': _op_for_output(seg, n)})
    arg_total = classes['param'] + classes['state'] + classes['feed']
    row = {
        'program': prog,
        'segment': str(segment_label),
        'peak_bytes': arg_total + out_total,
        'argument_bytes': arg_total,
        'output_bytes': out_total,
        'temp_bytes': 0.0,
        'generated_code_bytes': 0.0,
        'classes': classes,
        'arg_overhead_bytes': 0.0,
        'estimated': True,
        'top_buffers': sorted(
            (c for c in contributors if c['bytes']),
            key=lambda c: -c['bytes'])[:TOP_K],
        'outputs': [c for c in contributors
                    if c['class'] == 'output'][:TOP_K],
        'ts': time.time(),
    }
    return _file_row(prog, row)


def report(limit=32):
    """Attribution rows for /statusz, largest peak first: the top-K
    table that replaces the four scalars."""
    with _lock:
        rows = [dict(r) for r in _SEGMENTS.values()]
    rows.sort(key=lambda r: -r['peak_bytes'])
    return rows[:limit]


def peak_bytes(program=None):
    """Largest recorded segment peak for `program` (a label), or None
    when nothing is recorded for it.  `program=None` returns the
    job-wide max over every recorded row (None when empty) — callers
    needing the legacy global behavior fall back to the
    executor/segment_peak_bytes gauge."""
    with _lock:
        vals = [r['peak_bytes'] for (p, _s), r in _SEGMENTS.items()
                if program is None or p == program]
    return max(vals) if vals else None


def top_contributors(k=TOP_K):
    """The k largest named buffers across every recorded segment —
    the 'what is actually filling device memory' list OOM notes lead with."""
    with _lock:
        rows = list(_SEGMENTS.values())
    out = []
    seen = set()
    for r in rows:
        for c in r['top_buffers']:
            # dedup per PROGRAM: one buffer feeding several segments of
            # a program lists once, but identically-shaped same-named
            # buffers of DIFFERENT programs (model replicas, tenants)
            # are distinct device residency and must both show
            key = (r['program'], c['name'])
            if key in seen:
                continue
            seen.add(key)
            out.append(dict(c, program=r['program'],
                            segment=r['segment']))
    out.sort(key=lambda c: -c['bytes'])
    return out[:k]


# ---------------------------------------------------------- live census
def register_scope_provider(fn):
    """Register a callable returning [(label, core.Scope)] the census
    should walk beyond the active scope — the serving plane registers
    its tenant table so tenant residency is attributable."""
    with _lock:
        if fn not in _SCOPE_PROVIDERS:
            _SCOPE_PROVIDERS.append(fn)


def _walk_scope(scope, out, prefix=''):
    """storage pointer -> (name, bytes) over one scope tree's tensors.
    READ-ONLY: the census never allocates or moves a value."""
    import torch
    from . import core
    try:
        items = list(scope._vars.items())
        kids = list(scope.kids)
    except Exception:
        return
    for n, v in items:
        v = core.as_array(v) if v is not None else None
        if isinstance(v, torch.Tensor):
            st = v.untyped_storage()
            out.setdefault((v.device.type, st.data_ptr()),
                           (prefix + str(n), float(st.nbytes()),
                            v.device.type))
    for kid in kids:
        _walk_scope(kid, out, prefix)


def live_census(scope=None):
    """One pass over the scopes' tensors (global, `scope`, and every
    registered provider's) classified into param / state bytes (each
    storage counted once), plus per-tenant residency for the provider
    scopes.  On the card the rest of ``torch.cuda.memory_allocated`` is
    ``other``, so the classes sum to the allocator's count and
    ``total_bytes`` is that count; on the CPU the total is the scopes'
    own bytes.  ``feed`` and ``exec`` stay 0: staged batches are not
    tracked apart from ``other``, and a CUDA graph's pool is allocator
    memory (``other``).  Post-step only (the sampler or an
    incident)."""
    import torch
    from . import core
    storages = {}
    _walk_scope(core.global_scope(), storages)
    if scope is not None and scope is not core.global_scope():
        _walk_scope(scope, storages)
    tenant_of = {}
    with _lock:
        providers = list(_SCOPE_PROVIDERS)
        params = set(_PARAM_NAMES)
    for provider in providers:
        try:
            for label, sc in provider():
                t_st = {}
                _walk_scope(sc, t_st)
                for k, v in t_st.items():
                    storages.setdefault(k, v)
                    tenant_of[k] = str(label)
        except Exception:
            pass
    on_card = torch.cuda.is_available() and torch.cuda.is_initialized()
    kind = 'cuda' if on_card else 'cpu'
    classes = {'param': 0.0, 'state': 0.0, 'feed': 0.0, 'exec': 0.0,
               'other': 0.0}
    tenants = {}
    n_arrays = 0
    for key, (name, b, dev) in storages.items():
        if dev != kind:
            continue
        n_arrays += 1
        classes['param' if name in params else 'state'] += b
        t = tenant_of.get(key)
        if t is not None:
            tenants[t] = tenants.get(t, 0.0) + b
    named = classes['param'] + classes['state']
    if on_card:
        total = float(torch.cuda.memory_allocated())
        classes['other'] = max(0.0, total - named)
        total = max(total, named)
    else:
        total = named
    census = {'classes': classes, 'total_bytes': total,
              'arrays': n_arrays, 'tenants': tenants,
              'device': kind, 'ts': time.time()}
    with _lock:
        _state['last_census'] = census
    return census


def last_census():
    """The most recent census (sampler or incident), or None."""
    return _state['last_census']


# --------------------------------------------------------------- budget
def budget_bytes():
    """The device-memory budget the watermarks measure against:
    FLAGS_memviz_budget_bytes when set, else the card's memory
    (``torch.cuda.get_device_properties``, memoized; None on the
    CPU)."""
    flag = float(get_flag('FLAGS_memviz_budget_bytes', 0) or 0)
    if flag > 0:
        return flag
    detected = _state['budget_detected']
    if detected is None:
        detected = 0.0
        try:
            import torch
            if torch.cuda.is_available():
                detected = float(torch.cuda.get_device_properties(
                    torch.cuda.current_device()).total_memory)
        except Exception:
            pass
        with _lock:
            _state['budget_detected'] = detected
    return detected or None


def memory_pressure():
    """/healthz degradation input: {'utilization', 'degraded',
    'budget_bytes', 'live_bytes'} from the last census, or None before
    any sample (or without a budget)."""
    census = _state['last_census']
    if census is None:
        # no census yet: don't touch the device just to answer
        # /healthz on a process that never sampled
        return None
    budget = budget_bytes()
    if not budget:
        return None
    util = census['total_bytes'] / budget
    watermark = float(get_flag('FLAGS_memviz_watermark', 0.9) or 0.9)
    return {'utilization': round(util, 4),
            'degraded': util >= watermark,
            'budget_bytes': budget,
            'live_bytes': census['total_bytes']}


# -------------------------------------------------------------- sampler
def maybe_sample(step, scope=None):
    """Per-step sampler entry (the executor calls this after each
    step): OFF (FLAGS_memviz unset, the default) it costs one flag
    read.  On, every FLAGS_memviz_sample_steps'th step takes a census,
    publishes the per-class gauges + high watermark, feeds the
    Perfetto counter track, and runs the watermark/spike detectors."""
    if not get_flag('FLAGS_memviz'):
        return None
    stride = int(get_flag('FLAGS_memviz_sample_steps', 1) or 1)
    if stride > 1 and step % stride:
        return None
    t0 = time.perf_counter()
    census = live_census(scope)
    classes = census['classes']
    for cls, b in classes.items():
        monitor.set_gauge('memviz/live_bytes/%s' % cls, b)
    monitor.set_gauge('memviz/live_bytes_total', census['total_bytes'])
    monitor.set_gauge('memviz/live_arrays', census['arrays'])
    with _lock:
        # read-modify-write under the lock: concurrent samplers
        # (serving dispatcher + trainer) must not lose a watermark
        hwm = max(_state['hwm'], census['total_bytes'])
        _state['hwm'] = hwm
    monitor.set_gauge('memviz/live_bytes_hwm', hwm)
    monitor.add('memviz/samples')
    from . import trace
    trace.counter('memviz/live_bytes',
                  {cls: classes[cls] for cls in sorted(classes)})
    _check_watermarks(step, census)
    monitor.observe('memviz/sample_seconds',
                    time.perf_counter() - t0)
    return census


def _check_watermarks(step, census):
    """Budget watermark + growth-spike detectors over one census; a
    trip auto-dumps the flight recorder with the snapshot embedded
    BEFORE the allocator fails.  Never raises."""
    try:
        total = census['total_bytes']
        budget = budget_bytes()
        tripped = None
        if budget:
            util = total / budget
            monitor.set_gauge('memviz/budget_utilization', util)
            watermark = float(get_flag('FLAGS_memviz_watermark', 0.9)
                              or 0.9)
            if util >= watermark:
                monitor.add('memviz/watermark_trips')
                tripped = {'detector': 'watermark', 'step': step,
                           'utilization': util,
                           'budget_bytes': budget}
        factor = float(get_flag('FLAGS_memviz_spike_factor', 2.0)
                       or 0.0)
        with _lock:
            ema = _state['ema']
            _state['ema'] = total if ema is None else \
                0.9 * ema + 0.1 * total
        if tripped is None and ema is not None and ema > 0 and \
                factor > 0 and total > factor * ema:
            monitor.add('memviz/spike_trips')
            tripped = {'detector': 'spike', 'step': step,
                       'live_bytes': total, 'ema_bytes': ema,
                       'factor': factor}
        if tripped is not None:
            _auto_dump('memviz_%s_step%s'
                       % (tripped['detector'], step),
                       dict(tripped, kind='memory_pressure',
                            snapshot=snapshot(census=census)))
    except Exception:
        monitor.add('memviz/detector_errors')


def _auto_dump(tag, extra):
    """Rate-limited flight-recorder dump (one per
    FLAGS_memviz_dump_interval_s) so a persistently-pressured job
    cannot spam /tmp."""
    from . import trace
    interval = float(get_flag('FLAGS_memviz_dump_interval_s', 60.0)
                     or 60.0)
    # the shared limiter claims atomically: two concurrent detector
    # trips must produce ONE dump, not race past the limiter together
    path = trace.rate_limited_dump('memviz/detector', interval,
                                   tag=tag, extra=extra)
    if path:
        monitor.add('memviz/detector_dumps')
    return path


# -------------------------------------------------------- OOM forensics
# anchored on the canonical allocator markers: bare substrings would
# let an identifier containing 'OOM' (a model named BLOOM) or a
# host-side 'failed to allocate' (thread pool) hijack the forensics
# path and burn the rate-limited dump on a non-memory failure
_OOM_RE = _re.compile(
    r'RESOURCE[_ ]EXHAUSTED'
    r'|CUDA out of memory'
    r'|[Oo]ut of (?:device )?memory'
    r'|\bOOM\b'
    r'|[Ff]ailed to allocate (?:memory|device|\d)'
    r'|Allocation failure')


def is_oom_error(e):
    """Does this exception look like a device allocation failure?
    (``torch.cuda.OutOfMemoryError``, or an allocator's message.)"""
    import torch
    oom = getattr(torch.cuda, 'OutOfMemoryError', None)
    if oom is not None and isinstance(e, oom):
        return True
    return _OOM_RE.search(str(e)) is not None


def snapshot(scope=None, census=None):
    """The full memory snapshot an incident embeds: live census,
    per-segment peaks, largest buffers, serving tenants, budget.
    `segments`/`top_buffers` are the attribution REGISTRY's view —
    compile-time history of everything this process built, which may
    include programs no longer resident; the census classes are the
    ground truth of what is live right now."""
    census = census or live_census(scope)
    tenants = census.get('tenants') or {}
    return {
        'census': census,
        'segments': report(limit=TOP_K),
        'top_buffers': top_contributors(TOP_K),
        'serving_tenants': tenants,
        'budget': memory_pressure(),
    }


def oom_incident(e, step=None, scope=None):
    """Allocation-failure hook (executor + parallel runners): count
    it, dump the flight recorder with the memory snapshot embedded
    (rate-limited: one dump per FLAGS_memviz_oom_interval_s), and
    return the actionable note naming the top contributors.  Never
    raises — the original error must surface."""
    try:
        monitor.add('memviz/oom_incidents')
        program = current_program()
        snap = snapshot(scope)
        snap.update({'kind': 'oom', 'step': step, 'program': program,
                     'error': str(e)[:500]})
        from . import trace
        interval = float(get_flag('FLAGS_memviz_oom_interval_s', 30.0)
                         or 30.0)
        path = trace.rate_limited_dump('memviz/oom', interval,
                                       tag='oom_step%s' % step,
                                       extra=snap)
        if path:
            monitor.add('memviz/oom_dumps')
        return format_incident(snap, path)
    except Exception:
        return None


def _mib(b):
    b = float(b)
    if b >= (1 << 30):
        return '%.2fGiB' % (b / (1 << 30))
    if b >= (1 << 20):
        return '%.1fMiB' % (b / (1 << 20))
    if b >= 1024:
        return '%.1fKiB' % (b / 1024.0)
    return '%dB' % int(b)


def format_incident(snap, dump_path=None):
    """Render an OOM snapshot as the exception-note block: live device memory by
    class, the largest resident segments and named buffers, tenants,
    and where the full dump landed."""
    lines = ['device memory exhausted']
    census = snap.get('census') or {}
    classes = census.get('classes') or {}
    if classes:
        lines.append('  live device memory %s across %s tensors (%s)' % (
            _mib(census.get('total_bytes', 0.0)),
            census.get('arrays', 0),
            ', '.join('%s=%s' % (c, _mib(classes[c]))
                      for c in sorted(classes) if classes[c])))
    budget = snap.get('budget')
    if budget:
        lines.append('  budget %s at %.0f%% utilization%s' % (
            _mib(budget['budget_bytes']),
            100.0 * budget['utilization'],
            ' (DEGRADED)' if budget['degraded'] else ''))
    for r in (snap.get('segments') or [])[:3]:
        lines.append('  segment %s/%s peak %s (args %s, temps %s)'
                     % (r['program'], r['segment'],
                        _mib(r['peak_bytes']),
                        _mib(r['argument_bytes']),
                        _mib(r['temp_bytes'])))
    tops = snap.get('top_buffers') or []
    if tops:
        lines.append('  largest buffers: ' + ', '.join(
            '%s=%s (%s)' % (c['name'], _mib(c['bytes']), c['class'])
            for c in tops[:5]))
    tenants = snap.get('serving_tenants') or {}
    if tenants:
        lines.append('  serving tenants resident: ' + ', '.join(
            '%s=%s' % (t, _mib(b))
            for t, b in sorted(tenants.items(), key=lambda kv: -kv[1])))
    if dump_path:
        lines.append('  memory snapshot embedded in flight dump: %s'
                     % dump_path)
    return '\n'.join(lines)
