"""fluid.opprof — op-level cost attribution plane.

The runtime can say where a step's milliseconds go by *phase*
(``trace.step_report()``) and where its bytes go (``memviz``), and
``profiler`` rolls device kernels up to op *type* while it is armed;
this module says which op *instance* costs the time (JAX:
fluid/opprof.py, whose registries, rollups, worklist and report this
module keeps), in four coupled pieces:

**Instance provenance.**  Under ``FLAGS_opprof`` the executor names each
op's ``record_function`` range ``<type>#<block-index>`` (``op_scope()``
here computes the suffix) instead of the type alone, so a capture's
kernels resolve to a SPECIFIC op desc.  The ranges exist only while a
profile or capture runs (``profiler.op_ranges``); the name changes
nothing that keys a plan or a CUDA graph.

**Capture attribution.**  ``record_capture(events)`` folds a chrome
capture (a torch.profiler export run through
``profiler.annotate_device_events``, or any events carrying the JAX
package's ``tf_op`` scope paths) through
``profiler.attribute_trace_events(per_instance=True)`` into a bounded
per-(program, segment, op-instance) registry, with the time of events
no op range covers filed under an honest ``unattributed`` bucket.
Rollups by op type and by layer, ``opprof/*`` monitor points and the
``/statusz`` ``op_costs`` table read this one registry.

**Eager replay profiler.**  On snapshot steps (``FLAGS_opprof`` on,
every ``FLAGS_opprof_snapshot_steps``-th step) the executor stashes
copies of the state and feeds a step reads plus that step's measured
synchronous wall (the card synchronized at its end).  ``replay_all()``
(on demand: HTTP ``/opprof``) replays each stashed step op by op
through the executor's op runner (``executor.replay_ops``, the walk
``health.nan_provenance`` uses), timing every op to completion and
sizing its outputs; the eager walls are then NORMALIZED so a step's
instance costs sum to its measured wall (both numbers are kept).

**The worklist.**  ``kernel_worklist()`` ranks contiguous
same-segment op runs (maximal same-type runs — the shape the fused
multi-tensor kernels consume) by attributable ms/step and bytes moved,
names the hand-written kernel that already serves a run through the
kernel registry's declared ``op_types`` (``ops/kernels/common.py``
``covering_kernel``), and ``write_worklist()`` emits
``op_worklist.json``.

Hot-path discipline mirrors memviz: no torch import,
``FLAGS_opprof`` off costs ONE flag read per step (the
``want_snapshot`` gate), and all registries are bounded and
lock-disciplined.
"""

import json
import re
import threading
import time

from . import monitor
from .flags import get_flag

__all__ = [
    'enabled', 'instancing', 'op_scope', 'want_snapshot',
    'note_segment', 'replay_all', 'record_capture', 'report',
    'rollup_by_type', 'rollup_by_layer', 'kernel_worklist',
    'write_worklist', 'http_report', 'reset',
]

_lock = threading.Lock()

# (program, segment) -> cost row; insertion-ordered, bounded (the
# distinct-executable population is bounded by the compile caches, but
# a retrace loop must not leak)
_COSTS = {}
_COSTS_CAP = 512
# (program, segment) -> replay snapshot {ops, state, data, step,
# prefer_test, measured_s}; state copies pin device buffers, so this
# registry is small and overwritten per snapshot step
_SNAPSHOTS = {}
_SNAPSHOTS_CAP = 64
# instance scope -> (op type, layer label): lets capture-sourced rows
# (which carry scope strings, not op descs) join the layer rollup
_INSTANCE_OPS = {}
_INSTANCE_OPS_CAP = 8192
# trace-time block-index memo: (id(block), len(ops)) -> {id(op): idx}
_BLOCK_IDX = {}
_BLOCK_IDX_CAP = 64

_INSTANCE_RE = re.compile(r'^(.*)#(\d+)$')
_GENERIC_LAYER = re.compile(r'([A-Za-z]\w*?_\d+)\.')
_LAYER_RULES = None

TOP_K = 16


def reset():
    """Drop every registry (tests, bench entry isolation)."""
    with _lock:
        _COSTS.clear()
        _SNAPSHOTS.clear()
        _INSTANCE_OPS.clear()
        _BLOCK_IDX.clear()


# ---------------------------------------------------- instance provenance
def enabled():
    return bool(get_flag('FLAGS_opprof'))


def instancing():
    """Whether the executor should emit instance-suffixed scope names.
    Read at TRACE time (lowerings run once per compiled segment), so
    this is never a per-step cost."""
    return bool(get_flag('FLAGS_opprof'))


def _block_index(op):
    """Index of `op` within its Program block — the stable instance
    suffix.  Identity-based (Operator defines no __eq__) and memoized
    per block, so a whole-block lowering stays O(block)."""
    try:
        ops = op.block.ops
    except Exception:
        return -1
    key = (id(op.block), len(ops))
    idx = _BLOCK_IDX.get(key)
    if idx is None:
        idx = {id(o): i for i, o in enumerate(ops)}
        with _lock:
            if len(_BLOCK_IDX) >= _BLOCK_IDX_CAP:
                _BLOCK_IDX.clear()
            _BLOCK_IDX[key] = idx
    return idx.get(id(op), -1)


def op_scope(op, type_name=None):
    """The instance scope name for an op desc: ``<type>#<block-index>``.
    Stable across retraces of the same Program (the block's op list is
    the identity), and what a device capture's ``tf_op`` path carries
    back when ``FLAGS_opprof`` was on at trace time.  ``type_name``
    overrides the leading component (the fused-optimizer runs lower
    under their ``fused_<type>`` name, anchored at the run's first
    member)."""
    return '%s#%d' % (type_name or op.type, _block_index(op))


def split_instance(name):
    """('fc#3') -> ('fc', 3); a bare type maps to index None."""
    m = _INSTANCE_RE.match(name)
    if m:
        try:
            return m.group(1), int(m.group(2))
        except ValueError:
            pass
    return name, None


# ----------------------------------------------------- layer attribution
# the layer families of the JAX package's auto-sharding rules
# (parallel/plan.py default_rules: embeddings, moe experts, fc/mul
# weights), which name layers alike in both planes there; the planner
# itself is ROADMAP item 13 of the port
_LAYER_PATTERNS = (r'gpt_wte|embedding_\d+\.w_\d+', r'moe[\w.]*\.w_\d+',
                   r'(fc|mul)_\d+\.w_\d+')


def _layer_rules():
    """Compiled layer-naming regexes (``_LAYER_PATTERNS``)."""
    global _LAYER_RULES
    if _LAYER_RULES is None:
        _LAYER_RULES = [re.compile(p) for p in _LAYER_PATTERNS]
    return _LAYER_RULES


def layer_of(op):
    """Layer label for an op desc, from its var names: first match of
    the plan rule regexes wins (``fc_2.w_0`` -> ``fc_2``), then the
    generic ``<layer>_N.`` LayerHelper prefix, else None."""
    names = list(op.input_arg_names) + list(op.output_arg_names)
    for rx in _layer_rules():
        for n in names:
            m = rx.search(n)
            if m:
                return m.group(0).split('.')[0]
    for n in names:
        m = _GENERIC_LAYER.match(n)
        if m:
            return m.group(1)
    return None


# ------------------------------------------------------- replay snapshots
def want_snapshot(step):
    """The per-step gate ``Executor._run_plan`` reads ONCE per step:
    False immediately when ``FLAGS_opprof`` is off (one flag read —
    the whole disabled-path cost), else the snapshot cadence."""
    if not get_flag('FLAGS_opprof'):
        return False
    k = int(get_flag('FLAGS_opprof_snapshot_steps', 16) or 1)
    return int(step) % max(k, 1) == 0


def note_segment(program, segment, ops, state, data, step,
                 prefer_test=False, measured_s=None, device=None,
                 program_obj=None):
    """Stash a step's inputs (copies the executor made before the step
    wrote its state in place) + its measured synchronous wall for
    later eager replay on `device`.  Overwrites the previous snapshot
    for the same (program, segment) — the registry holds the LATEST
    step, not a history."""
    key = (str(program or '?'), str(segment))
    # resolve instance names BEFORE taking the lock: op_scope ->
    # _block_index acquires it on a memo miss (the mid-run flag-flip
    # path, where the segment compiled without instance naming)
    named = [(op_scope(op), op.type, layer_of(op)) for op in ops]
    with _lock:
        if key not in _SNAPSHOTS and \
                len(_SNAPSHOTS) >= _SNAPSHOTS_CAP:
            _SNAPSHOTS.pop(next(iter(_SNAPSHOTS)))
        _SNAPSHOTS[key] = {
            'ops': list(ops), 'state': dict(state), 'data': dict(data),
            'step': int(step), 'prefer_test': bool(prefer_test),
            'measured_s': (float(measured_s)
                           if measured_s is not None else None),
            'device': device, 'program': program_obj,
        }
        for inst, typ, layer in named:
            if len(_INSTANCE_OPS) >= _INSTANCE_OPS_CAP:
                _INSTANCE_OPS.clear()
            _INSTANCE_OPS[inst] = (typ, layer)
    monitor.add('opprof/snapshots')


def snapshots():
    with _lock:
        return {k: {'ops': len(v['ops']), 'step': v['step'],
                    'measured_s': v['measured_s']}
                for k, v in _SNAPSHOTS.items()}


def _replay_one(snap):
    """Replay one stashed step op by op through the executor's op
    runner, timing each op to completion (the card synchronized around
    it): per-op wall + output bytes.  Returns (ordered {instance:
    cells}, raw_total_s).

    Two passes: an untimed warmup first (the first eager run of an op
    builds its kernels and the allocator's blocks), then the timed
    walk."""
    from .executor import replay_ops
    args = (snap['ops'], snap['step'], snap['device'], snap['program'])
    for _ in replay_ops(dict(snap['data'], **snap['state']), *args):
        pass
    rows = {}
    raw_total = 0.0
    for rec in replay_ops(dict(snap['data'], **snap['state']), *args,
                          timed=True):
        op, wall, outs = rec['op'], rec['seconds'], rec['writes']
        inst = op_scope(op)
        raw_total += wall
        nbytes = 0
        for v in outs.values():
            try:
                nbytes += int(v.numel() * v.element_size())
            except Exception:
                pass
        cell = rows.get(inst)
        if cell is None:
            rows[inst] = {'type': op.type, 'layer': layer_of(op),
                          'calls': 1, 'raw_s': wall, 'max_s': wall,
                          'bytes': nbytes}
        else:
            cell['calls'] += 1
            cell['raw_s'] += wall
            cell['max_s'] = max(cell['max_s'], wall)
            cell['bytes'] += nbytes
    return rows, raw_total


def replay_all():
    """Replay every stashed snapshot and fold NORMALIZED per-instance
    costs into the registry: each segment's instance ms scale so they
    sum to its measured compiled wall (raw eager walls are kept in
    ``raw_ms`` — the normalization is visible, not hidden).  Returns
    {(program, segment) label: replayed op count}."""
    with _lock:
        pending = dict(_SNAPSHOTS)
    done = {}
    for (program, segment), snap in pending.items():
        try:
            rows, raw_total = _replay_one(snap)
        except Exception as e:
            done['%s/%s' % (program, segment)] = 'error: %s' % e
            continue
        measured = snap.get('measured_s')
        scale = ((measured / raw_total)
                 if measured and raw_total > 0 else 1.0)
        instances = {}
        for inst, c in rows.items():
            instances[inst] = {
                'type': c['type'], 'layer': c['layer'],
                'calls': c['calls'],
                'ms_per_step': round(c['raw_s'] * scale * 1e3, 6),
                'raw_ms': round(c['raw_s'] * 1e3, 6),
                'max_ms': round(c['max_s'] * 1e3, 6),
                'bytes_per_step': c['bytes'],
            }
        row = {
            'source': 'replay', 'step': snap['step'],
            'measured_ms': (round(measured * 1e3, 6)
                            if measured else None),
            'replay_raw_ms': round(raw_total * 1e3, 6),
            'normalized': bool(measured and raw_total > 0),
            'unattributed_ms': 0.0,
            'instances': instances,
        }
        _store_row(program, segment, row)
        done['%s/%s' % (program, segment)] = len(snap['ops'])
        monitor.add('opprof/replays')
    _publish_gauges()
    return done


def _store_row(program, segment, row):
    key = (str(program or '?'), str(segment))
    with _lock:
        if key not in _COSTS and len(_COSTS) >= _COSTS_CAP:
            _COSTS.pop(next(iter(_COSTS)))
        _COSTS[key] = row


def _publish_gauges():
    with _lock:
        rows = list(_COSTS.values())
    attributed = sum(c['ms_per_step'] for r in rows
                     for c in r['instances'].values())
    unattributed = sum(r.get('unattributed_ms') or 0.0 for r in rows)
    n_inst = sum(len(r['instances']) for r in rows)
    monitor.set_gauge('opprof/instances', float(n_inst))
    monitor.set_gauge('opprof/attributed_ms_total', round(attributed, 6))
    monitor.set_gauge('opprof/unattributed_ms_total',
                      round(unattributed, 6))


# ----------------------------------------------------- capture attribution
def record_capture(events, program='capture', steps=1):
    """Fold a chrome-trace capture into the registry: events carrying a
    ``tf_op`` scope path (``profiler.annotate_device_events`` writes
    them into a torch.profiler export) group by its first component
    (the program range, one group per program), each group runs
    through the per-instance attribution (split events + honest
    leftovers), totals divide by `steps` for per-step costs."""
    from . import profiler as _profiler
    groups = {}
    dropped_total = 0
    examined = 0
    for e in events:
        if not isinstance(e, dict):
            examined += 1        # attribution would count it as an
            dropped_total += 1   # examined-then-dropped event; keep
            continue             # the grouping filter just as honest
        if e.get('ph') != 'X':
            continue
        args = e.get('args') or {}
        tf_op = args.get('tf_op') if isinstance(args, dict) else None
        seg = 'device'
        if isinstance(tf_op, str) and tf_op:
            seg = tf_op.split(';', 1)[0].split(',', 1)[0] \
                       .split('/', 1)[0] or 'device'
        groups.setdefault(seg, []).append(e)
    steps = max(int(steps), 1)
    for seg, evs in sorted(groups.items()):
        recs, stats = _profiler.attribute_trace_events(
            evs, per_instance=True, with_stats=True)
        dropped_total += stats['dropped']
        instances = {}
        unattributed_s = 0.0
        for name, (calls, total_s, max_s, _min_s) in recs.items():
            if name.startswith('unattributed/'):
                unattributed_s += total_s
                continue
            typ, _idx = split_instance(name)
            known = _INSTANCE_OPS.get(name)
            instances[name] = {
                'type': typ, 'layer': known[1] if known else None,
                'calls': calls,
                'ms_per_step': round(total_s * 1e3 / steps, 6),
                'max_ms': round(max_s * 1e3, 6),
                'bytes_per_step': 0,
            }
        row = {
            'source': 'capture', 'steps': steps,
            'events': stats['events'], 'dropped': stats['dropped'],
            'unattributed_ms': round(unattributed_s * 1e3 / steps, 6),
            'instances': instances,
        }
        _store_row(program, seg, row)
        examined += stats['events']
    if examined:
        monitor.add('opprof/capture_events', float(examined))
    if dropped_total:
        monitor.add('opprof/dropped_events', float(dropped_total))
    _publish_gauges()
    return {'segments': len(groups), 'dropped': dropped_total}


# ------------------------------------------------------------- rollups
def _all_rows():
    with _lock:
        return {k: {kk: (dict(vv) if kk == 'instances' else vv)
                    for kk, vv in r.items()}
                for k, r in _COSTS.items()}


def rollup_by_type():
    """{op type: {'ms_per_step', 'calls', 'bytes_per_step'}} across
    every registry row."""
    out = {}
    for row in _all_rows().values():
        for cell in row['instances'].values():
            agg = out.setdefault(cell['type'],
                                 {'ms_per_step': 0.0, 'calls': 0,
                                  'bytes_per_step': 0})
            agg['ms_per_step'] = round(
                agg['ms_per_step'] + cell['ms_per_step'], 6)
            agg['calls'] += cell['calls']
            agg['bytes_per_step'] += cell.get('bytes_per_step', 0)
    return out


def rollup_by_layer():
    """{layer label: ms_per_step}; instances with no resolvable layer
    land under '(no layer)'."""
    out = {}
    for row in _all_rows().values():
        for inst, cell in row['instances'].items():
            layer = cell.get('layer')
            if layer is None:
                known = _INSTANCE_OPS.get(inst)
                layer = known[1] if known else None
            layer = layer or '(no layer)'
            out[layer] = round(out.get(layer, 0.0) +
                               cell['ms_per_step'], 6)
    return out


def report(limit=TOP_K):
    """The ``/statusz op_costs`` section: top-K instances by
    attributable ms/step, rollups, and per-segment source/agreement
    metadata.  JSON-able by construction."""
    rows = _all_rows()
    flat = []
    for (program, segment), row in rows.items():
        for inst, cell in row['instances'].items():
            flat.append(dict(cell, instance=inst, program=program,
                             segment=segment, source=row['source']))
    flat.sort(key=lambda c: (-c['ms_per_step'], c['instance']))
    total = sum(c['ms_per_step'] for c in flat)
    for c in flat:
        c['share_pct'] = round(100.0 * c['ms_per_step'] / total, 2) \
            if total > 0 else 0.0
    segments = []
    for (program, segment), row in rows.items():
        segments.append({
            'program': program, 'segment': segment,
            'source': row['source'],
            'instances': len(row['instances']),
            'attributed_ms': round(sum(
                c['ms_per_step']
                for c in row['instances'].values()), 6),
            'unattributed_ms': row.get('unattributed_ms', 0.0),
            'measured_ms': row.get('measured_ms'),
        })
    return {
        'enabled': enabled(),
        'top': flat[:max(int(limit), 1)],
        'segments': segments,
        'by_type': rollup_by_type(),
        'by_layer': rollup_by_layer(),
        'unattributed_ms': round(sum(
            r.get('unattributed_ms') or 0.0 for r in rows.values()), 6),
        'snapshots': len(_SNAPSHOTS),
    }


# ------------------------------------------------------------ worklist
def kernel_worklist(limit=TOP_K):
    """Rank contiguous same-segment op runs by attributable ms/step
    (tie: bytes moved, then name — deterministic).  A run is a maximal
    sequence of same-type instances adjacent in their segment's op
    order — the shape the existing fused multi-tensor kernels consume
    (a run of ``sgd`` ops -> one fused launch).  Each run
    cross-references the kernel registry's declared ``op_types``
    coverage: ``covered_by`` names the hand-written kernel that already
    serves it (worklist readers skip those, or read them as validation
    that the ranking finds the kernels we already built)."""
    try:
        from ..ops.kernels import common as _kernels
    except Exception:
        _kernels = None
    runs = []
    for (program, segment), row in _all_rows().items():
        ordered = list(row['instances'].items())
        # order instances by block index where present (capture rows
        # iterate in attribution order; replay rows are already in
        # segment op order — indices make both deterministic)
        ordered.sort(key=lambda kv: (
            split_instance(kv[0])[1]
            if split_instance(kv[0])[1] is not None else 1 << 30))
        i = 0
        while i < len(ordered):
            j = i
            typ = ordered[i][1]['type']
            while j + 1 < len(ordered) and \
                    ordered[j + 1][1]['type'] == typ:
                nxt = split_instance(ordered[j + 1][0])[1]
                cur = split_instance(ordered[j][0])[1]
                if nxt is not None and cur is not None and \
                        nxt != cur + 1:
                    break   # same type but not contiguous in the block
                j += 1
            members = ordered[i:j + 1]
            ms = round(sum(c['ms_per_step'] for _, c in members), 6)
            nbytes = sum(c.get('bytes_per_step', 0)
                         for _, c in members)
            covered = None
            if _kernels is not None:
                try:
                    covered = _kernels.covering_kernel([typ])
                except Exception:
                    covered = None
            span = [split_instance(members[0][0])[1],
                    split_instance(members[-1][0])[1]]
            runs.append({
                'program': program, 'segment': segment,
                'op_type': typ,
                'ops': [m[0] for m in members],
                'span': span,
                'ms_per_step': ms,
                'bytes_per_step': nbytes,
                'source': row['source'],
                'covered_by': covered,
            })
            i = j + 1
    runs.sort(key=lambda r: (-r['ms_per_step'], -r['bytes_per_step'],
                             r['segment'], r['op_type'],
                             str(r['ops'])))
    runs = runs[:max(int(limit), 1)]
    for rank, r in enumerate(runs, 1):
        r['rank'] = rank
    monitor.set_gauge('opprof/worklist_candidates', float(len(runs)))
    return runs


def write_worklist(path='op_worklist.json', limit=TOP_K):
    """Emit the ranked worklist artifact (the candidates for the next
    hand-written kernels)."""
    doc = {
        'version': 1,
        'generated_by': 'fluid.opprof',
        'candidates': kernel_worklist(limit),
        'by_type': rollup_by_type(),
        'by_layer': rollup_by_layer(),
        'segments': report(limit)['segments'],
    }
    with open(path, 'w') as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    return path


def http_report(replay=True, limit=TOP_K):
    """The ``/opprof`` endpoint body: replay whatever is stashed, then
    the full report + worklist."""
    out = {}
    if replay:
        try:
            out['replayed'] = replay_all()
        except Exception as e:   # a broken replay must not 500 the
            out['replay_error'] = str(e)     # whole report
    out['report'] = report(limit)
    out['worklist'] = kernel_worklist(limit)
    return out
