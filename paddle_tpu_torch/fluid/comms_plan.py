"""Collective planner, the decision half: which arm reduces a gradient
(or a fused bucket of gradients), and how the gradients bucket.

Reference: the JAX package's fluid/comms_plan.py (``decide`` :466,
``quant_wire_bytes`` :400, ``bucket_cap_bytes`` :451,
``fuse_cutoff_bytes`` :542, ``bucket_grads`` :567, ``verify_buckets``
:602, ``order_axes`` :646).  Three arms:

- **dense / flat**: one all-reduce.
- **dense / rs_ag**: reduce-scatter + all-gather, for payloads of at
  least ``FLAGS_comms_rs_ag_min_bytes``.
- **quant**: the block-scaled int8 all-reduce (K8,
  ops/kernels/quant_collective.py), under ``FLAGS_comms_quantize`` for
  payloads of at least ``FLAGS_comms_quantize_min_bytes`` of a dtype
  wider than one byte, with more than one participant.

The calibrated cost model and the HBM-budget gate are not ported
(ROADMAP Queue 1 item 12): ``predicted_s`` is None, as in the JAX
package without a model, and setting ``FLAGS_comms_model_path`` or
``FLAGS_comms_hbm_budget_bytes`` raises.
"""

from . import comms
from .flags import get_flag

__all__ = ['decide', 'bucket_grads', 'fuse_cutoff_bytes', 'quant_wire_bytes',
           'order_axes', 'bucket_cap_bytes', 'quant_block', 'quant_hbm_temp',
           'verify_buckets', 'record_program_plan', 'program_plans',
           'reset']

# the quantized arm's device temporaries beside the payload: the int8
# shards and the scales on each side of the wire (the kernels keep no
# f32 copy of the payload)
_QUANT_MEM_FACTOR = 0.75
_PLANS = {}
_PLANS_CAP = 64
_plan_seq = [0]


def _unported_gates():
    """Raise where a flag asks for a gate the port does not have."""
    if get_flag('FLAGS_comms_model_path', ''):
        raise NotImplementedError(
            'FLAGS_comms_model_path: the comms cost model is not ported '
            '(ROADMAP Queue 1 item 12, "comms records and the cost model")')
    if float(get_flag('FLAGS_comms_hbm_budget_bytes', 0) or 0) > 0:
        raise NotImplementedError(
            'FLAGS_comms_hbm_budget_bytes: the HBM-budget gate over '
            "memviz's per-program peak is not ported (ROADMAP Queue 1 "
            'item 12, "the HBM-budget gate")')


def reset():
    """Drop the plan registry (tests)."""
    _PLANS.clear()
    _plan_seq[0] = 0


def quant_block():
    return max(8, int(get_flag('FLAGS_comms_quant_block', 256)))


def quant_hbm_temp(payload_bytes):
    """Device bytes of the quantized arm's temporaries for one payload:
    the int8 shards and scales on each side of the wire."""
    return _QUANT_MEM_FACTOR * float(payload_bytes)


def quant_wire_bytes(payload_bytes, itemsize, participants, block=None):
    """Bytes each participant moves over the wire for the quantized
    arm: int8 payload + per-block fp32 scales through both phases, the
    (n-1)/n all_to_all share plus (n-1) reduced chunks gathered.  For
    fp32 this is ~dense/4 * (1 + 4/block)."""
    n = max(1, int(participants))
    if n == 1:
        return 0.0
    block = int(block or quant_block())
    itemsize = max(1, int(itemsize))
    elems = float(payload_bytes) / itemsize
    q_bytes = elems * (1.0 + 4.0 / block)
    rs = (n - 1.0) / n * q_bytes
    ag = (n - 1.0) * (q_bytes / n)
    return rs + ag


def bucket_cap_bytes():
    """The fused-bucket byte target (FLAGS_comms_bucket_bytes; 0 turns
    fusion off)."""
    _unported_gates()
    cap = float(get_flag('FLAGS_comms_bucket_bytes', 4 << 20) or 0)
    return max(cap, 0.0)


def decide(payload_bytes, itemsize, participants, forced_arm=None):
    """The reduction of one tensor or fused bucket: {'arm': 'dense' |
    'quant', 'strategy': 'flat' | 'rs_ag', 'block', 'wire_bytes',
    'dense_wire_bytes', 'predicted_s' (None: no cost model)}.
    `forced_arm` bypasses the gates: 'quant' forces the quantized arm,
    'dense' the flat dense one."""
    _unported_gates()
    n = max(1, int(participants))
    payload = float(payload_bytes)
    itemsize = max(1, int(itemsize))
    dense_wire = comms.wire_bytes('allreduce', payload, n)
    block = quant_block()
    out = {'arm': 'dense', 'strategy': 'flat', 'block': block,
           'wire_bytes': dense_wire, 'dense_wire_bytes': dense_wire,
           'predicted_s': None}
    if n == 1 or payload <= 0:
        return out
    want_quant = forced_arm == 'quant' or (
        forced_arm is None and
        bool(get_flag('FLAGS_comms_quantize', False)) and
        payload >= float(get_flag('FLAGS_comms_quantize_min_bytes', 65536)))
    if want_quant and itemsize > 1:
        out.update(arm='quant',
                   wire_bytes=quant_wire_bytes(payload, itemsize, n, block))
        return out
    if forced_arm == 'dense':
        return out
    if payload >= float(get_flag('FLAGS_comms_rs_ag_min_bytes', 8 << 20)):
        out.update(strategy='rs_ag')
    return out


def fuse_cutoff_bytes(cap=None):
    """Gradients of at least this payload reduce alone: fusing a
    bandwidth-bound gradient saves no latency and pays the concat and
    split.  FLAGS_comms_fuse_grad_max_bytes, at most the bucket cap."""
    cap = bucket_cap_bytes() if cap is None else float(cap)
    return min(float(get_flag('FLAGS_comms_fuse_grad_max_bytes', 64 << 10)),
               cap)


def bucket_grads(grads, cap_bytes=None, fuse_cutoff=None):
    """Coalesce gradients into fused reduction buckets.  `grads` is an
    ordered [(name, nbytes, dtype_str)]; a gradient below the fuse
    cutoff joins the most recent open bucket of its dtype (an earlier
    dtype's bucket stays open for its later gradients) until the
    bucket would pass the byte cap.  Gradients of unknown size
    (nbytes <= 0) or at least the cutoff stand alone.  Returns
    [{'names': [...], 'bytes': total, 'dtype': dt}] in first-appearance
    order."""
    cap = bucket_cap_bytes() if cap_bytes is None else float(cap_bytes)
    cutoff = fuse_cutoff_bytes(cap) if fuse_cutoff is None \
        else float(fuse_cutoff)
    buckets = []
    open_by_dtype = {}
    for name, nbytes, dtype in grads:
        nbytes = float(nbytes or 0)
        if cap <= 0 or nbytes <= 0 or nbytes >= min(cap, cutoff):
            buckets.append({'names': [name], 'bytes': max(nbytes, 0.0),
                            'dtype': dtype})
            continue
        cur = open_by_dtype.get(dtype)
        if cur is not None and cur['bytes'] + nbytes <= cap:
            cur['names'].append(name)
            cur['bytes'] += nbytes
        else:
            cur = {'names': [name], 'bytes': nbytes, 'dtype': dtype}
            buckets.append(cur)
            open_by_dtype[dtype] = cur
    return buckets


def verify_buckets(block, buckets):
    """Legality of a bucket rewrite before the collective ops land:
    every bucketed gradient is a declared variable, a fused bucket's
    gradients share its dtype, and no gradient is in two buckets.  The
    findings are recorded as a fluid.progcheck report (its counters and
    /statusz trail, JAX: fluid/comms_plan.py:602); a defect raises
    ValueError naming every one.  Returns `buckets`."""
    import time
    from . import progcheck
    t0 = time.perf_counter()
    rep = progcheck.Report('comms_plan', 'transpile:bucket')
    defects = []

    def defect(cls, msg, name):
        defects.append(msg)
        rep.add(progcheck.Diagnostic(cls, msg, var=name))

    seen = {}
    for bi, b in enumerate(buckets):
        for name in b['names']:
            if name in seen:
                defect('shard_conflict',
                       'grad %r appears in buckets %d and %d: it would '
                       'reduce twice' % (name, seen[name], bi), name)
            seen[name] = bi
            v = block._find_var_recursive(name)
            if v is None:
                defect('undefined_read', 'bucket %d names grad %r which no '
                       'block declares' % (bi, name), name)
                continue
            if len(b['names']) > 1 and v.dtype != b['dtype']:
                defect('dtype_mismatch',
                       'grad %r is %s but joined a %s fused bucket: the '
                       'concat would cast it' % (name, v.dtype, b['dtype']),
                       name)
    rep.ops_checked = len(buckets)
    rep.seconds = time.perf_counter() - t0
    progcheck._record(rep)
    if defects:
        raise ValueError('comms_plan bucket rewrite: ' + '; '.join(defects))
    return buckets


def order_axes(axes):
    """Reduction order of a multi-ring reduce: `axes` is [(name,
    size)]; largest first, ties by name."""
    return [name for name, _ in
            sorted(axes, key=lambda a: (-int(a[1]), a[0]))]


def record_program_plan(summary, label=None):
    """Keep one transpiled program's plan (bounded, insertion-ordered);
    returns its label."""
    if label is None:
        _plan_seq[0] += 1
        label = 'program_%d' % _plan_seq[0]
    if label not in _PLANS and len(_PLANS) >= _PLANS_CAP:
        _PLANS.pop(next(iter(_PLANS)))
    _PLANS[label] = summary
    return label


def program_plans():
    """{'programs': {label: plan}, 'arm_counters': {arm: count}}."""
    return {'programs': dict(_PLANS), 'arm_counters': comms.arm_counts()}
