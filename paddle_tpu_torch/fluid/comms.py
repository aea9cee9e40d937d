"""Collective accounting: the ring-algorithm wire formula and the count
of planned collectives each arm ran.

Reference: the JAX package's fluid/comms.py (``wire_bytes`` :122, and
the ``comms/plan_arm/<arm>`` counters that ``account_dispatch`` keeps).
The port counts an arm where the lowering runs it (ops/collective_ops.py
``_planned_allreduce``), once per collective per step.  The trace
records, the per-dispatch accounting and the cost-model fit are not
ported (ROADMAP Queue 1 item 12).
"""

ARMS = ('dense', 'rs_ag', 'quant')

_arm_counts = dict.fromkeys(ARMS, 0)


def wire_bytes(kind, payload_bytes, participants):
    """Ring-algorithm bytes each participant moves over the wire for a
    collective with `payload_bytes` per participant: allreduce rings
    send 2(n-1)/n of the payload, reduce-scatter / all-to-all /
    broadcast (n-1)/n, allgather receives the other n-1 shards.  n=1
    moves nothing (the reference's nranks==1 identity)."""
    n = max(1, int(participants))
    p = float(payload_bytes)
    if n == 1:
        return 0.0
    if kind == 'allreduce':
        return 2.0 * (n - 1) / n * p
    if kind == 'allgather':
        return (n - 1) * p
    return (n - 1) / n * p


def count_arm(arm):
    """One planned collective ran on `arm` ('dense', 'rs_ag' or
    'quant')."""
    _arm_counts[arm] += 1


def arm_counts():
    """{arm: planned collectives run} since the last reset."""
    return dict(_arm_counts)


def reset():
    for arm in ARMS:
        _arm_counts[arm] = 0
