"""Collective program rewrites.

Reference: python/paddle/fluid/transpiler/collective.py — Collective
(:36), GradAllReduce (:178), LocalSGD (:270), SingleProcessMultiThread
(:377); the JAX package's fluid/transpiler/collective.py.  The rewritten
program serializes op for op like the JAX package's; its collectives
reduce over the rank's ``torch.distributed`` group
(ops/collective_ops.py), one process per rank.
"""

import numpy as np


def _var_nbytes(block, name):
    """Static (nbytes, dtype_name) of a block var from its declared
    shape; -1 dims count as 1, unknown shapes 0 bytes."""
    v = block._find_var_recursive(name)
    shape = tuple(getattr(v, 'shape', ()) or ()) if v is not None else ()
    try:
        dt = np.dtype(v.dtype)
    except Exception:
        dt = np.dtype('float32')
    if not shape:
        return 0, dt.name
    elems = 1
    for d in shape:
        elems *= max(int(d), 1)
    return elems * dt.itemsize, dt.name


class Collective(object):
    def __init__(self, nrings=1):
        self.nrings = nrings
        self.endpoints = None
        self.current_endpoint = None
        self.nranks = None
        self.rank = None

    def transpile(self, startup_program, main_program, rank, endpoints,
                  current_endpoint, wait_port=True):
        """Rewrite `main_program` for data-parallel training over the
        job's ranks: nranks is the larger of the endpoint count and the
        process group's size.  With more than one endpoint and no group
        yet, the rank joins the launcher's group first
        (distributed.init_distributed)."""
        from ...distributed import launch
        self.startup_program = startup_program
        self.main_program = main_program
        self.rank = rank
        self.current_endpoint = current_endpoint
        self.endpoints = endpoints if isinstance(endpoints, list) else \
            endpoints.split(',')
        if len(self.endpoints) > 1:
            launch.init_distributed()
        self.nranks = max(len(self.endpoints), launch.world_size())
        from .. import monitor, progcheck
        monitor.add('collective/transpile_calls')
        self._transpile_main_program()
        main_program._collective_dp = True
        main_program._bump_version()
        # forced static verification of the rewrite (JAX:
        # fluid/transpiler/collective.py:64): a collective insertion
        # that dangles a grad name fails here, named
        progcheck.verify_program(
            main_program, origin='transpile:%s' % type(self).__name__,
            level='full' if progcheck.enabled() else 'fast')

    def _transpile_main_program(self):
        raise NotImplementedError


class GradAllReduce(Collective):
    """Reference collective.py:178: an all-reduce and a 1/nranks scale
    of every parameter gradient after the backward.

    With FLAGS_comms_plan (the default) the gradients are bucketed
    (fluid.comms_plan.bucket_grads) and each bucket gets one planned
    collective (``c_allreduce_sum`` for one gradient,
    ``c_allreduce_fused`` for several, ``plan`` set), whose arm the
    lowering picks at run time from the payload and the group's size;
    then the scale of each gradient.  FLAGS_comms_plan off gives the
    v1.6 rewrite: one c_allreduce_sum and one scale per gradient."""

    def _transpile_main_program(self):
        from .. import comms_plan
        from ..flags import get_flag
        block = self.main_program.global_block()
        grad_names = []
        for op in block.ops:
            if op.type in ('sgd', 'momentum', 'adam', 'adamw', 'lamb',
                           'adagrad', 'rmsprop', 'lars_momentum'):
                grad_names.extend(op.input('Grad'))
        # after the last grad or sum op, as the JAX package inserts
        insert_at = None
        for i, op in enumerate(block.ops):
            if op.type.endswith('_grad') or op.type == 'sum':
                insert_at = i + 1
        if insert_at is None:
            insert_at = len(block.ops)
        uniq = list(dict.fromkeys(grad_names))
        if not get_flag('FLAGS_comms_plan', True):
            for g in uniq:
                block._insert_op(insert_at, 'c_allreduce_sum',
                                 inputs={'X': g}, outputs={'Out': g},
                                 attrs={'ring_id': 0})
                block._insert_op(insert_at + 1, 'scale',
                                 inputs={'X': g}, outputs={'Out': g},
                                 attrs={'scale': 1.0 / self.nranks})
                insert_at += 2
            return

        grads = [(g,) + _var_nbytes(block, g) for g in uniq]
        buckets = comms_plan.verify_buckets(block,
                                            comms_plan.bucket_grads(grads))
        summary = {'nranks': self.nranks, 'grads': len(uniq), 'buckets': []}
        for b in buckets:
            names = b['names']
            if len(names) == 1:
                block._insert_op(insert_at, 'c_allreduce_sum',
                                 inputs={'X': names[0]},
                                 outputs={'Out': names[0]},
                                 attrs={'ring_id': 0, 'plan': True})
            else:
                block._insert_op(insert_at, 'c_allreduce_fused',
                                 inputs={'X': list(names)},
                                 outputs={'Out': list(names)},
                                 attrs={'ring_id': 0, 'plan': True})
            insert_at += 1
            for g in names:
                block._insert_op(insert_at, 'scale', inputs={'X': g},
                                 outputs={'Out': g},
                                 attrs={'scale': 1.0 / self.nranks})
                insert_at += 1
            # a preview: the lowering decides again at run time, from
            # the group's actual size
            try:
                itemsize = np.dtype(b['dtype']).itemsize
            except Exception:
                itemsize = 4
            decision = comms_plan.decide(b['bytes'], itemsize, self.nranks)
            summary['buckets'].append({
                'grads': len(names), 'bytes': b['bytes'],
                'dtype': b['dtype'], 'arm_preview': decision['arm'],
                'strategy_preview': decision['strategy'],
                'names': names[:8]})
        comms_plan.record_program_plan(summary)


class LocalSGD(Collective):
    """Reference collective.py:270: train locally, average the
    parameters every `steps` runs.  Not ported: its multi-process
    rendering averages on the host through
    distributed.collective_utils.process_mean."""

    def __init__(self, nrings=1, steps=4):
        super(LocalSGD, self).__init__(nrings)
        self.steps = steps

    def transpile(self, *args, **kwargs):
        raise NotImplementedError(
            'LocalSGD is not ported: it needs collective_utils.process_mean '
            '(ROADMAP Queue 1 item 12, "LocalSGD and collective_utils")')


class SingleProcessMultiThread(GradAllReduce):
    """Reference collective.py:377: GradAllReduce (one process per rank
    here, as every mode is in the JAX package one SPMD program)."""
