"""Multi-tensor Adam / AdamW and LAMB: the hand-written CUDA kernels
(csrc/fused_adam.cu, csrc/fused_lamb.cu) and their plain PyTorch
version.

The executor's run grouping (fluid/executor.py ``_fused_opt_run``)
hands a contiguous run of same-hyperparameter adam, adamw or lamb ops
to the ``fused_adam`` / ``fused_adamw`` / ``fused_lamb`` op: every
input slot carries the run's tensors aligned by index.  On CUDA tensors
the run's kernel updates every parameter and both moments in place (the
outputs are the input tensors); the plain version is the per-tensor
lowering in run order, the ungrouped program.  Per-tensor learning
rates and beta powers are read on the device, so tensors with different
schedules still fuse; beta1, beta2, epsilon, the AdamW decay and the
LAMB weight decay are the run's.  LAMB's per-tensor trust ratio
||p|| / ||r|| is summed from per-block partials in a fixed order, so it
is the same on every run.
"""

import ctypes
import os

import numpy as np
import torch

from . import common

SOURCE = 'fused_adam.cu'

common.register_kernel(
    'fused_adam',
    source=SOURCE,
    plain='ops.optimizer_ops.adam / adamw per tensor, in run order',
    replaces='paddle_tpu/ops/pallas/fused_optimizer.py:97 _adam_kernel',
    doc='one launch over a device table of tensor pointers; in place, '
        'no pack/unpack copies',
    op_types=('fused_adam', 'fused_adamw'))


LAMB_SOURCE = 'fused_lamb.cu'

common.register_kernel(
    'fused_lamb',
    source=LAMB_SOURCE,
    plain='ops.optimizer_ops.lamb per tensor, in run order',
    replaces='paddle_tpu/ops/pallas/fused_optimizer.py:118 _lamb1_kernel '
             '+ :139 _lamb2_kernel',
    doc='three kernels over the device table: moments and per-block '
        'partial norms, per-tensor trust by a fixed-order warp sum, the '
        'parameter update; in place',
    op_types=('fused_lamb',))


def _hyper(kind, attrs):
    """(beta1, beta2, epsilon, decay): the AdamW coeff or the LAMB
    weight_decay, 0 for Adam."""
    decay = {'adam': 0.0,
             'adamw': float(attrs.get('coeff', 0.01)),
             'lamb': float(attrs.get('weight_decay', 0.01))}[kind]
    return (float(attrs.get('beta1', 0.9)), float(attrs.get('beta2', 0.999)),
            float(attrs.get('epsilon', 1e-6 if kind == 'lamb' else 1e-8)),
            decay)


def pow_outputs(ins, attrs):
    """Beta1PowOut / Beta2PowOut as the JAX ``apply`` gives them: each
    tensor's beta power times beta.  A power shared by the run is
    multiplied once."""
    out = {}
    for slot, beta in (('Beta1Pow', float(attrs.get('beta1', 0.9))),
                       ('Beta2Pow', float(attrs.get('beta2', 0.999)))):
        done = {}
        row = []
        for x in ins[slot]:
            if id(x) not in done:
                done[id(x)] = x * beta
            row.append(done[id(x)])
        out[slot + 'Out'] = row
    return out


def apply_plain(kind, ctx, ins, attrs):
    """The per-tensor adam / adamw / lamb lowerings looped in run
    order."""
    from .. import optimizer_ops
    fn = {'adam': optimizer_ops.adam, 'adamw': optimizer_ops.adamw,
          'lamb': optimizer_ops.lamb}[kind]
    outs = {}
    for i in range(len(ins['Param'])):
        one = {slot: [vals[i]] for slot, vals in ins.items() if vals}
        for slot, vals in fn(ctx, one, attrs).items():
            outs.setdefault(slot, []).append(vals[0])
    return outs


def _check(ins):
    n = len(ins['Param'])
    dev = ins['Param'][0].device
    for slot in ('Param', 'Grad', 'Moment1', 'Moment2', 'LearningRate',
                 'Beta1Pow', 'Beta2Pow'):
        xs = ins[slot]
        if len(xs) != n:
            raise ValueError('fused optimizer: slot %s holds %d tensors, '
                             'Param %d' % (slot, len(xs), n))
        for x in xs:
            if x.dtype != torch.float32 or x.device != dev:
                raise TypeError('the fused optimizer kernels take f32 '
                                'tensors on one device; %s has %s on %s'
                                % (slot, x.dtype, x.device))
            if not x.is_contiguous():
                raise ValueError('fused optimizer: %s tensor is not '
                                 'contiguous' % slot)
    for i in range(n):
        numel = ins['Param'][i].numel()
        for slot in ('Grad', 'Moment1', 'Moment2'):
            if ins[slot][i].numel() != numel:
                raise ValueError('fused optimizer: tensor %d of %s has %d '
                                 'elements, its Param %d'
                                 % (i, slot, ins[slot][i].numel(), numel))
        for slot in ('LearningRate', 'Beta1Pow', 'Beta2Pow'):
            if ins[slot][i].numel() != 1:
                raise ValueError('fused optimizer: %s must hold one value'
                                 % slot)


def device_table(ins, source=SOURCE):
    """(table, blocks): the [n, 10] int64 table of the run's tensor
    pointers and sizes that the kernels of `source` read, on the run's
    device, and the number of blocks one pass over the run takes."""
    _check(ins)
    lib = common.library(source)
    chunk_fn = getattr(lib, os.path.splitext(source)[0] + '_chunk')
    chunk_fn.restype = ctypes.c_longlong
    chunk = int(chunk_fn())
    n = len(ins['Param'])
    table = np.zeros((n, 10), dtype=np.int64)
    first = 0
    for i in range(n):
        numel = ins['Param'][i].numel()
        table[i, :7] = [ins[slot][i].data_ptr() for slot in (
            'Param', 'Grad', 'Moment1', 'Moment2', 'LearningRate',
            'Beta1Pow', 'Beta2Pow')]
        table[i, 7] = numel
        table[i, 8] = first
        first += -(-numel // chunk)
    # pinned, so the upload is queued on the stream without a host sync
    table = torch.from_numpy(table).pin_memory().to(ins['Param'][0].device,
                                                    non_blocking=True)
    return table, first


def launch(kind, table, blocks, attrs):
    """One launch of the Adam / AdamW kernel over a device_table:
    updates the tensors it points at in place."""
    beta1, beta2, epsilon, coeff = _hyper(kind, attrs)
    lib = common.library(SOURCE)
    fn = lib.fused_adam_update
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong] + [
        ctypes.c_float] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = table.device
    with torch.cuda.device(dev):
        err = fn(table.data_ptr(), table.shape[0], blocks, beta1, beta2,
                 1.0 - beta1, 1.0 - beta2, epsilon, coeff,
                 common.stream_ptr(dev))
    common.check_launch('fused_adam', lib, err)


def launch_lamb(table, blocks, attrs):
    """One LAMB update over a device_table of fused_lamb.cu (its three
    kernels on the stream): parameters and moments in place."""
    beta1, beta2, epsilon, decay = _hyper('lamb', attrs)
    dev = table.device
    # per-block partial sums of p^2 and r^2, per-tensor trust ratios
    partial = torch.empty((blocks, 2), dtype=torch.float32, device=dev)
    trust = torch.empty((table.shape[0],), dtype=torch.float32, device=dev)
    lib = common.library(LAMB_SOURCE)
    fn = lib.fused_lamb_update
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong] + [
        ctypes.c_float] * 6 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(table.data_ptr(), table.shape[0], blocks, beta1, beta2,
                 1.0 - beta1, 1.0 - beta2, epsilon, decay,
                 partial.data_ptr(), trust.data_ptr(),
                 common.stream_ptr(dev))
    common.check_launch('fused_lamb', lib, err)


def apply_kernel(kind, ins, attrs):
    """The CUDA kernel over the run: Param, Moment1 and Moment2 are
    updated in place and returned as ParamOut, Moment1Out, Moment2Out
    (the same tensors)."""
    if kind == 'lamb':
        table, blocks = device_table(ins, LAMB_SOURCE)
        launch_lamb(table, blocks, attrs)
    else:
        table, blocks = device_table(ins)
        launch(kind, table, blocks, attrs)
    return {'ParamOut': list(ins['Param']),
            'Moment1Out': list(ins['Moment1']),
            'Moment2Out': list(ins['Moment2'])}


def apply(kind, ctx, ins, attrs):
    """Multi-tensor ``kind`` in {'adam', 'adamw', 'lamb'} over the
    aligned slots of ``ins``; returns the per-op output slots, each
    with one entry per tensor, Beta1PowOut / Beta2PowOut included."""
    flat = [x for slot in ('Param', 'Grad', 'Moment1', 'Moment2')
            for x in ins[slot]]
    if common.use_kernel(*flat):
        outs = apply_kernel(kind, ins, attrs)
    else:
        outs = apply_plain(kind, ctx, ins, attrs)
    outs.update(pow_outputs(ins, attrs))
    return outs
