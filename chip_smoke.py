#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--profile]

The Programs' random seed is N + 1 (fluid reads 0 as unseeded), so a
run's weights, batches and dropout masks are a function of N.

Phases, each of which fails the run (non-zero exit) on error:
  1. environment: torch/CUDA versions, the card's name and power limit;
  2. build: every CUDA kernel from paddle_tpu_torch/ops/kernels/csrc,
     one nvcc per source, all started together;
  3. kernel parity on the card, each kernel against its plain PyTorch
     version on the same inputs (TF32 off):
       flash_attention at the BERT-base shape B=8 H=12 T=512 D=64 f32
       with a 0/-10000 padding bias, a ragged T=200 case and a causal
       case (O and lse, atol 1e-4: f32 sums over up to 512 keys in
       another order); with attention dropout 0.1 at B=8 H=12 T=512 and
       at a ragged T=300 (O and lse, atol 1e-4), and its keep mask
       read back from the kernel bitwise against the plain hash;
       flash_attention_bwd (dQ, dK, dV, and the key-bias cotangent in
       two cases) against autograd of the plain forward with the same
       mask, max|diff| <= 1e-4 * max(1, max|plain|);
       embedding_lookup on a 30522 x 768 table with 4096 ids,
       duplicates and out-of-range ids included (bitwise);
       embedding_scatter_add on the 30522 x 768, 512 x 768 and 2 x 768
       tables with 4096 ids each, all of them on row 0 of the 2-row
       table (bitwise);
       fused_adam over the 153 parameters of BERT-base pretraining
       (~132M f32 elements) and an AdamW run: parameters and moments
       bitwise (the library is built with --fmad=false, so it rounds
       every operation as the plain version's separate kernels do);
       fused_lamb over the same 153 tensors plus a zero-gradient tensor
       without decay and a [1] tensor: moments bitwise, parameters to
       rtol 2e-6 / atol 3e-7 (the trust ratio's norms are summed in
       another order), and a second launch from the same state gives
       the same parameters bit for bit (fixed-order sums, no atomics);
       embedding_update (the sparse Adagrad rows) through the
       fused_emb_update op on the 1000001 x 16 table with 106,496
       uniform ids, on the 1000 x 16 table with the same ids (~106
       visits a row) and on a 1000001 x 1 table, padding_idx and
       out-of-range ids included (bitwise);
  4. serving: BERT-base (12 layers, hidden 768, seq 512, random weights
     from --seed) built with the port's layers, saved with
     save_inference_model, loaded by create_paddle_predictor on
     CUDAPlace(0), answering 3 requests of batch 1, 3 and 8 (buckets 1,
     4, 8).  Each request must launch flash_attention 12 times and
     embedding_lookup 3 times; outputs are finite [b, 512, 768]; the
     batch-8 answer matches the same predictor run with the plain
     versions (FLAGS_torch_kernels_plain) to max-abs 1e-3;
  5. training: BERT-base pretraining (build_pretrain(BASE, 512), MLM +
     NSP heads, hidden and attention dropout 0.1) with
     fluid.optimizer.Adam(1e-6, epsilon 1e-6).minimize on
     CUDAPlace(0): the startup program, then 3 steps of batch 8 on one
     repeated synthetic_batch.  Each step must launch flash_attention
     (with dropout) 12 times, flash_attention_bwd 12, embedding_lookup
     3, embedding_scatter_add 3 and fused_adam once; the loss is finite
     and falls from step 1 to step 3, and at step 3 it is below the loss
     the same 3 steps give with the parameters held (each step from the
     starting state: the same dropout masks, so the difference is what
     the updates learned).  Step 1 again from the same state
     with the plain versions gives the same loss (rel. 1e-4) and
     gradients, first moments and parameters within the limits printed;
     peak device memory is printed;
  6. LAMB pretraining: the same model with
     lr = linear_lr_warmup(polynomial_decay(4e-5, 1000, 0.0), 2, 0.0,
     4e-5) and fluid.optimizer.Lamb(lr, lamb_weight_decay
     0.01, epsilon 1e-6, grad_clip=GradientClipByGlobalNorm(1.0)), 3
     steps of batch 8: each step launches flash_attention 12 times,
     flash_attention_bwd 12, embedding_lookup 3, embedding_scatter_add
     3, fused_lamb once (one run over all 153 parameters) and fused_adam
     never; the rate of each step is printed; the loss checks of phase
     5; step 1 (rate 0) against the plain path as in phase 5;
  7. Wide&Deep CTR training: models.wide_deep.build at BASE widths with
     the hashed Criteo feature space (sparse_feature_dim 1000001:
     embedding 16, 26 sparse and 13 dense fields, hidden 400-400-400)
     and fluid.optimizer.Adagrad(1e-3, epsilon 1e-6), 3 steps of batch
     4096 (106,496 ids a step): each step launches embedding_lookup 2
     times and embedding_update 2 (the deep and the wide table's rows)
     and nothing else; the loss falls below the held run's; step 1
     again with the plain versions gives the same loss and state bit
     for bit (the same PyTorch ops around kernels that are bitwise
     their plain versions);
  8. timings: each kernel, its plain version and the PyTorch library
     call at the main path's shapes (device time of CUDA-graph replays,
     L2 flushed before each call; a plain version that syncs with the
     host is timed with CUDA events around single calls instead), the
     least time the card could take (bound), K6b also on the 2-row
     sentence table, K7 also on the 1000 x 16 and the 1000001 x 1
     tables, the request latency per batch size and the median step of
     each training path.  The library call for the flash backward is
     SDPA's memory-efficient backward op on its own forward's saved
     outputs; for the row update, torch.optim.Adagrad's step on a
     sparse gradient; PyTorch has no LAMB (null).
The line before the last is a JSON object {"kernels": [...]}; the last
is {"ok": true, "device": {...}}.  --profile adds a torch.profiler
breakdown of one request of each batch size and of one step of each
training path.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.fluid import flags
from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.models import wide_deep
from paddle_tpu_torch.ops.kernels import common
from paddle_tpu_torch.ops.kernels import embedding as emb_k
from paddle_tpu_torch.ops.kernels import flash_attention as fa_k
from paddle_tpu_torch.ops.kernels import fused_optimizer as opt_k

ROOT = os.path.dirname(os.path.abspath(__file__))
SEQ = 512
BATCHES = (1, 3, 8)
TRAIN_BATCH = 8
TRAIN_STEPS = 3
TIMED_STEPS = 5
# the rate BERT's linear warmup (peak 1e-4 after 10,000 steps) reaches
# after 100 steps: Adam's first steps at 1e-5 and above overshoot the
# NSP head (measured on the H100; PERF.md)
LR = 1e-6
RATE = 0.1
# H100 SXM data-sheet peaks (dense): HBM bytes/s, f32 FLOP/s outside
# the tensor cores (the kernels compute in full f32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
FA_TOL = 1e-4
BWD_TOL = 1e-4
SLICE_TOL = 1e-3
EPSILON = 1e-6  # BERT's Adam epsilon (Devlin et al. 2019)
# LAMB pretraining (You et al. 2019) with BERT's schedule and clip
# (Devlin et al. 2019): a linear warmup from 0 over LAMB_WARMUP steps
# into a polynomial decay, the global gradient norm clipped at 1.0.
# The warmup is cut to 2 steps so that 3 steps show the updates, and
# the peak is set for batch 8 (measured on the H100, PERF.md).
LAMB_PEAK = 4e-5
LAMB_WARMUP = 2
LAMB_DECAY_STEPS = 1000
LAMB_DECAY = 0.01
CLIP_NORM = 1.0
# Wide&Deep CTR: the hashed Criteo feature space of PaddlePaddle's
# CTR-DNN example, BASE's other widths; the JAX package's Adagrad
# epsilon
WD_ROWS = 1000001
WD_BATCH = 4096
WD_LR = 1e-3
# step 1 of the kernel path against the plain path (see check_plain_step)
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if out else ''


class Timer(object):
    """Device time of one call, host launch overhead excluded: `reps`
    calls captured in a CUDA graph, replayed `iters` times between CUDA
    events.  Cold (the default): each call follows a read of a 256 MB
    buffer, which evicts the 50 MB L2 as a request's earlier layers
    would; the time of those reads alone is subtracted.  graph=False
    times single calls between CUDA events instead (for calls a graph
    cannot hold: host syncs, autograd), host gaps inside the call
    included."""

    def __init__(self, dev):
        self._buf = torch.ones(64 << 20, device=dev)
        self._sink = torch.empty((), device=dev)

    def _flush(self):
        torch.sum(self._buf, dim=0, out=self._sink)

    @staticmethod
    def _graph_ms(fn, reps, iters):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (iters * reps)

    def _event_ms(self, fn, cold, iters):
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            if cold:
                self._flush()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        return total / iters

    def ms(self, fn, cold=True, reps=10, iters=10, graph=True):
        if not graph:
            return self._event_ms(fn, cold, iters)
        if not cold:
            return self._graph_ms(fn, reps, iters)

        def flushed():
            self._flush()
            fn()
        return (self._graph_ms(flushed, reps, iters) -
                self._graph_ms(self._flush, reps, iters))


def without_counting(fn):
    """Run fn() and put the launch counters back as they were: parity
    and timing launches are not the main path's."""
    saved = {k: common.launches(k) for k in common.KERNELS}
    try:
        return fn()
    finally:
        for k, n in saved.items():
            common.KERNELS[k]['launches'] = n


def counted(fn):
    """(fn(), launches per kernel during it): the counters are set to 0
    just before and read just after."""
    common.reset_launches()
    out = fn()
    return out, {k: common.launches(k) for k in common.KERNELS}


def max_abs(a, b):
    return (a.float() - b.float()).abs().max().item()


# ------------------------------------------------------------ phase 3
def qkv_views(gen, b, t, h, d, dev):
    """Q, K, V as split views of one [B, T, 3*H*D] projection, the
    layout the BERT path hands the kernel."""
    qkv = torch.randn(b, t, 3 * h * d, generator=gen, device=dev)
    return [x.reshape(b, t, h, d) for x in qkv.split(h * d, dim=2)]


def padding_bias(gen, b, t, dev):
    lens = torch.randint(t // 4, t + 1, (b,), generator=gen, device=dev)
    keep = torch.arange(t, device=dev)[None, :] < lens[:, None]
    return torch.where(keep, 0.0, -10000.0).float()


def check_flash(gen, dev):
    cases = [('serving B8 H12 T512 D64', 8, 512, 12, 64, False, True),
             ('ragged B2 H4 T200 D64', 2, 200, 4, 64, False, True),
             ('causal ragged B2 H4 T300 D128', 2, 300, 4, 128, True, True),
             ('no bias B1 H2 T64 D32', 1, 64, 2, 32, False, False)]
    worst = 0.0
    for name, b, t, h, d, causal, with_bias in cases:
        q, k, v = qkv_views(gen, b, t, h, d, dev)
        bias = padding_bias(gen, b, t, dev) if with_bias else None
        o, lse = fa_k.flash_attention_kernel(q, k, v, causal, bias)
        po, plse = fa_k.flash_attention_plain(q, k, v, causal, bias)
        torch.cuda.synchronize()
        eo, el = max_abs(o, po), max_abs(lse, plse)
        log('  flash_attention %-30s max|dO| %.3e max|dlse| %.3e'
            % (name, eo, el))
        if not (eo <= FA_TOL and el <= FA_TOL):
            raise AssertionError('flash_attention %s disagrees with its '
                                 'plain version' % name)
        worst = max(worst, eo, el)
    return worst


def kernel_keep_mask(b, h, t, seed, dev):
    """The forward kernel's dropout keep mask [b, h, t, t], read back:
    with Q = K = 0 every unmasked key gets p = 1/64, and with the key
    bias opening one 64-key window at a time and V one-hot over that
    window, O[q, d] = keep(q, window + d) / (64 * (1 - rate))."""
    z = torch.zeros(b, t, h, 64, device=dev)
    keep = torch.empty(b, h, t, t, dtype=torch.bool, device=dev)
    for k0 in range(0, t, 64):
        w = min(64, t - k0)
        bias = torch.full((b, t), float('-inf'), device=dev)
        bias[:, k0:k0 + w] = 0.0
        v = torch.zeros(b, t, h, 64, device=dev)
        v[:, k0:k0 + w, :, :w] = torch.eye(w, device=dev)[None, :, None, :]
        o, _ = fa_k.flash_attention_kernel(z, z, v, False, bias, RATE, seed)
        keep[:, :, :, k0:k0 + w] = (o[..., :w] > 0).permute(0, 2, 1, 3)
    return keep


def check_flash_dropout(gen, dev):
    seed = 0x9E3779B9 ^ 12345
    worst = 0.0
    for name, b, t, h in (('B8 H12 T512 D64', 8, 512, 12),
                          ('ragged B2 H4 T300 D64', 2, 300, 4)):
        q, k, v = qkv_views(gen, b, t, h, 64, dev)
        bias = padding_bias(gen, b, t, dev)
        o, lse = fa_k.flash_attention_kernel(q, k, v, False, bias, RATE,
                                             seed)
        po, plse = fa_k.flash_attention_plain(q, k, v, False, bias, RATE,
                                              seed)
        eo, el = max_abs(o, po), max_abs(lse, plse)
        keep = kernel_keep_mask(b, h, t, seed, dev)
        want = fa_k.dropout_keep_plain(seed, b, h, t, t, RATE, dev)
        torch.cuda.synchronize()
        same = torch.equal(keep, want)
        log('  flash_attention dropout %.1f %-22s max|dO| %.3e max|dlse| '
            '%.3e, keep mask bitwise %s (keep rate %.4f)'
            % (RATE, name, eo, el, same, keep.float().mean().item()))
        if not (eo <= FA_TOL and el <= FA_TOL and same):
            raise AssertionError('flash_attention with dropout %s disagrees '
                                 'with its plain version' % name)
        worst = max(worst, eo, el)
    return worst


def check_flash_bwd(gen, dev):
    cases = [('B8 H12 T512 D64 dropout', 8, 512, 12, 64, False, RATE, False),
             ('ragged B2 H4 T300 D64 dropout dbias+dlse', 2, 300, 4, 64,
              False, RATE, True),
             ('causal B2 H4 T200 D128 dbias', 2, 200, 4, 128, True, 0.0,
              True),
             ('B1 H2 T64 D32', 1, 64, 2, 32, False, 0.0, False)]
    worst = 0.0
    for name, b, t, h, d, causal, rate, with_grads in cases:
        seed = 77 + t
        q, k, v = qkv_views(gen, b, t, h, d, dev)
        bias = padding_bias(gen, b, t, dev)
        do = torch.randn(b, t, h, d, generator=gen, device=dev)
        dlse = (torch.randn(b, h, t, generator=gen, device=dev)
                if with_grads else None)
        o, lse = fa_k.flash_attention_kernel(q, k, v, causal, bias, rate,
                                             seed)
        got = fa_k.flash_attention_bwd_kernel(q, k, v, bias, o, lse, do,
                                              dlse, causal, rate, seed,
                                              bias_grad=with_grads)
        want = fa_k.flash_attention_bwd_plain(q, k, v, bias, do, dlse,
                                              causal, rate, seed,
                                              bias_grad=with_grads)
        torch.cuda.synchronize()
        errs = []
        for label, g, w in zip(('dQ', 'dK', 'dV', 'dbias'), got, want):
            if w is None:
                continue
            err = max_abs(g, w)
            e = err / max(1.0, w.abs().max().item())
            errs.append('%s %.2e' % (label, e))
            if not e <= BWD_TOL:
                raise AssertionError('flash_attention_bwd %s: %s differs '
                                     'from the plain backward by %g'
                                     % (name, label, e))
            worst = max(worst, err)
        log('  flash_attention_bwd %-40s %s' % (name, ', '.join(errs)))
    return worst


def check_embedding(gen, dev):
    w = torch.randn(30522, 768, generator=gen, device=dev)
    ids = torch.randint(0, 30522, (4096,), generator=gen, device=dev)
    ids[:8] = torch.tensor([7, 7, 7, 30521, -1, -500, 30522, 10 ** 9],
                           device=dev)
    got = emb_k.gather_kernel(w, ids)
    want = emb_k.gather_plain(w, ids)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError('embedding_lookup is not bitwise equal to '
                             'its plain version')
    for name, cast in (('int32 ids', torch.int32), ('bf16 table', None)):
        if cast is None:
            wb = w.to(torch.bfloat16)
            ok = torch.equal(emb_k.gather_kernel(wb, ids),
                             emb_k.gather_plain(wb, ids))
        else:
            ok = torch.equal(emb_k.gather_kernel(w, ids.to(cast)),
                             emb_k.gather_plain(w, ids.to(cast)))
        if not ok:
            raise AssertionError('embedding_lookup (%s) differs' % name)
    log('  embedding_lookup 30522x768, 4096 ids: bitwise equal '
        '(int64, int32 ids, bf16 table)')
    return 0.0


def check_scatter(gen, dev):
    n, d = TRAIN_BATCH * SEQ, 768
    for rows, ids in (
            (30522, torch.randint(0, 30522, (n,), generator=gen,
                                  device=dev)),
            (SEQ, torch.arange(SEQ, device=dev).repeat(TRAIN_BATCH)),
            (2, torch.zeros(n, dtype=torch.int64, device=dev))):
        if rows == 30522:
            ids[:8] = torch.tensor([7, 7, 7, 30521, -1, -500, 30522, 7],
                                   device=dev)
        g = torch.randn(n, d, generator=gen, device=dev)
        got = emb_k.scatter_add_kernel(rows, ids, g)
        want = emb_k.scatter_add_plain(rows, ids, g)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError('embedding_scatter_add on %d rows is not '
                                 'bitwise equal to its plain version '
                                 '(max|diff| %g)' % (rows, max_abs(got,
                                                                   want)))
        log('  embedding_scatter_add %5d x %d, %d ids: bitwise equal'
            % (rows, d, n))
    return 0.0


def adam_inputs(shapes, gen, dev):
    lr = torch.full((1,), LR, device=dev)
    b1p = torch.full((1,), 0.9 ** 3, device=dev)
    b2p = torch.full((1,), 0.999 ** 3, device=dev)
    ins = {k: [] for k in ('Param', 'Grad', 'Moment1', 'Moment2',
                           'LearningRate', 'Beta1Pow', 'Beta2Pow')}
    for s in shapes:
        ins['Param'].append(torch.randn(s, generator=gen, device=dev))
        ins['Grad'].append(torch.randn(s, generator=gen, device=dev) * 1e-2)
        ins['Moment1'].append(torch.randn(s, generator=gen, device=dev) *
                              1e-3)
        ins['Moment2'].append(torch.rand(s, generator=gen, device=dev) *
                              1e-4)
        ins['LearningRate'].append(lr)
        ins['Beta1Pow'].append(b1p)
        ins['Beta2Pow'].append(b2p)
    return ins


def check_adam(gen, dev, shapes):
    for kind, attrs, subset in (
            ('adam', {'beta1': 0.9, 'beta2': 0.999, 'epsilon': EPSILON},
             shapes),
            ('adamw', {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8,
                       'coeff': 0.01}, shapes[:9])):
        ins = adam_inputs(subset, gen, dev)
        want = opt_k.apply_plain(kind, None, ins, attrs)
        opt_k.apply_kernel(kind, ins, attrs)  # in place
        torch.cuda.synchronize()
        for slot, got_slot in (('ParamOut', 'Param'),
                               ('Moment1Out', 'Moment1'),
                               ('Moment2Out', 'Moment2')):
            for got, w in zip(ins[got_slot], want[slot]):
                if not torch.equal(got, w):
                    raise AssertionError('fused_adam (%s) %s is not bitwise '
                                         'equal to the per-tensor lowering: '
                                         'max|diff| %g'
                                         % (kind, slot, max_abs(got, w)))
        log('  fused_adam %-5s %3d tensors, %d elements: bitwise equal'
            % (kind, len(subset), sum(int(np.prod(s)) for s in subset)))
    return 0.0


def lamb_inputs(shapes, gen, dev):
    """adam_inputs over `shapes` with per-tensor beta powers (LAMB keeps
    one pair a parameter), then a tensor with a zero gradient and zero
    moments and a [1] tensor."""
    ins = adam_inputs(list(shapes) + [(4096,), (1,)], gen, dev)
    for slot in ('Beta1Pow', 'Beta2Pow'):
        ins[slot] = [x.clone() for x in ins[slot]]
    for slot in ('Grad', 'Moment1', 'Moment2'):
        ins[slot][-2].zero_()
    return ins


def check_lamb(gen, dev, shapes):
    """K5 over BERT-base's parameter set: moments bitwise, parameters to
    rtol 2e-6 / atol 3e-7, the same parameters bit for bit from a second
    launch on the same state.  The zero-gradient tensor runs without
    decay (its own run), so its r is 0: trust 1 and a zero step."""
    attrs = {'beta1': 0.9, 'beta2': 0.999, 'epsilon': EPSILON,
             'weight_decay': LAMB_DECAY}
    ins = lamb_inputs(shapes, gen, dev)
    worst = 0.0
    for lo, hi, run_attrs in ((0, len(shapes) + 2, attrs),
                              (len(shapes), len(shapes) + 1,
                               dict(attrs, weight_decay=0.0))):
        part = {k: v[lo:hi] for k, v in ins.items()}
        want = opt_k.apply_plain('lamb', None, part, run_attrs)
        outs = []
        for _ in range(2):
            got = {k: [x.clone() for x in v] for k, v in part.items()}
            opt_k.apply_kernel('lamb', got, run_attrs)
            outs.append(got)
        torch.cuda.synchronize()
        for slot, out in (('Moment1', 'Moment1Out'),
                          ('Moment2', 'Moment2Out')):
            for a, b in zip(outs[0][slot], want[out]):
                if not torch.equal(a, b):
                    raise AssertionError('fused_lamb %s is not bitwise equal '
                                         'to the per-tensor lowering: '
                                         'max|diff| %g' % (slot,
                                                           max_abs(a, b)))
        for a, b, c in zip(outs[0]['Param'], want['ParamOut'],
                           outs[1]['Param']):
            worst = max(worst, max_abs(a, b))
            if not torch.allclose(a, b, rtol=2e-6, atol=3e-7):
                raise AssertionError('fused_lamb parameters differ from the '
                                     'per-tensor lowering: max|diff| %g'
                                     % max_abs(a, b))
            if not torch.equal(a, c):
                raise AssertionError('fused_lamb gave other parameters on a '
                                     'second launch from the same state')
    if not torch.equal(outs[0]['Param'][0], part['Param'][0]):
        raise AssertionError('fused_lamb moved a tensor whose r is 0')
    log('  fused_lamb  %3d tensors, %d elements (+ a zero-gradient and a '
        '[1] tensor): moments bitwise, parameters max|diff| %.3e (rtol '
        '2e-6, atol 3e-7), bitwise from launch to launch'
        % (len(shapes), sum(int(np.prod(s)) for s in shapes), worst))
    return worst


def check_emb_update(gen, dev):
    """K7 through the fused_emb_update op against the op's plain path
    (FLAGS_torch_kernels_plain), bitwise: padding rows zeroed, ids
    clipped, untouched rows left alone."""
    n = WD_BATCH * wide_deep.BASE.num_sparse_fields
    ids = torch.randint(0, WD_ROWS, (WD_BATCH, 26), generator=gen,
                        device=dev)
    ids[0, :6] = torch.tensor([5, 5, -3, WD_ROWS, 10 ** 9, 17], device=dev)
    for rows, d, pad in ((WD_ROWS, 16, 17), (1000, 16, 0), (WD_ROWS, 1, 5)):
        ins = {'Param': [torch.randn(rows, d, generator=gen, device=dev)],
               'Moment': [torch.rand(rows, d, generator=gen, device=dev)],
               'Ids': [ids if rows == WD_ROWS else ids % rows],
               'Grad': [torch.randn(WD_BATCH, 26, d, generator=gen,
                                    device=dev)],
               'LearningRate': [torch.full((1,), 0.05, device=dev)]}
        attrs = {'epsilon': 1e-6, 'padding_idx': pad}
        start = [ins['Param'][0].clone(), ins['Moment'][0].clone()]
        flags.set_flags({'FLAGS_torch_kernels_plain': True})
        try:
            want = emb_k.apply_update(None, ins, attrs)
        finally:
            flags.set_flags({'FLAGS_torch_kernels_plain': False})
        got = emb_k.apply_update(None, ins, attrs)  # in place
        torch.cuda.synchronize()
        for slot, a, b in zip(('ParamOut', 'MomentOut'),
                              (got['ParamOut'][0], got['MomentOut'][0]),
                              (want['ParamOut'][0], want['MomentOut'][0])):
            if not torch.equal(a, b):
                raise AssertionError('embedding_update %s on %d x %d is not '
                                     'bitwise equal to its plain version: '
                                     'max|diff| %g' % (slot, rows, d,
                                                       max_abs(a, b)))
        if not (torch.equal(got['ParamOut'][0][pad], start[0][pad]) and
                torch.equal(got['MomentOut'][0][pad], start[1][pad])):
            raise AssertionError('embedding_update moved the padding row')
        touched = int(torch.unique(ins['Ids'][0].clamp(0, rows - 1)).numel())
        log('  embedding_update %7d x %2d, %d ids (%d rows touched): '
            'bitwise equal' % (rows, d, n, touched))
    return 0.0


# ------------------------------------------------------------ phase 4
def build_model(model_dir, seed):
    cfg = bert.BASE
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feeds = bert.encoder_feeds(SEQ)
        enc = bert.bert_encoder(feeds['src_ids'], feeds['pos_ids'],
                                feeds['sent_ids'], feeds['input_mask'],
                                cfg, is_test=True)
    n_attn = sum(op.type == 'fused_multihead_attention'
                 for op in main.global_block().ops)
    n_emb = sum(op.type == 'lookup_table_v2'
                for op in main.global_block().ops)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(model_dir, list(feeds), [enc], exe,
                                      main_program=main)
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    return cfg, n_attn, n_emb, n_params


def serve(model_dir, cfg, n_attn, n_emb, seed):
    config = AnalysisConfig(model_dir)
    pred = create_paddle_predictor(config)
    if pred.place != fluid.CUDAPlace(0):
        raise AssertionError('predictor is on %r' % pred.place)
    rng = np.random.RandomState(seed)
    requests = [bert.encoder_batch(cfg, b, SEQ, rng, pad_to=SEQ - 37 * i)
                for i, b in enumerate(BATCHES)]
    names = pred.get_input_names()
    outs, latency, per_request = [], [], []
    expected = {k: 0 for k in common.KERNELS}
    expected.update({'flash_attention': n_attn, 'embedding_lookup': n_emb})
    launches = {k: 0 for k in common.KERNELS}
    for req in requests:
        t0 = time.perf_counter()
        out, counts = counted(
            lambda: pred.run([req[n] for n in names])[0].data)
        latency.append(time.perf_counter() - t0)
        per_request.append(counts)
        outs.append(out)
        for k, c in counts.items():
            launches[k] += c
    for req, out, counts, sec in zip(requests, outs, per_request, latency):
        b = req['src_ids'].shape[0]
        log('  request batch %d: out %s %s, %.2f ms, launches %s'
            % (b, out.shape, out.dtype, sec * 1e3,
               {k: c for k, c in counts.items() if c}))
        if out.shape != (b, SEQ, cfg.hidden) or not np.isfinite(out).all():
            raise AssertionError('request batch %d: bad output' % b)
        if counts != expected:
            raise AssertionError('request batch %d launched %s, expected %s'
                                 % (b, counts, expected))
    # the whole path again with the plain versions, on the card
    flags.set_flags({'FLAGS_torch_kernels_plain': True})
    try:
        plain = without_counting(
            lambda: pred.run([requests[-1][n] for n in names])[0].data)
    finally:
        flags.set_flags({'FLAGS_torch_kernels_plain': False})
    err = float(np.abs(plain - outs[-1]).max())
    log('  batch 8 vs the plain path on the card: max|diff| %.3e '
        '(limit %g)' % (err, SLICE_TOL))
    if not err <= SLICE_TOL:
        raise AssertionError('the kernel path disagrees with the plain '
                             'path: %g' % err)
    return pred, requests, launches


def profile_run(label, fn):
    """torch.profiler over one call of fn: host and device totals, the
    device-op count and the by-kernel table."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    host = sum(e.self_cpu_time_total for e in events) / 1e3
    dev = sum(e.self_device_time_total for e in events
              if e.device_type == DeviceType.CUDA) / 1e3
    n_dev = sum(e.count for e in events
                if e.device_type == DeviceType.CUDA)
    log('  profile %s: host %.2f ms self CPU, device %.2f ms in %d '
        'kernels/copies' % (label, host, dev, n_dev))
    return events


def profile_requests(pred, requests):
    names = pred.get_input_names()
    for req in requests:
        events = profile_run('request batch %d' % req['src_ids'].shape[0],
                             lambda: pred.run([req[n] for n in names]))
    log(events.table(sort_by='self_cuda_time_total', row_limit=15))


# ------------------------------------------------------- phases 5-7
def pretrain_program(seed, optimizer):
    """BERT-base pretraining with Adam ('adam', phase 5) or with LAMB,
    the warmup over a polynomial decay and the global-norm clip
    ('lamb', phase 6): the path dict that train() runs."""
    cfg = bert.BASE
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = bert.build_pretrain(cfg, seq_len=SEQ)
        if optimizer == 'adam':
            lr = None
            fluid.optimizer.Adam(learning_rate=LR,
                                 epsilon=EPSILON).minimize(loss)
        else:
            lr = fluid.layers.linear_lr_warmup(
                fluid.layers.polynomial_decay(LAMB_PEAK, LAMB_DECAY_STEPS,
                                              0.0),
                LAMB_WARMUP, 0.0, LAMB_PEAK)
            fluid.optimizer.Lamb(
                lr, lamb_weight_decay=LAMB_DECAY, epsilon=EPSILON,
                grad_clip=fluid.clip.GradientClipByGlobalNorm(CLIP_NORM)
            ).minimize(loss)
    n_attn = sum(op.type == 'fused_multihead_attention'
                 for op in main.global_block().ops)
    expected = {k: 0 for k in common.KERNELS}
    expected.update({'flash_attention': n_attn,
                     'flash_attention_bwd': n_attn,
                     'embedding_lookup': 3, 'embedding_scatter_add': 3,
                     'fused_' + optimizer: 1})
    # gradients fetched beside the loss on step 1, held against the
    # plain path
    probe = ['embedding_0.w_0', 'fc_0.w_0', 'fc_0.w_1', 'layer_norm_0.w_0']
    probe += [p.name for p in main.all_parameters()
              if p.shape == (cfg.hidden, cfg.vocab_size)]
    return {'name': 'BERT-base %s' % optimizer.upper(), 'main': main,
            'startup': startup, 'loss': loss, 'lr': lr,
            'batch': bert.synthetic_batch(cfg, TRAIN_BATCH, SEQ,
                                          np.random.RandomState(seed)),
            'expected': expected, 'probe': probe, 'tokens': TRAIN_BATCH * SEQ,
            'bitwise': False}


def wide_deep_program(seed):
    """Wide&Deep CTR at BASE widths over the hashed Criteo feature space
    with Adagrad (phase 7): the path dict that train() runs."""
    cfg = wide_deep.WideDeepConfig(sparse_feature_dim=WD_ROWS)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = wide_deep.build(cfg)
        fluid.optimizer.Adagrad(WD_LR, epsilon=1e-6).minimize(loss)
    n_update = sum(op.type == 'fused_emb_update'
                   for op in main.global_block().ops)
    expected = {k: 0 for k in common.KERNELS}
    expected.update({'embedding_lookup': 2, 'embedding_update': n_update})
    return {'name': 'Wide&Deep Adagrad', 'main': main, 'startup': startup,
            'loss': loss, 'lr': None,
            'batch': wide_deep.synthetic_batch(cfg, WD_BATCH,
                                               np.random.RandomState(seed)),
            'expected': expected, 'probe': [],
            'tokens': WD_BATCH * cfg.num_sparse_fields, 'bitwise': True}


def snapshot(scope, names):
    return {n: scope.find_var(n).detach().clone() for n in names}


def train(path):
    """TRAIN_STEPS steps of a training path on CUDAPlace(0), each step's
    launches checked; the loss checks and the step-1 check against the
    plain path.  Returns what the timings need."""
    main, startup, loss = path['main'], path['startup'], path['loss']
    n_opt = sum(op.type in ('adam', 'lamb', 'adagrad', 'fused_emb_update')
                for op in main.global_block().ops)
    params = main.all_parameters()
    log('  %s program: %d ops (%d update ops), %d parameters (%d elements)'
        % (path['name'], len(main.global_block().ops), n_opt, len(params),
           sum(int(np.prod(p.shape)) for p in params)))
    state_names = weights.startup_names(startup)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    fetch = [loss.name] + ([path['lr'].name] if path['lr'] else [])
    grad_fetch = [main._grad_name_map[p] for p in path['probe']]
    launches = {k: 0 for k in common.KERNELS}
    losses, rates, secs = [], [], []
    with fluid.scope_guard(scope):
        exe.run(startup)
        start = snapshot(scope, state_names)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for step in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            out, counts = counted(lambda: exe.run(
                main, feed=path['batch'],
                fetch_list=fetch + (grad_fetch if step == 0 else []),
                return_numpy=False))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(out[0]))
            rates.append(float(out[1]) if path['lr'] else None)
            if step == 0:
                grads = [g.clone() for g in out[len(fetch):]]
                after1 = snapshot(scope, state_names)
            for k, c in counts.items():
                launches[k] += c
            log('  step %d: loss %.6f%s, %.1f ms, launches %s'
                % (step + 1, losses[-1],
                   ', lr %.4g' % rates[-1] if path['lr'] else '',
                   secs[-1] * 1e3, {k: c for k, c in counts.items() if c}))
            if counts != path['expected']:
                raise AssertionError('step %d launched %s, expected %s'
                                     % (step + 1, counts, path['expected']))
        peak = torch.cuda.max_memory_allocated()
    log('  peak device memory over the %d steps: %.2f GiB'
        % (TRAIN_STEPS, peak / 2 ** 30))
    held = held_losses(path, start)
    log('  losses %s; with the parameters held %s'
        % (['%.6f' % x for x in losses], ['%.6f' % x for x in held]))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] or \
            not losses[-1] < held[-1] or \
            not abs(held[0] - losses[0]) <= 1e-6 * abs(losses[0]):
        raise AssertionError('loss %s (held %s): not finite, not falling '
                             'from step 1 to step %d, or not below the '
                             'held run' % (losses, held, TRAIN_STEPS))
    check_plain_step(path, fetch + grad_fetch, start, after1, losses[0],
                     grads, rates[0] if path['lr'] else LR)
    return {'path': path, 'exe': exe, 'scope': scope, 'launches': launches,
            'peak': peak, 'rates': rates}


def held_losses(path, start):
    """The losses of TRAIN_STEPS steps that each start from `start`: the
    same step numbers, hence the same dropout masks, and parameters that
    do not move."""
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    losses = []
    with fluid.scope_guard(scope):
        without_counting(lambda: exe.run(path['startup']))
        for _ in range(TRAIN_STEPS):
            for n, v in start.items():
                scope.set_var(n, v.clone())
            losses.append(float(without_counting(lambda: exe.run(
                path['main'], feed=path['batch'],
                fetch_list=[path['loss']]))[0]))
    return losses


def check_plain_step(path, fetch, start, after1, loss1, grads, lr1):
    """Step 1 again from the same state (a startup run, so the step
    counter matches, then the kernel path's starting values), with every
    kernel's plain version.

    A path with `bitwise` (Wide&Deep) runs the same PyTorch ops around
    kernels that are bitwise their plain versions: the loss and the
    whole state after the step must be bit for bit the kernel path's.

    On the BERT paths the hidden dropout draws from the same generator
    (program seed, op seed, step) and the attention mask from the same
    hash, so both paths compute the same function in another summation
    order: the loss agrees to LOSS_RTOL, the probed gradients and every
    first moment ((1 - beta1) * gradient after one step) to GRAD_TOL of
    their largest magnitude.  A first Adam step at rate lr1 moves a
    parameter by lr1 * g / (|g| + epsilon), which changes by at most
    lr1 / epsilon times a change of g, so each parameter must agree
    within (lr1 / epsilon) * max|d moment1| / (1 - beta1), with 5% and
    1e-7 of slack for rounding; LAMB's first step runs at the warmup's
    rate 0, so its parameters must stay within the 1e-7."""
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    flags.set_flags({'FLAGS_torch_kernels_plain': True})
    try:
        with fluid.scope_guard(scope):
            without_counting(lambda: exe.run(path['startup']))
            for n, v in start.items():
                scope.set_var(n, v.clone())
            out = without_counting(lambda: exe.run(
                path['main'], feed=path['batch'], fetch_list=fetch,
                return_numpy=False))
            torch.cuda.synchronize()
            got = snapshot(scope, list(start))
    finally:
        flags.set_flags({'FLAGS_torch_kernels_plain': False})
    if path['bitwise']:
        differ = [n for n in start if not torch.equal(after1[n], got[n])]
        log('  step 1 vs the plain path: loss %s, state %s' % (
            'equal' if float(out[0]) == loss1 else 'differs',
            'bitwise equal (%d variables)' % len(start) if not differ
            else 'differs in %s' % differ))
        if float(out[0]) != loss1 or differ:
            raise AssertionError('the training step is not bitwise its '
                                 'plain path')
        return
    loss_err = abs(float(out[0]) - loss1) / abs(loss1)
    n_fixed = len(fetch) - len(grads)
    grad_err = max(max_abs(a, b) / b.abs().max().item()
                   for a, b in zip(grads, out[n_fixed:]))
    moment_err, param_ratio = 0.0, 0.0
    for n in start:
        if '_moment1_' not in n:
            continue
        dm = max_abs(after1[n], got[n])
        moment_err = max(moment_err,
                         dm / max(got[n].abs().max().item(), 1e-30))
        p = n.split('_moment1_')[0]
        limit = lr1 / EPSILON * dm / (1 - 0.9) * 1.05 + 1e-7
        param_ratio = max(param_ratio, max_abs(after1[p], got[p]) / limit)
    log('  step 1 vs the plain path: loss rel %.2e (limit %g), gradients '
        'of %s rel %.2e, first moments rel %.2e (limit %g), parameters at '
        '%.2f of their bound' % (loss_err, LOSS_RTOL, path['probe'],
                                 grad_err, moment_err, GRAD_TOL,
                                 param_ratio))
    if not (loss_err <= LOSS_RTOL and grad_err <= GRAD_TOL and
            moment_err <= GRAD_TOL and param_ratio <= 1.0):
        raise AssertionError('the training step disagrees with its plain '
                             'path')


def train_step_ms(run):
    """Median host-clock time of exe.run (the loss fetched to numpy, so
    it ends after the step's last kernel) over TIMED_STEPS steps."""
    path = run['path']
    secs = []
    with fluid.scope_guard(run['scope']):
        for _ in range(TIMED_STEPS):
            t0 = time.perf_counter()
            run['exe'].run(path['main'], feed=path['batch'],
                           fetch_list=[path['loss']])
            secs.append(time.perf_counter() - t0)
    med = statistics.median(secs) * 1e3
    log('  %s step: median %.2f ms over %d steps %s, %.0f %s/s' % (
        path['name'], med, TIMED_STEPS, ['%.2f' % (x * 1e3) for x in secs],
        path['tokens'] / med * 1e3,
        'ids' if path['bitwise'] else 'tokens'))
    return med


def profile_train(run):
    path = run['path']
    with fluid.scope_guard(run['scope']):
        events = profile_run('%s step' % path['name'], lambda: run['exe'].run(
            path['main'], feed=path['batch'], fetch_list=[path['loss']]))
    log(events.table(sort_by='self_cuda_time_total', row_limit=25))


# ------------------------------------------------------------ phase 8
def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return {'bound_ms': max(t_bytes, t_ops),
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations'}


def sdpa_bwd_call(q, k, v, mask, do):
    """The library call for the flash backward: SDPA's memory-efficient
    backward op (the backend SDPA takes for f32 with a float mask) on
    the outputs its forward saved, with dropout RATE; one call a CUDA
    graph can hold."""
    b, t, h, _ = q.shape
    qh, kh, vh, doh = [x.transpose(1, 2) for x in (q, k, v, do)]
    bias = mask.expand(b, h, t, t)
    out, lse, seed, offset = \
        torch.ops.aten._scaled_dot_product_efficient_attention(
            qh, kh, vh, bias, True, RATE)
    # the backward reads the dropout RNG's seed and offset from host
    # tensors when called eagerly and from device tensors under CUDA
    # graph capture
    rng = {False: (seed.cpu(), offset.cpu()),
           True: (seed.to(q.device), offset.to(q.device))}
    bwd = torch.ops.aten._scaled_dot_product_efficient_attention_backward
    return lambda: bwd(
        doh, qh, kh, vh, bias, out, lse,
        *rng[torch.cuda.is_current_stream_capturing()], RATE,
        [True, True, True, False])


def time_kernels(timer, gen, dev, req, train_batch, wd_batch, launches,
                 max_err, adam_shapes):
    b, t, h, d = 8, SEQ, 12, 64
    seed = 4242
    q, k, v = qkv_views(gen, b, t, h, d, dev)
    bias = torch.from_numpy(req['input_mask']).to(dev) * 10000.0 - 10000.0
    qh, kh, vh = [x.transpose(1, 2) for x in (q, k, v)]
    mask = bias[:, None, None, :]
    o, lse = fa_k.flash_attention_kernel(q, k, v, False, bias, RATE, seed)
    do = torch.randn(b, t, h, d, generator=gen, device=dev)
    fa_bytes = 4 * (4 * b * t * h * d + b * t + b * h * t)
    fa_flops = 4 * b * h * t * t * d
    w = torch.randn(30522, 768, generator=gen, device=dev)
    ids = torch.from_numpy(req['src_ids']).to(dev).reshape(-1)
    n = ids.numel()
    src = torch.from_numpy(train_batch['src_ids']).to(dev).reshape(-1)
    g = torch.randn(src.numel(), 768, generator=gen, device=dev)
    ins = adam_inputs(adam_shapes, gen, dev)
    adam_attrs = {'beta1': 0.9, 'beta2': 0.999, 'epsilon': EPSILON}
    table, blocks = opt_k.device_table(ins)
    n_adam = sum(x.numel() for x in ins['Param'])
    lib_params = [torch.nn.Parameter(x.clone()) for x in ins['Param']]
    for p, x in zip(lib_params, ins['Grad']):
        p.grad = x.clone()
    lib_adam = torch.optim.Adam(lib_params, lr=LR, eps=EPSILON, fused=True,
                                capturable=True)
    lamb_attrs = {'beta1': 0.9, 'beta2': 0.999, 'epsilon': EPSILON,
                  'weight_decay': LAMB_DECAY}
    lamb_ins = lamb_inputs(adam_shapes, gen, dev)
    lamb_ins = {k: v[:len(adam_shapes)] for k, v in lamb_ins.items()}
    lamb_table, lamb_blocks = opt_k.device_table(lamb_ins, opt_k.LAMB_SOURCE)
    # the deep table's update: the main path's ids, its [V, 16] table
    wd_ids = torch.from_numpy(wd_batch['sparse_input']).to(dev).reshape(-1)
    n_wd = wd_ids.numel()
    rows_wd = {}
    for rows, width in ((WD_ROWS, 16), (1000, 16), (WD_ROWS, 1)):
        ids_r = wd_ids % rows
        touched = int(torch.unique(ids_r).numel())
        rows_wd[(rows, width)] = dict(
            ids=ids_r, w=torch.randn(rows, width, generator=gen, device=dev),
            m=torch.rand(rows, width, generator=gen, device=dev),
            g=torch.randn(n_wd, width, generator=gen, device=dev),
            touched=touched,
            bound=bound(n_wd * (8 + width * 4) + touched * width * 16, 0))
    lr_wd = torch.full((1,), WD_LR, device=dev)
    deep = rows_wd[(WD_ROWS, 16)]
    lib_emb = torch.nn.Parameter(deep['w'].clone())
    lib_emb.grad = torch.sparse_coo_tensor(deep['ids'][None], deep['g'],
                                           deep['w'].shape,
                                           check_invariants=True)
    lib_adagrad = torch.optim.Adagrad([lib_emb], lr=WD_LR, eps=1e-6)
    # name, kernel, plain, library, bound, whether a CUDA graph can
    # hold the plain version and the library call (the others have no
    # host sync)
    calls = [
        ('flash_attention',
         lambda: fa_k.flash_attention_kernel(q, k, v, False, bias),
         lambda: fa_k.flash_attention_plain(q, k, v, False, bias),
         lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
         bound(fa_bytes, fa_flops), True, True),
        ('flash_attention[dropout]',
         lambda: fa_k.flash_attention_kernel(q, k, v, False, bias, RATE,
                                             seed),
         lambda: fa_k.flash_attention_plain(q, k, v, False, bias, RATE,
                                            seed),
         lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                dropout_p=RATE),
         bound(fa_bytes, fa_flops), True, True),
        # the bound counts the S recompute and the four products the
        # gradient needs from q, k, v, O, lse and dO
        ('flash_attention_bwd',
         lambda: fa_k.flash_attention_bwd_kernel(q, k, v, bias, o, lse, do,
                                                 None, False, RATE, seed),
         lambda: fa_k.flash_attention_bwd_plain(q, k, v, bias, do, None,
                                                False, RATE, seed),
         sdpa_bwd_call(q, k, v, mask, do),
         bound(4 * (8 * b * t * h * d + b * t + b * h * t),
               10 * b * h * t * t * d), False, True),
        # the ids are in range here: F.embedding does not clip
        ('embedding_lookup',
         lambda: emb_k.gather_kernel(w, ids),
         lambda: emb_k.gather_plain(w, ids),
         lambda: F.embedding(ids, w),
         bound(2 * n * 768 * 4 + n * 8, 0), True, True),
        ('embedding_scatter_add',
         lambda: emb_k.scatter_add_kernel(30522, src, g),
         lambda: emb_k.scatter_add_plain(30522, src, g),
         lambda: torch.zeros(30522, 768, device=dev).index_add_(0, src, g),
         bound(src.numel() * (768 * 4 + 8) + 30522 * 768 * 4, 0), False,
         True),
        ('fused_adam',
         lambda: opt_k.launch('adam', table, blocks, adam_attrs),
         lambda: opt_k.apply_plain('adam', None, ins, adam_attrs),
         lib_adam.step,
         bound(28 * n_adam + 12 * len(adam_shapes), 0), True, True),
        # moments pass 24 bytes an element, apply pass 16; no PyTorch
        # call computes LAMB
        ('fused_lamb',
         lambda: opt_k.launch_lamb(lamb_table, lamb_blocks, lamb_attrs),
         lambda: opt_k.apply_plain('lamb', None, lamb_ins, lamb_attrs),
         None, bound(40 * n_adam + 12 * len(adam_shapes), 0), True, True),
        # ids, gradient rows, the touched rows of w and m read and written
        ('embedding_update',
         lambda: emb_k.update_kernel(deep['w'], deep['m'], deep['ids'],
                                     deep['g'], lr_wd, 1e-6),
         lambda: emb_k.update_plain(deep['w'], deep['m'], deep['ids'],
                                    deep['g'], lr_wd, 1e-6),
         lib_adagrad.step, deep['bound'], False, False),
    ]
    rows = []
    for name, kernel, plain, library, bnd, graph, lib_graph in calls:
        base = name.split('[')[0]
        info = common.KERNELS[base]
        ms = timer.ms(kernel)
        plain_ms = timer.ms(plain, graph=graph)
        library_ms = None if library is None else \
            timer.ms(library, graph=lib_graph)
        row = {'name': name, 'route': 'cuda',
               'source': 'paddle_tpu_torch/ops/kernels/csrc/' +
                         info['source'],
               'replaces': info['replaces'].split(' ')[0],
               'launches': launches[name],
               'max_abs_err': max_err[name],
               'ms': ms, 'plain_ms': plain_ms,
               'bound_ms': bnd['bound_ms'], 'bound_by': bnd['bound_by'],
               'library_ms': library_ms}
        rows.append(row)
        log('  %-24s cold L2: kernel %.4f ms  plain %.4f ms%s  library '
            '%s  bound %.4f ms (%s)' % (
                name, ms, plain_ms, '' if graph else ' (events)',
                'none' if library_ms is None else '%.4f ms%s' % (
                    library_ms, '' if lib_graph else ' (events)'),
                row['bound_ms'], row['bound_by']))
    # the step's other scatter: BERT's 2-row sentence table, every id on
    # row 0, one run of 4096 rows
    zeros = torch.zeros_like(src)
    log('  %-24s cold L2: kernel %.4f ms  library %.4f ms  bound %.4f ms '
        '(2 x 768 table, one run of %d ids)' % (
            'embedding_scatter_add', timer.ms(
                lambda: emb_k.scatter_add_kernel(2, zeros, g)),
            timer.ms(lambda: torch.zeros(2, 768, device=dev).index_add_(
                0, zeros, g)),
            bound(src.numel() * (768 * 4 + 8) + 2 * 768 * 4, 0)['bound_ms'],
            src.numel()))
    # the row update on BASE's 1000-row table (~106 visits a row) and on
    # the wide part's D = 1 table
    for key in ((1000, 16), (WD_ROWS, 1)):
        r = rows_wd[key]
        log('  %-24s cold L2: kernel %.4f ms  plain %.4f ms (events)  '
            'bound %.4f ms (%d x %d table, %d ids, %d rows touched)' % (
                'embedding_update', timer.ms(
                    lambda: emb_k.update_kernel(r['w'], r['m'], r['ids'],
                                                r['g'], lr_wd, 1e-6)),
                timer.ms(lambda: emb_k.update_plain(
                    r['w'], r['m'], r['ids'], r['g'], lr_wd, 1e-6),
                    graph=False),
                r['bound']['bound_ms'], key[0], key[1], n_wd,
                r['touched']))
    return rows


def request_latency(pred, requests, runs=5):
    """Median host-clock time of pred.run (numpy in, numpy out, so it
    ends after the device-to-host copy) per request batch size."""
    names = pred.get_input_names()
    for req in requests:
        secs = []
        for _ in range(runs):
            t0 = time.perf_counter()
            pred.run([req[n] for n in names])
            secs.append(time.perf_counter() - t0)
        log('  request latency batch %d: median %.2f ms over %d runs %s' % (
            req['src_ids'].shape[0], statistics.median(secs) * 1e3, runs,
            ['%.2f' % (x * 1e3) for x in secs]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--profile', action='store_true')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false (torch %s)'
              % torch.__version__, file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    card = card_line()
    t_start = time.perf_counter()
    log('[1] torch %s, CUDA %s, python %s' % (
        torch.__version__, torch.version.cuda, sys.version.split()[0]))
    log('    card: %s | %s (count %d)' % (
        torch.cuda.get_device_name(0), card, torch.cuda.device_count()))

    t0 = time.perf_counter()
    common.build()
    for info in common.KERNELS.values():
        common.library(info['source'])
    log('[2] built %s in %.1f s into %s' % (
        sorted({k['source'] for k in common.KERNELS.values()}),
        time.perf_counter() - t0, common.build_dir()))

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    paths = [pretrain_program(args.seed, 'adam'),
             pretrain_program(args.seed, 'lamb'),
             wide_deep_program(args.seed)]
    adam_shapes = [tuple(p.shape) for p in sorted(
        paths[0]['main'].all_parameters(), key=lambda p: p.name)]
    log('[3] kernel parity on the card')
    max_err = {
        'flash_attention': without_counting(lambda: check_flash(gen, dev)),
        'flash_attention[dropout]': without_counting(
            lambda: check_flash_dropout(gen, dev)),
        'flash_attention_bwd': without_counting(
            lambda: check_flash_bwd(gen, dev)),
        'embedding_lookup': without_counting(
            lambda: check_embedding(gen, dev)),
        'embedding_scatter_add': without_counting(
            lambda: check_scatter(gen, dev)),
        'fused_adam': without_counting(
            lambda: check_adam(gen, dev, adam_shapes)),
        'fused_lamb': without_counting(
            lambda: check_lamb(gen, dev, adam_shapes)),
        'embedding_update': without_counting(
            lambda: check_emb_update(gen, dev)),
    }
    torch.cuda.empty_cache()

    log('[4] BERT-base serving through create_paddle_predictor')
    os.makedirs(os.path.join(ROOT, 'build', 'chip_smoke'), exist_ok=True)
    with tempfile.TemporaryDirectory(
            dir=os.path.join(ROOT, 'build', 'chip_smoke')) as model_dir:
        t0 = time.perf_counter()
        cfg, n_attn, n_emb, n_params = build_model(model_dir, args.seed)
        log('  built, initialised and saved %d parameters (%d attention, '
            '%d lookup ops) in %.1f s' % (n_params, n_attn, n_emb,
                                          time.perf_counter() - t0))
        pred, requests, serve_launches = serve(model_dir, cfg, n_attn,
                                               n_emb, args.seed)
    log('  launches on the 3 requests: %s'
        % {k: c for k, c in serve_launches.items() if c})

    runs = []
    for phase, path in zip((5, 6, 7), paths):
        log('[%d] %s training steps on CUDAPlace(0)' % (phase, path['name']))
        runs.append(train(path))
        log('  launches on the %d steps: %s' % (
            TRAIN_STEPS, {k: c for k, c in runs[-1]['launches'].items()
                          if c}))
    train_launches = {k: sum(r['launches'][k] for r in runs)
                      for k in common.KERNELS}
    # serving runs flash_attention without dropout, training with it
    launches = dict(train_launches)
    launches.update({
        'flash_attention': serve_launches['flash_attention'],
        'flash_attention[dropout]': train_launches['flash_attention'],
        'embedding_lookup': (serve_launches['embedding_lookup'] +
                             train_launches['embedding_lookup'])})

    log('[8] timings at the main path\'s shapes (%s | %s)' % (
        torch.cuda.get_device_name(0), card))
    timer = Timer(dev)
    rows = without_counting(lambda: time_kernels(
        timer, gen, dev, requests[-1], paths[0]['batch'], paths[2]['batch'],
        launches, max_err, adam_shapes))
    without_counting(lambda: request_latency(pred, requests))
    for run in runs:
        without_counting(lambda: train_step_ms(run))
    if args.profile:
        without_counting(lambda: profile_requests(pred, requests))
        for run in runs:
            without_counting(lambda: profile_train(run))
    log('  whole run %.1f s' % (time.perf_counter() - t_start))
    log('card: %s' % card_line())
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
