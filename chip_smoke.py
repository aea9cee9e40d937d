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
     the same 3 steps give with the parameters held (learning rate 0:
     the same dropout masks, so the difference is what the updates
     learned).  Step 1 again from the same state
     with the plain versions gives the same loss (rel. 1e-4) and
     gradients, first moments and parameters within the limits printed;
     peak device memory is printed;
  6. timings: each kernel, its plain version and the PyTorch library
     call at the main path's shapes (device time of CUDA-graph replays,
     L2 flushed before each call; a plain version that syncs with the
     host is timed with CUDA events around single calls instead), the
     least time the card could take (bound), K6b also on the 2-row
     sentence table, the request latency per batch size and the median
     training step.  The library call for the flash backward is SDPA's
     memory-efficient backward op on its own forward's saved outputs.
The line before the last is a JSON object {"kernels": [...]}; the last
is {"ok": true, "device": {...}}.  --profile adds a torch.profiler
breakdown of one request of each batch size and of one training step.
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


def pretrain_program(seed):
    """(cfg, main, startup, feeds, loss) of BERT-base pretraining with
    Adam."""
    cfg = bert.BASE
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feeds, _, loss = bert.build_pretrain(cfg, seq_len=SEQ)
        fluid.optimizer.Adam(learning_rate=LR,
                             epsilon=EPSILON).minimize(loss)
    return cfg, main, startup, feeds, loss


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


# ------------------------------------------------------------ phase 5
def snapshot(scope, names):
    return {n: scope.find_var(n).detach().clone() for n in names}


def train(prog, seed):
    """BERT-base pretraining steps on CUDAPlace(0); returns what the
    timings need."""
    cfg, main, startup, feeds, loss = prog
    n_attn = sum(op.type == 'fused_multihead_attention'
                 for op in main.global_block().ops)
    n_adam = sum(op.type == 'adam' for op in main.global_block().ops)
    params = main.all_parameters()
    log('  BERT-base pretraining program: %d ops (%d adam), %d parameters '
        '(%d elements)' % (len(main.global_block().ops), n_adam,
                           len(params),
                           sum(int(np.prod(p.shape)) for p in params)))
    batch = bert.synthetic_batch(cfg, TRAIN_BATCH, SEQ,
                                 np.random.RandomState(seed))
    state_names = weights.startup_names(startup)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    expected = {k: 0 for k in common.KERNELS}
    expected.update({'flash_attention': n_attn,
                     'flash_attention_bwd': n_attn,
                     'embedding_lookup': 3, 'embedding_scatter_add': 3,
                     'fused_adam': 1})
    # gradients fetched beside the loss on step 1, held against the
    # plain path
    grad_map = main._grad_name_map
    probe = ['embedding_0.w_0', 'fc_0.w_0', 'fc_0.w_1', 'layer_norm_0.w_0']
    probe += [p.name for p in params if p.shape == (cfg.hidden,
                                                    cfg.vocab_size)]
    fetch = [loss.name] + [grad_map[p] for p in probe]
    launches = {k: 0 for k in common.KERNELS}
    losses, secs = [], []
    with fluid.scope_guard(scope):
        exe.run(startup)
        start = snapshot(scope, state_names)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for step in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            out, counts = counted(lambda: exe.run(
                main, feed=batch, fetch_list=fetch if step == 0 else [loss],
                return_numpy=False))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(out[0]))
            if step == 0:
                grads = [g.clone() for g in out[1:]]
                after1 = snapshot(scope, state_names)
            for k, c in counts.items():
                launches[k] += c
            log('  step %d: loss %.6f, %.1f ms, launches %s'
                % (step + 1, losses[-1], secs[-1] * 1e3,
                   {k: c for k, c in counts.items() if c}))
            if counts != expected:
                raise AssertionError('step %d launched %s, expected %s'
                                     % (step + 1, counts, expected))
        peak = torch.cuda.max_memory_allocated()
    log('  peak device memory over the %d steps: %.2f GiB'
        % (TRAIN_STEPS, peak / 2 ** 30))
    held = held_losses(main, startup, batch, loss, start)
    log('  losses %s; with the parameters held %s'
        % (['%.6f' % x for x in losses], ['%.6f' % x for x in held]))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] or \
            not losses[-1] < held[-1] or \
            not abs(held[0] - losses[0]) <= 1e-6 * abs(losses[0]):
        raise AssertionError('loss %s (held %s): not finite, not falling '
                             'from step 1 to step %d, or not below the '
                             'held run' % (losses, held, TRAIN_STEPS))
    check_plain_step(main, startup, batch, fetch, start, after1, losses[0],
                     grads, probe)
    return {'main': main, 'exe': exe, 'scope': scope, 'batch': batch,
            'loss': loss, 'launches': launches, 'peak': peak}


def held_losses(main, startup, batch, loss, start):
    """The losses of TRAIN_STEPS steps from `start` with the learning
    rate set to 0: the same step numbers, hence the same dropout masks,
    and parameters that do not move."""
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    with fluid.scope_guard(scope):
        without_counting(lambda: exe.run(startup))
        for n, v in start.items():
            scope.set_var(n, torch.zeros_like(v) if n.startswith(
                'learning_rate') else v.clone())
        return [float(without_counting(lambda: exe.run(
            main, feed=batch, fetch_list=[loss]))[0])
            for _ in range(TRAIN_STEPS)]


def check_plain_step(main, startup, batch, fetch, start, after1, loss1,
                     grads, probe):
    """Step 1 again from the same state (a startup run, so the step
    counter matches, then the kernel path's starting values), with every
    kernel's plain version.  The hidden dropout draws from the same
    generator (program seed, op seed, step) and the attention mask from
    the same hash, so both paths compute the same function in another
    summation order: the loss agrees to LOSS_RTOL, the probed gradients
    and every first moment ((1 - beta1) * gradient after one step) to
    GRAD_TOL of their largest magnitude.  A first Adam step moves a
    parameter by lr * g / (|g| + epsilon), which changes by at most
    lr / epsilon times a change of g, so each parameter must agree
    within (lr / epsilon) * max|d moment1| / (1 - beta1), with 5% and
    1e-7 of slack for rounding."""
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    flags.set_flags({'FLAGS_torch_kernels_plain': True})
    try:
        with fluid.scope_guard(scope):
            without_counting(lambda: exe.run(startup))
            for n, v in start.items():
                scope.set_var(n, v.clone())
            out = without_counting(lambda: exe.run(
                main, feed=batch, fetch_list=fetch, return_numpy=False))
            torch.cuda.synchronize()
            got = snapshot(scope, list(start))
    finally:
        flags.set_flags({'FLAGS_torch_kernels_plain': False})
    loss_err = abs(float(out[0]) - loss1) / abs(loss1)
    grad_err = max(max_abs(a, b) / b.abs().max().item()
                   for a, b in zip(grads, out[1:]))
    moment_err, param_ratio = 0.0, 0.0
    for n in start:
        if '_moment1_' not in n:
            continue
        dm = max_abs(after1[n], got[n])
        moment_err = max(moment_err,
                         dm / max(got[n].abs().max().item(), 1e-30))
        p = n.split('_moment1_')[0]
        limit = LR / EPSILON * dm / (1 - 0.9) * 1.05 + 1e-7
        param_ratio = max(param_ratio, max_abs(after1[p], got[p]) / limit)
    log('  step 1 vs the plain path: loss rel %.2e (limit %g), gradients '
        'of %s rel %.2e, first moments rel %.2e (limit %g), parameters at '
        '%.2f of their bound' % (loss_err, LOSS_RTOL, probe, grad_err,
                                 moment_err, GRAD_TOL, param_ratio))
    if not (loss_err <= LOSS_RTOL and grad_err <= GRAD_TOL and
            moment_err <= GRAD_TOL and param_ratio <= 1.0):
        raise AssertionError('the training step disagrees with its plain '
                             'path')


def train_step_ms(run):
    """Median host-clock time of exe.run (the loss fetched to numpy, so
    it ends after the step's last kernel) over TIMED_STEPS steps."""
    secs = []
    with fluid.scope_guard(run['scope']):
        for _ in range(TIMED_STEPS):
            t0 = time.perf_counter()
            run['exe'].run(run['main'], feed=run['batch'],
                           fetch_list=[run['loss']])
            secs.append(time.perf_counter() - t0)
    med = statistics.median(secs) * 1e3
    log('  train step (batch %d, seq %d): median %.2f ms over %d steps %s, '
        '%.0f tokens/s' % (TRAIN_BATCH, SEQ, med, TIMED_STEPS,
                           ['%.2f' % (x * 1e3) for x in secs],
                           TRAIN_BATCH * SEQ / med * 1e3))
    return med


def profile_train(run):
    with fluid.scope_guard(run['scope']):
        events = profile_run('train step', lambda: run['exe'].run(
            run['main'], feed=run['batch'], fetch_list=[run['loss']]))
    log(events.table(sort_by='self_cuda_time_total', row_limit=25))


# ------------------------------------------------------------ phase 6
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


def time_kernels(timer, gen, dev, req, train_batch, launches, max_err,
                 adam_shapes):
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
    # name, kernel, plain, library, bound, whether a CUDA graph can
    # hold the plain version (the others have no host sync)
    calls = [
        ('flash_attention',
         lambda: fa_k.flash_attention_kernel(q, k, v, False, bias),
         lambda: fa_k.flash_attention_plain(q, k, v, False, bias),
         lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
         bound(fa_bytes, fa_flops), True),
        ('flash_attention[dropout]',
         lambda: fa_k.flash_attention_kernel(q, k, v, False, bias, RATE,
                                             seed),
         lambda: fa_k.flash_attention_plain(q, k, v, False, bias, RATE,
                                            seed),
         lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                dropout_p=RATE),
         bound(fa_bytes, fa_flops), True),
        # the bound counts the S recompute and the four products the
        # gradient needs from q, k, v, O, lse and dO
        ('flash_attention_bwd',
         lambda: fa_k.flash_attention_bwd_kernel(q, k, v, bias, o, lse, do,
                                                 None, False, RATE, seed),
         lambda: fa_k.flash_attention_bwd_plain(q, k, v, bias, do, None,
                                                False, RATE, seed),
         sdpa_bwd_call(q, k, v, mask, do),
         bound(4 * (8 * b * t * h * d + b * t + b * h * t),
               10 * b * h * t * t * d), False),
        # the ids are in range here: F.embedding does not clip
        ('embedding_lookup',
         lambda: emb_k.gather_kernel(w, ids),
         lambda: emb_k.gather_plain(w, ids),
         lambda: F.embedding(ids, w),
         bound(2 * n * 768 * 4 + n * 8, 0), True),
        ('embedding_scatter_add',
         lambda: emb_k.scatter_add_kernel(30522, src, g),
         lambda: emb_k.scatter_add_plain(30522, src, g),
         lambda: torch.zeros(30522, 768, device=dev).index_add_(0, src, g),
         bound(src.numel() * (768 * 4 + 8) + 30522 * 768 * 4, 0), False),
        ('fused_adam',
         lambda: opt_k.launch('adam', table, blocks, adam_attrs),
         lambda: opt_k.apply_plain('adam', None, ins, adam_attrs),
         lib_adam.step,
         bound(28 * n_adam + 12 * len(adam_shapes), 0), True),
    ]
    rows = []
    for name, kernel, plain, library, bnd, graph in calls:
        base = name.split('[')[0]
        info = common.KERNELS[base]
        ms = timer.ms(kernel)
        plain_ms = timer.ms(plain, graph=graph)
        library_ms = timer.ms(library)
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
            '%.4f ms  bound %.4f ms (%s)' % (
                name, ms, plain_ms, '' if graph else ' (events)',
                library_ms, row['bound_ms'], row['bound_by']))
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
    prog = pretrain_program(args.seed)
    adam_shapes = [tuple(p.shape) for p in sorted(
        prog[1].all_parameters(), key=lambda p: p.name)]
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
    }

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

    log('[5] BERT-base pretraining steps on CUDAPlace(0)')
    run = train(prog, args.seed)
    train_launches = run['launches']
    log('  launches on the %d steps: %s' % (
        TRAIN_STEPS, {k: c for k, c in train_launches.items() if c}))
    # serving runs flash_attention without dropout, training with it
    launches = {
        'flash_attention': serve_launches['flash_attention'],
        'flash_attention[dropout]': train_launches['flash_attention'],
        'flash_attention_bwd': train_launches['flash_attention_bwd'],
        'embedding_lookup': (serve_launches['embedding_lookup'] +
                             train_launches['embedding_lookup']),
        'embedding_scatter_add': train_launches['embedding_scatter_add'],
        'fused_adam': train_launches['fused_adam'],
    }

    log('[6] timings at the main path\'s shapes (%s | %s)' % (
        torch.cuda.get_device_name(0), card))
    timer = Timer(dev)
    rows = without_counting(lambda: time_kernels(
        timer, gen, dev, requests[-1], run['batch'], launches, max_err,
        adam_shapes))
    without_counting(lambda: request_latency(pred, requests))
    without_counting(lambda: train_step_ms(run))
    if args.profile:
        without_counting(lambda: profile_requests(pred, requests))
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
