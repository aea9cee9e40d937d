#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--profile]

(``--dp-worker`` is the mode in which phase 9 runs this script on each
data-parallel rank through the port's launcher; it is not for callers.)

The Programs' random seed is N + 1 (fluid reads 0 as unseeded), so a
run's weights, batches and dropout masks are a function of N.

Phases, each of which fails the run (non-zero exit) on error:
  1. environment: torch/CUDA versions, the card's name and power limit;
  2. build: every CUDA kernel from paddle_tpu_torch/ops/kernels/csrc,
     one nvcc per source, all started together;
  3. kernel parity on the card, each kernel against its plain PyTorch
     version on the same inputs (TF32 off):
       flash_attention at the BERT-base shape B=8 H=12 T=512 D=64 f32
       with a 0/-10000 padding bias, a ragged T=200 case, a causal
       case, D = 32 and 128, one query (T=1) and one key past a tile
       (T=65) (O and lse, atol 1e-4: f32-accurate 3xTF32 products and
       sums over up to 512 keys in another order), bf16 at D = 32, 64
       and 128 (O bitwise the kernel's f32 output on the same values
       rounded to bf16, lse bitwise the f32 launch's and within 1e-4
       of the plain); with attention dropout 0.1 at B=8 H=12 T=512 and
       at a ragged T=300 with D = 32, 64 and 128, and with fully masked
       rows (O exactly 0, lse log(1e-20)) (O and lse, atol 1e-4), and
       its keep mask read back from the kernel bitwise against the
       plain hash at the first two shapes; every case launched twice,
       the second launch bitwise the first;
       flash_attention_bwd (dQ, dK, dV, and the key-bias cotangent in
       six cases; D = 32, 64 and 128, ragged T, causal, dropout, bf16,
       fully masked rows) against autograd of the plain forward with the
       same mask, max|diff| <= 1e-4 * max(1, max|plain|) (bf16: bitwise
       the f32 path on the same values rounded to bf16, and within 2e-2
       of the plain), and a second launch from the same inputs bitwise
       the first;
       embedding_lookup on a 30522 x 768 table with 4096 ids,
       duplicates and out-of-range ids included (bitwise);
       embedding_scatter_add on the 30522 x 768, 512 x 768 and 2 x 768
       tables with 4096 ids each, all of them on row 0 of the 2-row
       table, a run of 1500 starting at sorted position 37, D = 16, 100
       and 1, one id, and 12,288 int32 ids (bitwise);
       embedding_lookup and embedding_scatter_add on the Transformer's
       10,000 x 512 table at phase 11's 4096 source ids, padding ids 0
       among them (bitwise);
       fused_adam over the 153 parameters of BERT-base pretraining
       (~132M f32 elements), an AdamW run and LeNet-5's 6 parameters:
       parameters and moments bitwise (the library is built with --fmad=false, so it rounds
       every operation as the plain version's separate kernels do);
       and, Adam and AdamW, views at element offsets 1, 2 and 3 (one
       tensor's four streams at different offsets among them), sizes
       1, 3, 5, 8191 and 8193, and a run of 200 tiny tensors, each
       tensor with its own learning rate and beta powers, one counted
       launch a run (bitwise);
       fused_lamb over the same 153 tensors plus a zero-gradient tensor
       without decay and a [1] tensor: moments bitwise, parameters to
       rtol 2e-6 / atol 3e-7 (the trust ratio's norms are summed in
       another order), and a second launch from the same state gives
       the same parameters bit for bit (fixed-order sums, no atomics);
       embedding_update (the sparse Adagrad rows) through the
       fused_emb_update op on the 1000001 x 16 table with 106,496
       uniform ids, on the 1000 x 16 table with the same ids (~106
       visits a row) and on a 1000001 x 1 table, padding_idx and
       out-of-range ids included, and on the 1000001 x 16 table with
       one id, 8192 equal ids and 2**20 + 7 uniform ids (bitwise);
       quant_quantize and quant_reduce (K8) at the shapes 2-rank
       BERT-base training gives them: the 30522 x 768 table gradient
       (quantize [91566, 256], reduce [2, 45783, 256]), a 768 x 3072
       gradient ([9216, 256], [2, 4608, 256]), the fused bucket of the
       101 small gradients (124,418 elements padded to 124,928) and
       block 64 on an unaligned size; the reduce also at blocks 8, 9,
       200, 256, 1024 and 4096, n = 1, 2, 3 and 8, one row and 37 rows
       with an all-zero row and a row whose absmax is its last element,
       and shards at byte 1 of their buffer (bitwise);
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
     call at the main path's shapes (K8 at the table gradient's; its
     768 x 3072 shape beside it) (device time of CUDA-graph replays,
     L2 flushed before each call; a plain version that syncs with the
     host is timed with CUDA events around single calls instead), the
     least time the card could take (bound; for K1 and K2 with their
     products as f32-accurate 3xTF32 products on the tensor cores, the
     f32-pipe bound beside it; K1's, K4's and K8's reduce rows also
     print the time before their redesign), K4 also at LeNet-5's 6
     tensors (a row of its own, fused_adam[lenet]), K6b also on the 2-row
     sentence table (a row of its own) and split into its sort, its
     zeroing and its
     passes on both tables, K7 also on the 1000001 x 1 table (a row of
     its own), the 1000 x 16 table and a 64 x 16 table whose 8192 ids
     all but six are 0 (one run of 8187), and split into its sort and
     its run kernels on the three Wide&Deep tables, K6b past its
     one-block sort (16,384 and 65,536 ids on the word table, beside
     index_add_, bitwise its plain version), K6 and K6b on the
     Transformer's 10,000 x 512 table at phase 11's source ids (rows of
     their own, embedding_lookup[nmt] and embedding_scatter_add[nmt]),
     the crossover of the naive attention chain (the port's lowerings,
     autograd for its backward) and K1 (forward) and K1 + K2 (forward
     and backward) on BERT-base's attention at seq 128, 256 and 512
     with 4096 tokens each (no dropout, a padding bias; the two routes'
     outputs within 1e-4), the request latency per batch size and the
     median step of each training path, with the garbage collections
     and allocator retries of each timed step.  The library call for
     the flash backward is
     SDPA's memory-efficient backward op on its own forward's saved
     outputs; for the row update (deep and wide tables),
     torch.optim.Adagrad's step on a sparse gradient; PyTorch has no
     LAMB and no block-scaled int8 quantize (null; phase 9 times the
     dense collective on the same payload as K8's collective-level
     yardstick);
  9. data-parallel training: this script again on 2 ranks through
     ``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2``
     (one card a rank over NCCL where the machine has two cards or
     more, else both ranks on card 0 over gloo, the wire staged through
     host memory).  Each rank builds phase 5's program, rewrites it with
     GradAllReduce over the 2 endpoints with FLAGS_comms_quantize on
     and trains 3 steps of batch 8 on data from --seed + rank.  Each
     step must launch K8's quantize and reduce once for every planned
     collective the transpiled program holds whose arm is 'quant' (53
     at BERT-base), and the other kernels as in phase 5; after every
     step the ranks' parameters are bitwise equal; the loss at step 3
     is below the held run's; step 1's all-reduced gradients of the
     quantized arm lie within the quantization bound of the dense
     arm's (per block, sum_r s_r / 2 + s_red / 2); one quantized
     all-reduce of the table gradient is bitwise its plain path's.
     Each rank's step medians with the arm on and off, its peak device
     memory and the collective times (quantized, flat dense, the
     planner's dense rs_ag) of the table gradient are printed; a rank
     that fails fails the phase;
 10. image classification on CUDAPlace(0): LeNet-5 (models.lenet, batch
     64 of synthetic MNIST from --seed) with fluid.optimizer.Adam(1e-3)
     and with SGD(0.01), 3 steps and 5 timed steps each: every Adam step
     launches fused_adam once (8 in all) and every SGD step nothing; the
     loss falls; metrics.Accuracy accumulates the fetched accuracy; step
     1 again with the plain versions agrees (loss rel 1e-4, gradients
     and Adam's moments or SGD's parameter changes rel 1e-3); peak
     memory and a profiled step's device time are printed.  ResNet-50
     (models.resnet, full depth and width, 1000 classes) at batch 128
     of 3 x 224 x 224 f32 NCHW images from --seed with Momentum(0.1,
     0.9) and L2Decay(1e-4): 3 steps and 5 timed, no kernel of the port
     launched; step ms, images/s, the device time of
     a profiled step and the peak memory are printed; every moving mean
     and variance changes; its clone(for_test=True) at batch 32 gives
     finite [32, 1000] logits, the same on a second run; step 1 at batch
     4 from the same state on CUDAPlace(0) and on CPUPlace(): the f32
     losses within rel 1e-4, and in float64 the loss and every
     parameter, velocity and moving statistic within 1e-6 of their
     largest (the f32 states' distances from float64 are printed).
     SE-ResNeXt-50 (cardinality 32) at batch 32, the same optimizer, 3
     steps: finite losses, every moving statistic updated, step ms, a
     profiled step's device time and peak memory printed.  Convolutions
     run in f32 on cuDNN whatever torch.backends.cudnn.allow_tf32 says;
 11. the attention chain below flash_min_len on CUDAPlace(0): BERT-base
     built by build_pretrain(BASE, 128, is_test=True), saved and served
     through create_paddle_predictor at batches 1, 8 and 32 (buckets 1,
     8, 32): each request launches embedding_lookup 3 times and no
     flash kernel, the batch-8 answer within 1e-3 of the plain path;
     BERT-base pretraining at seq 128 with Adam as in phase 5 at batch
     32 (4096 tokens), each step launching embedding_lookup 3 times,
     embedding_scatter_add 3 and fused_adam once, the loss checks and
     step 1 against the plain path of phase 5; Transformer-base NMT
     (models.transformer BASE: d_model 512, 8 heads, ffn 2048, 6 + 6
     layers, vocabularies of 10,000, dropout 0.1, label smoothing 0.1)
     with Adam(1e-4, epsilon 1e-6) at batch 64 of 64 x 64 ragged,
     bucket-padded pairs, 3 steps, each launching embedding_lookup 2
     times, embedding_scatter_add 2 and fused_adam once, with the same
     checks, then one step of a 32 x 32 batch on the same Program (its
     launches, a finite loss, and the loss, gradients and moments
     against the plain path); every path's latency or step time and
     rate, peak memory and a profiled request or step (its device time
     and 10 largest kernels) are printed.  f32 products run without
     TF32 whatever torch.backends.cuda.matmul.allow_tf32 says.
The line before the last is a JSON object {"kernels": [...]}: a row
that times one table of a kernel (embedding_scatter_add[2-row],
embedding_update[wide], embedding_lookup[nmt],
embedding_scatter_add[nmt]) counts the main path's launches on that
table,
its kernel's row those on the kernel's other tables; fused_adam counts
all of K4's launches (BERT-base Adam's and LeNet-5's) and
fused_adam[lenet] LeNet-5's; a row with no launch fails the run.  The last is {"ok": true, "device": {...}}.
--profile adds a torch.profiler breakdown of one request of each batch
size, of one step of each training path, of one data-parallel step of
each arm and of one ResNet-50 step.
"""

import argparse
import gc
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.dataset import mnist
from paddle_tpu_torch.fluid import core, flags, metrics
from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.models import lenet
from paddle_tpu_torch.models import resnet
from paddle_tpu_torch.models import se_resnext
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.models import wide_deep
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.ops.kernels import common
from paddle_tpu_torch.ops.kernels import embedding as emb_k
from paddle_tpu_torch.ops.kernels import flash_attention as fa_k
from paddle_tpu_torch.ops.kernels import fused_optimizer as opt_k
from paddle_tpu_torch.ops.kernels import quant_collective as qc_k

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
# the tensor cores, TF32 FLOP/s on them (an f32-accurate product costs
# three TF32 products: the 3xTF32 split)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
FA_TOL = 1e-4
# times before a redesign (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md's
# kernel table), printed beside the rows of phase 8: K1 when both
# products ran as scalar f32 FMAs, K4 with scalar loads, K8's reduce
# with a warp a row and one byte a lane
BEFORE_MS = {'flash_attention': ('the scalar-FMA K1', 0.4120),
             'flash_attention[dropout]': ('the scalar-FMA K1', 0.4141),
             'fused_adam': ('the scalar-load K4', 1.4078),
             'quant_reduce': ('the warp-a-row reduce', 0.0795),
             'embedding_update': ('K7 after torch.sort', 0.1390),
             'embedding_update[wide]': ('K7 after torch.sort', 0.0972),
             'embedding_update[1000-row]': ('K7 after torch.sort', 0.1126)}
BWD_TOL = 1e-4
FA_BF16_TOL = 2e-2  # tests/test_torch_cuda_flash_attention.py's bf16 limit
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
# data-parallel training (phase 9): ranks, K8's block, the time limit
DP_RANKS = 2
QUANT_BLOCK = 256
DP_TIMEOUT_S = 600
TABLE_NUMEL = 30522 * 768
# image classification (phase 10): LeNet-5 at the batch and rates of the
# reference's test_recognize_digits.py (SGD at 0.01); ResNet-50 as the
# JAX package's bench.py trains it (batch 128, Momentum 0.1 / 0.9, uniform
# [0, 1) images) with the reference ResNet recipe's L2Decay(1e-4);
# SE-ResNeXt-50 (cardinality 32) at batch 32 with the same optimizer
LENET_BATCH = 64
LENET_LR = {'adam': 1e-3, 'sgd': 0.01}
LENET_ADAM = {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8}  # Adam(1e-3)'s
IMAGE_CLASSES = 1000
RESNET_BATCH = 128
RESNET_EVAL_BATCH = 32
RESNET_CPU_BATCH = 4
SE_BATCH = 32
IMAGE_LR = 0.1
IMAGE_MOMENTUM = 0.9
IMAGE_DECAY = 1e-4
# ResNet-50's float64 step 1 on the card against the CPU's, relative
# to each variable's largest magnitude (see check_card_against_cpu)
F64_TOL = 1e-6
# K6b past its one-block sort (SORT_MAX ids): a batch of 32 and of 128
# at seq 512 on the word table
SCATTER_BIG_IDS = (16384, 65536)
# the attention chain below flash_min_len (phase 11): BERT-base served
# and trained at seq 128, the length of its main pretraining phase
# (Devlin et al. 2019), training at batch 32 (4096 tokens, as the seq-512
# path's batch 8); Transformer-base (Vaswani et al. 2017) at batch 64 of
# 64 x 64 (4096 target tokens, the reference's token batches), then one
# step of the 32 bucket, Adam at 1e-4 (a rate at which 3 steps show
# through the dropout noise)
SHORT_SEQ = 128
SHORT_BATCHES = (1, 8, 32)
SHORT_TRAIN_BATCH = 32
NMT_BATCH = 64
NMT_LEN = 64
NMT_BUCKET = 32
NMT_LR = 1e-4
NMT_ROWS = 10000
# phase 8's crossover of the naive chain and K1 + K2 on BERT-base's
# attention: 4096 tokens at each length
CROSSOVER_SEQS = (128, 256, 512)
CROSSOVER_TOKENS = 4096


START = time.perf_counter()


def log(*args):
    """print, flushed; a phase's first line ('[N] ...') also says when
    it started, in seconds since the script began."""
    if args and str(args[0]).startswith('['):
        args = args + ('(at %.1f s)' % (time.perf_counter() - START),)
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


# rows of the kernels line that time one table of a kernel: the
# kernel's wrapper and which of its calls are on that table
TABLE_ROWS = {
    'embedding_scatter_add[2-row]': ('scatter_add_kernel',
                                     lambda nrows, ids, g: nrows == 2),
    'embedding_update[wide]': ('update_kernel',
                               lambda w, *rest: w.shape[1] == 1),
    # the Transformer's 10,000 x 512 source and target tables
    'embedding_lookup[nmt]': ('gather_kernel',
                              lambda w, ids: w.shape[0] == NMT_ROWS),
    'embedding_scatter_add[nmt]': ('scatter_add_kernel',
                                   lambda nrows, ids, g: nrows == NMT_ROWS)}
# the launches counted() saw on those tables
TABLE_LAUNCHES = dict.fromkeys(TABLE_ROWS, 0)


def on_table(row, kernel, pick):
    """kernel, adding to TABLE_LAUNCHES[row] what its launch counter
    gains in each call that pick() puts on that row's table."""
    base = row.split('[')[0]

    def call(*args):
        before = common.launches(base)
        out = kernel(*args)
        if pick(*args):
            TABLE_LAUNCHES[row] += common.launches(base) - before
        return out
    return call


def counted(fn):
    """(fn(), launches per kernel during it): the counters are set to 0
    just before and read just after.  Meanwhile the launches on the
    tables of TABLE_ROWS are added to TABLE_LAUNCHES."""
    common.reset_launches()
    kernels = {name: getattr(emb_k, name) for name, _ in TABLE_ROWS.values()}
    # a kernel with rows on two tables is wrapped twice
    for row, (name, pick) in TABLE_ROWS.items():
        setattr(emb_k, name, on_table(row, getattr(emb_k, name), pick))
    try:
        out = fn()
    finally:
        for name, kernel in kernels.items():
            setattr(emb_k, name, kernel)
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


def flash_twice(q, k, v, causal, bias, rate=0.0, seed=None):
    """K1's (O, lse), launched twice from the same inputs: the second
    launch must give the first's bits."""
    o, lse = fa_k.flash_attention_kernel(q, k, v, causal, bias, rate, seed)
    o2, lse2 = fa_k.flash_attention_kernel(q, k, v, causal, bias, rate,
                                           seed)
    torch.cuda.synchronize()
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError('flash_attention: a second launch from the '
                             'same inputs gave other bits')
    return o, lse


def check_flash(gen, dev):
    """K1 without dropout against its plain version: O and lse within
    FA_TOL, and a second launch bitwise the first.  bf16: O bitwise the
    kernel's own f32 output on the same values upcast, rounded to bf16
    (the bf16 path only converts at load and store), lse bitwise the
    f32 launch's and within FA_TOL of the plain version."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [('serving B8 H12 T512 D64', 8, 512, 12, 64, False, True, f32),
             ('ragged B2 H4 T200 D64', 2, 200, 4, 64, False, True, f32),
             ('causal ragged B2 H4 T300 D128', 2, 300, 4, 128, True, True,
              f32),
             ('no bias B1 H2 T64 D32', 1, 64, 2, 32, False, False, f32),
             ('one query B2 H4 T1 D64', 2, 1, 4, 64, False, True, f32),
             ('a key past a tile B2 H4 T65 D64', 2, 65, 4, 64, False, True,
              f32),
             ('bf16 ragged B2 H4 T300 D32', 2, 300, 4, 32, False, True,
              bf16),
             ('bf16 B2 H4 T512 D64', 2, 512, 4, 64, False, True, bf16),
             ('bf16 causal ragged B2 H4 T300 D128', 2, 300, 4, 128, True,
              True, bf16)]
    worst = 0.0
    for name, b, t, h, d, causal, with_bias, dtype in cases:
        q, k, v = [x.to(dtype) for x in qkv_views(gen, b, t, h, d, dev)]
        bias = padding_bias(gen, b, t, dev) if with_bias else None
        o, lse = flash_twice(q, k, v, causal, bias)
        po, plse = fa_k.flash_attention_plain(q, k, v, causal, bias)
        note = ''
        if dtype == bf16:
            fo, flse = fa_k.flash_attention_kernel(
                q.float(), k.float(), v.float(), causal, bias)
            torch.cuda.synchronize()
            if not (torch.equal(o, fo.to(bf16)) and torch.equal(lse, flse)):
                raise AssertionError('flash_attention %s: not the f32 path '
                                     'rounded' % name)
            note = '; bitwise the f32 path rounded'
        eo, el = max_abs(o, po), max_abs(lse, plse)
        log('  flash_attention %-36s max|dO| %.3e%s max|dlse| %.3e (limit '
            '%g); 2nd launch bitwise%s'
            % (name, eo, ' (bf16 O, held bitwise)' if dtype == bf16 else '',
               el, FA_TOL, note))
        if not (el <= FA_TOL and (dtype == bf16 or eo <= FA_TOL)):
            raise AssertionError('flash_attention %s disagrees with its '
                                 'plain version' % name)
        worst = max(worst, el, 0.0 if dtype == bf16 else eo)
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
    """K1 with attention dropout against its plain version (the same
    hash): O and lse within FA_TOL, a second launch bitwise the first,
    and at the first two shapes the keep mask read back from the kernel
    bitwise the plain hash.  'masked': batch 0's keys all -inf, whose
    rows give O = 0 exactly and lse = log(1e-20)."""
    seed = 0x9E3779B9 ^ 12345
    worst = 0.0
    for name, b, t, h, d, readback, masked in (
            ('B8 H12 T512 D64', 8, 512, 12, 64, True, False),
            ('ragged B2 H4 T300 D64', 2, 300, 4, 64, True, False),
            ('ragged B2 H4 T300 D32', 2, 300, 4, 32, False, False),
            ('ragged B2 H4 T300 D128', 2, 300, 4, 128, False, False),
            ('masked B2 H4 T200 D64', 2, 200, 4, 64, False, True)):
        q, k, v = qkv_views(gen, b, t, h, d, dev)
        bias = padding_bias(gen, b, t, dev)
        if masked:
            bias[0] = float('-inf')
        o, lse = flash_twice(q, k, v, False, bias, RATE, seed)
        po, plse = fa_k.flash_attention_plain(q, k, v, False, bias, RATE,
                                              seed)
        eo, el = max_abs(o, po), max_abs(lse, plse)
        ok = eo <= FA_TOL and el <= FA_TOL
        note = ''
        if readback:
            keep = kernel_keep_mask(b, h, t, seed, dev)
            want = fa_k.dropout_keep_plain(seed, b, h, t, t, RATE, dev)
            torch.cuda.synchronize()
            same = torch.equal(keep, want)
            ok = ok and same
            note = ', keep mask bitwise %s (keep rate %.4f)' % (
                same, keep.float().mean().item())
        if masked:
            zero = o[0].abs().max().item() == 0.0
            lse_err = (lse[0] - math.log(1e-20)).abs().max().item()
            ok = ok and zero and lse_err <= FA_TOL
            note = ', masked rows: O exactly 0 %s, max|lse - log(1e-20)| ' \
                   '%.3e' % (zero, lse_err)
        log('  flash_attention dropout %.1f %-22s max|dO| %.3e max|dlse| '
            '%.3e (limit %g)%s, 2nd launch bitwise'
            % (RATE, name, eo, el, FA_TOL, note))
        if not ok:
            raise AssertionError('flash_attention with dropout %s disagrees '
                                 'with its plain version' % name)
        worst = max(worst, eo, el)
    return worst


def check_flash_bwd(gen, dev):
    """K2 against autograd of the plain forward, max|diff| <= 1e-4 *
    max(1, max|plain|) for dQ, dK, dV and the bias cotangent, and a second
    launch from the same inputs bitwise the first.  bf16 (whose O reaches
    the backward rounded, while autograd of the plain forward differs
    through the unrounded O): bitwise the f32 kernel on the same values
    with its gradients rounded to bf16 (the bf16 path only converts at
    load and store), and within K1's bf16 limit, 2e-2 * max(1,
    max|plain|), of the plain backward in f32.  'masked': batch 0's keys
    all -inf (fully masked rows, whose gradients are 0)."""
    cases = [('B8 H12 T512 D64 dropout', 8, 512, 12, 64, False, RATE, False,
              None),
             ('ragged B2 H4 T300 D64 dropout dbias+dlse', 2, 300, 4, 64,
              False, RATE, True, None),
             ('causal B2 H4 T200 D128 dbias', 2, 200, 4, 128, True, 0.0,
              True, None),
             ('B1 H2 T64 D32', 1, 64, 2, 32, False, 0.0, False, None),
             ('B2 H4 T512 D128 dropout dbias+dlse', 2, 512, 4, 128, False,
              RATE, True, None),
             ('ragged B2 H3 T300 D32 dropout dbias+dlse', 2, 300, 3, 32,
              False, RATE, True, None),
             ('bf16 ragged B2 H4 T300 D64 dropout dbias', 2, 300, 4, 64,
              False, RATE, True, 'bf16'),
             ('masked B2 H4 T200 D64 dbias+dlse', 2, 200, 4, 64, False, 0.0,
              True, 'masked')]
    worst = 0.0
    for name, b, t, h, d, causal, rate, with_grads, kind in cases:
        seed = 77 + t
        dtype = torch.bfloat16 if kind == 'bf16' else torch.float32
        q, k, v = [x.to(dtype) for x in qkv_views(gen, b, t, h, d, dev)]
        bias = padding_bias(gen, b, t, dev)
        if kind == 'masked':
            bias[0] = float('-inf')
        do = torch.randn(b, t, h, d, generator=gen, device=dev).to(dtype)
        dlse = (torch.randn(b, h, t, generator=gen, device=dev)
                if with_grads else None)
        o, lse = fa_k.flash_attention_kernel(q, k, v, causal, bias, rate,
                                             seed)
        got, again = [fa_k.flash_attention_bwd_kernel(
            q, k, v, bias, o, lse, do, dlse, causal, rate, seed,
            bias_grad=with_grads) for _ in range(2)]
        want = fa_k.flash_attention_bwd_plain(
            q.float(), k.float(), v.float(), bias, do.float(), dlse, causal,
            rate, seed, bias_grad=with_grads)
        f32 = None
        if kind == 'bf16':
            f32 = fa_k.flash_attention_bwd_kernel(
                q.float(), k.float(), v.float(), bias, o.float(), lse,
                do.float(), dlse, causal, rate, seed, bias_grad=with_grads)
        torch.cuda.synchronize()
        errs = []
        for i, (label, g, w, g2) in enumerate(zip(
                ('dQ', 'dK', 'dV', 'dbias'), got, want, again)):
            if w is None:
                continue
            if not torch.equal(g, g2):
                raise AssertionError('flash_attention_bwd %s: a second launch '
                                     'gave another %s' % (name, label))
            if f32 is not None and not torch.equal(g, f32[i].to(g.dtype)):
                raise AssertionError('flash_attention_bwd %s: %s is not the '
                                     'f32 path rounded' % (name, label))
            tol = BWD_TOL if f32 is None else FA_BF16_TOL
            e = max_abs(g, w) / max(1.0, w.abs().max().item())
            errs.append('%s %.2e' % (label, e))
            if not e <= tol:
                raise AssertionError('flash_attention_bwd %s: %s differs '
                                     'from the plain backward by %g'
                                     % (name, label, e))
            if kind is None:
                worst = max(worst, max_abs(g, w))
        log('  flash_attention_bwd %-42s %s; 2nd launch bitwise%s'
            % (name, ', '.join(errs), '' if f32 is None else
               '; bitwise the f32 path rounded to bf16'))
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
    """K6b bitwise against its plain version: BERT's three tables at the
    main path's 4096 ids (word with duplicates and out-of-range ids,
    positions, the 2-row sentence table with every id on row 0), a run
    of 1500 that starts mid-chunk (sorted position 37 onward) over many
    128-row stages, D = 16, 100 and 1 with long and short runs, one id,
    and 12,288 int32 ids (past the kernel's one-block sort: torch.sort)."""
    n, d = TRAIN_BATCH * SEQ, 768
    word = torch.randint(0, 30522, (n,), generator=gen, device=dev)
    word[:8] = torch.tensor([7, 7, 7, 30521, -1, -500, 30522, 7], device=dev)
    mid = torch.randint(0, 7, (3000,), generator=gen, device=dev)
    mid[37:1537] = 7
    mid[1537:] = torch.randint(8, 50, (1463,), generator=gen, device=dev)

    def skewed(rows, m):
        ids = torch.randint(0, rows, (m,), generator=gen, device=dev)
        ids[5:900] = 3
        return ids

    cases = [('30522 x 768', 30522, word, d),
             ('512 x 768 positions', SEQ,
              torch.arange(SEQ, device=dev).repeat(TRAIN_BATCH), d),
             ('2 x 768 sentence', 2, torch.zeros(n, dtype=torch.int64,
                                                 device=dev), d),
             ('50 x 768, run of 1500 from sorted position 37', 50, mid, d),
             ('40 x 16 skewed', 40, skewed(40, 2000), 16),
             ('40 x 100 skewed', 40, skewed(40, 2000), 100),
             ('41 x 1 skewed', 41, skewed(41, 2000), 1),
             ('10 x 768, one id', 10, torch.tensor([4], device=dev), d),
             ('1000 x 64, 12288 int32 ids', 1000, torch.randint(
                 -5, 1005, (12288,), generator=gen, device=dev).to(
                     torch.int32), 64)]
    for name, rows, ids, width in cases:
        g = torch.randn(ids.numel(), width, generator=gen, device=dev)
        got = emb_k.scatter_add_kernel(rows, ids, g)
        want = emb_k.scatter_add_plain(rows, ids, g)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError('embedding_scatter_add %s is not bitwise '
                                 'equal to its plain version (max|diff| %g)'
                                 % (name, max_abs(got, want)))
        log('  embedding_scatter_add %-46s %5d ids: bitwise equal'
            % (name, ids.numel()))
    return 0.0


def nmt_ids(seed, length=NMT_LEN):
    """The source ids of phase 11's Transformer batch ([NMT_BATCH,
    length], ragged rows padded with id 0), flattened."""
    batch = transformer.synthetic_batch(
        transformer.BASE, NMT_BATCH, length, length,
        np.random.RandomState(seed))
    return torch.from_numpy(batch['src_ids']).reshape(-1)


def check_nmt_tables(gen, dev, seed):
    """K6 and K6b bitwise against their plain versions on the
    Transformer's 10,000 x 512 table at the ids of phase 11's batch
    (4096, a run of padding ids 0 among them)."""
    ids = nmt_ids(seed).to(dev)
    w = torch.randn(NMT_ROWS, 512, generator=gen, device=dev)
    g = torch.randn(ids.numel(), 512, generator=gen, device=dev)
    for name, got, want in (
            ('embedding_lookup', emb_k.gather_kernel(w, ids),
             emb_k.gather_plain(w, ids)),
            ('embedding_scatter_add',
             emb_k.scatter_add_kernel(NMT_ROWS, ids, g),
             emb_k.scatter_add_plain(NMT_ROWS, ids, g))):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError('%s on the 10000 x 512 table is not bitwise '
                                 'equal to its plain version' % name)
        log('  %-22s 10000 x 512, %d ids (%d padding): bitwise equal'
            % (name, ids.numel(), int((ids == 0).sum())))
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


def check_adam(gen, dev, shapes, lenet_shapes):
    for kind, attrs, subset in (
            ('adam', {'beta1': 0.9, 'beta2': 0.999, 'epsilon': EPSILON},
             shapes),
            ('adamw', {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8,
                       'coeff': 0.01}, shapes[:9]),
            ('adam', LENET_ADAM, lenet_shapes)):
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
    check_adam_edges(gen, dev)
    return 0.0


def offset_view(x, offset):
    """x copied into a contiguous view at element `offset` of a larger
    buffer."""
    buf = torch.zeros(x.numel() + 4, dtype=x.dtype, device=x.device)
    out = buf[offset:offset + x.numel()]
    out.copy_(x)
    return out


def check_adam_edges(gen, dev):
    """K4's design edges, Adam and AdamW, each run one counted launch
    bitwise the per-tensor lowering: views at element offsets 1, 2 and
    3 (all four streams, and one tensor's streams at different offsets),
    sizes 1, 3, 5, 8191 and 8193, a run of 200 tiny tensors; every
    tensor with its own learning rate and beta powers."""
    aligned = (0, 0, 0, 0)
    cases = [('views at offsets 1-3', [5000, 8193, 3, 8191, 30522, 1],
              [(1, 1, 1, 1), (2, 2, 2, 2), (3, 3, 3, 3), (1, 0, 2, 3)]),
             ('sizes 1-8193', [1, 3, 5, 8191, 8193], [aligned]),
             ('200 tiny tensors', [1 + (7 * i) % 40 for i in range(200)],
              [aligned, (1, 1, 1, 1), aligned, (3, 0, 3, 3)])]
    for kind, attrs in (('adam', {'beta1': 0.9, 'beta2': 0.999,
                                  'epsilon': EPSILON}),
                        ('adamw', {'beta1': 0.85, 'beta2': 0.99,
                                   'epsilon': 1e-8, 'coeff': 0.02})):
        for name, sizes, offsets in cases:
            ins = {k: [] for k in ('Param', 'Grad', 'Moment1', 'Moment2',
                                   'LearningRate', 'Beta1Pow', 'Beta2Pow')}
            for i, n in enumerate(sizes):
                vals = (torch.randn(n, generator=gen, device=dev),
                        torch.randn(n, generator=gen, device=dev) * 1e-2,
                        torch.randn(n, generator=gen, device=dev) * 1e-3,
                        torch.rand(n, generator=gen, device=dev) * 1e-4)
                for slot, v, o in zip(('Param', 'Grad', 'Moment1',
                                       'Moment2'), vals,
                                      offsets[i % len(offsets)]):
                    ins[slot].append(offset_view(v, o))
                ins['LearningRate'].append(torch.full(
                    (1,), LR * (1 + i % 7), device=dev))
                ins['Beta1Pow'].append(torch.full((1,), 0.9 ** (i + 1),
                                                  device=dev))
                ins['Beta2Pow'].append(torch.full((1,), 0.999 ** (i + 1),
                                                  device=dev))
            want = opt_k.apply_plain(kind, None, ins, attrs)
            before = common.launches('fused_adam')
            opt_k.apply_kernel(kind, ins, attrs)  # in place
            torch.cuda.synchronize()
            if common.launches('fused_adam') != before + 1:
                raise AssertionError('fused_adam (%s) launched %d times'
                                     % (name, common.launches('fused_adam')
                                        - before))
            for slot, out in (('Param', 'ParamOut'),
                              ('Moment1', 'Moment1Out'),
                              ('Moment2', 'Moment2Out')):
                for got, w in zip(ins[slot], want[out]):
                    if not torch.equal(got, w):
                        raise AssertionError(
                            'fused_adam (%s, %s) %s is not bitwise equal to '
                            'the per-tensor lowering: max|diff| %g'
                            % (kind, name, slot, max_abs(got, w)))
            log('  fused_adam %-5s %-22s %3d tensors: bitwise equal'
                % (kind, name, len(sizes)))


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
    # one id, one run of 8192 (the long-run kernel) and past 2**20 ids
    for name, ids in (('one id', torch.tensor([WD_ROWS - 1], device=dev)),
                      ('8192 equal ids', torch.full((8192,), 4242,
                                                    device=dev)),
                      ('2**20 + 7 uniform ids', torch.randint(
                          0, WD_ROWS, (2 ** 20 + 7,), generator=gen,
                          device=dev))):
        w = torch.randn(WD_ROWS, 16, generator=gen, device=dev)
        m = torch.rand(WD_ROWS, 16, generator=gen, device=dev)
        g = torch.randn(ids.numel(), 16, generator=gen, device=dev)
        lr = torch.full((1,), 0.05, device=dev)
        want = emb_k.update_plain(w, m, ids, g, lr, 1e-6)
        emb_k.update_kernel(w, m, ids, g, lr, 1e-6)  # in place
        torch.cuda.synchronize()
        if not (torch.equal(w, want[0]) and torch.equal(m, want[1])):
            raise AssertionError('embedding_update on %d x 16, %s, is not '
                                 'bitwise equal to its plain version: '
                                 'max|diff| %g' % (WD_ROWS, name, max(
                                     max_abs(w, want[0]),
                                     max_abs(m, want[1]))))
        log('  embedding_update %7d x 16, %s: bitwise equal'
            % (WD_ROWS, name))
    return 0.0


def quant_rows(x, n, block):
    """x flat, zero-padded to n chunks of whole blocks: [n * cb, block],
    the layout quant_allreduce quantizes."""
    chunk = -(-x.numel() // n)
    chunk = -(-chunk // block) * block
    return F.pad(x, (0, chunk * n - x.numel())).reshape(-1, block)


def check_quant(gen, dev):
    """K8's quantize and reduce at the 2-rank data-parallel shapes, each
    against its plain version, bitwise."""
    for name, numel, block in (('table 30522x768', TABLE_NUMEL, 256),
                               ('768x3072', 768 * 3072, 256),
                               ('fused bucket', 124418, 256),
                               ('block 64 unaligned', 1000003, 64)):
        n = DP_RANKS
        shards = []
        for _ in range(n):
            x = torch.randn(numel, generator=gen, device=dev) * 1e-3
            x[:2 * block] = 0.0
            x[-block:] *= 1e4
            rows = quant_rows(x, n, block)
            q, sc = qc_k.quantize_kernel(rows)
            pq, ps = qc_k.quantize_plain(rows)
            torch.cuda.synchronize()
            if not (torch.equal(q, pq) and torch.equal(sc, ps)):
                raise AssertionError('quant_quantize (%s) is not bitwise '
                                     'equal to its plain version' % name)
            shards.append((q, sc))
        cb = rows.shape[0] // n
        qt = torch.stack([q.reshape(n, cb, block)[0] for q, _ in shards])
        st = torch.stack([sc.reshape(n, cb, 1)[0] for _, sc in shards])
        qr, sr = qc_k.reduce_kernel(qt, st)
        pqr, psr = qc_k.dequant_reduce_requant_plain(qt, st)
        torch.cuda.synchronize()
        if not (torch.equal(qr, pqr) and torch.equal(sr, psr)):
            raise AssertionError('quant_reduce (%s) is not bitwise equal to '
                                 'its plain version' % name)
        log('  quant_collective %-18s %d elements: quantize %s, reduce %s: '
            'bitwise equal' % (name, numel, list(rows.shape),
                               list(qt.shape)))
    check_reduce_edges(gen, dev)
    return 0.0


def check_reduce_edges(gen, dev):
    """K8's reduce at its design edges against its plain version,
    bitwise: blocks 8, 9, 200, 256, 1024 and 4096 (vectors where rows
    start on 16 bytes, bytes where not; a second read past 256), n = 1,
    2, 3 and 8, one row and 37 rows with an all-zero row and a row whose
    absmax is its last element, and shards at byte 1 of their buffer."""
    cases = 0
    for block in (8, 9, 200, 256, 1024, 4096):
        for n in (1, 2, 3, 8):
            for cb in (1, 37):
                x = torch.randn(n * cb, block, generator=gen, device=dev) * (
                    10.0 ** torch.randint(-3, 2, (n * cb, 1), generator=gen,
                                          device=dev))
                qt, st = qc_k.quantize_plain(x)
                qt, st = qt.reshape(n, cb, block), st.reshape(n, cb, 1)
                if cb > 2:
                    qt[:, 1] = 0
                    st[:, 1] = 1.0
                    qt[:, 2] = qt[:, 2].clamp(-100, 100)
                    qt[:, 2, -1] = 127
                shards = [qt]
                if block == 256:
                    shards.append(offset_view(qt.reshape(-1), 1).view(
                        qt.shape))
                for q in shards:
                    qr, sr = qc_k.reduce_kernel(q, st)
                    pqr, psr = qc_k.dequant_reduce_requant_plain(q, st)
                    torch.cuda.synchronize()
                    if not (torch.equal(qr, pqr) and torch.equal(sr, psr)):
                        raise AssertionError(
                            'quant_reduce [%d, %d, %d] (data at byte %d mod '
                            '16) is not bitwise equal to its plain version'
                            % (n, cb, block, q.data_ptr() % 16))
                    cases += 1
    log('  quant_reduce edges: blocks 8, 9, 200, 256, 1024, 4096 x n = 1, '
        '2, 3, 8 x cb = 1, 37 (zero row, absmax last) and shards off 16 '
        'bytes: %d cases bitwise equal' % cases)


# ------------------------------------------------------------ phase 4
def build_model(model_dir, seed, seq=SEQ, pretrain=False):
    """BERT-base's encoder at `seq` saved as an inference model: built
    with bert_encoder, or (pretrain) by build_pretrain(BASE, seq,
    is_test=True) with the encoder output fetched."""
    cfg = bert.BASE
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if pretrain:
            feeds, enc, _ = bert.build_pretrain(cfg, seq, is_test=True)
            feeds = {n: feeds[n] for n in ('src_ids', 'pos_ids', 'sent_ids',
                                           'input_mask')}
        else:
            feeds = bert.encoder_feeds(seq)
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


def serve(model_dir, cfg, n_attn, n_emb, seed, seq=SEQ, batches=BATCHES):
    """The requests of `batches` at `seq`, each one's launches checked;
    the batch-8 answer against the plain path."""
    config = AnalysisConfig(model_dir)
    pred = create_paddle_predictor(config)
    if pred.place != fluid.CUDAPlace(0):
        raise AssertionError('predictor is on %r' % pred.place)
    rng = np.random.RandomState(seed)
    requests = [bert.encoder_batch(cfg, b, seq, rng, pad_to=seq - 37 * i)
                for i, b in enumerate(batches)]
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
        if out.shape != (b, seq, cfg.hidden) or not np.isfinite(out).all():
            raise AssertionError('request batch %d: bad output' % b)
        if counts != expected:
            raise AssertionError('request batch %d launched %s, expected %s'
                                 % (b, counts, expected))
    # the whole path again with the plain versions, on the card
    i8 = batches.index(8)
    flags.set_flags({'FLAGS_torch_kernels_plain': True})
    try:
        plain = without_counting(
            lambda: pred.run([requests[i8][n] for n in names])[0].data)
    finally:
        flags.set_flags({'FLAGS_torch_kernels_plain': False})
    err = float(np.abs(plain - outs[i8]).max())
    log('  batch 8 vs the plain path on the card: max|diff| %.3e '
        '(limit %g)' % (err, SLICE_TOL))
    if not err <= SLICE_TOL:
        raise AssertionError('the kernel path disagrees with the plain '
                             'path: %g' % err)
    return pred, requests, launches


def device_ms(events):
    """Device time of a profiled call: the sum of its CUDA events' own
    times (ms)."""
    from torch.autograd import DeviceType
    return sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA) / 1e3


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
    dev = device_ms(events)
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
def pretrain_program(seed, optimizer, seq=SEQ, batch=TRAIN_BATCH):
    """BERT-base pretraining with Adam ('adam', phase 5; phase 11 at
    seq 128) or with LAMB, the warmup over a polynomial decay and the
    global-norm clip ('lamb', phase 6): the path dict that train()
    runs."""
    cfg = bert.BASE
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = bert.build_pretrain(cfg, seq_len=seq)
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
    return {'name': 'BERT-base %s%s' % (
                optimizer.upper(), '' if seq == SEQ else ' seq %d' % seq),
            'main': main, 'startup': startup, 'loss': loss, 'lr': lr,
            'batch': bert.synthetic_batch(cfg, batch, seq,
                                          np.random.RandomState(seed)),
            'expected': expected, 'probe': probe, 'tokens': batch * seq,
            'rate': LR, 'bitwise': False}


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
            'tokens': WD_BATCH * cfg.num_sparse_fields, 'rate': WD_LR,
            'bitwise': True}


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
                     grads, rates[0] if path['lr'] else path['rate'])
    return {'path': path, 'exe': exe, 'scope': scope, 'launches': launches,
            'peak': peak, 'rates': rates}


def held_losses(path, start, place=None):
    """The losses of TRAIN_STEPS steps that each start from `start`: the
    same step numbers, hence the same dropout masks, and parameters that
    do not move."""
    exe = fluid.Executor(place or fluid.CUDAPlace(0))
    scope = fluid.Scope()
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


def check_plain_step(path, fetch, start, after1, loss1, grads, lr1,
                     batch=None, step=1):
    """Step 1 (or the step after executor step `step`, on `batch`) again
    from the same state (a startup run and the kernel path's step
    counter, then its starting values), with every kernel's plain
    version.

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
    rate 0, so its parameters must stay within the 1e-7.  A later step
    (lr1 None) holds the loss, the gradients and the moments alone: its
    parameters move by ratios of moments that no bound of this kind
    covers."""
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    flags.set_flags({'FLAGS_torch_kernels_plain': True})
    try:
        with fluid.scope_guard(scope):
            without_counting(lambda: exe.run(path['startup']))
            exe._step = step
            for n, v in start.items():
                scope.set_var(n, v.clone())
            out = without_counting(lambda: exe.run(
                path['main'], feed=path['batch'] if batch is None else batch,
                fetch_list=fetch, return_numpy=False))
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
        if lr1 is not None:
            p = n.split('_moment1_')[0]
            limit = lr1 / EPSILON * dm / (1 - 0.9) * 1.05 + 1e-7
            param_ratio = max(param_ratio,
                              max_abs(after1[p], got[p]) / limit)
    log('  step %s vs the plain path: loss rel %.2e (limit %g), gradients '
        'of %s rel %.2e, first moments rel %.2e (limit %g), %s' % (
            '1' if step == 1 else 'after executor step %d' % step, loss_err,
            LOSS_RTOL, path['probe'], grad_err, moment_err, GRAD_TOL,
            'parameters not bounded' if lr1 is None else
            'parameters at %.2f of their bound' % param_ratio))
    if not (loss_err <= LOSS_RTOL and grad_err <= GRAD_TOL and
            moment_err <= GRAD_TOL and param_ratio <= 1.0):
        raise AssertionError('the training step disagrees with its plain '
                             'path')


def train_step_ms(run):
    """Median host-clock time of exe.run (the loss fetched to numpy, so
    it ends after the step's last kernel) over TIMED_STEPS steps.  Beside
    each step, outside its timing: the garbage collections Python ran
    during it and since the step before (generation, ms; from
    gc.callbacks) and how many times the caching allocator freed its
    cache to retry an allocation during it
    (torch.cuda.memory_stats()['num_alloc_retries'])."""
    path = run['path']
    secs, notes = [], []
    collections, began = [], [0.0]

    def on_gc(phase, info):
        if phase == 'start':
            began[0] = time.perf_counter()
        else:
            collections.append('gen %d %.2f ms' % (
                info['generation'], (time.perf_counter() - began[0]) * 1e3))
    seen = 0
    gc.callbacks.append(on_gc)
    try:
        with fluid.scope_guard(run['scope']):
            for _ in range(TIMED_STEPS):
                retries = torch.cuda.memory_stats().get('num_alloc_retries',
                                                        0)
                before = len(collections)
                t0 = time.perf_counter()
                run['exe'].run(path['main'], feed=path['batch'],
                               fetch_list=[path['loss']])
                secs.append(time.perf_counter() - t0)
                after = len(collections)
                notes.append('gc during %s, before %s; alloc retries +%d' % (
                    collections[before:after] or 'none',
                    collections[seen:before] or 'none',
                    torch.cuda.memory_stats().get('num_alloc_retries', 0) -
                    retries))
                seen = after
    finally:
        gc.callbacks.remove(on_gc)
    med = statistics.median(secs) * 1e3
    log('  %s step: median %.2f ms over %d steps %s, %.0f %s/s' % (
        path['name'], med, TIMED_STEPS, ['%.2f' % (x * 1e3) for x in secs],
        path['tokens'] / med * 1e3,
        'ids' if path['bitwise'] else 'tokens'))
    for i, note in enumerate(notes):
        log('    timed step %d: %s' % (i + 1, note))
    return med


def profile_train(run):
    path = run['path']
    with fluid.scope_guard(run['scope']):
        events = profile_run('%s step' % path['name'], lambda: run['exe'].run(
            path['main'], feed=path['batch'], fetch_list=[path['loss']]))
    log(events.table(sort_by='self_cuda_time_total', row_limit=25))
    # the port's own kernels in the step (all in anonymous namespaces)
    from torch.autograd import DeviceType
    mark = '(anonymous namespace)::'
    port = sorted((e for e in events if e.device_type == DeviceType.CUDA and
                   e.key.split(mark)[0] in ('', 'void ') and mark in e.key),
                  key=lambda e: -e.self_device_time_total)
    for e in port:
        log('    %-36s %9.3f us in %d launches' % (
            e.key.split(mark)[1].split('(')[0], e.self_device_time_total,
            e.count))
    log('    the port\'s kernels: %.3f us of the step\'s device time'
        % sum(e.self_device_time_total for e in port))


# ------------------------------------------------------------ phase 8
def bound(nbytes, flops, tensor_cores=False):
    """The least time for `nbytes` of HBM traffic and `flops` of f32
    work: on the f32 pipe, or (tensor_cores) as f32-accurate products on
    the tensor cores, three TF32 products each, with the f32-pipe figure
    kept under bound_f32_ms."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_f32 = flops / F32_FLOPS_PER_S * 1e3
    t_ops = 3 * flops / TF32_FLOPS_PER_S * 1e3 if tensor_cores else t_f32
    out = {'bound_ms': max(t_bytes, t_ops),
           'bound_by': 'bytes' if t_bytes >= t_ops else 'operations'}
    if tensor_cores:
        out['bound_f32_ms'] = max(t_bytes, t_f32)
    return out


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


def scatter_split(timer, rows, ids, g):
    """K6b's parts on one input, each timed alone (cold L2): the sort of
    the clipped ids; the zeroing of the output, which the kernel does in
    the sort's launch on other SMs (timed as that launch); the run and
    long-run passes (with the zeroing of their 4-byte run count)."""
    runs = emb_k._runs_scratch(g.shape[0], g.device)
    out = torch.empty(rows, g.shape[1], device=g.device)
    keys, order, _ = emb_k._scatter_sort(rows, ids, runs)
    return {'sort_ms': timer.ms(lambda: emb_k._scatter_sort(rows, ids,
                                                            runs)),
            'sort_and_zero_ms': timer.ms(lambda: emb_k._scatter_sort(
                rows, ids, runs, out)),
            'kernel_ms': timer.ms(lambda: emb_k._scatter_sum(
                keys, order, g, out, runs, False, True))}


def update_split(timer, rows, ids, w, m, g, lr):
    """K7's parts on one input, each timed alone (cold L2): the sort (the
    histogram and one launch a digit pass) and the run and long-run
    kernels on the sorted workspace."""
    lib = emb_k._update_lib()
    work = emb_k._update_work(lib, ids.numel(), rows, ids.device)
    emb_k._update_sort(lib, rows, ids, work)
    return {'sort_ms': timer.ms(lambda: emb_k._update_sort(
                lib, rows, ids, work)),
            'kernel_ms': timer.ms(lambda: emb_k._update_rows(
                lib, work, g, lr, w, m, 1e-6))}


def time_kernels(timer, gen, dev, req, train_batch, wd_batch, launches,
                 max_err, adam_shapes, lenet_shapes, seed):
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
    zeros = torch.zeros_like(src)
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
    # K4 over LeNet-5's 6 tensors, beside fused torch.optim.Adam on them
    lenet_ins = adam_inputs(lenet_shapes, gen, dev)
    lenet_table, lenet_blocks = opt_k.device_table(lenet_ins)
    n_lenet = sum(x.numel() for x in lenet_ins['Param'])
    lenet_params = [torch.nn.Parameter(x.clone())
                    for x in lenet_ins['Param']]
    for p, x in zip(lenet_params, lenet_ins['Grad']):
        p.grad = x.clone()
    lib_lenet = torch.optim.Adam(lenet_params, lr=LENET_LR['adam'],
                                 fused=True, capturable=True)
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
    # the hot case: 8192 ids on a 64 x 16 table, all but six on row 0
    hot_ids = torch.zeros(8192, dtype=torch.int64, device=dev)
    hot_ids[:6] = torch.tensor([3, 3, -7, 64, 64 + 9, 63], device=dev)
    rows_wd['hot'] = dict(
        ids=hot_ids, w=torch.randn(64, 16, generator=gen, device=dev),
        m=torch.rand(64, 16, generator=gen, device=dev),
        g=torch.randn(8192, 16, generator=gen, device=dev), touched=3,
        bound=bound(8192 * (8 + 16 * 4) + 3 * 16 * 16, 0))
    lr_wd = torch.full((1,), WD_LR, device=dev)
    deep = rows_wd[(WD_ROWS, 16)]
    wide = rows_wd[(WD_ROWS, 1)]
    lib_emb = torch.nn.Parameter(deep['w'].clone())
    lib_emb.grad = torch.sparse_coo_tensor(deep['ids'][None], deep['g'],
                                           deep['w'].shape,
                                           check_invariants=True)
    lib_adagrad = torch.optim.Adagrad([lib_emb], lr=WD_LR, eps=1e-6)
    lib_wide = torch.nn.Parameter(wide['w'].clone())
    lib_wide.grad = torch.sparse_coo_tensor(wide['ids'][None], wide['g'],
                                            wide['w'].shape,
                                            check_invariants=True)
    lib_adagrad_wide = torch.optim.Adagrad([lib_wide], lr=WD_LR, eps=1e-6)
    # K8 at the table gradient's shapes on 2 ranks: the quantize of the
    # padded payload, the reduce of one chunk's 2 shards
    quant = {}
    for numel in (TABLE_NUMEL, 768 * 3072):
        rows = quant_rows(torch.randn(numel, generator=gen, device=dev) *
                          1e-3, DP_RANKS, QUANT_BLOCK)
        codes, scales = qc_k.quantize_kernel(rows)
        cb = rows.shape[0] // DP_RANKS
        nbytes = rows.numel() * (1 + 4 / QUANT_BLOCK)
        quant[numel] = dict(
            rows=rows, qt=codes.reshape(DP_RANKS, cb, QUANT_BLOCK),
            st=scales.reshape(DP_RANKS, cb, 1),
            # f32 in, int8 and scales out; n shards in, one chunk out
            qbound=bound(rows.numel() * 4 + nbytes, 0),
            rbound=bound(nbytes + nbytes / DP_RANKS, 0))
    tab = quant[TABLE_NUMEL]
    # the Transformer's 10,000 x 512 tables at phase 11's source ids
    nmt = nmt_ids(seed).to(dev)
    w_nmt = torch.randn(NMT_ROWS, 512, generator=gen, device=dev)
    g_nmt = torch.randn(nmt.numel(), 512, generator=gen, device=dev)
    # name, kernel, plain, library, bound, whether a CUDA graph can
    # hold the plain version and the library call (the others have no
    # host sync)
    calls = [
        ('flash_attention',
         lambda: fa_k.flash_attention_kernel(q, k, v, False, bias),
         lambda: fa_k.flash_attention_plain(q, k, v, False, bias),
         lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
         bound(fa_bytes, fa_flops, True), True, True),
        ('flash_attention[dropout]',
         lambda: fa_k.flash_attention_kernel(q, k, v, False, bias, RATE,
                                             seed),
         lambda: fa_k.flash_attention_plain(q, k, v, False, bias, RATE,
                                            seed),
         lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                dropout_p=RATE),
         bound(fa_bytes, fa_flops, True), True, True),
        # the bound counts the S recompute and the four products the
        # gradient needs from q, k, v, O, lse and dO
        ('flash_attention_bwd',
         lambda: fa_k.flash_attention_bwd_kernel(q, k, v, bias, o, lse, do,
                                                 None, False, RATE, seed),
         lambda: fa_k.flash_attention_bwd_plain(q, k, v, bias, do, None,
                                                False, RATE, seed),
         sdpa_bwd_call(q, k, v, mask, do),
         bound(4 * (8 * b * t * h * d + b * t + b * h * t),
               10 * b * h * t * t * d, True), False, True),
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
        # the step's other scatter: BERT's 2-row sentence table, every id
        # on row 0, one run of 4096 rows
        ('embedding_scatter_add[2-row]',
         lambda: emb_k.scatter_add_kernel(2, zeros, g),
         lambda: emb_k.scatter_add_plain(2, zeros, g),
         lambda: torch.zeros(2, 768, device=dev).index_add_(0, zeros, g),
         bound(src.numel() * (768 * 4 + 8) + 2 * 768 * 4, 0), False, True),
        ('embedding_lookup[nmt]',
         lambda: emb_k.gather_kernel(w_nmt, nmt),
         lambda: emb_k.gather_plain(w_nmt, nmt),
         lambda: F.embedding(nmt, w_nmt),
         bound(2 * nmt.numel() * 512 * 4 + nmt.numel() * 8, 0), True, True),
        ('embedding_scatter_add[nmt]',
         lambda: emb_k.scatter_add_kernel(NMT_ROWS, nmt, g_nmt),
         lambda: emb_k.scatter_add_plain(NMT_ROWS, nmt, g_nmt),
         lambda: torch.zeros(NMT_ROWS, 512, device=dev).index_add_(
             0, nmt, g_nmt),
         bound(nmt.numel() * (512 * 4 + 8) + NMT_ROWS * 512 * 4, 0), False,
         True),
        ('fused_adam',
         lambda: opt_k.launch('adam', table, blocks, adam_attrs),
         lambda: opt_k.apply_plain('adam', None, ins, adam_attrs),
         lib_adam.step,
         bound(28 * n_adam + 12 * len(adam_shapes), 0), True, True),
        ('fused_adam[lenet]',
         lambda: opt_k.launch('adam', lenet_table, lenet_blocks, LENET_ADAM),
         lambda: opt_k.apply_plain('adam', None, lenet_ins, LENET_ADAM),
         lib_lenet.step,
         bound(28 * n_lenet + 12 * len(lenet_shapes), 0), True, True),
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
        # the wide part's D = 1 table over the same ids
        ('embedding_update[wide]',
         lambda: emb_k.update_kernel(wide['w'], wide['m'], wide['ids'],
                                     wide['g'], lr_wd, 1e-6),
         lambda: emb_k.update_plain(wide['w'], wide['m'], wide['ids'],
                                    wide['g'], lr_wd, 1e-6),
         lib_adagrad_wide.step, wide['bound'], False, False),
        # no PyTorch call computes the block absmax scale and the +-127
        # rounding; phase 9 times the dense collective instead
        ('quant_quantize',
         lambda: qc_k.quantize_kernel(tab['rows']),
         lambda: qc_k.quantize_plain(tab['rows']),
         None, tab['qbound'], True, True),
        ('quant_reduce',
         lambda: qc_k.reduce_kernel(tab['qt'], tab['st']),
         lambda: qc_k.dequant_reduce_requant_plain(tab['qt'], tab['st']),
         None, tab['rbound'], True, True),
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
               'launches': launches.get(name, launches.get(base)),
               'max_abs_err': max_err.get(name, max_err.get(base)),
               'ms': ms, 'plain_ms': plain_ms,
               'bound_ms': bnd['bound_ms'], 'bound_by': bnd['bound_by'],
               'library_ms': library_ms}
        if 'bound_f32_ms' in bnd:
            row['bound_f32_ms'] = bnd['bound_f32_ms']
        rows.append(row)
        log('  %-28s cold L2: kernel %.4f ms  plain %.4f ms%s  library '
            '%s  bound %.4f ms (%s)%s' % (
                name, ms, plain_ms, '' if graph else ' (events)',
                'none' if library_ms is None else '%.4f ms%s' % (
                    library_ms, '' if lib_graph else ' (events)'),
                row['bound_ms'], row['bound_by'],
                '' if 'bound_f32_ms' not in bnd else
                ', tensor cores; %.4f ms on the f32 pipe'
                % bnd['bound_f32_ms']) +
            ('' if name not in BEFORE_MS else
             '; %s took %.4f ms' % BEFORE_MS[name]))
    # K6b's parts: the sort, the zeroing (in the sort's launch) and the
    # run and long-run passes
    for rows_k, ids_k in ((30522, src), (2, zeros)):
        split = scatter_split(timer, rows_k, ids_k, g)
        log('  %-24s cold L2 split, %d x 768 table: sort %.4f ms, sort with '
            'the zeroing (one launch) %.4f ms, run and long-run passes '
            '%.4f ms' % ('embedding_scatter_add', rows_k, split['sort_ms'],
                         split['sort_and_zero_ms'], split['kernel_ms']))
    # K6b past SORT_MAX ids: torch.sort, a memset and the kernel's passes
    for n_ids in SCATTER_BIG_IDS:
        ids_n = torch.randint(0, 30522, (n_ids,), generator=gen, device=dev)
        g_n = torch.randn(n_ids, 768, generator=gen, device=dev)
        same = torch.equal(emb_k.scatter_add_kernel(30522, ids_n, g_n),
                           emb_k.scatter_add_plain(30522, ids_n, g_n))
        log('  %-24s cold L2, %d ids on the 30522 x 768 table: kernel %.4f '
            'ms  plain %.4f ms (events)  index_add_ %.4f ms  bound %.4f ms; '
            '%s its plain version' % (
                'embedding_scatter_add', n_ids,
                timer.ms(lambda: emb_k.scatter_add_kernel(30522, ids_n, g_n)),
                timer.ms(lambda: emb_k.scatter_add_plain(30522, ids_n, g_n),
                         graph=False),
                timer.ms(lambda: torch.zeros(30522, 768, device=dev)
                         .index_add_(0, ids_n, g_n)),
                bound(n_ids * (768 * 4 + 8) + 30522 * 768 * 4, 0)['bound_ms'],
                'bitwise' if same else 'NOT bitwise'))
        if not same:
            raise AssertionError('embedding_scatter_add at %d ids is not '
                                 'bitwise its plain version' % n_ids)
    # K8 at a 768 x 3072 gradient's shapes
    w3 = quant[768 * 3072]
    log('  %-24s cold L2: kernel %.4f ms  plain %.4f ms  bound %.4f ms '
        '(768 x 3072 gradient, [%d, %d])' % (
            'quant_quantize', timer.ms(lambda: qc_k.quantize_kernel(
                w3['rows'])), timer.ms(lambda: qc_k.quantize_plain(
                    w3['rows'])), w3['qbound']['bound_ms'],
            *w3['rows'].shape))
    log('  %-24s cold L2: kernel %.4f ms  plain %.4f ms  bound %.4f ms '
        '(768 x 3072 gradient, [%d, %d, %d])' % (
            'quant_reduce', timer.ms(lambda: qc_k.reduce_kernel(
                w3['qt'], w3['st'])),
            timer.ms(lambda: qc_k.dequant_reduce_requant_plain(
                w3['qt'], w3['st'])), w3['rbound']['bound_ms'],
            *w3['qt'].shape))
    # the row update on BASE's 1000-row table (~106 visits a row) and on
    # the hot case (one run of 8187 rows)
    for key, label in (((1000, 16), '1000 x 16 table'),
                       ('hot', '64 x 16 table, one run of 8187')):
        r = rows_wd[key]
        log('  %-28s cold L2: kernel %.4f ms  plain %.4f ms (events)  '
            'bound %.4f ms (%s, %d ids, %d rows touched)' % (
                'embedding_update', timer.ms(
                    lambda: emb_k.update_kernel(r['w'], r['m'], r['ids'],
                                                r['g'], lr_wd, 1e-6)),
                timer.ms(lambda: emb_k.update_plain(
                    r['w'], r['m'], r['ids'], r['g'], lr_wd, 1e-6),
                    graph=False),
                r['bound']['bound_ms'], label, r['ids'].numel(),
                r['touched']) + (
                    '; %s took %.4f ms'
                    % BEFORE_MS['embedding_update[1000-row]']
                    if key == (1000, 16) else ''))
    # K7's parts: its sort and its run kernels
    for key in ((WD_ROWS, 16), (WD_ROWS, 1), (1000, 16), 'hot'):
        r = rows_wd[key]
        rows_k = 64 if key == 'hot' else key[0]
        split = update_split(timer, rows_k, r['ids'], r['w'], r['m'],
                             r['g'], lr_wd)
        log('  %-24s cold L2 split, %d x %d table: sort %.4f ms, run and '
            'long-run kernels %.4f ms' % (
                'embedding_update', rows_k, r['w'].shape[1],
                split['sort_ms'], split['kernel_ms']))
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


def naive_attention(q, k, v, mask):
    """The port's naive attention chain on [B, T, H, D] q, k, v and a
    [B, 1, 1, T] key bias: the lowerings BERT runs below flash_min_len
    (transpose2, matmul with the scale, elementwise_add, softmax,
    matmul, transpose2, reshape2), without dropout."""
    ctx = registry.LowerCtx(1, device=q.device)

    def op(kind, ins, **attrs):
        return registry.get(kind).run(ctx, ins, attrs)['Out'][0]
    qh, kh, vh = [op('transpose2', {'X': [x]}, axis=[0, 2, 1, 3])
                  for x in (q, k, v)]
    s = op('matmul', {'X': [qh], 'Y': [kh]}, transpose_Y=True,
           alpha=q.shape[3] ** -0.5)
    p = op('softmax', {'X': [op('elementwise_add', {'X': [s], 'Y': [mask]},
                                axis=-1)]}, axis=-1)
    o = op('transpose2', {'X': [op('matmul', {'X': [p], 'Y': [vh]})]},
           axis=[0, 2, 1, 3])
    return op('reshape2', {'X': [o]}, shape=[0, 0, -1])


def attention_crossover(timer, gen, dev):
    """The naive chain against K1 (forward) and K1 + K2 (forward and
    backward) on BERT-base's attention (12 heads, D = 64) at
    CROSSOVER_SEQS with CROSSOVER_TOKENS tokens each, no dropout, a
    padding bias; device times of CUDA-graph replays with L2 flushed.
    The chain's backward is autograd's over its lowerings; the outputs
    of both routes agree within FA_TOL."""
    h, d = 12, 64
    for t in CROSSOVER_SEQS:
        b = CROSSOVER_TOKENS // t
        qkv = torch.randn(b, t, 3 * h * d, generator=gen, device=dev)
        q, k, v = [x.reshape(b, t, h, d) for x in qkv.split(h * d, dim=2)]
        leaf = qkv.clone().requires_grad_()
        bias = padding_bias(gen, b, t, dev)
        mask = bias[:, None, None, :]
        do = torch.randn(b, t, h, d, generator=gen, device=dev)
        o, _ = fa_k.flash_attention_kernel(q, k, v, False, bias)
        with torch.no_grad():
            err = max_abs(naive_attention(q, k, v, mask),
                          o.reshape(b, t, h * d))
        if not err <= FA_TOL:
            raise AssertionError('the naive chain and K1 disagree at seq %d: '
                                 '%g' % (t, err))

        def naive_fwd():
            with torch.no_grad():
                naive_attention(q, k, v, mask)

        def naive_fwd_bwd():
            out = naive_attention(*[x.reshape(b, t, h, d)
                                    for x in leaf.split(h * d, dim=2)], mask)
            torch.autograd.grad(out, [leaf], do.reshape(b, t, h * d))

        def flash_fwd_bwd():
            o, lse = fa_k.flash_attention_kernel(q, k, v, False, bias)
            fa_k.flash_attention_bwd_kernel(q, k, v, bias, o, lse, do, None)
        times = {name: timer.ms(fn) for name, fn in (
            ('naive_fwd', naive_fwd),
            ('k1', lambda: fa_k.flash_attention_kernel(q, k, v, False,
                                                       bias)),
            ('naive_fwd_bwd', naive_fwd_bwd), ('k1_k2', flash_fwd_bwd))}
        log('  attention crossover seq %d (batch %d, %d tokens): forward '
            'naive %.4f ms, K1 %.4f ms; forward + backward naive %.4f ms, '
            'K1 + K2 %.4f ms (naive/flash %.2f); max|naive - K1| %.1e' % (
                t, b, b * t, times['naive_fwd'], times['k1'],
                times['naive_fwd_bwd'], times['k1_k2'],
                times['naive_fwd_bwd'] / times['k1_k2'], err))


# ------------------------------------------------------------ phase 9
def free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sk:
        sk.bind(('127.0.0.1', 0))
        return sk.getsockname()[1]


def data_parallel(seed, profile):
    """Phase 9: this script on DP_RANKS ranks through the port's
    launcher; the ranks' results.  A rank that fails (or the time limit)
    fails the phase: the launcher then stops every rank."""
    out_dir = tempfile.mkdtemp(dir=os.path.join(ROOT, 'build', 'chip_smoke'))
    cmd = [sys.executable, '-m', 'paddle_tpu_torch.distributed.launch',
           '--nproc_per_node', str(DP_RANKS), '--started_port',
           str(free_port()), os.path.join(ROOT, 'chip_smoke.py'),
           '--dp-worker', '--dp-out', out_dir, '--seed', str(seed)] + \
        (['--profile'] if profile else [])
    t0 = time.perf_counter()
    rc = subprocess.run(cmd, cwd=ROOT, timeout=DP_TIMEOUT_S).returncode
    if rc != 0:
        raise AssertionError('the data-parallel ranks failed (launcher exit '
                             '%d)' % rc)
    results = []
    for r in range(DP_RANKS):
        with open(os.path.join(out_dir, 'rank%d.json' % r)) as f:
            results.append(json.load(f))
    log('  %d ranks on cards %s over %s, %.1f s' % (
        DP_RANKS, [res['card'] for res in results], results[0]['backend'],
        time.perf_counter() - t0))
    for res in results:
        log('  rank %d: losses %s, held %s; step median quantized %.2f ms '
            '(its collectives alone %.2f), dense %.2f ms (%.2f); peak %.2f '
            'GiB; quant bound used %.3f; table-gradient all-reduce '
            'quantized %.2f ms, flat dense %.2f ms, rs_ag %.2f ms' % (
                res['rank'], ['%.6f' % x for x in res['losses']],
                ['%.6f' % x for x in res['held']], res['step_ms']['quant'],
                res['step_collectives_ms']['quant'], res['step_ms']['dense'],
                res['step_collectives_ms']['dense'], res['peak'] / 2 ** 30,
                res['bound_ratio'], res['collective_ms']['quant'],
                res['collective_ms']['dense'], res['collective_ms']['rs_ag']))
    return results


def params_in_sync(scope, names, group, dev):
    """Whether every rank's parameters are bitwise rank 0's."""
    from paddle_tpu_torch.distributed import wire
    flat = torch.cat([scope.find_var(n).reshape(-1) for n in names])
    same = torch.equal(flat, wire.broadcast(flat, group, 0))
    ok = wire.all_reduce(torch.tensor([float(same)], device=dev), group,
                         op=dist.ReduceOp.MIN)
    return bool(ok.item())


def collective_ms(fn, group, runs=5):
    """Median wall time of fn() on every rank, the ranks released
    together."""
    secs = []
    for _ in range(runs):
        dist.barrier(group=group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs) * 1e3


def dp_worker(args):
    """One rank of phase 9 (see the module docstring); raises on any
    failed check, so the launcher stops the job."""
    from paddle_tpu_torch.distributed import init_distributed, local_card
    from paddle_tpu_torch.distributed import wire
    from paddle_tpu_torch.fluid import comms, comms_plan
    from paddle_tpu_torch.fluid.transpiler import GradAllReduce
    from paddle_tpu_torch.ops import collective_ops
    card = local_card()
    place = fluid.CUDAPlace(card)
    dev = place.torch_device()
    torch.cuda.set_device(dev)
    group = init_distributed(place)
    rank, n = dist.get_rank(), dist.get_world_size()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def say(fmt, *a):
        log('  [rank %d] ' % rank + fmt % a)

    flags.set_flags({'FLAGS_comms_quantize': True})
    path = pretrain_program(args.seed, 'adam')
    batch = path['batch'] = bert.synthetic_batch(
        bert.BASE, TRAIN_BATCH, SEQ, np.random.RandomState(args.seed + rank))
    main, startup, loss = path['main'], path['startup'], path['loss']
    GradAllReduce().transpile(startup, main, rank,
                              os.environ['PADDLE_TRAINER_ENDPOINTS'].split(
                                  ','),
                              os.environ['PADDLE_CURRENT_ENDPOINT'])
    block = main.global_block()
    colls = [op.input('X') for op in block.ops if op.attrs.get('plan') and
             op.type in ('c_allreduce_sum', 'c_allreduce_fused')]
    arms = [comms_plan.decide(
        4.0 * sum(int(np.prod(block.var(g).shape)) for g in names), 4,
        n)['arm'] for names in colls]
    n_quant = arms.count('quant')
    expected = dict(path['expected'], quant_quantize=n_quant,
                    quant_reduce=n_quant)
    say('%d ops, %d planned collectives (%d quantized, %d fused), backend '
        '%s, card %d', len(block.ops), len(colls), n_quant,
        sum(len(x) > 1 for x in colls), dist.get_backend(group), card)
    grads = [g for names in colls for g in names]
    params = sorted(p.name for p in main.all_parameters())
    state_names = weights.startup_names(startup)
    exe, scope = fluid.Executor(place), fluid.Scope()
    losses, secs = [], []
    launches = {k: 0 for k in common.KERNELS}
    with fluid.scope_guard(scope):
        exe.run(startup)
        start = snapshot(scope, state_names)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        comms.reset()
        for step in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            out, counts = counted(lambda: exe.run(
                main, feed=batch,
                fetch_list=[loss] + (grads if step == 0 else []),
                return_numpy=False))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(out[0]))
            for k, c in counts.items():
                launches[k] += c
            if step == 0:
                quant_avg = dict(zip(grads, out[1:]))
            in_sync = without_counting(
                lambda: params_in_sync(scope, params, group, dev))
            say('step %d: loss %.6f, %.1f ms, launches %s, ranks in sync %s',
                step + 1, losses[-1], secs[-1] * 1e3,
                {k: c for k, c in counts.items() if c}, in_sync)
            if counts != expected:
                raise AssertionError('step %d launched %s, expected %s'
                                     % (step + 1, counts, expected))
            if not in_sync:
                raise AssertionError('the ranks\' parameters differ after '
                                     'step %d' % (step + 1))
        peak = torch.cuda.max_memory_allocated(dev)
        if comms.arm_counts() != {'quant': TRAIN_STEPS * n_quant,
                                  'dense': 0, 'rs_ag': 0}:
            raise AssertionError('arms run: %s' % comms.arm_counts())
    held = without_counting(lambda: held_losses(path, start, place))
    say('losses %s; with the parameters held %s',
        ['%.6f' % x for x in losses], ['%.6f' % x for x in held])
    if not (all(np.isfinite(losses)) and losses[-1] < held[-1]):
        raise AssertionError('loss %s not finite or not below the held run '
                             '%s' % (losses, held))

    def step1(prog, prog_startup, quantize):
        """The gradients `grads` of step 1 of `prog` from `start`, on a
        scope of its own."""
        flags.set_flags({'FLAGS_comms_quantize': quantize})
        try:
            ex, sc = fluid.Executor(place), fluid.Scope()
            with fluid.scope_guard(sc):
                ex.run(prog_startup)
                for name, v in start.items():
                    sc.set_var(name, v.clone())
                got = ex.run(prog, feed=batch, fetch_list=grads,
                             return_numpy=False)
            return dict(zip(grads, got))
        finally:
            flags.set_flags({'FLAGS_comms_quantize': True})

    dense_avg = without_counting(lambda: step1(main, startup, False))
    # each rank's own gradients: the program before the rewrite
    before = pretrain_program(args.seed, 'adam')
    local = without_counting(lambda: step1(before['main'],
                                           before['startup'], True))
    del before
    ratio = 0.0
    for names in colls:
        rows = [quant_rows(torch.cat([src[g].reshape(-1) for g in names]),
                           n, QUANT_BLOCK) for src in (local, quant_avg,
                                                       dense_avg)]
        s_sum = wire.all_reduce(rows[0].abs().amax(1) / 127.0, group)
        q_sum, d_sum = rows[1] * n, rows[2] * n
        bound_b = s_sum / 2 + q_sum.abs().amax(1) / 127.0 / 2 + \
            2e-6 * d_sum.abs().amax(1) + 1e-30
        err_b = (q_sum - d_sum).abs().amax(1)
        ratio = max(ratio, (err_b / bound_b).max().item())
    say('step 1 quantized vs dense all-reduced gradients: at most %.3f of '
        'the quantization bound', ratio)
    if not ratio <= 1.0:
        raise AssertionError('the quantized arm is off the dense arm by more '
                             'than its bound (%.3f)' % ratio)
    table = max(grads, key=lambda g: local[g].numel())
    x = local[table]
    got = without_counting(lambda: qc_k.quant_allreduce(x, group, n,
                                                        QUANT_BLOCK))
    flags.set_flags({'FLAGS_torch_kernels_plain': True})
    try:
        want = without_counting(lambda: qc_k.quant_allreduce(
            x, group, n, QUANT_BLOCK))
    finally:
        flags.set_flags({'FLAGS_torch_kernels_plain': False})
    if not torch.equal(got, want):
        raise AssertionError('the quantized all-reduce of %s is not bitwise '
                             'its plain path' % table)
    say('quantized all-reduce of %s %s: bitwise its plain path', table,
        list(x.shape))
    # a step's planned collectives alone, on this rank's gradients
    payloads = [torch.cat([local[g].reshape(-1) for g in names])
                for names in colls]
    del local, quant_avg, dense_avg, got, want, start
    torch.cuda.empty_cache()

    step_ms = {}
    with fluid.scope_guard(scope):
        for arm in ('quant', 'dense'):
            flags.set_flags({'FLAGS_comms_quantize': arm == 'quant'})
            ts = []
            for _ in range(TIMED_STEPS):
                t0 = time.perf_counter()
                without_counting(lambda: exe.run(main, feed=batch,
                                                 fetch_list=[loss]))
                ts.append(time.perf_counter() - t0)
            step_ms[arm] = statistics.median(ts) * 1e3
            say('%s arm: step median %.2f ms over %d steps %s', arm,
                step_ms[arm], TIMED_STEPS, ['%.1f' % (t * 1e3) for t in ts])
            if args.profile:
                events = without_counting(lambda: profile_run(
                    'rank %d %s arm step' % (rank, arm), lambda: exe.run(
                        main, feed=batch, fetch_list=[loss])))
                if rank == 0:
                    log(events.table(sort_by='self_cpu_time_total',
                                     row_limit=12))
    step_coll = {}
    for arm in ('quant', 'dense'):
        flags.set_flags({'FLAGS_comms_quantize': arm == 'quant'})
        step_coll[arm] = collective_ms(lambda: without_counting(lambda: [
            collective_ops._planned_allreduce(p, group, n, {'plan': True})
            for p in payloads]), group)
    say('the %d planned collectives of a step alone: quantized %.2f ms, '
        'dense %.2f ms', len(payloads), step_coll['quant'],
        step_coll['dense'])
    flags.set_flags({'FLAGS_comms_quantize': True})
    coll = {
        'quant': collective_ms(lambda: without_counting(
            lambda: qc_k.quant_allreduce(x, group, n, QUANT_BLOCK)), group),
        'dense': collective_ms(lambda: wire.all_reduce(x, group), group),
        'rs_ag': collective_ms(lambda: collective_ops._rs_ag_allreduce(
            x, group, n), group)}
    say('all-reduce of %s (%.1f MB f32): quantized %.2f ms, flat dense %.2f '
        'ms, rs_ag %.2f ms', table, x.numel() * 4 / 1e6, coll['quant'],
        coll['dense'], coll['rs_ag'])
    res = {'rank': rank, 'card': card, 'backend': dist.get_backend(group),
           'losses': losses, 'held': held, 'step_ms': step_ms, 'peak': peak,
           'bound_ratio': ratio, 'collective_ms': coll,
           'step_collectives_ms': step_coll,
           'n_collectives': len(colls), 'n_quant': n_quant,
           'launches': launches,
           'card_line': card_line()}
    with open(os.path.join(args.dp_out, 'rank%d.json' % rank), 'w') as f:
        json.dump(res, f)
    dist.barrier(group=group)
    dist.destroy_process_group()
    return 0


# ----------------------------------------------------------- phase 10
def lenet_path(seed, opt):
    """LeNet-5 with Adam ('adam', K4 once a step) or SGD ('sgd', no
    kernel) on one synthetic MNIST batch from `seed`."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss, acc = lenet.build()
        if opt == 'adam':
            fluid.optimizer.Adam(LENET_LR['adam']).minimize(loss)
        else:
            fluid.optimizer.SGD(LENET_LR['sgd']).minimize(loss)
    imgs, labels = mnist._synthetic(LENET_BATCH, seed)
    expected = {k: 0 for k in common.KERNELS}
    if opt == 'adam':
        expected['fused_adam'] = 1
    return {'name': 'LeNet-5 %s' % opt.upper(), 'opt': opt, 'main': main,
            'startup': startup, 'loss': loss, 'acc': acc,
            'batch': {'img': imgs.reshape(-1, 1, 28, 28),
                      'label': labels.reshape(-1, 1)},
            'expected': expected,
            'probe': sorted(p.name for p in main.all_parameters())}


def train_lenet(path):
    """TRAIN_STEPS steps, then TIMED_STEPS timed ones, of LeNet-5 on
    CUDAPlace(0); every step's launches are counted and checked, the
    fetched accuracy goes to metrics.Accuracy, the loss must fall, and
    step 1 is held against the plain path."""
    main, loss = path['main'], path['loss']
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    names = weights.startup_names(path['startup'])
    grad_fetch = [main._grad_name_map[p] for p in path['probe']]
    accuracy = metrics.Accuracy()
    launches = {k: 0 for k in common.KERNELS}
    losses, secs = [], []
    with fluid.scope_guard(scope):
        exe.run(path['startup'])
        start = snapshot(scope, names)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for step in range(TRAIN_STEPS + TIMED_STEPS):
            t0 = time.perf_counter()
            # the loss comes back as numpy: the step has ended
            out, counts = counted(lambda: exe.run(
                main, feed=path['batch'],
                fetch_list=[loss, path['acc']] +
                (grad_fetch if step == 0 else [])))
            secs.append(time.perf_counter() - t0)
            losses.append(float(out[0]))
            accuracy.update(out[1], LENET_BATCH)
            if step == 0:
                grads = [torch.from_numpy(g) for g in out[2:]]
                after1 = snapshot(scope, names)
            for k, c in counts.items():
                launches[k] += c
            if counts != path['expected']:
                raise AssertionError('%s step %d launched %s, expected %s'
                                     % (path['name'], step + 1, counts,
                                        path['expected']))
        peak = torch.cuda.max_memory_allocated()
        dev_ms = device_ms(without_counting(lambda: profile_run(
            '%s step' % path['name'], lambda: exe.run(
                main, feed=path['batch'], fetch_list=[loss]))))
    med = statistics.median(secs[TRAIN_STEPS:]) * 1e3
    log('  %s: losses %s, accuracy %.4f (metrics.Accuracy over %d '
        'batches); step median %.3f ms over %d timed steps %s, %.0f '
        'images/s, device %.3f ms a profiled step; peak device memory '
        '%.3f GiB; launches %s' % (
            path['name'], ['%.5f' % x for x in losses], accuracy.eval(),
            len(losses), med, TIMED_STEPS,
            ['%.3f' % (x * 1e3) for x in secs[TRAIN_STEPS:]],
            LENET_BATCH / med * 1e3, dev_ms, peak / 2 ** 30,
            {k: c for k, c in launches.items() if c}))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError('%s: loss %s not finite or not falling'
                             % (path['name'], losses))
    check_plain_lenet(path, grad_fetch, start, after1, losses[0], grads)
    return {'launches': launches, 'step_ms': med}


def check_plain_lenet(path, grad_fetch, start, after1, loss1, grads):
    """Step 1 again from the same state with every kernel's plain
    version (K4's per-tensor adam lowering): the loss within LOSS_RTOL,
    each gradient within GRAD_TOL of its largest magnitude, and the
    state the step writes (Adam's moments; SGD's parameter change, -lr
    times the gradient) within GRAD_TOL of its largest.  cuDNN's
    backward may sum in another order from run to run, so this is not
    bitwise."""
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    flags.set_flags({'FLAGS_torch_kernels_plain': True})
    try:
        with fluid.scope_guard(scope):
            without_counting(lambda: exe.run(path['startup']))
            for n, v in start.items():
                scope.set_var(n, v.clone())
            out = without_counting(lambda: exe.run(
                path['main'], feed=path['batch'],
                fetch_list=[path['loss']] + grad_fetch))
            got = snapshot(scope, list(start))
    finally:
        flags.set_flags({'FLAGS_torch_kernels_plain': False})
    loss_err = abs(float(out[0]) - loss1) / abs(loss1)
    grad_err = max(max_abs(a, torch.from_numpy(b)) /
                   max(float(np.abs(b).max()), 1e-30)
                   for a, b in zip(grads, out[1:]))
    state_err = 0.0
    for n in start:
        if path['opt'] == 'adam' and '_moment' in n:
            a, b = after1[n], got[n]
        elif path['opt'] == 'sgd' and n in path['probe']:
            a, b = after1[n] - start[n], got[n] - start[n]
        else:
            continue
        state_err = max(state_err, max_abs(a, b) /
                        max(b.abs().max().item(), 1e-30))
    log('  %s step 1 vs the plain path: loss rel %.2e (limit %g), '
        'gradients rel %.2e, %s rel %.2e (limit %g)' % (
            path['name'], loss_err, LOSS_RTOL, grad_err,
            'moments' if path['opt'] == 'adam' else 'parameter changes',
            state_err, GRAD_TOL))
    if not (loss_err <= LOSS_RTOL and grad_err <= GRAD_TOL and
            state_err <= GRAD_TOL):
        raise AssertionError('%s step 1 disagrees with its plain path'
                             % path['name'])


def image_path(seed, model, batch, dev):
    """ResNet-50 ('resnet') or SE-ResNeXt-50 ('se_resnext', cardinality
    32) with Momentum and L2Decay on CUDAPlace(0): the path dict, its
    for_test clone, and a batch of uniform [0, 1) images (as the JAX
    package's bench.py makes them) and labels from `seed`, on `dev`."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if model == 'resnet':
            _, out, loss, acc = resnet.build(class_dim=IMAGE_CLASSES)
        else:
            _, out, loss, acc = se_resnext.build(class_dim=IMAGE_CLASSES)
        test = main.clone(for_test=True)
        fluid.optimizer.Momentum(
            IMAGE_LR, IMAGE_MOMENTUM,
            regularization=fluid.regularizer.L2Decay(IMAGE_DECAY)
        ).minimize(loss)
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.rand(batch, 3, 224, 224).astype('float32'))
    y = torch.from_numpy(rng.randint(0, IMAGE_CLASSES, (batch, 1)))
    stats = sorted(p.name for p in main.all_parameters()
                   if not p.trainable)
    return {'name': 'ResNet-50' if model == 'resnet' else 'SE-ResNeXt-50',
            'main': main, 'startup': startup, 'test': test, 'loss': loss,
            'out': out, 'acc': acc, 'stats': stats,
            'batch': {'image': x.to(dev), 'label': y.to(dev)},
            'host_batch': {'image': x, 'label': y}}


def train_image(path, steps, timed, profile):
    """`steps` counted steps (no kernel of the port may launch), then
    `timed` timed ones; every moving mean and variance must change and
    the losses stay finite.  Returns the run."""
    main, loss = path['main'], path['loss']
    ops = main.global_block().ops
    params = [p for p in main.all_parameters() if p.trainable]
    log('  %s program: %d ops (%d conv2d, %d batch_norm, %d momentum), %d '
        'trainable parameters (%d elements), %d moving statistics' % (
            path['name'], len(ops), sum(op.type == 'conv2d' for op in ops),
            sum(op.type == 'batch_norm' for op in ops),
            sum(op.type == 'momentum' for op in ops), len(params),
            sum(int(np.prod(p.shape)) for p in params), len(path['stats'])))
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    names = weights.startup_names(path['startup'])
    none = {k: 0 for k in common.KERNELS}
    batch = path['batch']['image'].shape[0]
    losses, secs = [], []
    with fluid.scope_guard(scope):
        exe.run(path['startup'])
        start = snapshot(scope, names)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for step in range(steps + timed):
            t0 = time.perf_counter()
            out, counts = counted(lambda: exe.run(
                main, feed=path['batch'], fetch_list=[loss, path['acc']]))
            secs.append(time.perf_counter() - t0)
            losses.append(float(out[0]))
            if counts != none:
                raise AssertionError('%s step %d launched %s: no kernel of '
                                     'the port is on this path'
                                     % (path['name'], step + 1, counts))
            if step < steps:
                log('  step %d: loss %.5f, accuracy %.4f, %.1f ms' % (
                    step + 1, losses[-1], float(out[1]), secs[-1] * 1e3))
        peak = torch.cuda.max_memory_allocated()
        moved = [n for n in path['stats']
                 if not torch.equal(scope.find_var(n), start[n])]
        events = without_counting(lambda: profile_run(
            '%s step' % path['name'], lambda: exe.run(
                main, feed=path['batch'], fetch_list=[loss])))
        dev_ms = device_ms(events)
        if profile:
            log(events.table(sort_by='self_cuda_time_total', row_limit=20))
    med = statistics.median(secs[steps:] if timed else secs) * 1e3
    log('  %s: step %s %.2f ms%s, %.1f images/s, device %.2f ms a '
        'profiled step; peak device memory %.2f GiB; %d of %d moving '
        'statistics changed' % (
            path['name'], 'median' if timed else 'median of the counted',
            med, '' if not timed else ' over %d timed steps %s' % (
                timed, ['%.2f' % (x * 1e3) for x in secs[steps:]]),
            batch / med * 1e3, dev_ms, peak / 2 ** 30, len(moved),
            len(path['stats'])))
    if not all(np.isfinite(losses)):
        raise AssertionError('%s: loss %s not finite'
                             % (path['name'], losses))
    if len(moved) != len(path['stats']):
        raise AssertionError('%s: moving statistics not updated: %s' % (
            path['name'], sorted(set(path['stats']) - set(moved))[:5]))
    return {'exe': exe, 'scope': scope, 'start': start, 'step_ms': med,
            'peak': peak, 'device_ms': dev_ms}


def check_eval(path, run):
    """The for_test clone at RESNET_EVAL_BATCH: finite logits of the
    right shape, the same on a second run."""
    feed = {k: v[:RESNET_EVAL_BATCH] for k, v in path['batch'].items()}
    with fluid.scope_guard(run['scope']):
        outs = [without_counting(lambda: run['exe'].run(
            path['test'], feed=feed, fetch_list=[path['out']],
            return_numpy=False))[0] for _ in range(2)]
    shape = (RESNET_EVAL_BATCH, IMAGE_CLASSES)
    ok = tuple(outs[0].shape) == shape and \
        bool(torch.isfinite(outs[0]).all()) and torch.equal(*outs)
    log('  %s eval clone, batch %d: logits %s, finite and the same on a '
        'second run: %s' % (path['name'], RESNET_EVAL_BATCH,
                            list(outs[0].shape), ok))
    if not ok:
        raise AssertionError('%s eval clone: logits not finite, not %s or '
                             'not deterministic' % (path['name'], shape))


def check_card_against_cpu(path, start):
    """Step 1 at RESNET_CPU_BATCH from the same state and feed on
    CUDAPlace(0) and on CPUPlace(), in f32 and in float64 (the state and
    the images cast; the port keeps f64 in f64, cuDNN's convolutions
    included).  In f32 the card's loss is within LOSS_RTOL of the CPU's.
    In float64 the card computes the CPU's step: the loss and every
    variable of the state after the step (parameters, velocities, moving
    means and variances) within F64_TOL of their largest magnitude.  The
    f32 state is only printed, as each device's distance from the
    float64 step: the f32 gradients of ResNet-50 at batch 4 are not
    pinned down (relu inputs within f32 rounding of 0 fall on either
    side), so the CPU's own f32 velocities lie percents of their largest
    from the float64 ones (tests/torch_image_cases.py)."""
    feed32 = {k: v[:RESNET_CPU_BATCH].numpy()
              for k, v in path['host_batch'].items()}
    state32 = {n: core.to_numpy(v) for n, v in start.items()}
    names = sorted(state32)
    res = {}
    for dtype in (np.float32, np.float64):
        state = {n: v.astype(dtype) if v.dtype.kind == 'f' else v
                 for n, v in state32.items()}
        feed = dict(feed32, image=feed32['image'].astype(dtype))
        for dev_name, place in (('card', fluid.CUDAPlace(0)),
                                ('cpu', fluid.CPUPlace())):
            exe = fluid.Executor(place)
            scope = fluid.Scope()
            with fluid.scope_guard(scope):
                without_counting(lambda: exe.run(path['startup']))
                weights.load_numpy_params(scope, state, place)
                t0 = time.perf_counter()
                loss = float(without_counting(lambda: exe.run(
                    path['main'], feed=feed, fetch_list=[path['loss']]))[0])
                secs = time.perf_counter() - t0
                res[dev_name, dtype] = (loss, weights.numpy_state(
                    scope, names), secs)
    card32, cpu32 = res['card', np.float32], res['cpu', np.float32]
    card64, cpu64 = res['card', np.float64], res['cpu', np.float64]
    loss32 = abs(card32[0] - cpu32[0]) / abs(cpu32[0])
    loss64 = abs(card64[0] - cpu64[0]) / abs(cpu64[0])
    worst64, worst32 = {}, {}
    for n in names:
        ref = cpu64[1][n]
        if ref.dtype.kind != 'f':
            continue
        kind = ('velocity' if '_velocity_' in n else
                'stats' if n in path['stats'] else
                'param' if n + '_velocity_0' in cpu64[1] else None)
        if kind is None:
            continue
        top = max(float(np.abs(ref).max()), 1e-30)
        e64 = float(np.abs(card64[1][n] - ref).max()) / top
        if e64 >= worst64.get(kind, (-1.0,))[0]:
            worst64[kind] = (e64, n)
        e_card = float(np.abs(card32[1][n] - ref).max()) / top
        e_cpu = float(np.abs(cpu32[1][n] - ref).max()) / top
        if e_card >= worst32.get(kind, (-1.0,))[0]:
            worst32[kind] = (e_card, e_cpu, n)
    log('  %s step 1 at batch %d from the same state: f32 loss on the card '
        '%.6f (%.1f ms), on the CPU %.6f (%.1f ms), rel %.2e (limit %g); '
        'float64 loss %.9f (%.1f ms) / %.9f (%.1f ms), rel %.2e (limit %g)'
        % (path['name'], RESNET_CPU_BATCH, card32[0], card32[2] * 1e3,
           cpu32[0], cpu32[2] * 1e3, loss32, LOSS_RTOL, card64[0],
           card64[2] * 1e3, cpu64[0], cpu64[2] * 1e3, loss64, F64_TOL))
    for kind in sorted(worst64):
        e64, n64 = worst64[kind]
        e_card, e_cpu, n32 = worst32[kind]
        log('    %-8s float64 card vs CPU: worst %s %.2e of its largest '
            '(limit %g); f32 from the float64 step: worst %s, card %.2e, '
            'CPU %.2e' % (kind, n64, e64, F64_TOL, n32, e_card, e_cpu))
    if not (loss32 <= LOSS_RTOL and loss64 <= F64_TOL and
            max(w[0] for w in worst64.values()) <= F64_TOL):
        raise AssertionError('%s: the card\'s step 1 disagrees with the '
                             'CPU\'s' % path['name'])


def image_classification(seed, dev, profile):
    """Phase 10; returns LeNet-5 + Adam's K4 launches."""
    lenet_launches = {}
    for opt in ('adam', 'sgd'):
        path = lenet_path(seed, opt)
        log('[10] %s, batch %d, %d steps and %d timed' % (
            path['name'], LENET_BATCH, TRAIN_STEPS, TIMED_STEPS))
        lenet_launches[opt] = train_lenet(path)['launches']
    want = TRAIN_STEPS + TIMED_STEPS
    if lenet_launches['adam']['fused_adam'] != want or \
            any(lenet_launches['sgd'].values()):
        raise AssertionError('LeNet-5 launched %s (Adam) and %s (SGD): '
                             'expected fused_adam %d times and nothing'
                             % (lenet_launches['adam'],
                                lenet_launches['sgd'], want))

    path = image_path(seed, 'resnet', RESNET_BATCH, dev)
    log('[10] %s, batch %d, 3 x 224 x 224 NCHW f32, %d classes, '
        'Momentum(%g, %g) with L2Decay(%g)' % (
            path['name'], RESNET_BATCH, IMAGE_CLASSES, IMAGE_LR,
            IMAGE_MOMENTUM, IMAGE_DECAY))
    run = train_image(path, TRAIN_STEPS, TIMED_STEPS, profile)
    check_eval(path, run)
    start = run['start']
    del run
    torch.cuda.empty_cache()
    check_card_against_cpu(path, start)
    del path, start
    torch.cuda.empty_cache()

    path = image_path(seed, 'se_resnext', SE_BATCH, dev)
    log('[10] %s (cardinality 32), batch %d, Momentum(%g, %g) with '
        'L2Decay(%g)' % (path['name'], SE_BATCH, IMAGE_LR, IMAGE_MOMENTUM,
                         IMAGE_DECAY))
    train_image(path, TRAIN_STEPS, 0, profile)
    del path
    torch.cuda.empty_cache()
    return lenet_launches['adam']['fused_adam']


# ----------------------------------------------------------- phase 11
def nmt_program(seed):
    """Transformer-base NMT training with Adam (phase 11): the path dict
    that train() runs."""
    cfg = transformer.BASE
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed + 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = transformer.build(cfg, src_len=NMT_LEN, tgt_len=NMT_LEN)
        fluid.optimizer.Adam(learning_rate=NMT_LR,
                             epsilon=EPSILON).minimize(loss)
    expected = {k: 0 for k in common.KERNELS}
    expected.update({'embedding_lookup': 2, 'embedding_scatter_add': 2,
                     'fused_adam': 1})
    probe = ['embedding_0.w_0', 'embedding_1.w_0', 'fc_0.w_0']
    probe += [p.name for p in main.all_parameters()
              if p.shape == (cfg.d_model, cfg.tgt_vocab)]
    return {'name': 'Transformer-base Adam', 'main': main,
            'startup': startup, 'loss': loss, 'lr': None,
            'batch': transformer.synthetic_batch(
                cfg, NMT_BATCH, NMT_LEN, NMT_LEN,
                np.random.RandomState(seed)),
            'expected': expected, 'probe': probe,
            'tokens': NMT_BATCH * NMT_LEN, 'rate': NMT_LR, 'bitwise': False}


def bucket_step(run, seed):
    """One step of the NMT_BUCKET bucket on the Program built for
    NMT_LEN, on the path's executor after its steps: its launches
    checked, the loss finite, the step against the plain path."""
    path = run['path']
    main = path['main']
    batch = transformer.synthetic_batch(
        transformer.BASE, NMT_BATCH, NMT_BUCKET, NMT_BUCKET,
        np.random.RandomState(seed + 1))
    names = weights.startup_names(path['startup'])
    fetch = [path['loss'].name] + [main._grad_name_map[p]
                                   for p in path['probe']]
    with fluid.scope_guard(run['scope']):
        start = snapshot(run['scope'], names)
        step = run['exe']._step
        t0 = time.perf_counter()
        out, counts = counted(lambda: run['exe'].run(
            main, feed=batch, fetch_list=fetch, return_numpy=False))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        after = snapshot(run['scope'], names)
    loss = float(out[0])
    log('  bucket %d step (batch %d, %d target tokens): loss %.6f, %.1f ms, '
        'launches %s' % (NMT_BUCKET, NMT_BATCH, NMT_BATCH * NMT_BUCKET, loss,
                         sec * 1e3, {k: c for k, c in counts.items() if c}))
    if counts != path['expected'] or not math.isfinite(loss):
        raise AssertionError('the bucket step launched %s (expected %s), '
                             'loss %g' % (counts, path['expected'], loss))
    check_plain_step(path, fetch, start, after, loss,
                     [g.clone() for g in out[1:]], None, batch=batch,
                     step=step)
    return counts


def short_attention(seed):
    """Phase 11: BERT-base served and trained at seq 128 and
    Transformer-base trained, all through the naive attention chain,
    each with a profiled request or step; returns the launches of the
    three paths."""
    launches = {k: 0 for k in common.KERNELS}
    log('[11] BERT-base seq %d serving through create_paddle_predictor'
        % SHORT_SEQ)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(
            dir=os.path.join(ROOT, 'build', 'chip_smoke')) as model_dir:
        cfg, n_attn, n_emb, _ = build_model(model_dir, seed, SHORT_SEQ,
                                            pretrain=True)
        if n_attn:
            raise AssertionError('seq %d built %d fused attention ops'
                                 % (SHORT_SEQ, n_attn))
        pred, requests, served = serve(model_dir, cfg, 0, n_emb, seed,
                                       SHORT_SEQ, SHORT_BATCHES)
    for k, c in served.items():
        launches[k] += c
    without_counting(lambda: request_latency(pred, requests))
    log('  peak device memory while serving: %.2f GiB'
        % (torch.cuda.max_memory_allocated() / 2 ** 30))
    without_counting(lambda: profile_requests(pred, requests))
    del pred
    torch.cuda.empty_cache()

    for path in (pretrain_program(seed, 'adam', SHORT_SEQ,
                                  SHORT_TRAIN_BATCH), nmt_program(seed)):
        log('[11] %s training steps on CUDAPlace(0)' % path['name'])
        run = train(path)
        for k, c in run['launches'].items():
            launches[k] += c
        if path['name'].startswith('Transformer'):
            for k, c in bucket_step(run, seed).items():
                launches[k] += c
        without_counting(lambda: train_step_ms(run))
        without_counting(lambda: profile_train(run))
        del run
        torch.cuda.empty_cache()
    log('  launches on phase 11\'s paths: %s'
        % {k: c for k, c in launches.items() if c})
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--profile', action='store_true')
    ap.add_argument('--dp-worker', action='store_true',
                    help=argparse.SUPPRESS)
    ap.add_argument('--dp-out', help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false (torch %s)'
              % torch.__version__, file=sys.stderr)
        return 1
    if args.dp_worker:
        return dp_worker(args)
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
    lenet_shapes = [tuple(p.shape) for p in sorted(
        lenet_path(args.seed, 'adam')['main'].all_parameters(),
        key=lambda p: p.name)]
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
            lambda: check_adam(gen, dev, adam_shapes, lenet_shapes)),
        'fused_lamb': without_counting(
            lambda: check_lamb(gen, dev, adam_shapes)),
        'embedding_update': without_counting(
            lambda: check_emb_update(gen, dev)),
        'quant_quantize': without_counting(lambda: check_quant(gen, dev)),
        'quant_reduce': 0.0,
        'embedding_lookup[nmt]': without_counting(
            lambda: check_nmt_tables(gen, dev, args.seed)),
    }
    max_err['embedding_scatter_add[nmt]'] = max_err['embedding_lookup[nmt]']
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
    TABLE_LAUNCHES.update(dict.fromkeys(TABLE_ROWS, 0))
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
    # a row that times one table counts the launches on that table; its
    # kernel's row, those on the kernel's other tables
    for row, n in TABLE_LAUNCHES.items():
        launches[row] = n
        launches[row.split('[')[0]] -= n
    log('  launches by the kernels line\'s rows: %s'
        % {k: launches[k] for k in sorted(TABLE_ROWS) + sorted(
            {r.split('[')[0] for r in TABLE_ROWS})})

    log('[8] timings at the main path\'s shapes (%s | %s)' % (
        torch.cuda.get_device_name(0), card))
    timer = Timer(dev)
    rows = without_counting(lambda: time_kernels(
        timer, gen, dev, requests[-1], paths[0]['batch'], paths[2]['batch'],
        launches, max_err, adam_shapes, lenet_shapes, args.seed))
    without_counting(lambda: attention_crossover(timer, gen, dev))
    without_counting(lambda: request_latency(pred, requests))
    for run in runs:
        without_counting(lambda: train_step_ms(run))
    if args.profile:
        without_counting(lambda: profile_requests(pred, requests))
        for run in runs:
            without_counting(lambda: profile_train(run))
    del pred, runs, timer
    torch.cuda.empty_cache()

    log('[9] data-parallel BERT-base training, %d ranks (%s | %s)' % (
        DP_RANKS, torch.cuda.get_device_name(0), card))
    dp = data_parallel(args.seed, args.profile)
    for row in rows:
        if row['name'] in ('quant_quantize', 'quant_reduce'):
            row['launches'] = dp[0]['launches'][row['name']]

    lenet_k4 = image_classification(args.seed, dev, args.profile)
    # K4's row counts all its launches, LeNet-5's included; the
    # fused_adam[lenet] row counts LeNet-5's
    for row in rows:
        if row['name'] == 'fused_adam':
            row['launches'] += lenet_k4
        elif row['name'] == 'fused_adam[lenet]':
            row['launches'] = lenet_k4
    t0 = time.perf_counter()
    before = dict(TABLE_LAUNCHES)
    short = short_attention(args.seed)
    log('  phase 11: %.1f s' % (time.perf_counter() - t0))
    # the rows of phase 11's tables take their launches there; each
    # kernel's own row, the launches on its other tables
    gain = {row: TABLE_LAUNCHES[row] - before[row] for row in TABLE_ROWS}
    for row in rows:
        name = row['name']
        if name in gain:
            row['launches'] += gain[name]
        elif name in short:
            row['launches'] += short[name] - sum(
                n for r, n in gain.items() if r.split('[')[0] == name)
    idle = [row['name'] for row in rows if not row['launches']]
    if idle:
        raise AssertionError('no launch on the main path: %s' % idle)
    log('  whole run %.1f s' % (time.perf_counter() - t_start))
    log('card: %s' % card_line())
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
