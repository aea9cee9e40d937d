#!/usr/bin/env python3
"""Time the bf16 route of the port's flash-attention kernels (K1 forward,
K2 backward) at several block shapes beside SDPA, or split their cycles
by phase, at BERT-base's attention on one GPU.

    python3 tools/torch_flash_tune.py [--rounds N] [--out FILE]
    python3 tools/torch_flash_tune.py --cycles [--out FILE]

Inputs: batch 8, seq 512, 12 heads, head dim 64, Q / K / V as split
views of one [8, 512, 3 * 768] bf16 projection, a padding bias (the
keys past 400 of every row at -10000), dropout 0.1 at head offset 0.

Shapes: copies of csrc/flash_attention_{fwd,bwd}.cu built into the build
directory with ``FWD_BF16_SHAPE_D64`` / ``BWD_BF16_SHAPE_D64`` defined
(the first of each list is the sources' own).  Each shape is first held
against the plain bf16 version (2e-2 of max(1, max|plain|), lse 1e-4).
Every time is chip_smoke.py's phase-8 time: 10 calls captured in a CUDA
graph and replayed 10 times, each call after a read of a 256 MB buffer
that evicts the L2 (that read's own time subtracted).  Rounds run the
shapes forward then backward (0 1 .. n n .. 1 0), so drift shows.
Prints a line a (round, kernel, shape), then one JSON object of the
medians and the card's name and power limit.

--cycles: copies built with ``FLASH_CYCLES`` defined, whose consumer
warps stamp clock64() at the sources' CYCLES_STAMP points, run once
with and without dropout after an L2-evicting read; prints, averaged
over every consumer warp of every block, the cycles spent between
stamps:

  forward:  waiting for Q (and the block's start), waiting for K/V
            tiles (with the first tile's S and softmax), waiting for S,
            the softmax, waiting for P V, the rescale and the packing of
            P, the last P V and the epilogue;
  dK/dV and dQ passes: waiting for the fixed tiles, waiting for S^T (S)
            with the previous tile's products, the exponentials, waiting
            for dP^T (dP), dS with the dropout, the packing and the
            products' issue with the next tile's wait, the epilogue.

The stamps cost a few instructions a tile.  Prints the card's name,
power limit and SM clock.
"""

import argparse
import contextlib
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops.kernels import common  # noqa: E402
from paddle_tpu_torch.ops.kernels import flash_attention as fa_k  # noqa

# (NWG, BN, MINB) and (NWG, BM, BN, MINB) at D = 64; the first the
# sources' own
FWD_SHAPES = ['1, 64, 3', '1, 128, 2', '2, 64, 1', '2, 128, 1']
BWD_SHAPES = ['1, 32, 32, 3', '2, 64, 64, 1', '2, 32, 64, 1',
              '1, 32, 64, 2']
RATE = 0.1
SEED = 4242
NAMES = {
    'forward': ['Q wait and start', 'K/V tile wait', 'S wait', 'softmax',
                'P V wait', 'rescale and pack', 'last P V and epilogue'],
    'dK/dV pass': ['K/V wait and start', 'S^T wait', 'exponentials',
                   'dP^T wait', 'dS and dropout', 'pack, issue, next tile',
                   'epilogue'],
    'dQ pass': ['Q/dO wait and start', 'S wait', 'exponentials', 'dP wait',
                'dS and dropout', 'pack, issue, next tile', 'epilogue'],
}


def build(variants):
    """Build each (source, name, defines) as a copy of csrc/<source> with
    `defines` (a list of '#define' bodies) ahead of it, all at once;
    returns {name: ctypes library}."""
    out = os.path.join(common.build_dir(), 'flash_tune')
    os.makedirs(out, exist_ok=True)
    procs = []
    for source, name, defines in variants:
        cu = os.path.join(out, name + '.cu')
        with open(cu, 'w') as f:
            f.write(''.join('#define %s\n' % d for d in defines))
            f.write('#include "%s"\n' % os.path.join(common.CSRC_DIR,
                                                     source))
        lib = os.path.join(out, name + '.so')
        procs.append((name, lib, subprocess.Popen(
            [common._nvcc()] + common._flags(source) + ['-o', lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    libs = {}
    for name, lib, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit('nvcc failed for %s:\n%s' % (
                name, log.decode(errors='replace')))
        libs[name] = ctypes.CDLL(lib)
    return libs


@contextlib.contextmanager
def using(source, lib):
    """The wrappers launch from `lib` in place of csrc/<source>'s."""
    saved = common._LIBS.get(source)
    common._LIBS[source] = lib
    try:
        yield
    finally:
        if saved is None:
            common._LIBS.pop(source, None)
        else:
            common._LIBS[source] = saved


def check(name, got, want):
    """O, dQ, dK, dV within 2e-2 of max(1, max|plain|), lse within 1e-4."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None:
            continue
        tol = 1e-4 if name.startswith('fwd') and i == 1 else \
            2e-2 * max(1.0, w.float().abs().max().item())
        err = (g.float() - w.float()).abs().max().item()
        if not err <= tol:
            raise AssertionError('%s disagrees with its plain version: %g > '
                                 '%g' % (name, err, tol))


def inputs(dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    b, t, h, d = 8, 512, 12, 64
    q, k, v = [x.to(torch.bfloat16) for x in cs.qkv_views(gen, b, t, h, d,
                                                          dev)]
    bias = torch.zeros(b, t, device=dev)
    bias[:, 400:] = -10000.0
    do = torch.randn(b, t, h, d, generator=gen, device=dev).to(torch.bfloat16)
    return q, k, v, bias, do


def card(query='name,power.limit'):
    return subprocess.run(['nvidia-smi', '--query-gpu=' + query,
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()


def shapes(dev, rounds):
    """Median ms of each (kernel, shape) and of SDPA."""
    libs = build(
        [(fa_k.FWD_SOURCE, 'fwd%d' % i, ['FWD_BF16_SHAPE_D64 ' + s])
         for i, s in enumerate(FWD_SHAPES)] +
        [(fa_k.BWD_SOURCE, 'bwd%d' % i, ['BWD_BF16_SHAPE_D64 ' + s])
         for i, s in enumerate(BWD_SHAPES)])
    q, k, v, bias, do = inputs(dev)
    o, lse = fa_k.flash_attention_plain(q, k, v, False, bias, RATE, SEED)
    qh, kh, vh = [x.transpose(1, 2) for x in (q, k, v)]
    mask = bias[:, None, None, :].to(torch.bfloat16)
    timer = cs.Timer(dev)
    calls = {
        'fwd': lambda: fa_k.flash_attention_kernel(q, k, v, False, bias),
        'fwd[dropout]': lambda: fa_k.flash_attention_kernel(
            q, k, v, False, bias, RATE, SEED),
        'bwd': lambda: fa_k.flash_attention_bwd_kernel(
            q, k, v, bias, o, lse, do, None, False, RATE, SEED)}
    plain = {
        'fwd': fa_k.flash_attention_plain(q, k, v, False, bias),
        'fwd[dropout]': (o, lse),
        'bwd': fa_k.flash_attention_bwd_plain(q, k, v, bias, do, None, False,
                                              RATE, SEED)}
    variants = {'fwd': ('fwd', fa_k.FWD_SOURCE, len(FWD_SHAPES)),
                'fwd[dropout]': ('fwd', fa_k.FWD_SOURCE, len(FWD_SHAPES)),
                'bwd': ('bwd', fa_k.BWD_SOURCE, len(BWD_SHAPES))}
    library = {
        'fwd': lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                      attn_mask=mask),
        'fwd[dropout]': lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, dropout_p=RATE),
        'bwd': cs.sdpa_bwd_call(q, k, v, mask, do)}
    for name, (stem, source, n) in variants.items():
        for shape in range(n):
            with using(source, libs['%s%d' % (stem, shape)]):
                check('%s shape %d' % (name, shape), calls[name](),
                      plain[name])
    times = {}
    for rnd in range(rounds):
        for name, (stem, source, n) in variants.items():
            for shape in list(range(n)) + list(reversed(range(n))):
                with using(source, libs['%s%d' % (stem, shape)]):
                    ms = timer.ms(calls[name])
                times.setdefault('%s shape %d' % (name, shape), []).append(ms)
                print('round %d %-13s shape %d: %.4f ms' % (rnd, name, shape,
                                                           ms), flush=True)
            ms = timer.ms(library[name])
            times.setdefault('%s sdpa' % name, []).append(ms)
            print('round %d %-13s sdpa   : %.4f ms' % (rnd, name, ms),
                  flush=True)
    return {'median_ms': {key: statistics.median(vals)
                          for key, vals in times.items()},
            'rounds': rounds, 'fwd_shapes': FWD_SHAPES,
            'bwd_shapes': BWD_SHAPES, 'card': card()}


def phases(buf, blocks, names):
    """Mean cycles a consumer warp of a block spends in each phase."""
    a = buf.view(blocks, 16, 8).cpu()
    a = a[a[:, :, 7] == 1]  # the warps that stamped
    return {n: round(a[:, i].double().mean().item(), 1)
            for i, n in enumerate(names)}


def cycles(dev):
    """The phase split of each kernel, with and without dropout."""
    libs = build([(fa_k.FWD_SOURCE, 'fwd_cycles', ['FLASH_CYCLES']),
                  (fa_k.BWD_SOURCE, 'bwd_cycles', ['FLASH_CYCLES'])])
    for lib in libs.values():
        lib.set_cycles.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    q, k, v, bias, do = inputs(dev)
    b, t, h, _ = q.shape
    blocks = b * h * t // 64  # at most: one warpgroup of 64 rows a block
    bufs = [torch.zeros(blocks * 16 * 8, dtype=torch.int64, device=dev)
            for _ in range(2)]
    flush = torch.ones(64 << 20, device=dev)
    result = {}
    for rate in (0.0, 0.1):
        o, lse = fa_k.flash_attention_plain(q, k, v, False, bias, rate, SEED)
        for lib, source, passes, call in (
                (libs['fwd_cycles'], fa_k.FWD_SOURCE, ['forward'],
                 lambda: fa_k.flash_attention_kernel(q, k, v, False, bias,
                                                     rate, SEED)),
                (libs['bwd_cycles'], fa_k.BWD_SOURCE,
                 ['dK/dV pass', 'dQ pass'],
                 lambda: fa_k.flash_attention_bwd_kernel(
                     q, k, v, bias, o, lse, do, None, False, rate, SEED))):
            with using(source, lib):
                lib.set_cycles(None, None)
                call()  # configures the kernels outside the stamped run
                for x in bufs:
                    x.zero_()
                lib.set_cycles(bufs[0].data_ptr(), bufs[1].data_ptr())
                flush.sum()
                call()
                torch.cuda.synchronize()
                lib.set_cycles(None, None)
            for i, pss in enumerate(passes):
                key = '%s, dropout %.1f' % (pss, rate)
                result[key] = phases(bufs[i], blocks, NAMES[pss])
                print(key, json.dumps(result[key]), flush=True)
    return {'cycles': result, 'card': card('name,power.limit,clocks.sm')}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--rounds', type=int, default=2)
    ap.add_argument('--cycles', action='store_true')
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    dev = torch.device('cuda', 0)
    result = cycles(dev) if args.cycles else shapes(dev, args.rounds)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    print(result['card'])


if __name__ == '__main__':
    main()
