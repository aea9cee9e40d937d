#!/usr/bin/env python3
"""Time the port's embedding scatter-add (K6b) and sparse Adagrad row
update (K7) of several checkouts on one GPU, one process a checkout.

    python3 tools/torch_emb_compare.py DIR [DIR ...] [--out FILE]

Each DIR is the root of a checkout holding ``paddle_tpu_torch``; its
kernels are built from its own sources into its ``build/torch_kernels``.
Give two checkouts as A B B A to see the drift between processes.  Every
case is the device time of one call, 10 calls captured in a CUDA graph
and replayed 10 times, each call after a read of a 256 MB buffer that
evicts the L2 (that read's own time subtracted), as chip_smoke.py's
phase 8 times them.  Inputs come from a seed, the same in every
checkout:

  update[deep]   1,000,001 x 16 table, 106,496 uniform ids (a Wide&Deep
                 step of batch 4096 x 26 fields)
  update[wide]   1,000,001 x 1 table, the same ids
  update[1000]   1000 x 16 table, the same ids modulo 1000
  update[hot]    64 x 16 table, 8192 ids, all but six on row 0 (one run
                 of 8187)
  update[hot, D=k]  the same ids on a 64 x k table, k = 1, 4, 64, 256:
                 the long-run kernel adds a stage of 2048 floats (2048 / k
                 rows of up to 256 columns) at a time, so the sweep
                 separates a stage's fixed cost from a row's
  update[hot x2] 64 x 16 table, 16384 ids, all but six on row 0
  scatter[word]  30522 x 768 output, 4096 uniform ids (BERT-base's word
                 table at batch 8 x seq 512)
  scatter[2-row] 2 x 768 output, 4096 ids all 0 (BERT's sentence table)

Prints one JSON line a checkout, {"checkout", "ms": {case: ms}}, then
the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

SEED = 0
WD_ROWS = 1000001
WD_IDS = 4096 * 26


def cold_ms(torch, fn, reps=10, iters=10):
    """Device time of fn() after an L2-evicting read, CUDA-graph
    replays, the read's own time subtracted."""
    buf = torch.ones(64 << 20, device='cuda')
    sink = torch.empty((), device='cuda')

    def flush():
        torch.sum(buf, dim=0, out=sink)

    def graph_ms(body):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                body()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                body()
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

    def flushed():
        flush()
        fn()
    return graph_ms(flushed) - graph_ms(flush)


def one(checkout):
    """The cases' times with checkout's kernels: {case: ms}."""
    sys.path.insert(0, os.path.abspath(checkout))
    import torch
    from paddle_tpu_torch.ops.kernels import common
    from paddle_tpu_torch.ops.kernels import embedding as emb_k
    if not os.path.abspath(emb_k.__file__).startswith(
            os.path.abspath(checkout)):
        raise RuntimeError('imported %s, not the checkout %s'
                           % (emb_k.__file__, checkout))
    common.build([emb_k.UPDATE_SOURCE, emb_k.SCATTER_SOURCE])
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    lr = torch.full((1,), 1e-3, device=dev)
    ids = torch.randint(0, WD_ROWS, (WD_IDS,), generator=gen, device=dev)
    hot = torch.zeros(8192, dtype=torch.int64, device=dev)
    hot[:6] = torch.tensor([3, 3, -7, 64, 64 + 9, 63], device=dev)
    hot2 = torch.zeros(16384, dtype=torch.int64, device=dev)
    hot2[:6] = hot[:6]
    cases = {}
    tables = [('update[deep]', WD_ROWS, 16, ids),
              ('update[wide]', WD_ROWS, 1, ids),
              ('update[1000]', 1000, 16, ids % 1000),
              ('update[hot]', 64, 16, hot)]
    tables += [('update[hot, D=%d]' % k, 64, k, hot) for k in (1, 4, 64, 256)]
    tables += [('update[hot x2]', 64, 16, hot2)]
    for name, rows, d, case_ids in tables:
        w = torch.randn(rows, d, generator=gen, device=dev)
        m = torch.rand(rows, d, generator=gen, device=dev)
        g = torch.randn(case_ids.numel(), d, generator=gen, device=dev)
        cases[name] = (lambda w=w, m=m, i=case_ids, g=g:
                       emb_k.update_kernel(w, m, i, g, lr, 1e-6))
    tokens = torch.randint(0, 30522, (4096,), generator=gen, device=dev)
    g_bert = torch.randn(4096, 768, generator=gen, device=dev)
    cases['scatter[word]'] = lambda: emb_k.scatter_add_kernel(
        30522, tokens, g_bert)
    cases['scatter[2-row]'] = lambda: emb_k.scatter_add_kernel(
        2, torch.zeros_like(tokens), g_bert)
    return {name: cold_ms(torch, fn) for name, fn in cases.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('checkouts', nargs='*')
    ap.add_argument('--one', help=argparse.SUPPRESS)
    ap.add_argument('--out', help='also write the lines to this file')
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps({'checkout': args.one, 'ms': one(args.one)}))
        return 0
    if not args.checkouts:
        ap.error('name at least one checkout')
    lines = []
    for checkout in args.checkouts:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), '--one', checkout],
            capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            sys.stderr.write(out.stdout + out.stderr)
            return out.returncode
        lines.append(out.stdout.strip().splitlines()[-1])
        print(lines[-1], flush=True)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    lines.append('card: %s' % card)
    print(lines[-1])
    if args.out:
        with open(args.out, 'w') as f:
            f.write('\n'.join(lines) + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
