"""Step wall of LeNet-5 on the card through one checkout of the port, every
flag at its default (the observability plane off): Adam, batch 64, one
synthetic MNIST batch, three ways a user's loop runs it:

- ``replayed``: ``Executor.run``, the plan cached and the step replayed
  from its CUDA graph;
- ``eager``: the cached plan run op by op (``Executor._run_graphed``
  with ``graphs=False``, the path a program that is never captured
  takes);
- ``uncached``: ``Executor.run(use_program_cache=False)``, a plan built
  for each call.

Each step ends with its fetched loss on the host.  To compare two
checkouts on one card, run the script once for each, in the order
A B B A, in one session:

    python3 torch_step_ab.py --tree <checkout> --label <name>

It prints one JSON line: the label, the card's name and power limit as
``nvidia-smi`` gives them, and for each way the median, the quartiles
and the mean of the step wall in ms, over --blocks blocks of --steps
steps (the three ways take turns, block by block).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

BATCH = 64
WARM_STEPS = 20


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else ''


def lenet_step(fluid, lenet, mnist):
    """(step functions by way, the program): LeNet-5 with Adam on
    CUDAPlace(0), its startup run in a scope of its own."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss, _ = lenet.build()
        fluid.optimizer.Adam(1e-3).minimize(loss)
    imgs, labels = mnist._synthetic(BATCH, 0)
    feed = {'img': imgs.reshape(-1, 1, 28, 28),
            'label': labels.reshape(-1, 1)}
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
    fetch = [loss.name]

    def replayed():
        return exe.run(main, feed=feed, fetch_list=fetch)

    def eager():
        plan = exe._get_plan(main, feed, fetch)
        return exe._run_graphed(plan, main, feed, fetch, scope, True,
                                graphs=False)

    def uncached():
        return exe.run(main, feed=feed, fetch_list=fetch,
                       use_program_cache=False)

    return {'replayed': replayed, 'eager': eager,
            'uncached': uncached}, scope


def stats(ms):
    q = statistics.quantiles(ms, n=4)
    return {'median_ms': statistics.median(ms), 'q1_ms': q[0],
            'q3_ms': q[2], 'mean_ms': statistics.fmean(ms),
            'steps': len(ms)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--tree', required=True,
                    help='the checkout whose paddle_tpu_torch runs')
    ap.add_argument('--label', required=True)
    ap.add_argument('--steps', type=int, default=100,
                    help='steps a block')
    ap.add_argument('--blocks', type=int, default=6,
                    help='blocks a way')
    ap.add_argument('--out', default=None,
                    help='also write the JSON line to this file')
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        sys.exit('torch_step_ab.py needs a CUDA card')
    import paddle_tpu_torch
    if not os.path.abspath(paddle_tpu_torch.__file__).startswith(tree):
        sys.exit('paddle_tpu_torch came from %s, not %s' % (
            paddle_tpu_torch.__file__, tree))
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.dataset import mnist
    from paddle_tpu_torch.models import lenet
    ways, scope = lenet_step(fluid, lenet, mnist)
    ms = {w: [] for w in ways}
    with fluid.scope_guard(scope):
        for fn in ways.values():
            for _ in range(WARM_STEPS):
                fn()
        for _ in range(args.blocks):
            for w, fn in ways.items():
                for _ in range(args.steps):
                    t0 = time.perf_counter()
                    fn()
                    ms[w].append((time.perf_counter() - t0) * 1e3)
    line = json.dumps({'label': args.label, 'card': card_line(),
                       'ways': {w: stats(v) for w, v in ms.items()}})
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'a') as f:
            f.write(line + '\n')


if __name__ == '__main__':
    main()
