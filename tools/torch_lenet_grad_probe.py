#!/usr/bin/env python3
"""Where one f32 LeNet-5 step on the GPU parts from the same step on the
CPU: every forward value and gradient of the step, each held against the
same step computed in float64 on the CPU.

    python3 tools/torch_lenet_grad_probe.py

The program, its initial state and its batch are chip_smoke.py's phase
17 (b) (LeNet-5 under SGD, batch 16 of synthetic MNIST, from seed 0).
Prints one row a variable: its size, and the largest distance of the CPU
f32 value, the GPU f32 value and the GPU f32 value under cuDNN's
deterministic algorithms from the float64 value, each as a share of the
float64 value's largest magnitude; then the card's name and power limit.
TF32 is off, as chip_smoke.py sets it.
"""

import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

fluid, weights = cs.fluid, cs.weights


def step_values(program, place, feed, state, names, dtype):
    """{name: ndarray} of `names` after one step of `program` on `place`
    from `state`, cast to `dtype` where it is floating."""
    main, startup, _, _ = program
    exe, scope = fluid.Executor(place), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        weights.load_numpy_params(scope, {
            n: v.astype(dtype) if v.dtype.kind == 'f' else v
            for n, v in state.items()}, place, startup)
        return dict(zip(names, cs.eager_run(exe, main, feed, names)))


def main():
    if not torch.cuda.is_available():
        print('torch_lenet_grad_probe: no GPU', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build = lambda o, loss: o.SGD(0.01).minimize(loss)  # noqa: E731
    f32 = cs.lenet_optimizer_program(0, build, 'float32')
    f64 = cs.lenet_optimizer_program(0, build, 'float64')
    block = f32[0].global_block()
    names = []
    for op in block.ops:
        if op.attrs.get('__op_role__') == 'optimize':
            continue
        for ns in op.outputs.values():
            for n in ns:
                v = block._find_var_recursive(n)
                if v is not None and not v.persistable and n not in names:
                    names.append(n)
    cpu, card = fluid.CPUPlace(), fluid.CUDAPlace(0)
    exe, scope = fluid.Executor(cpu), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(f32[1])
        state = weights.numpy_state(scope, weights.startup_names(f32[1]))
    feed = cs.lenet_feeds(0, np.float32)[0]
    feed64 = dict(feed, img=feed['img'].astype(np.float64))
    truth = step_values(f64, cpu, feed64, state, names, np.float64)
    sides = [step_values(f32, cpu, feed, state, names, np.float32),
             step_values(f32, card, feed, state, names, np.float32)]
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        sides.append(step_values(f32, card, feed, state, names,
                                 np.float32))
    finally:
        torch.backends.cudnn.deterministic = saved
    print('%-30s %7s %10s %10s %14s' % ('variable', 'size', 'CPU f32',
                                        'GPU f32', 'deterministic'))
    for n in names:
        t = np.asarray(truth[n], np.float64)
        if t.dtype.kind != 'f' or t.size == 0:
            continue
        s = max(float(np.abs(t).max()), 1e-30)
        print('%-30s %7d %10.2e %10.2e %14.2e' % ((n[:30], t.size) + tuple(
            float(np.abs(np.asarray(v[n], np.float64) - t).max()) / s
            for v in sides)))
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True,
        text=True).stdout.strip())
    return 0


if __name__ == '__main__':
    sys.exit(main())
