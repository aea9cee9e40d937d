"""uniform_random, gaussian_random and gaussian_random_batch_size_like
in a main program draw on the device from the counter hash under the
device step (ops/tensor_ops.py ``_unit`` / ``normal_draws``), so a
CUDA graph replays each step's own draws; in a startup program the
random initializers keep the host generator, so every parameter's
initial value is what it was before main programs drew on the device.

Held on the CPU: the draws' moments over 10^6 values, at 6 sigma of
their sampling error (a chi-square over 20 bins for the uniform, at
its 1 - 1e-6 quantile); each step draws anew, the same step again the
same; the startup values bitwise the checksums recorded from the host
path before the change (sha256 of each array's bytes, first 16 hex
digits); the capture refusal: a main program holding the ops may be
captured, a startup program holding them is refused by name.
"""

import hashlib

import numpy as np
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor
from paddle_tpu_torch.ops import registry

N = 1000000

# recorded from the host-generator path of the parent commit
STARTUP_SHA256 = {
    'conv2d_0.w_0': 'de01a5b1e32b3d20', 'conv2d_0.w_1': '374708fff7719dd5',
    'embedding_0.w_0': '053394bb6e524267', 'fc_0.w_0': '477457a8c51f1bf2',
    'fc_0.w_1': 'f5a5fd42d16a2030', 'gauss': '87bbc0d866a49a72',
    'learning_rate_0': 'fb360f7241a770dc', 'unif': '0740d050d1c6fb4e',
}


def _draw_program():
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data('x', [4], dtype='float32')
        u = fluid.layers.uniform_random([1000, 1000], min=-2.0, max=3.0)
        g = fluid.layers.gaussian_random([1000, 1000], mean=1.0, std=0.5)
        b = fluid.layers.gaussian_random_batch_size_like(
            x, [-1, 250], mean=-1.0, std=2.0)
    return main, startup, [u, g, b]


def _run(main, startup, fetch, steps):
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        feed = {'x': np.zeros((4000, 4), 'float32')}
        return [exe.run(main, feed=feed, fetch_list=fetch)
                for _ in range(steps)]


def test_main_program_draws_and_their_statistics():
    main, startup, fetch = _draw_program()
    runs = _run(main, startup, fetch, 2)
    u, g, b = runs[0]
    assert u.shape == g.shape == (1000, 1000) and b.shape == (4000, 250)
    assert u.min() >= -2.0 and u.max() < 3.0
    assert abs(u.mean() - 0.5) < 6 * (5.0 / np.sqrt(12)) / np.sqrt(N)
    counts = np.histogram(u, bins=20, range=(-2.0, 3.0))[0]
    chi2 = float(((counts - N / 20.0) ** 2 / (N / 20.0)).sum())
    assert chi2 < 56.0, chi2   # chi-square(19) at 1 - 1e-6: 55.6
    for v, mean, std in ((g, 1.0, 0.5), (b, -1.0, 2.0)):
        assert abs(v.mean() - mean) < 6 * std / np.sqrt(N)
        assert abs(v.std() - std) < 6 * std / np.sqrt(2 * N)
    # each step draws anew; a new executor over the same steps again
    for a, c in zip(runs[0], runs[1]):
        assert not np.array_equal(a, c)
    again = _run(main, startup, fetch, 2)
    for r, s in zip(runs, again):
        for a, c in zip(r, s):
            np.testing.assert_array_equal(a, c)


def test_the_same_step_draws_the_same_values():
    """The lowering's draws are a function of (program seed, op seed,
    step): what a replayed graph reproduces."""
    op = registry.get('uniform_random')
    attrs = {'shape': [64], 'min': 0.0, 'max': 1.0, 'seed': 0}

    def draw(step, seed=3):
        ctx = registry.LowerCtx(step, seed, device='cpu', random_seed=5)
        return op.run(ctx, {}, attrs)['Out'][0]
    assert torch.equal(draw(4), draw(4))
    assert not torch.equal(draw(4), draw(5))
    assert not torch.equal(draw(4), draw(4, 7))
    host = registry.LowerCtx(4, 3, device='cpu', random_seed=5,
                             host_draws=True)
    assert not torch.equal(op.run(host, {}, attrs)['Out'][0], draw(4))


def test_startup_initializers_bitwise_the_host_path():
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data('x', [3, 8, 8], dtype='float32')
        ids = fluid.layers.data('ids', [1], dtype='int64')
        h = fluid.layers.fc(fluid.layers.conv2d(x, 4, 3), 16, act='relu')
        e = fluid.layers.embedding(ids, [50, 8])
        w = fluid.layers.create_parameter(
            [5, 7], 'float32', name='gauss',
            default_initializer=fluid.initializer.Normal(0.5, 2.0))
        u = fluid.layers.create_parameter(
            [300], 'float32', name='unif',
            default_initializer=fluid.initializer.Uniform(-0.3, 0.7, seed=5))
        loss = fluid.layers.mean(h) + fluid.layers.mean(e) + \
            fluid.layers.mean(w) + fluid.layers.mean(u)
        fluid.optimizer.SGD(0.1).minimize(loss)
    assert startup._is_start_up_program_ and not main._is_start_up_program_
    types = [op.type for op in startup.global_block().ops]
    assert 'uniform_random' in types and 'gaussian_random' in types
    with fluid.scope_guard(fluid.Scope()):
        fluid.Executor(fluid.CPUPlace()).run(startup)
        got = {n: hashlib.sha256(np.ascontiguousarray(np.asarray(
            fluid.global_scope().find_var(n))).tobytes()).hexdigest()[:16]
            for n in STARTUP_SHA256}
    assert got == STARTUP_SHA256


def test_capture_refused_by_name_only_in_a_startup_program():
    main, startup, fetch = _draw_program()
    plan = executor._build_plan(main, [v.name for v in fetch])
    assert plan.no_graph is None
    init_main, init_startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(init_main, init_startup):
        fluid.layers.create_parameter(
            [3], 'float32', default_initializer=fluid.initializer.Uniform())
    why = executor._build_plan(init_startup, []).no_graph
    assert why is not None and 'uniform_random' in why and \
        'startup' in why
    # the clone of a startup program is one too
    assert init_startup.clone()._is_start_up_program_
    assert fluid.default_startup_program()._is_start_up_program_
