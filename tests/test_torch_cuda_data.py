"""The dropout op's kernel and the data plane on the card.  Marked
`cuda`: every test skips where torch has no CUDA device.  Run the
card-only tests on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_*.py

This file imports torch and the port only.

- the dropout kernel bitwise its plain version (f32, bf16, both
  implementations, p 0.1 / 0 / 1, NaN and inf inputs, an odd element
  count, non-contiguous and offset views, a second launch), its
  gradient bitwise autograd through the plain version, and no fallback
  (an unsupported dtype raises);
- the DataLoader's staging: the batches arrive on the card with no
  synchronizing call (``torch.cuda.set_sync_debug_mode('error')``), the
  native feeder's batches in pinned memory;
- a load_persistables into the running scope keeps the step's CUDA graph
  (no capture, no stale graph) and the replay gives the first run's
  loss again; a program holding host ops replays its device ops from a
  graph and runs the host ops at every step.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import compile_cache
from paddle_tpu_torch.ops.kernels import common
from paddle_tpu_torch.ops.kernels import dropout as dk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _x(dev, shape, dtype, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn(*shape, generator=g, device=dev)
    special = torch.tensor([float('nan'), float('inf'), -float('inf'),
                            -0.0], device=dev)[:x.numel()]
    x.view(-1)[:special.numel()] = special
    return x.to(dtype)


@pytest.mark.parametrize('p', [0.1, 0.0, 1.0])
@pytest.mark.parametrize('upscale', [True, False])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_dropout_kernel_is_its_plain_version_bitwise(dev, dtype, upscale, p):
    seed = torch.tensor(2 ** 32 - 5, device=dev)
    for shape in ((8, 512, 768), (3, 5, 7), (1,)):
        x = _x(dev, shape, dtype)
        out, mask = dk.dropout_kernel(x, seed, p, upscale)
        out2, mask2 = dk.dropout_kernel(x, seed, p, upscale)
        want, want_mask = dk.dropout_plain(x, seed, p, upscale)
        torch.cuda.synchronize()
        assert torch.equal(_bits(out), _bits(want)), shape
        assert torch.equal(_bits(mask), _bits(want_mask)), shape
        assert torch.equal(_bits(out), _bits(out2)) and \
            torch.equal(mask, mask2)


def test_dropout_kernel_views_gradient_and_no_fallback(dev):
    seed = torch.tensor(77, device=dev)
    x = torch.randn(64, 64, 2049, device=dev)
    for view in (x[..., 1:], x.view(-1)[1:1 + 64 * 64 * 2048]):
        out, mask = dk.dropout_kernel(view, seed, 0.1, True)
        want, want_mask = dk.dropout_plain(view.contiguous(), seed, 0.1,
                                           True)
        assert torch.equal(out, want) and torch.equal(mask, want_mask)
    for dtype in (torch.float32, torch.bfloat16):
        for upscale in (True, False):
            xa = _x(dev, (4, 33, 65), dtype).requires_grad_()
            g = torch.randn(4, 33, 65, device=dev).to(dtype)
            before = common.launches('dropout')
            got, = torch.autograd.grad(
                dk.dropout(xa, seed, 0.1, upscale)[0], xa, g)
            assert common.launches('dropout') == before + 1
            xb = xa.detach().clone().requires_grad_()
            keep = dk.hash_keep(seed, xb.shape, 0.1, dev)
            want, = torch.autograd.grad(
                dk.apply_keep(xb, keep, 0.1, upscale)[0], xb, g)
            assert torch.equal(_bits(got), _bits(want))
    with pytest.raises(TypeError, match='f32 or bf16'):
        dk.dropout(torch.ones(8, device=dev, dtype=torch.float64), seed,
                   0.1, True)
    with pytest.raises(ValueError, match='seed'):
        dk.dropout_kernel(torch.ones(8, device=dev), torch.tensor(1), 0.1,
                          True)


def test_loader_stages_without_a_synchronizing_call(dev):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=[256], dtype='float32')
        y = fluid.layers.data('y', shape=[1], dtype='int64')
    data = [(np.full((64, 256), i, 'float32'),
             np.full((64, 1), i, 'int64')) for i in range(6)]
    loader = fluid.io.DataLoader.from_generator(
        feed_list=[x, y], capacity=2, use_double_buffer=True)
    loader.set_batch_generator(lambda: iter(data),
                               places=fluid.cuda_places())
    it = iter(loader)
    first = next(it)  # the pinned-memory pool's first allocations
    got = [first]
    torch.cuda.set_sync_debug_mode('error')
    try:
        got += [next(it) for _ in range(5)]
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert next(it, None) is None
    for i, b in enumerate(got):
        assert b['x'].is_cuda and b['y'].dtype == torch.int64
        assert float(b['x'][0, 0]) == i and int(b['y'][-1, 0]) == i
    loader2 = fluid.io.DataLoader.from_generator(
        feed_list=[x, y], capacity=2, use_double_buffer=True,
        stage_exclude=['y'])
    loader2.set_batch_generator(lambda: iter(data),
                                places=fluid.cuda_places())
    b = next(iter(loader2))
    assert b['x'].is_cuda and isinstance(b['y'], np.ndarray)


def test_native_feeder_writes_pinned_batches(dev, tmp_path):
    path = str(tmp_path / 'part-0')
    rng = np.random.RandomState(0)
    with open(path, 'w') as f:
        for _ in range(70):
            f.write('2 %f %f 3 %d %d %d 1 %d\n' % (
                rng.rand(), rng.rand(), *rng.randint(0, 50, 3),
                rng.randint(2)))
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        d = fluid.layers.data('d', shape=[2], dtype='float32')
        s = fluid.layers.data('s', shape=[3], dtype='int64')
        y = fluid.layers.data('y', shape=[1], dtype='int64')
    ds = fluid.DatasetFactory().create_dataset('InMemoryDataset')
    ds.set_batch_size(32)
    ds.set_filelist([path])
    ds.set_use_var([d, s, y])
    ds.load_into_memory()
    batches = list(ds.batches())
    assert [int(b['y'].shape[0]) for b in batches] == [32, 32, 6]
    assert all(v.is_pinned() for b in batches for v in b.values())


def _program():
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=[16], dtype='float32')
        h = fluid.layers.dropout(fluid.layers.fc(x, size=32, act='relu'),
                                 0.1, dropout_implementation=
                                 'upscale_in_train')
        loss = fluid.layers.mean(fluid.layers.fc(h, size=1))
        fluid.optimizer.Adam(1e-3).minimize(loss)
    return main, startup, loss


def test_a_load_into_the_running_scope_keeps_the_graph(dev, tmp_path):
    main, startup, loss = _program()
    x = np.random.RandomState(1).randn(8, 16).astype('float32')
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    d = str(tmp_path / 'ckpt')
    with fluid.scope_guard(scope):
        exe.run(startup)
        step0 = exe._step
        fluid.io.save_persistables(exe, d, main, save_format='paddle')
        losses = [float(exe.run(main, feed={'x': x},
                                fetch_list=[loss])[0]) for _ in range(3)]
        before = compile_cache.plane().stats()
        held = {v.name: scope.find_var(v.name)
                for v in fluid.io._persistable_vars(main)}
        fluid.io.load_persistables(exe, d, main)
        assert all(scope.find_var(n) is t for n, t in held.items())
        # the checkpoint holds no executor step, which seeds the dropout
        # masks: set back by hand for the same step
        exe._step = step0
        again = float(exe.run(main, feed={'x': x}, fetch_list=[loss])[0])
        after = compile_cache.plane().stats()
    assert again == losses[0]
    assert after['graph_captures'] == before['graph_captures']
    assert after['graph_stale'] == before['graph_stale']
    assert after['graph_replays'] == before['graph_replays'] + 1


def test_a_program_with_a_host_op_runs_eagerly(dev, tmp_path, capsys):
    main, startup, loss = _program()
    with fluid.program_guard(main):
        fluid.layers.Print(loss, message='loss')
    path = str(tmp_path / 'saved')
    main.global_block().append_op('save', inputs={'X': [loss]},
                                  outputs={}, attrs={'file_path': path})
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    x = np.random.RandomState(1).randn(8, 16).astype('float32')
    with fluid.scope_guard(scope):
        exe.run(startup)
        before = compile_cache.plane().stats()
        out = [exe.run(main, feed={'x': x}, fetch_list=[loss])[0]
               for _ in range(3)]
        after = compile_cache.plane().stats()
    # the device ops before the host ops replay from one graph; print
    # and save run on the host at every step
    assert after['graph_captures'] == before['graph_captures'] + 1
    assert capsys.readouterr().out.count('loss ') == 3
    assert np.array_equal(np.load(path + '.npy'), out[-1])
