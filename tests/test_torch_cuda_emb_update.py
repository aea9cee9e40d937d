"""The sparse Adagrad row update (K7) on the card: its own radix sort
against torch.sort, and the whole update against its plain version, at
the sizes on either side of the sort's tiles and the run kernels'
limits.  Marked `cuda`: every test skips where torch has no CUDA device.
Run on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_emb_update.py

Every comparison is bitwise: the sort is an integer permutation, and the
update (built with --fmad=false, no float atomics) sums each run left to
right as the plain version does.  This file imports torch and the port
only.
"""

import pytest
import torch

from paddle_tpu_torch.ops.kernels import common
from paddle_tpu_torch.ops.kernels import embedding as emb_k

pytestmark = pytest.mark.cuda

# one id, two, one either side of 8192 (eight of the sort's 1024-key
# tiles), Wide&Deep's batch of 4096 x 26 ids, and past 2**20
NS = [1, 2, 8191, 8193, 106496, 2 ** 20 + 7]
# one key bit, 10, 20 (Wide&Deep's hashed table) and 25
VS = [2, 1000, 1000001, 2 ** 24 + 1]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


def _gen(dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def _ids(dev, n, rows, seed, dtype=torch.int64):
    """Uniform ids with some below 0 and some at or past rows."""
    ids = torch.randint(-3, rows + 3, (n,), generator=_gen(dev, seed),
                        device=dev)
    return ids.to(dtype)


def _update(dev, rows, d, ids, seed):
    """(kernel's w and m, plain's w and m) from one random start."""
    gen = _gen(dev, seed)
    w = torch.randn(rows, d, generator=gen, device=dev)
    m = torch.rand(rows, d, generator=gen, device=dev)
    g = torch.randn(ids.numel(), d, generator=gen, device=dev)
    lr = torch.full((1,), 0.05, device=dev)
    want = emb_k.update_plain(w, m, ids, g, lr, 1e-6)
    got_w, got_m = w.clone(), m.clone()
    before = common.launches('embedding_update')
    emb_k.update_kernel(got_w, got_m, ids, g, lr, 1e-6)
    assert common.launches('embedding_update') == before + 1
    torch.cuda.synchronize()
    return (got_w, got_m), want


def _assert_bitwise(got, want, what):
    for name, a, b in zip(('w', 'm'), got, want):
        assert torch.equal(a, b), '%s: %s differs by up to %g' % (
            what, name, (a - b).abs().max().item())


@pytest.mark.parametrize('n', NS)
def test_sort_is_the_stable_sort(dev, n):
    for k, rows in enumerate(VS):
        ids = _ids(dev, n, rows, k)
        lib = emb_k._update_lib()
        work = emb_k._update_work(lib, n, rows, dev)
        keys, order = emb_k._update_sort(lib, rows, ids, work)
        want_keys, want_order = torch.sort(ids.clamp(0, rows - 1),
                                           stable=True)
        torch.cuda.synchronize()
        assert keys.dtype == torch.int32 and order.dtype == torch.int32
        assert torch.equal(keys.long(), want_keys), rows
        assert torch.equal(order.long(), want_order), rows


# each n and each V once; D = 1 where the table is 2**24 + 1 rows
@pytest.mark.parametrize('n,rows,d', [(1, 1000001, 16), (2, 2, 16),
                                      (8191, 2 ** 24 + 1, 1), (8193, 2, 4),
                                      (106496, 1000001, 16),
                                      (2 ** 20 + 7, 1000, 16)])
def test_update_is_the_plain_update(dev, n, rows, d):
    got, want = _update(dev, rows, d, _ids(dev, n, rows, 7), 8)
    _assert_bitwise(got, want, '%d ids, %d x %d' % (n, rows, d))


@pytest.mark.parametrize('d', [1, 3, 16, 17, 128])
def test_update_edges(dev, d):
    """Uniform ids with out-of-range ones and a run of 600 equal ids,
    as int64 and as int32, and all 5000 ids equal (one long run)."""
    ids = _ids(dev, 4096, 1000, 11)
    ids[1000:1600] = 321
    for dtype in (torch.int64, torch.int32):
        got, want = _update(dev, 1000, d, ids.to(dtype), 12)
        _assert_bitwise(got, want, '%s ids, D = %d' % (dtype, d))
    equal = torch.full((5000,), 999, dtype=torch.int64, device=dev)
    got, want = _update(dev, 1000, d, equal, 13)
    _assert_bitwise(got, want, 'all ids equal, D = %d' % d)


def test_rows_step_runs_again_on_one_workspace(dev):
    """The run kernel rewrites its tiles' lists of long runs every call,
    so the run and long-run step, launched twice on one sorted workspace
    from the same start, gives the plain update both times."""
    gen = _gen(dev, 21)
    rows, d, n = 64, 16, 8192
    ids = torch.zeros(n, dtype=torch.int64, device=dev)
    ids[:6] = torch.tensor([3, 3, -7, rows, rows + 9, rows - 1], device=dev)
    ids[4000:4100] = 5
    w = torch.randn(rows, d, generator=gen, device=dev)
    m = torch.rand(rows, d, generator=gen, device=dev)
    g = torch.randn(n, d, generator=gen, device=dev)
    lr = torch.full((1,), 0.05, device=dev)
    want = emb_k.update_plain(w, m, ids, g, lr, 1e-6)
    lib = emb_k._update_lib()
    work = emb_k._update_work(lib, n, rows, dev)
    emb_k._update_sort(lib, rows, ids, work)
    for _ in range(2):
        got = (w.clone(), m.clone())
        emb_k._update_rows(lib, work, g, lr, got[0], got[1], 1e-6)
        torch.cuda.synchronize()
        _assert_bitwise(got, want, 'hot rows')


def test_card_path_calls_no_library_sort(dev, monkeypatch):
    ids = _ids(dev, 106496, 1000001, 31)
    gen = _gen(dev, 32)
    w = torch.randn(1000001, 16, generator=gen, device=dev)
    m = torch.rand(1000001, 16, generator=gen, device=dev)
    g = torch.randn(ids.numel(), 16, generator=gen, device=dev)
    lr = torch.full((1,), 0.05, device=dev)
    want = emb_k.update_plain(w, m, ids, g, lr, 1e-6)

    def refuse(*args, **kwargs):
        raise AssertionError('a library sort on the card path')
    for name in ('sort', 'argsort', 'unique', 'unique_consecutive'):
        monkeypatch.setattr(torch, name, refuse)
    monkeypatch.setattr(torch.Tensor, 'sort', refuse)
    monkeypatch.setattr(torch.Tensor, 'argsort', refuse)
    before = common.launches('embedding_update')
    emb_k.update_kernel(w, m, ids, g, lr, 1e-6)
    assert common.launches('embedding_update') == before + 1
    torch.cuda.synchronize()
    monkeypatch.undo()
    _assert_bitwise((w, m), want, 'monkeypatched')
