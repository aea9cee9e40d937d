"""The multi-tensor finite check (ops/kernels/finite_check.py) and
FLAGS_check_nan_inf on it, on the CPU.

- the plain version gives one byte per tensor, 1 where numpy's isfinite
  holds everywhere, on f32, bf16, f16 and f64 tensors with inf, -inf
  and NaN, and 1 on empty tensors;
- the kernel's table (pointer, elements, kind, first block) cuts each
  tensor into 16384-element blocks, gives an empty tensor no block,
  reads a permuted tensor in place and a strided view through a
  contiguous copy;
- a step with a parameter set to inf raises FloatingPointError naming
  the same non-finite variables as the JAX package's ``_check_nan_inf``
  on the same program (every written value fetched, so the JAX
  package's segment outputs are the port's checked values), with the
  op that first went non-finite in its notes; the step's verdicts come
  from one finite_check call.

The kernel is held bitwise to the plain version on the card in
tests/test_torch_cuda_graph_control.py and chip_smoke.py.
"""

import re

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

import paddle_tpu.fluid as jfluid

import torch

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.fluid import flags as tflags
from paddle_tpu_torch.ops.kernels import finite_check as fc


def _tensors(seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for k, dtype in enumerate([torch.float32, torch.bfloat16, torch.float16,
                               torch.float64] * 3):
        n = [0, 1, 7, 40000][k % 4]
        a = rng.randn(n).astype('float32')
        if n and k % 3:
            a[rng.randint(n)] = [np.inf, np.nan, -np.inf][k % 3]
        out.append(torch.from_numpy(a).to(dtype))
    return out


def test_plain_version_is_numpys_isfinite():
    ts = _tensors()
    got = fc.finite_check_plain(ts)
    want = [int(np.isfinite(t.float().numpy()).all()) for t in ts]
    assert got.dtype == torch.uint8 and got.tolist() == want
    assert 0 in want and 1 in want
    assert fc.finite_check(ts).tolist() == want   # CPU: the plain version
    assert fc.finite_check([]).shape == (0,)


def test_bf16_and_empty_tensors():
    big = torch.full((70000,), 3.0, dtype=torch.bfloat16)
    assert fc.finite_check_plain([big, torch.zeros(0)]).tolist() == [1, 1]
    big[69999] = float('inf')
    assert fc.finite_check_plain([big]).tolist() == [0]
    # the largest bf16 is finite, its next step is not
    top = torch.tensor([3.3895e38], dtype=torch.bfloat16)
    assert fc.finite_check_plain([top]).tolist() == [1]


def test_table_cuts_blocks_and_copies_only_strided_views():
    a = torch.zeros(fc.CHUNK)
    b = torch.zeros(fc.CHUNK + 1, dtype=torch.bfloat16)
    e = torch.zeros(0, dtype=torch.float16)
    perm = torch.zeros(64, 48).t()
    strided = torch.zeros(64, 48)[:, ::2]
    rows, blocks, kept = fc.table([a, b, e, perm, strided])
    assert rows[:, 1].tolist() == [fc.CHUNK, fc.CHUNK + 1, 0, 3072, 1536]
    assert rows[:, 2].tolist() == [0, 1, 2, 0, 0]
    assert rows[:, 3].tolist() == [0, 1, 3, 3, 4]
    assert blocks == 5
    assert rows[0, 0] == a.data_ptr() and rows[3, 0] == perm.data_ptr()
    assert len(kept) == 1 and kept[0].is_contiguous()
    assert fc.dense(perm) and not fc.dense(strided)
    with pytest.raises(TypeError, match='f32, bf16, f16 and f64'):
        fc.table([torch.zeros(2, dtype=torch.int32)])


def _nan_prog(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=[4], dtype='float32')
        h = fluid.layers.fc(x, 3, bias_attr=False)
        r = fluid.layers.relu(h)
        ok = fluid.layers.scale(x, scale=2.0)
        loss = fluid.layers.mean(r)
    return main, startup, [h, r, ok, loss]


def _bad_names(err):
    m = re.search(r'nan/inf detected in (\d+) var\(s\) \[([^\]]*)\]', err)
    names = [n.strip() for n in m.group(2).split(',')]
    assert int(m.group(1)) == len(names)
    return names


@pytest.fixture
def nan_flags():
    tflags.set_flags({'FLAGS_check_nan_inf': True})
    jfluid.set_flags({'FLAGS_check_nan_inf': True})
    yield
    tflags.set_flags({'FLAGS_check_nan_inf': False})
    jfluid.set_flags({'FLAGS_check_nan_inf': False})


def test_injected_inf_names_the_jax_packages_variables(nan_flags):
    xv = np.abs(np.random.RandomState(2).randn(2, 4)).astype('float32')
    errs, start = {}, None
    for fluid in (jfluid, tfluid):
        main, startup, fetch = _nan_prog(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            names = weights.startup_names(startup)
            if start is None:
                start = weights.numpy_state(scope, names)
            else:
                weights.load_numpy_params(scope, start, fluid.CPUPlace(),
                                          startup)
            good = exe.run(main, feed={'x': xv}, fetch_list=fetch)
            assert all(np.isfinite(np.asarray(v)).all() for v in good)
            w = [p.name for p in main.all_parameters()][0]
            scope.set_var(w, np.full(start[w].shape, np.inf, 'float32'))
            with pytest.raises(FloatingPointError) as e:
                exe.run(main, feed={'x': xv}, fetch_list=fetch)
        errs[fluid] = e.value
    tnames, jnames = _bad_names(str(errs[tfluid])), \
        _bad_names(str(errs[jfluid]))
    assert sorted(tnames) == sorted(jnames)
    assert len(tnames) == 3 and fetch[2].name not in tnames
    notes = '\n'.join(getattr(errs[tfluid], '__notes__', []))
    assert 'mul' in notes   # the provenance: the first op that went bad


def test_step_checks_in_one_call(nan_flags, monkeypatch):
    calls = []
    real = fc.finite_check

    def spy(tensors, device=None):
        calls.append(len(tensors))
        return real(tensors, device)
    monkeypatch.setattr(fc, 'finite_check', spy)
    main, startup, fetch = _nan_prog(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        calls.clear()
        exe.run(main, feed={'x': np.ones((2, 4), 'float32')},
                fetch_list=fetch)
    assert calls == [4]
