"""The observability plane on the card, at a small size.  Marked `cuda`:
every test skips where torch has no CUDA device.  Run the card-only
tests on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_*.py

This file imports torch and the port only.

- the 'Default' profiler over eager steps of a small BERT: the rows,
  unattributed included, sum to the profiled device time, K1's and K2's
  kernels sit under fused_multihead_attention and its grad, and the
  op-cost worklist names them as the cover of those runs;
- a replayed step: one step record with the replay's spans only (the
  capture recorded nothing), the device union over the streams at most
  the step's wall;
- memviz on the card: a program's first run measured under FLAGS_memviz
  (peak_bytes is torch.cuda.max_memory_allocated of the run, the row's
  parts sum to it) and live_census against torch.cuda.memory_allocated.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import memviz, opprof, profiler, trace
from paddle_tpu_torch.models import bert

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    yield torch.device('cuda', 0)
    trace.disable()
    trace.reset()
    opprof.reset()
    fluid.set_flags({'FLAGS_memviz': False})


# a small BERT at seq 512, where the program takes the fused attention
# op (bert.BertConfig.flash_min_len), with K1's head size 64
SMALL = bert.BertConfig(vocab_size=1000, hidden=128, layers=2, heads=2,
                        intermediate=256, max_pos=512)


def _bert(seq=512, batch=2):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 1
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = bert.build_pretrain(SMALL, seq_len=seq)
        fluid.optimizer.Adam(1e-4).minimize(loss)
    feed = bert.synthetic_batch(SMALL, batch, seq, np.random.RandomState(0))
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
    return main, loss, feed, exe, scope


def _eager(exe, main, feed, fetch):
    plan = exe._get_plan(main, feed, fetch)
    return exe._run_graphed(plan, main, feed, fetch, fluid.global_scope(),
                            True, graphs=False)


def test_default_profile_attributes_k1_k2_and_sums(dev, capsys):
    main, loss, feed, exe, scope = _bert()
    with fluid.scope_guard(scope):
        _eager(exe, main, feed, [loss.name])
        with profiler.profiler('All', tracer_option='Default'):
            for _ in range(2):
                _eager(exe, main, feed, [loss.name])
            torch.cuda.synchronize()
    capsys.readouterr()
    last = profiler.last_profile()
    total = sum(r['total'] for r in last['rows'].values()) * 1e3
    assert total == pytest.approx(last['device']['sum_ms'], rel=1e-2)
    assert last['device']['union_ms'] <= last['device']['sum_ms'] + 1e-9
    k = last['kernels']
    assert any('flash_fwd' in n for n in k['fused_multihead_attention'])
    assert any('flash_bwd' in n
               for n in k['fused_multihead_attention_grad'])
    opprof.record_capture(profiler.last_events(), program='tiny', steps=2)
    covers = {r['op_type']: r['covered_by']
              for r in opprof.kernel_worklist(limit=64)}
    assert covers['fused_multihead_attention'] == 'flash_attention'
    assert covers['fused_multihead_attention_grad'] == 'flash_attention_bwd'


def test_replayed_step_records_once_and_union_fits_the_wall(dev, capsys):
    main, loss, feed, exe, scope = _bert()
    with fluid.scope_guard(scope):
        trace.enable(buffer_steps=8)
        for _ in range(3):          # eager, captured, replayed
            exe.run(main, feed=feed, fetch_list=[loss])
        recs = trace.steps()
        assert len(recs) == 3
        for rec in recs[1:]:
            names = [s[0] for s in rec['spans']]
            assert 'bind' not in names and names.count('dispatch') == 1
        trace.disable()
        import time
        with profiler.profiler('All', tracer_option='Default'):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            exe.run(main, feed=feed, fetch_list=[loss])
            wall = (time.perf_counter() - t0) * 1e3
    capsys.readouterr()
    dev_t = profiler.last_profile()['device']
    assert 0 < dev_t['union_ms'] <= wall


def test_memviz_measures_the_first_run_on_the_card(dev):
    main, loss, feed, exe, scope = _bert()
    fluid.set_flags({'FLAGS_memviz': True})
    with fluid.scope_guard(scope):
        memviz.note_params(p.name for p in main.all_parameters())
        exe.run(main, feed=feed, fetch_list=[loss])
        peak = torch.cuda.max_memory_allocated()
        row = [r for r in memviz.report()
               if r['program'] == memviz.program_label(main)][0]
        census = memviz.live_census(scope)
        alloc = torch.cuda.memory_allocated()
    assert not row.get('estimated')
    assert row['peak_bytes'] == pytest.approx(peak, rel=1e-2)
    parts = sum(row['classes'].values()) + row['output_bytes'] + \
        row['temp_bytes'] + row['other_bytes']
    assert parts == pytest.approx(row['peak_bytes'])
    assert census['total_bytes'] == pytest.approx(alloc, abs=1 << 20)
    assert census['classes']['param'] > 0
