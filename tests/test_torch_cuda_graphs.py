"""Serving from CUDA graphs on the card (fluid/cuda_graph.py): a small
BERT encoder (2 layers, hidden 64, 2 heads of 32, seq 64,
flash_min_len 0 so attention is K1's fused op; K6 for the three
tables) saved and served by ``create_paddle_predictor`` on
CUDAPlace(0).

- every bucket's replays are bitwise the eager answer
  (``_use_program_cache = False``: a plan built for the request, run
  op by op);
- the wrappers count an eager run's launches, and a replay's kernels
  count as replayed launches through the graph's manifest;
- a ``set_var`` after the capture makes the next request run eagerly
  and capture again, and the answer follows the new value; a host
  value set between the first run and the capture is moved to the
  device before it;
- two predictors of one model each replay graphs of their own;
- ``FLAGS_torch_kernels_plain`` keys another graph, which launches no
  kernel;
- ``return_numpy=False`` outputs survive the next replay;
- ``Executor.warmup`` captures ahead of the first request, and ahead
  of a training program's first step, whose replays are its eager
  steps bitwise;
- a predictor's graphs go with its scope;
- a capture that hits a host sync fails, and its signature is served
  eagerly from then on;
- ``Executor.compile`` of a serving program replays its graph.

Marked `cuda`: every test skips where torch has no CUDA device.  Run on
a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_*.py

This file imports torch and the port only.
"""

import functools

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import compile_cache
from paddle_tpu_torch.fluid import executor
from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.ops.kernels import common

pytestmark = pytest.mark.cuda

SEQ = 64
LAYERS = 2
FEEDS = ('src_ids', 'pos_ids', 'sent_ids', 'input_mask')


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


def _cfg():
    cfg = bert.BertConfig(vocab_size=1000, hidden=64, layers=LAYERS,
                          heads=2, intermediate=128, max_pos=SEQ)
    cfg.flash_min_len = 0
    return cfg


@pytest.fixture
def model_dir(dev, tmp_path):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feeds = bert.encoder_feeds(SEQ)
        enc = bert.bert_encoder(feeds['src_ids'], feeds['pos_ids'],
                                feeds['sent_ids'], feeds['input_mask'],
                                _cfg(), is_test=True)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(str(tmp_path), list(FEEDS), [enc],
                                      exe, main_program=main)
    compile_cache.reset_plane()
    yield str(tmp_path)
    compile_cache.reset_plane()


def _request(batch, seed):
    return bert.encoder_batch(_cfg(), batch, SEQ,
                              np.random.RandomState(seed),
                              pad_to=SEQ - 5 * batch)


def _counted(fn):
    common.reset_launches()
    out = fn()
    return out, {k: common.launches(k) for k in common.KERNELS
                 if common.launches(k)}


def _replayed(fn):
    """(launches, replayed launches) of fn() by kernel."""
    _, launched = _counted(fn)
    return launched, {k: common.replayed(k) for k in common.KERNELS
                      if common.replayed(k)}


def _stat(name):
    return compile_cache.counter_value('executor/' + name)


def _eager_run(exe, program, feed, fetch_list):
    """Executor.run's path without its CUDA graph: the cached plan run
    op by op."""
    fetch = executor._fetch_names(fetch_list)
    plan = exe._get_plan(program, feed, fetch)
    return exe._run_graphed(plan, program, feed, fetch,
                            fluid.global_scope(), True, graphs=False)


EXPECTED = {'flash_attention': LAYERS, 'embedding_lookup': 3}


def test_replays_are_bitwise_eager_at_every_bucket(model_dir):
    pred = create_paddle_predictor(AnalysisConfig(model_dir))
    for batch in (1, 3, 8):
        req = _request(batch, batch)
        pred._use_program_cache = False
        eager = pred.run_dict(req)[0]
        pred._use_program_cache = True
        captures = _stat('graph_captures')
        for i in range(4):  # eager, capture + replay, replays
            got = pred.run_dict(req)[0]
            assert got.shape == (batch, SEQ, 64)
            assert np.array_equal(got, eager), (batch, i)
        assert _stat('graph_captures') == captures + 1


def test_replay_launch_counts_come_from_the_manifest(model_dir):
    pred = create_paddle_predictor(AnalysisConfig(model_dir))
    req = _request(4, 0)
    counts = [_replayed(lambda: pred.run_dict(req)) for _ in range(4)]
    # the first run launches at the wrappers; the capture records its
    # launches, and it and every replay count them as replayed
    assert counts == [(EXPECTED, {})] + [({}, EXPECTED)] * 3
    replays = _stat('graph_replays')
    assert _replayed(lambda: pred.run_dict(req)) == ({}, EXPECTED)
    assert _stat('graph_replays') == replays + 1


def test_set_var_after_capture_captures_again(model_dir):
    pred = create_paddle_predictor(AnalysisConfig(model_dir))
    req = _request(2, 1)
    for _ in range(3):
        before = pred.run_dict(req)[0]
    name = 'layer_norm_0.w_0'
    scope = pred._scope
    scope.set_var(name, scope.find_var(name) * 2.0)
    stale, captures = _stat('graph_stale'), _stat('graph_captures')
    after = [pred.run_dict(req)[0] for _ in range(3)]
    assert _stat('graph_stale') == stale + 1
    assert _stat('graph_captures') == captures + 1
    pred._use_program_cache = False
    want = pred.run_dict(req)[0]
    assert not np.array_equal(want, before)
    for got in after:
        assert np.array_equal(got, want)


def test_a_host_value_set_before_the_capture(model_dir):
    """A numpy value set between a signature's first run and its
    capture moves to the device before the capture: every answer is
    the eager one, and the signature is captured and replayed."""
    pred = create_paddle_predictor(AnalysisConfig(model_dir))
    req = _request(2, 7)
    first = pred.run_dict(req)[0]
    name = 'layer_norm_0.w_0'
    scope = pred._scope
    scope.set_var(name, scope.find_var(name).cpu().numpy() * 2.0)
    refused, replays = _stat('graph_refused'), _stat('graph_replays')
    got = [pred.run_dict(req)[0] for _ in range(2)]
    assert _stat('graph_refused') == refused
    assert _stat('graph_replays') == replays + 2
    assert isinstance(scope.find_var(name), torch.Tensor)
    pred._use_program_cache = False
    want = pred.run_dict(req)[0]
    assert not np.array_equal(want, first)
    for out in got:
        assert np.array_equal(out, want)


def test_two_predictors_of_one_model_each_replay(model_dir):
    """Graphs are kept per scope: two predictors of one model dir,
    asked in turn, capture once each and then both replay."""
    preds = [create_paddle_predictor(AnalysisConfig(model_dir))
             for _ in range(2)]
    req = _request(2, 8)
    captures, replays = _stat('graph_captures'), _stat('graph_replays')
    outs = [[p.run_dict(req)[0] for p in preds] for _ in range(4)]
    assert _stat('graph_captures') == captures + 2
    assert _stat('graph_replays') == replays + 6
    for pair in outs:
        for out in pair:
            assert np.array_equal(out, outs[0][0])


def test_plain_flag_keys_its_own_graph(model_dir):
    pred = create_paddle_predictor(AnalysisConfig(model_dir))
    req = _request(2, 2)
    for _ in range(3):
        kernel = pred.run_dict(req)[0]
    entries = compile_cache.plane().entry_count()
    fluid.set_flags({'FLAGS_torch_kernels_plain': True})
    try:
        outs = [_counted(lambda: pred.run_dict(req)) for _ in range(3)]
    finally:
        fluid.set_flags({'FLAGS_torch_kernels_plain': False})
    assert compile_cache.plane().entry_count() == entries + 1
    for out, counts in outs:
        assert counts == {}
        assert np.array_equal(out[0], outs[0][0][0])
        np.testing.assert_allclose(out[0], kernel, rtol=1e-4, atol=1e-4)


def test_device_outputs_survive_the_next_replay(model_dir):
    pred = create_paddle_predictor(AnalysisConfig(model_dir))
    a, b = _request(4, 3), _request(4, 4)
    firsts = []
    for _ in range(3):
        firsts.append(pred.run_dict(a, return_numpy=False)[0])
        pred.run_dict(b, return_numpy=False)
    kept = [t.clone() for t in firsts]
    pred.run_dict(b, return_numpy=False)
    torch.cuda.synchronize()
    for t, k in zip(firsts, kept):
        assert torch.equal(t, k)
    assert torch.equal(firsts[-1], firsts[0])


def test_warmup_captures_ahead_and_training_stays_eager(model_dir, dev):
    """Named when training steps stayed eager; they are captured now:
    a training program's warmup captures its step too, its runs replay
    it, and the loss falls as the eager steps' does, bitwise."""
    pred = create_paddle_predictor(AnalysisConfig(model_dir))
    exe, program = pred._exe, pred._program
    shapes = {n: ((8, SEQ), 'float32' if n == 'input_mask' else 'int64')
              for n in FEEDS}
    with fluid.scope_guard(pred._scope):
        res = exe.warmup(program, [shapes], pred._fetch_vars)
    assert len(res.captured) == 1 and res.skipped == []
    captures, firsts = _stat('graph_captures'), _stat('graph_first_runs')
    counts = _replayed(lambda: pred.run_dict(_request(8, 5)))
    assert counts == ({}, EXPECTED)
    assert _stat('graph_captures') == captures
    assert _stat('graph_first_runs') == firsts

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=[8], dtype='float32')
        loss = fluid.layers.mean(fluid.layers.fc(x, 4))
        fluid.optimizer.SGD(0.1).minimize(loss)
    feed = {'x': np.ones((2, 8), 'float32')}
    runs = {}
    for graphs in (False, True):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            w = fluid.global_scope().find_var('fc_0.w_0')
            if graphs:
                res = exe.warmup(main, [{'x': ((2, 8), 'float32')}],
                                 [loss])
                assert len(res.captured) == 1 and res.skipped == []
            captures = _stat('graph_captures')
            replays = _stat('graph_replays')
            run = exe.run if graphs else functools.partial(_eager_run, exe)
            runs[graphs] = [run(main, feed=feed, fetch_list=[loss])[0]
                            for _ in range(3)]
            assert fluid.global_scope().find_var('fc_0.w_0') is w
            assert _stat('graph_captures') == captures
            assert _stat('graph_replays') == replays + 3 * graphs
    assert runs[True][2] < runs[True][0]
    for a, b in zip(runs[False], runs[True]):
        assert np.array_equal(a, b)


def test_graphs_go_with_their_scope(model_dir):
    """A predictor's graphs go with its scope: the plan holds them
    weakly keyed by the scope, and they hold its tensors weakly."""
    import gc
    pred = create_paddle_predictor(AnalysisConfig(model_dir))
    for _ in range(3):
        pred.run_dict(_request(2, 6))
    entries = compile_cache.plane().entry_count()
    assert entries >= 1
    del pred
    gc.collect()
    assert compile_cache.plane().entry_count() == entries - 1


def test_a_capture_that_syncs_raises(dev):
    """An op that reads a value on the host (a synchronizing copy)
    cannot be captured: the capture raises instead of hanging, the
    failure is kept with its reason, and that run and every later one
    answer eagerly, capturing no more; the executor's step counts each
    run once, the one whose capture failed included."""
    from paddle_tpu_torch.ops import registry

    @registry.register('host_read_probe')
    def host_read_probe(ctx, ins, attrs):
        x = ins['X'][0]
        return {'Out': [x * float(x.sum().item())]}

    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data('x', shape=[4], dtype='float32')
            y = main.global_block().create_var(name='y', shape=(-1, 4),
                                               dtype='float32')
            main.global_block().append_op(
                'host_read_probe', inputs={'X': x}, outputs={'Out': y},
                infer_shape=False)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        feed = {'x': np.ones((2, 4), 'float32')}
        want = np.full((2, 4), 8.0, 'float32')
        refused = _stat('graph_refused')
        with fluid.scope_guard(fluid.Scope()):
            outs = [exe.run(main, feed=feed, fetch_list=[y])[0]
                    for _ in range(4)]
            assert exe._step == 4
            (graphs,) = [g for plan in main._exec_cache.values()
                         for g in plan.graphs.values()]
        assert _stat('graph_refused') == refused + 1
        (why,) = graphs.values()
        assert why.startswith('the capture failed: ')
        assert torch.cuda.current_stream().cuda_stream == \
            torch.cuda.default_stream().cuda_stream
        for out in outs:
            assert np.array_equal(out, want)
        torch.cuda.synchronize()
    finally:
        registry._REGISTRY.pop('host_read_probe', None)


def test_compiled_step_replays_its_graph(model_dir):
    """Executor.compile of a serving program: its first call runs
    eagerly, its second captures, later ones replay; each answer is
    Executor.run's, and new weights written through ``data`` reach
    the replay."""
    pred = create_paddle_predictor(AnalysisConfig(model_dir))
    exe, program, scope = pred._exe, pred._program, pred._scope
    fetch = pred._fetch_vars
    step = exe.compile(program, list(FEEDS), fetch)
    params = {n: scope.find_var(n) for n in step.input_names
              if n not in FEEDS}
    req = _request(2, 9)
    want = pred.run_dict(req)[0]
    captures, replays = _stat('graph_captures'), _stat('graph_replays')
    outs = [step(0, {}, dict(params, **req)) for _ in range(3)]
    assert _stat('graph_captures') == captures + 1
    assert _stat('graph_replays') == replays + 2
    for out in outs:
        (got,) = out.values()
        assert np.array_equal(got.cpu().numpy(), want)
    name = 'layer_norm_0.w_0'
    kept = params[name].clone()
    doubled = dict(params, **req)
    doubled[name] = params[name] * 2.0
    got = step(0, {}, doubled)
    assert _stat('graph_replays') == replays + 3
    assert torch.equal(params[name], kept)  # the caller's tensor
    scope.set_var(name, doubled[name])
    pred._use_program_cache = False
    (out,) = got.values()
    assert np.array_equal(out.cpu().numpy(), pred.run_dict(req)[0])
