"""The structured-prediction slice on the card (ops/lang_ops.py,
ops/nn_ops.py row_conv, models/label_semantic_roles.py,
RecomputeOptimizer):

- every new op type at small shapes: its forward and the gradients of
  its float inputs under seeded cotangents, launched twice (bitwise:
  no float atomics, the draws a function of the device step) and held
  against the same lowering on the CPU (integers and samples exact,
  floats within 1e-5 of the largest magnitude);
- label_semantic_roles at TINY fed by the bucketed loader on
  CUDAPlace(0): each bucket's steps replay from its own CUDA graph
  bitwise its eager steps, and the eval clone (chunk_eval, a host op)
  runs as a pipeline around its host unit;
- BERT-tiny under RecomputeOptimizer: 3 steps bitwise the same steps
  without recompute, the step captured and replayed.

Marked `cuda`: every test skips where torch has no CUDA device.  Run on
a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_*.py

This file imports torch and the port only.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.fluid import compile_cache
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.models import label_semantic_roles as srl
from paddle_tpu_torch.ops import registry

pytestmark = pytest.mark.cuda

TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    yield torch.device('cuda', 0)


def _cases():
    r = np.random.RandomState(0)
    f = lambda *s: r.randn(*s).astype('float32')  # noqa: E731
    i = lambda hi, *s: r.randint(0, hi, s).astype('int64')  # noqa: E731
    cases = {
        'linear_chain_crf': ({'Emission': [f(3, 7, 5)],
                              'Transition': [f(7, 5)], 'Label': [i(5, 3, 7)],
                              'Length': [np.array([[7], [4], [1]])]}, {}),
        'crf_decoding': ({'Emission': [f(3, 7, 5)], 'Transition': [f(7, 5)],
                          'Length': [np.array([[7], [4], [1]])]}, {}),
        'warpctc': ({'Logits': [f(3, 12, 6)], 'Label': [i(5, 3, 4) + 1],
                     'LogitsLength': [np.array([12, 9, 10])],
                     'LabelLength': [np.array([4, 2, 3])]},
                    {'norm_by_times': True}),
        'ctc_align': ({'Input': [i(4, 3, 12)],
                       'InputLength': [np.array([12, 5, 0])]},
                      {'padding_value': -1}),
        'edit_distance': ({'Hyps': [i(4, 3, 9)], 'Refs': [i(4, 3, 7)],
                           'HypsLength': [np.array([9, 3, 0])],
                           'RefsLength': [np.array([7, 7, 2])]},
                          {'normalized': True, 'ignored_tokens': [1]}),
        'hierarchical_sigmoid': ({'X': [f(6, 4)], 'W': [f(15, 4)],
                                  'Bias': [f(15)], 'Label': [i(16, 6)]},
                                 {'num_classes': 16}),
        'sample_logits': ({'Logits': [f(6, 50)], 'Labels': [i(50, 6, 2)]},
                          {'num_samples': 8}),
        'cos_sim': ({'X': [f(6, 4)], 'Y': [f(1, 4)]}, {}),
        'pyramid_hash': ({'X': [i(1 << 30, 3, 9)], 'W': [f(101, 4)]},
                         {'pyramid_layer': 3}),
        'filter_by_instag': ({'Ins': [f(6, 3)], 'Ins_tag': [i(4, 6)],
                              'Filter_tag': [np.array([1, 2])]}, {}),
        'var_conv_2d': ({'X': [f(2, 2, 6, 7)], 'W': [f(3, 18)]},
                        {'output_channel': 3, 'input_channel': 2}),
        'tree_conv': ({'NodesVector': [f(2, 5, 3)],
                       'EdgeSet': [np.array(
                           [[[0, 1], [0, 2], [1, 3], [-1, -1]],
                            [[0, 1], [1, 2], [1, 3], [0, 4]]])],
                       'Filter': [f(3, 3, 2, 2)]}, {}),
        'row_conv': ({'X': [f(2, 6, 4)], 'Filter': [f(3, 4)]}, {}),
    }
    for sampler in ('uniform', 'log_uniform', 'custom_dist'):
        attrs = {'num_neg_samples': 4, 'sampler': sampler, 'seed': 1}
        if sampler == 'custom_dist':
            attrs['custom_dist'] = list(r.dirichlet(np.ones(30)))
        cases['nce:' + sampler] = ({'Input': [f(6, 4)], 'Weight': [f(30, 4)],
                                    'Bias': [f(30)], 'Label': [i(30, 6, 1)]},
                                   attrs)
    return cases


CASES = _cases()


def _run(op, ins, attrs, device):
    ctx = registry.LowerCtx(step=2, op_seed=5, device=device, random_seed=3)
    opdef = registry.get(op)
    with torch.enable_grad():
        tins = {s: [torch.as_tensor(a, device=device) for a in v]
                for s, v in ins.items()}
        xs = [x.requires_grad_() for v in tins.values() for x in v
              if x.is_floating_point()]
        outs = opdef.run(ctx, tins, attrs)
        ys = [y for s, v in sorted(outs.items()) for y in v
              if s not in opdef.no_grad_out_slots and y.requires_grad]
        rng = np.random.RandomState(1)
        cts = [torch.as_tensor(rng.randn(*y.shape).astype('float32'),
                               device=device) for y in ys]
        grads = torch.autograd.grad(ys, xs, cts, allow_unused=True) \
            if ys else []
    vals = [y.detach() for s in sorted(outs) for y in outs[s]]
    return [v.cpu() for v in vals] + [g.cpu() for g in grads
                                      if g is not None]


@pytest.mark.parametrize('case', sorted(CASES))
def test_op_on_the_card_twice_bitwise_and_as_on_the_cpu(case, dev):
    ins, attrs = CASES[case]
    op = case.split(':')[0]
    first, second = _run(op, ins, attrs, dev), _run(op, ins, attrs, dev)
    cpu = _run(op, ins, attrs, 'cpu')
    assert len(first) == len(second) == len(cpu)
    for a, b, c in zip(first, second, cpu):
        assert torch.equal(a, b)
        if a.is_floating_point():
            scale = max(c.abs().max().item(), 1e-30)
            assert (a - c).abs().max().item() <= TOL * scale
        else:
            assert torch.equal(a, c)


def _graphs():
    return {k: compile_cache.counter_value('executor/' + k)
            for k in ('graph_captures', 'graph_replays')}


def test_srl_buckets_replay_bitwise_eager(dev):
    cfg = srl.TINY
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feeds, loss, decode = srl.build_train(fluid, cfg)
    test, chunk = srl.build_eval(fluid, cfg, main, decode)
    samples = srl.synthetic_samples(cfg, 0, 48, max_len=30)
    loader = fluid.io.DataLoader.from_generator(
        feed_list=feeds[:-1], bucket_boundaries=[8, 16, 32],
        batch_size=cfg.batch, drop_last=True)
    loader.set_sample_generator(lambda: iter(samples),
                                places=fluid.CUDAPlace(0))
    names = weights.startup_names(startup)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        seen = {}
        for batch in loader:
            b = batch['word'].shape[1]
            seen[b] = seen.get(b, 0) + 1
            if seen[b] < 3:
                exe.run(main, feed=batch, fetch_list=[loss])
                continue
            # from here this bucket replays its graph
            held = {n: scope.find_var(n) for n in names}
            before, step = {n: v.clone() for n, v in held.items()}, exe._step
            g0 = _graphs()
            got = exe.run(main, feed=batch, fetch_list=[loss])[0]
            after = {n: v.clone() for n, v in held.items()}
            assert _graphs()['graph_replays'] == g0['graph_replays'] + 1
            for n, v in before.items():
                held[n].copy_(v)
            exe._step = step
            plan = exe._get_plan(main, batch, [loss.name])
            want = exe._run_graphed(plan, main, batch, [loss.name], scope,
                                    True, graphs=False)[0]
            assert np.array_equal(got, want)
            assert all(torch.equal(after[n], held[n]) for n in names)
        assert max(seen.values()) >= 3
        feed = srl.pad_batch(samples[:cfg.batch], 32)
        plan = exe._get_plan(test, feed, [decode.name] +
                             [v.name for v in chunk])
        assert plan.no_graph is None
        assert 'chunk_eval' in [u.steps[0].members[0].op.type
                                for u in plan.units if u.host]
        exe.run(test, feed=feed, fetch_list=[decode] + chunk)


def test_bert_recompute_bitwise_plain_and_replayed(dev):
    cfg = bert.BertConfig(vocab_size=300, hidden=64, layers=2, heads=2,
                          intermediate=128, max_pos=64, dropout=0.1,
                          attn_dropout=0.1)
    feed = bert.synthetic_batch(cfg, 2, 64, np.random.RandomState(0))
    runs = []
    for rc in (False, True):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 5
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            _, _, loss = bert.build_pretrain(cfg, seq_len=64)
            opt = fluid.optimizer.Adam(learning_rate=1e-3)
            if rc:
                lns = [op for op in main.global_block().ops
                       if op.type == 'layer_norm']
                opt = fluid.optimizer.RecomputeOptimizer(opt)
                opt._set_checkpoints([op.output('Y')[0] for op in lns[2::2]])
            opt.minimize(loss)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            if runs:
                for n, v in runs[0]['start'].items():
                    scope.find_var(n).copy_(v)
            start = {n: scope.find_var(n).clone()
                     for n in weights.startup_names(startup)}
            g0 = _graphs()
            losses = [exe.run(main, feed=feed, fetch_list=[loss])[0]
                      for _ in range(3)]
            moved = {k: v - g0[k] for k, v in _graphs().items()}
            runs.append({'start': start, 'losses': losses, 'graphs': moved,
                         'state': {n: scope.find_var(n).clone()
                                   for n in start}})
    plain, rc = runs
    assert rc['graphs'] == {'graph_captures': 1, 'graph_replays': 2}
    for a, b in zip(plain['losses'], rc['losses']):
        assert np.array_equal(a, b)
    assert all(torch.equal(plain['state'][n], rc['state'][n])
               for n in plain['state'])
