"""The port's training Program against the JAX package's: BERT
pretraining (build_pretrain, 2 layers, hidden 64, 4 heads, seq 64,
flash_min_len 0 so it holds fused_multihead_attention, attention dropout
0.1) with Adam.minimize serializes alike in both packages: the same op
types, inputs, outputs and attributes (the creation call stack aside),
the same vars with their shapes and flags, the same grad name map, the
same startup program, and clone(for_test=True) prunes the same ops.

Both packages build inside their own unique_name.guard and
program_guard, so no generator or default program leaks out.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import bert as tbert

SEQ = 64


def _cfg(bert_mod):
    cfg = bert_mod.BertConfig(vocab_size=1000, hidden=64, layers=2,
                              heads=4, intermediate=128, max_pos=64,
                              dropout=0.1, attn_dropout=0.1)
    cfg.flash_min_len = 0
    return cfg


def _build(fluid, bert_mod, opt='adam'):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = bert_mod.build_pretrain(_cfg(bert_mod), seq_len=SEQ)
        if opt == 'adam':
            o = fluid.optimizer.Adam(learning_rate=1e-3, epsilon=1e-6)
        else:
            o = fluid.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01)
        _, params_grads = o.minimize(loss)
    return main, startup, loss, params_grads


@pytest.fixture(scope='module')
def programs():
    return {'jax': _build(jfluid, jbert), 'torch': _build(tfluid, tbert)}


def _norm_dtype(name):
    # the JAX package narrows int64 to int32 (x64 off); the port keeps it
    return 'int' if name in ('int32', 'int64') else name


def _assert_same_block(jb, tb):
    assert [o['type'] for o in jb['ops']] == [o['type'] for o in tb['ops']]
    for jo, to in zip(jb['ops'], tb['ops']):
        assert jo['inputs'] == to['inputs'], jo['type']
        assert jo['outputs'] == to['outputs'], jo['type']
        strip = ('__op_callstack__',)
        assert {k: v for k, v in jo['attrs'].items() if k not in strip} == \
            {k: v for k, v in to['attrs'].items() if k not in strip}, \
            jo['type']
    jv = {v['name']: v for v in jb['vars']}
    tv = {v['name']: v for v in tb['vars']}
    assert jv.keys() == tv.keys()
    for name, v in jv.items():
        assert v['shape'] == tv[name]['shape'], name
        assert _norm_dtype(v['dtype']) == _norm_dtype(tv[name]['dtype']), \
            name
        for key in ('persistable', 'is_parameter', 'is_data',
                    'stop_gradient', 'trainable'):
            assert v[key] == tv[name][key], (name, key)


def test_train_program_serializes_like_jax(programs):
    (jb,) = programs['jax'][0].to_dict()['blocks']
    (tb,) = programs['torch'][0].to_dict()['blocks']
    _assert_same_block(jb, tb)
    types = [o['type'] for o in tb['ops']]
    for t in ('fused_multihead_attention_grad', 'lookup_table_v2_grad',
              'softmax_with_cross_entropy_grad', 'dropout_grad', 'adam',
              'sum'):
        assert t in types, t
    assert types.count('adam') == len(programs['torch'][3])


def test_roles_split_forward_backward_optimize(programs):
    ops = programs['torch'][0].global_block().ops
    roles = [op.attrs['__op_role__'] for op in ops]
    first_bwd = roles.index('backward')
    assert set(roles[:first_bwd]) == {'forward'}
    assert roles[first_bwd:].count('forward') == 0
    assert [op.type for op in ops if op.attrs['__op_role__'] == 'optimize'
            ][-2:] == ['scale', 'scale']
    assert all(op.type.endswith('_grad') or op.type in (
        'fill_constant', 'sum') for op in ops
        if op.attrs['__op_role__'] == 'backward')


def test_startup_program_serializes_like_jax(programs):
    (jb,) = programs['jax'][1].to_dict()['blocks']
    (tb,) = programs['torch'][1].to_dict()['blocks']
    _assert_same_block(jb, tb)
    names = weights.startup_names(programs['torch'][1])
    assert 'learning_rate_0' in names
    assert sum('_moment1_' in n for n in names) == \
        len(programs['torch'][3])
    assert sum('_pow_acc_' in n for n in names) == 2


def test_grad_name_map_and_params_grads_match(programs):
    jmain, _, jloss, jpg = programs['jax']
    tmain, _, tloss, tpg = programs['torch']
    assert jmain._grad_name_map == tmain._grad_name_map
    assert [(p.name, g.name) for p, g in jpg] == \
        [(p.name, g.name) for p, g in tpg]
    assert tmain._grad_name_map[tloss.name] == tloss.name + '@GRAD'


def test_adamw_program_serializes_like_jax():
    jmain = _build(jfluid, jbert, 'adamw')[0]
    tmain = _build(tfluid, tbert, 'adamw')[0]
    (jb,), (tb,) = jmain.to_dict()['blocks'], tmain.to_dict()['blocks']
    _assert_same_block(jb, tb)
    assert 'adamw' in [o['type'] for o in tb['ops']]


def test_clone_for_test_prunes_like_jax(programs):
    jt = programs['jax'][0].clone(for_test=True).to_dict()['blocks'][0]
    tt = programs['torch'][0].clone(for_test=True).to_dict()['blocks'][0]
    assert [o['type'] for o in jt['ops']] == [o['type'] for o in tt['ops']]
    assert not any(o['type'].endswith('_grad') or o['type'] == 'adam'
                   for o in tt['ops'])
    assert all(o['attrs'].get('is_test') for o in tt['ops']
               if o['type'] in ('dropout', 'fused_multihead_attention'))


def test_append_backward_honours_no_grad_set_and_trainable():
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = 5
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data('x', shape=[4], dtype='float32')
            h = fluid.layers.fc(x, size=3,
                                param_attr=fluid.ParamAttr(trainable=False))
            h = fluid.layers.fc(h, size=2)
            loss = fluid.layers.mean(h)
            pg = fluid.backward.append_backward(
                loss, no_grad_set={'fc_1.w_1'})
        return main, [(p.name, g.name) for p, g in pg]

    jmain, jpg = build(jfluid)
    tmain, tpg = build(tfluid)
    # fc_0.w_0 is not trainable, fc_1.w_1 (a bias) is in no_grad_set
    assert tpg == jpg
    assert [p for p, _ in tpg] == ['fc_0.w_1', 'fc_1.w_0']
    _assert_same_block(jmain.to_dict()['blocks'][0],
                       tmain.to_dict()['blocks'][0])


def test_optimizer_raises_on_what_is_not_ported():
    """Recompute checkpoints are not ported, and an optimizer without
    an update op of its own (the base class) raises.  (Clipping and
    regularization are ported: tests/test_torch_lr_clip.py.)"""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data('x', shape=[4], dtype='float32')
        loss = tfluid.layers.mean(tfluid.layers.fc(x, size=2))
        with pytest.raises(NotImplementedError):
            tfluid.optimizer.Optimizer(0.1).minimize(loss)
        with pytest.raises(NotImplementedError, match='recompute'):
            tfluid.backward.append_backward(loss, checkpoints=[x])


def test_startup_state_loading_is_checked(programs):
    startup = programs['torch'][1]
    names = weights.startup_names(startup)
    block = startup.global_block()
    state = {n: np.zeros(block.var(n).shape, 'float32') for n in names}
    scope = tfluid.Scope()
    weights.load_numpy_params(scope, state, tfluid.CPUPlace(), startup)
    assert sorted(scope.local_var_names()) == names
    missing = dict(state)
    missing.pop(names[0])
    with pytest.raises(KeyError, match='startup program sets'):
        weights.load_numpy_params(tfluid.Scope(), missing,
                                  tfluid.CPUPlace(), startup)
    bad = dict(state)
    bad[names[0]] = np.zeros((1, 2, 3), 'float32')
    with pytest.raises(ValueError, match='the program declares'):
        weights.load_numpy_params(tfluid.Scope(), bad, tfluid.CPUPlace(),
                                  startup)
