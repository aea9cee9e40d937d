"""The port's BERT serving slice against the JAX package, on the CPU.

A small BERT (2 layers, hidden 64, 4 heads, vocab 1000, max_pos 64,
seq 64, flash_min_len lowered to 0 so the program holds
fused_multihead_attention) is built in both packages:

(a) the two Programs serialize alike (op types, attrs, inputs/outputs,
    var shapes);
(b) a model dir the JAX package saved is served by the port's
    predictor (CPU) and agrees with the JAX predictor on 3 requests;
(c) a port-built program run from the JAX package's startup values
    (weights.load_numpy_params) agrees with the JAX executor.

Tolerance rtol = atol = 1e-4: both sides compute in f32 with different
summation orders through 2 encoder layers and layer norms.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import unique_name as j_unique_name
from paddle_tpu.inference import predictor as jpredictor
from paddle_tpu.models import bert as jbert

import torch

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.fluid import unique_name as t_unique_name
from paddle_tpu_torch.inference import predictor as tpredictor
from paddle_tpu_torch.models import bert as tbert

SEQ = 64
FEEDS = ('src_ids', 'pos_ids', 'sent_ids', 'input_mask')
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfg(bert_mod):
    cfg = bert_mod.BertConfig(vocab_size=1000, hidden=64, layers=2,
                              heads=4, intermediate=128, max_pos=64)
    cfg.flash_min_len = 0
    return cfg


def _build(fluid, bert_mod, unique_name):
    """(main, startup, enc) of the encoder in one package."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with unique_name.guard(), fluid.program_guard(main, startup):
        src, pos, sent = [fluid.layers.data(n, shape=[SEQ], dtype='int64')
                          for n in FEEDS[:3]]
        mask = fluid.layers.data('input_mask', shape=[SEQ],
                                 dtype='float32')
        enc = bert_mod.bert_encoder(src, pos, sent, mask,
                                    _cfg(bert_mod), is_test=True)
    return main, startup, enc


def _requests(batches=(1, 3, 5)):
    rng = np.random.RandomState(0)
    cfg = _cfg(tbert)
    out = []
    for b in batches:
        feed = tbert.encoder_batch(cfg, b, SEQ, rng)
        feed['input_mask'][:, SEQ - 1 - b:] = 0.0  # padded tails
        out.append(feed)
    return out


@pytest.fixture(scope='module')
def jax_model(tmp_path_factory):
    """The JAX package's program, its startup values and a saved
    inference-model dir."""
    main, startup, enc = _build(jfluid, jbert, j_unique_name)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    d = str(tmp_path_factory.mktemp('jax_bert'))
    with jfluid.scope_guard(scope):
        exe.run(startup)
        jfluid.io.save_inference_model(d, list(FEEDS), [enc], exe,
                                       main_program=main)
        params = {p.name: np.asarray(scope.find_var(p.name))
                  for p in main.all_parameters()}
    return dict(main=main, enc=enc, exe=exe, scope=scope, dir=d,
                params=params)


def _norm_dtype(name):
    # the JAX package narrows int64 to int32 (x64 off); the port keeps it
    return 'int' if name in ('int32', 'int64') else name


def test_program_to_dict_matches(jax_model):
    tmain, _, tenc = _build(tfluid, tbert, t_unique_name)
    jd, td = jax_model['main'].to_dict(), tmain.to_dict()
    assert jax_model['enc'].name == tenc.name
    (jb,), (tb,) = jd['blocks'], td['blocks']
    assert [o['type'] for o in jb['ops']] == [o['type'] for o in tb['ops']]
    assert 'fused_multihead_attention' in [o['type'] for o in tb['ops']]
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
        for key in ('persistable', 'is_parameter', 'is_data'):
            assert v[key] == tv[name][key], (name, key)


def test_port_predictor_serves_jax_saved_model(jax_model):
    jcfg = jpredictor.AnalysisConfig(jax_model['dir'])
    jpred = jpredictor.create_paddle_predictor(jcfg)
    tcfg = tpredictor.AnalysisConfig(jax_model['dir'])
    tcfg.disable_gpu()
    tpred = tpredictor.create_paddle_predictor(tcfg)
    assert tpred.get_input_names() == list(FEEDS)
    assert tpred.get_output_names() == [jax_model['enc'].name]
    assert tpred.place == tfluid.CPUPlace()
    for feed in _requests():
        inputs = [feed[n] for n in FEEDS]
        got = tpred.run(inputs)[0].data
        want = jpred.run(inputs)[0].data
        assert got.shape == (feed['src_ids'].shape[0], SEQ, 64)
        np.testing.assert_allclose(got, want, **TOL)


def test_port_program_from_jax_weights(jax_model):
    tmain, _, tenc = _build(tfluid, tbert, t_unique_name)
    scope = tfluid.Scope()
    weights.load_numpy_params(scope, jax_model['params'], tfluid.CPUPlace())
    dumped = weights.dump_numpy_params(scope)
    assert dumped.keys() == jax_model['params'].keys()
    for name, arr in jax_model['params'].items():
        np.testing.assert_array_equal(dumped[name], arr)
    texe = tfluid.Executor(tfluid.CPUPlace())
    for feed in _requests((2, 4)):
        with tfluid.scope_guard(scope):
            got, = texe.run(tmain, feed=feed, fetch_list=[tenc])
        with jfluid.scope_guard(jax_model['scope']):
            want, = jax_model['exe'].run(jax_model['main'], feed=feed,
                                         fetch_list=[jax_model['enc']])
        np.testing.assert_allclose(got, want, **TOL)


def test_port_save_load_roundtrip(tmp_path):
    """The port's own startup + save_inference_model + predictor give
    the executor's answer bitwise, and the JAX package loads the dir."""
    tmain, tstartup, tenc = _build(tfluid, tbert, t_unique_name)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    feed = _requests((3,))[0]
    with tfluid.scope_guard(scope):
        exe.run(tstartup)
        want, = exe.run(tmain, feed=feed, fetch_list=[tenc])
        tfluid.io.save_inference_model(str(tmp_path), list(FEEDS), [tenc],
                                       exe, main_program=tmain)
    cfg = tpredictor.AnalysisConfig(str(tmp_path))
    cfg.disable_gpu()
    got = tpredictor.create_paddle_predictor(cfg).run(
        [feed[n] for n in FEEDS])[0].data
    np.testing.assert_array_equal(got, want)
    jgot = jpredictor.create_paddle_predictor(
        jpredictor.AnalysisConfig(str(tmp_path))).run(
            [feed[n] for n in FEEDS])[0].data
    np.testing.assert_allclose(jgot, want, **TOL)


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    assert tpredictor.AnalysisConfig().place == tfluid.CUDAPlace(0)
    cfg = tpredictor.AnalysisConfig()
    cfg.disable_gpu()
    assert cfg.place == tfluid.CPUPlace()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            tfluid.Executor()
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            tpredictor.create_paddle_predictor(
                tpredictor.AnalysisConfig(str(tmp_path)))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    exe = tfluid.Executor()
    assert exe.place == tfluid.CUDAPlace(0)
    assert exe.device == torch.device('cuda', 0)
    assert tfluid.Executor(tfluid.CPUPlace()).device == torch.device('cpu')


def test_naive_attention_program_raises_in_executor():
    """Below flash_min_len the encoder builds the matmul/softmax chain,
    which the port lowers since the attention-chain slice: the program
    runs and gives finite [b, T, hidden] rows.  An op the port does not
    lower yet, appended to it, makes the executor raise and name it."""
    cfg = _cfg(tbert)
    cfg.flash_min_len = 512
    main, startup = tfluid.Program(), tfluid.Program()
    with t_unique_name.guard(), tfluid.program_guard(main, startup):
        src, pos, sent = [tfluid.layers.data(n, shape=[SEQ], dtype='int64')
                          for n in FEEDS[:3]]
        mask = tfluid.layers.data('input_mask', shape=[SEQ],
                                  dtype='float32')
        enc = tbert.bert_encoder(src, pos, sent, mask, cfg, is_test=True)
    assert 'fused_multihead_attention' not in [
        o.type for o in main.global_block().ops]
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        out, = exe.run(main, feed=_requests((1,))[0], fetch_list=[enc])
        assert out.shape == (1, SEQ, 64) and np.isfinite(out).all()
        block = main.global_block()
        hidden = block.create_var(name='hidden', shape=(), dtype='float32')
        block.append_op('fusion_gru', inputs={'X': [enc.name]},
                        outputs={'Hidden': [hidden.name]},
                        infer_shape=False)
        with pytest.raises(NotImplementedError, match="'fusion_gru'"):
            exe.run(main, feed=_requests((1,))[0], fetch_list=[enc])
