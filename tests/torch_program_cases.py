"""Shared runs of the control-flow and recurrent slice's tests, on the
CPU: one program-building function called with each package's `fluid`,
the JAX package's startup state carried into the port
(weights.numpy_state, weights.load_numpy_params), then the same feeds
through both executors.  Each test file states its tolerance."""

import numpy as np

import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights

from torch_attention_cases import close


def build_both(build, seed=3):
    """{'jax' / 'torch': (main, startup, fetch)}: fetch = build(fluid)
    inside each package's unique_name.guard and program_guard."""
    out = {}
    for key, fluid in (('jax', jfluid), ('torch', tfluid)):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = seed
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            fetch = build(fluid)
        out[key] = (main, startup, fetch)
    return out


def _names(fetch):
    return [getattr(v, 'name', v) for v in fetch]


def run_both(progs, feeds, torch_place=None):
    """{'jax' / 'torch': [[fetched numpy values] for each feed]}: the
    feeds run in order as steps of one scope, the port from the JAX
    package's startup state."""
    jm, js, jf = progs['jax']
    tm, ts, tf = progs['torch']
    out = {}
    with jfluid.scope_guard(jfluid.Scope()):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(js)
        state = weights.numpy_state(jfluid.global_scope(),
                                    weights.startup_names(ts))
        out['jax'] = [[np.asarray(v) for v in exe.run(
            jm, feed=f, fetch_list=_names(jf))] for f in feeds]
    place = torch_place or tfluid.CPUPlace()
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(place)
        exe.run(ts)
        weights.load_numpy_params(tfluid.global_scope(), state, place, ts)
        out['torch'] = [[np.asarray(v) for v in exe.run(
            tm, feed=f, fetch_list=_names(tf))] for f in feeds]
    return out


def assert_runs_close(out, tol, what=''):
    """Every fetch of every run of the port within `tol` of the JAX
    package's (torch_attention_cases.close: 0 bitwise, else rtol tol
    with a floor of tol times the largest magnitude); integer fetches
    compared by value (the JAX package narrows int64 to int32)."""
    assert len(out['jax']) == len(out['torch'])
    for k, (jr, tr) in enumerate(zip(out['jax'], out['torch'])):
        assert len(jr) == len(tr)
        for i, (w, g) in enumerate(zip(jr, tr)):
            if np.issubdtype(w.dtype, np.integer):
                np.testing.assert_array_equal(g, w, err_msg='%s run %d '
                                              'fetch %d' % (what, k, i))
                continue
            if np.issubdtype(w.dtype, np.bool_):
                np.testing.assert_array_equal(g, w)
                continue
            close(g.reshape(w.shape) if g.size == w.size else g, w, tol,
                  '%s run %d fetch %d' % (what, k, i))


def same_program(jp, tp):
    """The two packages' programs hold the same blocks, op for op (the
    inputs, outputs and attributes, the creation call stack aside; an
    int32 dtype or out_dtype attr the JAX package inferred where the
    port keeps int64), with the same variables, shapes and flags."""
    def norm_dtype(d):
        return 'int' if d in ('int32', 'int64') else d

    jd, td = jp.to_dict(), tp.to_dict()
    assert len(jd['blocks']) == len(td['blocks'])
    for jb, tb in zip(jd['blocks'], td['blocks']):
        assert (jb['idx'], jb['parent_idx']) == (tb['idx'], tb['parent_idx'])
        assert [o['type'] for o in jb['ops']] == \
            [o['type'] for o in tb['ops']]
        for jo, to in zip(jb['ops'], tb['ops']):
            assert jo['inputs'] == to['inputs'], jo['type']
            assert jo['outputs'] == to['outputs'], jo['type']

            def attrs(o):
                return {k: norm_dtype(v) if k in ('dtype', 'out_dtype')
                        else v
                        for k, v in o['attrs'].items()
                        if k != '__op_callstack__'}
            assert attrs(jo) == attrs(to), jo['type']
        jv = {v['name']: v for v in jb['vars']}
        tv = {v['name']: v for v in tb['vars']}
        assert jv.keys() == tv.keys()
        for name, v in jv.items():
            assert v['shape'] == tv[name]['shape'], name
            assert norm_dtype(v['dtype']) == norm_dtype(tv[name]['dtype']), \
                name
            for key in ('persistable', 'is_parameter', 'is_data',
                        'stop_gradient', 'trainable'):
                assert v[key] == tv[name][key], (name, key)
