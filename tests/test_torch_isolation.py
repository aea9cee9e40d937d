"""The port stands alone: importing paddle_tpu_torch, every submodule of
it and chip_smoke (as a module, without running main) loads neither
jax nor the JAX package, and no source of the port names them.

The JAX package's module name is a prefix of the port's, so the checks
match the module `paddle_tpu` exactly or `paddle_tpu.` with the dot.
"""

import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r'''
import importlib.util, json, pkgutil, sys
sys.path.insert(0, ROOT)
import paddle_tpu_torch
names = ['paddle_tpu_torch']
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                               'paddle_tpu_torch.'):
    importlib.import_module(m.name)
    names.append(m.name)
spec = importlib.util.spec_from_file_location(
    'chip_smoke', ROOT + '/chip_smoke.py')
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
bad = sorted(n for n in sys.modules
             if n == 'jax' or n.startswith('jax.') or n == 'jaxlib'
             or n.startswith('jaxlib.') or n == 'paddle_tpu'
             or n.startswith('paddle_tpu.'))
print(json.dumps({'imported': names, 'bad': bad,
                  'main': callable(getattr(mod, 'main', None))}))
'''

_BAD_LINE = re.compile(
    r'^\s*(import\s+(jax|jaxlib)\b|from\s+(jax|jaxlib)\b|'
    r'import\s+paddle_tpu(\.|\s|$|,)|from\s+paddle_tpu(\.|\s))')


def test_import_loads_neither_jax_nor_the_jax_package():
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    out = subprocess.run(
        [sys.executable, '-c', 'ROOT = %r\n' % ROOT + _PROBE],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res['bad'] == []
    assert res['main']
    for name in ('paddle_tpu_torch.fluid.executor',
                 'paddle_tpu_torch.fluid.backward',
                 'paddle_tpu_torch.fluid.optimizer',
                 'paddle_tpu_torch.fluid.clip',
                 'paddle_tpu_torch.fluid.regularizer',
                 'paddle_tpu_torch.fluid.layers.tensor',
                 'paddle_tpu_torch.fluid.layers.learning_rate_scheduler',
                 'paddle_tpu_torch.models.wide_deep',
                 'paddle_tpu_torch.inference.predictor',
                 'paddle_tpu_torch.models.bert',
                 'paddle_tpu_torch.ops.optimizer_ops',
                 'paddle_tpu_torch.ops.kernels.flash_attention',
                 'paddle_tpu_torch.ops.kernels.embedding',
                 'paddle_tpu_torch.ops.kernels.fused_optimizer',
                 'paddle_tpu_torch.weights',
                 'paddle_tpu_torch.distributed',
                 'paddle_tpu_torch.distributed.launch',
                 'paddle_tpu_torch.distributed.wire',
                 'paddle_tpu_torch.fluid.transpiler',
                 'paddle_tpu_torch.fluid.transpiler.collective',
                 'paddle_tpu_torch.fluid.incubate',
                 'paddle_tpu_torch.fluid.incubate.fleet.base.role_maker',
                 'paddle_tpu_torch.fluid.incubate.fleet.base.fleet_base',
                 'paddle_tpu_torch.fluid.incubate.fleet.collective',
                 'paddle_tpu_torch.fluid.comms',
                 'paddle_tpu_torch.fluid.comms_plan',
                 'paddle_tpu_torch.ops.collective_ops',
                 'paddle_tpu_torch.ops.kernels.quant_collective',
                 'paddle_tpu_torch.ops.nn_ops',
                 'paddle_tpu_torch.ops.math_ops',
                 'paddle_tpu_torch.ops.activation_ops',
                 'paddle_tpu_torch.fluid.nets',
                 'paddle_tpu_torch.fluid.metrics',
                 'paddle_tpu_torch.fluid.layers.nn',
                 'paddle_tpu_torch.fluid.layers.math_op_patch',
                 'paddle_tpu_torch.dataset',
                 'paddle_tpu_torch.dataset.mnist',
                 'paddle_tpu_torch.models.lenet',
                 'paddle_tpu_torch.models.resnet',
                 'paddle_tpu_torch.models.se_resnext',
                 'paddle_tpu_torch.models.transformer',
                 'paddle_tpu_torch.ops.misc_ops',
                 'paddle_tpu_torch.ops.tensor_ops'):
        assert name in res['imported']


def test_port_sources_name_neither_jax_nor_the_jax_package():
    files = [os.path.join(ROOT, 'chip_smoke.py')]
    for dirpath, _, names in os.walk(os.path.join(ROOT,
                                                  'paddle_tpu_torch')):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith('.py')]
    assert len(files) > 20
    offenders = []
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if _BAD_LINE.match(line):
                    offenders.append('%s:%d: %s' % (path, i, line.strip()))
    assert offenders == []


def test_bad_line_pattern_tells_the_packages_apart():
    for line in ('import jax', 'import jax.numpy as jnp', 'from jax import x',
                 'import paddle_tpu', 'import paddle_tpu.fluid',
                 'from paddle_tpu import fluid', 'from paddle_tpu.ops import x',
                 '    import jax'):
        assert _BAD_LINE.match(line), line
    for line in ('import paddle_tpu_torch', 'from paddle_tpu_torch import x',
                 'import paddle_tpu_torch.fluid as fluid', 'import jaxtyping',
                 '# import jax in a comment'):
        assert not _BAD_LINE.match(line), line
