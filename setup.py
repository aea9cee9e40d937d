"""Packaging for paddle_tpu: the python tree + the prebuilt native
artifacts (run `make` first; package_data ships the .so files the way
the reference wheel ships libpaddle_framework)."""
from setuptools import setup, find_packages

setup(
    name='paddle_tpu',
    version='0.4.0',
    description='fluid-v1.6-compatible TPU-native deep learning '
                'framework (JAX/XLA/Pallas compute, C++ runtime)',
    packages=find_packages(include=['paddle_tpu', 'paddle_tpu.*',
                                    'paddle_tpu_torch',
                                    'paddle_tpu_torch.*']),
    package_data={
        'paddle_tpu.runtime': ['libptruntime.so', 'Makefile', '*.cc'],
        'paddle_tpu.inference.capi': ['libpaddle_tpu_capi.so',
                                      'Makefile', '*.cc', '*.h'],
        'paddle_tpu.train.demo': ['*.cc'],
        # the port's CUDA kernels build from these sources at first use
        'paddle_tpu_torch.ops.kernels': ['csrc/*.cu', 'csrc/*.cuh'],
    },
    install_requires=['numpy', 'jax'],
    python_requires='>=3.9',
)
