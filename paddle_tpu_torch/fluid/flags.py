"""Global FLAGS_* settings: the subset the port reads.

Reference: paddle/fluid/platform/flags.cc (gflags read from the
environment).  Each flag takes its default from ``_DEFAULTS`` unless an
environment variable of the same name overrides it at import.
"""

import os

_DEFAULTS = {
    # Test-only switch: run each kernel's plain PyTorch version on CUDA
    # tensors too.  chip_smoke.py uses it to hold the whole serving
    # path against its plain twin on the card; nothing else sets it.
    'FLAGS_torch_kernels_plain': False,
    # Directory the CUDA kernels are compiled into; '' means
    # <checkout>/build/torch_kernels.
    'FLAGS_torch_kernel_build_dir': '',
    # Group each contiguous run of same-hyperparameter adam/adamw ops
    # into one multi-tensor update (the JAX package's
    # FLAGS_pallas_opt_fuse), when the run holds at least this many
    # tensors (FLAGS_pallas_opt_min_tensors).
    'FLAGS_torch_opt_fuse': True,
    'FLAGS_torch_opt_min_tensors': 2,
    # AdagradOptimizer rewrites each embedding table's lookup grad +
    # adagrad pair into one fused_emb_update over the looked-up rows
    # (the JAX package does so under FLAGS_pallas_embedding)
    'FLAGS_torch_emb_update': True,
}

_flags = {}


def _coerce(default, raw):
    if isinstance(default, bool):
        return raw.lower() in ('1', 'true', 'yes', 'on')
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


def _init():
    for k, v in _DEFAULTS.items():
        raw = os.environ.get(k)
        _flags[k] = _coerce(v, raw) if raw is not None else v


_init()


def get_flags(keys):
    if isinstance(keys, str):
        keys = [keys]
    return {k: _flags.get(k) for k in keys}


def set_flags(d):
    for k, v in d.items():
        _flags[k] = v


def get_flag(key, default=None):
    return _flags.get(key, default)
