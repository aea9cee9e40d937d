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
    # Directory g++ builds the native MultiSlot feeder into; '' means
    # <checkout>/build/torch_runtime.
    'FLAGS_torch_runtime_build_dir': '',
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
    # The executor checks every floating value a step writes for nan
    # and inf on the device and raises naming each non-finite one
    # (reference platform/flags.cc FLAGS_check_nan_inf)
    'FLAGS_check_nan_inf': False,
    # The collective planner (fluid/comms_plan.py), with the JAX
    # package's defaults.  FLAGS_comms_plan: GradAllReduce buckets the
    # gradients and inserts one planned collective per bucket (off: the
    # v1.6 one c_allreduce_sum per gradient).
    'FLAGS_comms_plan': True,
    # the quantized arm (block-scaled int8, K8) for payloads of at least
    # FLAGS_comms_quantize_min_bytes, in blocks of FLAGS_comms_quant_block
    'FLAGS_comms_quantize': False,
    'FLAGS_comms_quantize_min_bytes': 65536,
    'FLAGS_comms_quant_block': 256,
    # fused-bucket byte target (0: no fusion) and the per-gradient size
    # from which a gradient reduces alone
    'FLAGS_comms_bucket_bytes': 4 << 20,
    'FLAGS_comms_fuse_grad_max_bytes': 64 << 10,
    # dense payloads of at least this many bytes reduce as
    # reduce-scatter + all-gather
    'FLAGS_comms_rs_ag_min_bytes': 8 << 20,
    # the cost model and the HBM budget are not ported: setting either
    # raises (fluid/comms_plan.py)
    'FLAGS_comms_model_path': '',
    'FLAGS_comms_hbm_budget_bytes': 0,
    # run plans a Program keeps (fluid/executor.py _get_plan; 0:
    # unbounded), as in the JAX package
    'FLAGS_plan_cache_capacity': 64,
    # ---- the observability plane (ROADMAP item 10), with the JAX
    # package's defaults (JAX: fluid/flags.py).  Span tracer + flight
    # recorder (fluid/trace.py): on at import when set; off, a span
    # site costs one call and one global load.  The recorder keeps the
    # last FLAGS_trace_buffer_steps steps.
    'FLAGS_trace': False,
    'FLAGS_trace_buffer_steps': 16,
    # status plane (fluid/health.py): a nonzero port starts the HTTP
    # server (/metrics, /healthz, /statusz, /trace/dump, /timeseries,
    # /alertz, /opprof) at the first Executor; 0 leaves it off
    'FLAGS_status_port': 0,
    # /healthz readiness: the last step at most this old (0: no bound)
    'FLAGS_status_ready_max_step_age': 0.0,
    # the rank-0 aggregator's probe cadence and per-worker timeout
    'FLAGS_health_heartbeat_seconds': 2.0,
    # consecutive missed scrapes before the aggregator calls a worker
    # down
    'FLAGS_heartbeat_misses': 3,
    # per-step tensor-health summaries (weight / grad / update norms,
    # one device-to-host copy a step) with the spike and zero-update
    # detectors
    'FLAGS_health_summaries': False,
    'FLAGS_health_spike_factor': 10.0,
    'FLAGS_health_zero_update_steps': 3,
    # the aggregator's straggler detector (0 disables)
    'FLAGS_straggler_factor': 2.0,
    # FLAGS_check_nan_inf's error names the first op that wrote a
    # non-finite value, by replaying the step op by op from copies of
    # the state it read (fluid/health.py nan_provenance)
    'FLAGS_nan_replay': True,
    # device-memory plane (fluid/memviz.py): the per-step census and
    # the measured peak of each program's first run; budget (0: the
    # card's memory), watermark and spike detectors, dump intervals
    'FLAGS_memviz': False,
    'FLAGS_memviz_sample_steps': 1,
    'FLAGS_memviz_budget_bytes': 0,
    'FLAGS_memviz_watermark': 0.9,
    'FLAGS_memviz_spike_factor': 2.0,
    'FLAGS_memviz_dump_interval_s': 60.0,
    'FLAGS_memviz_oom_interval_s': 30.0,
    # op-cost plane (fluid/opprof.py): instance names ('type#index') on
    # the profiler's op ranges, and a replay snapshot every
    # FLAGS_opprof_snapshot_steps steps
    'FLAGS_opprof': False,
    'FLAGS_opprof_snapshot_steps': 16,
    # static Program verifier (fluid/progcheck.py) at every plan build;
    # forced ('fast') in Executor.warmup and on the port's rewrites
    'FLAGS_program_verify': False,
    # fault-injection clauses '<site>:<action>[:<arg>][@n[+]]'
    # (fluid/faultinject.py); empty disarms
    'FLAGS_faultinject': '',
    # windowed history (fluid/timeseries.py) and SLOs (fluid/slo.py)
    'FLAGS_timeseries': False,
    'FLAGS_timeseries_window': 512,
    'FLAGS_timeseries_sample_steps': 1,
    'FLAGS_slo': '',
    'FLAGS_slo_fast_points': 12,
    'FLAGS_slo_slow_points': 96,
    'FLAGS_slo_hysteresis': 3,
    'FLAGS_slo_dump_interval_s': 60.0,
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
