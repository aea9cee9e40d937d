"""AnalysisPredictor over the eager executor.
Reference: inference/api/analysis_predictor.h:47.

``AnalysisConfig()`` serves on ``CUDAPlace(0)``; creating a predictor
without CUDA raises unless the config called ``disable_gpu()``.
Parameters are loaded straight onto the device, once (reference:
inference/analysis/passes/ir_params_sync_among_devices_pass), so no
run uploads the weights again.  A single-shot run pads
the batch to the next power-of-two bucket and slices the answer back,
so the predictor sees O(log max_batch) distinct batch sizes.

On a CUDA place each bucket is one CUDA-graph signature of the
executor (fluid/cuda_graph.py): a bucket's first request runs eagerly,
its second captures the graph, and every later one replays it, the
padded feed copied in through pinned host buffers and the answer
copied back through one before the rows are sliced.
``_use_program_cache = False`` runs every request eagerly through a
plan built for it (``Executor.run(use_program_cache=False)``).
"""

import numpy as np

from ..fluid import core
from ..fluid import io as fluid_io
from ..fluid import serving as fluid_serving
from ..fluid.executor import Executor
from ..fluid.reader import bucket_for, pow2_bucket_ladder


class AnalysisConfig(object):
    """Reference: inference/api/paddle_analysis_config.h."""

    def __init__(self, model_dir=None, params_file=None):
        self.model_dir = model_dir
        self.model_filename = None
        self.params_filename = params_file
        self._use_gpu = True
        self._serving_buckets = True
        self._serving_max_batch = 64

    def disable_gpu(self):
        self._use_gpu = False

    @property
    def place(self):
        return core.CUDAPlace(0) if self._use_gpu else core.CPUPlace()

    def switch_serving_buckets(self, on=True, max_batch=64):
        """Toggle batch-bucket padding on run()/run_dict() (on by
        default)."""
        self._serving_buckets = bool(on)
        self._serving_max_batch = int(max_batch)


class PaddleTensor(object):
    def __init__(self, data=None, name=None):
        self.data = np.asarray(data) if data is not None else None
        self.name = name
        self.shape = tuple(self.data.shape) if data is not None else ()

    def as_ndarray(self):
        return self.data


class AnalysisPredictor(object):
    """Reference: inference/api/analysis_predictor.h:47."""

    def __init__(self, config):
        self.config = config
        self._scope = core.Scope()
        self._exe = Executor(config.place)
        with core.scope_guard(self._scope):
            self._program, self._feed_names, self._fetch_vars = \
                fluid_io.load_inference_model(
                    config.model_dir, self._exe,
                    model_filename=config.model_filename,
                    params_filename=config.params_filename)
        self._ladder = tuple(pow2_bucket_ladder(
            max(1, int(config._serving_max_batch))))
        # bucket routing is only transparent when every fetch carries
        # the batch dim (declared -1 leading dim) and can be sliced back
        self._bucket_ok = all(
            getattr(v, 'shape', None) and int(v.shape[0]) < 0
            for v in self._fetch_vars)
        self._use_program_cache = True

    @property
    def place(self):
        return self._exe.place

    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return [v.name for v in self._fetch_vars]

    def _bucket_feed(self, feed):
        """Pad the shared leading (batch) dim of a single-shot feed up
        to the next power-of-two bucket.  Returns (feed, rows, bucket);
        rows is None when the feed passes through untouched (mismatched
        leading dims, already a bucket, or bigger than the ladder)."""
        if not self.config._serving_buckets or not self._bucket_ok or \
                not feed:
            return feed, None, None
        dims = set()
        for v in feed.values():
            if isinstance(v, core.LoDTensor):
                if v.lod:
                    return feed, None, None
                v = v.data
            shape = np.shape(v)
            if not shape:
                return feed, None, None
            dims.add(int(shape[0]))
        if len(dims) != 1:
            return feed, None, None
        rows = dims.pop()
        if rows > self._ladder[-1]:
            return feed, None, None
        bucket = bucket_for(rows, self._ladder)
        if bucket == rows:
            return feed, None, None
        padded, _waste = fluid_serving.pad_rows_to_bucket(
            {k: (v.data if isinstance(v, core.LoDTensor) else v)
             for k, v in feed.items()}, rows, bucket)
        return padded, rows, bucket

    def run_dict(self, feed, return_numpy=True):
        """return_numpy=False returns the device tensors as the
        executor fetched them (no bucket padding); True routes the feed
        through the bucket pad/slice path and returns numpy arrays."""
        rows = None
        if return_numpy:
            feed, rows, bucket = self._bucket_feed(feed)
        with core.scope_guard(self._scope):
            outs = self._exe.run(self._program, feed=feed,
                                 fetch_list=self._fetch_vars,
                                 return_numpy=return_numpy,
                                 use_program_cache=self._use_program_cache)
        if rows is not None:
            outs = [fluid_serving.slice_rows(o, 0, rows, bucket)
                    for o in outs]
        return outs

    def run(self, inputs):
        """inputs: [PaddleTensor] or [ndarray] in feed order."""
        feed = {}
        for name, t in zip(self._feed_names, inputs):
            feed[name] = t.data if isinstance(t, PaddleTensor) else \
                np.asarray(t)
        outs = self.run_dict(feed)
        return [PaddleTensor(o, name=v.name)
                for o, v in zip(outs, self._fetch_vars)]


def create_paddle_predictor(config):
    return AnalysisPredictor(config)
