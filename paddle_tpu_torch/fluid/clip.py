"""Gradient clipping. Reference: python/paddle/fluid/clip.py
(GradientClipByValue/Norm/GlobalNorm, set_gradient_clip).

Each clip appends the ops the JAX package's fluid/clip.py appends, in
the optimize role, between the backward and the update ops."""

from . import unique_name
from .framework import default_main_program
from .layer_helper import LayerHelper


class BaseGradientClipAttr(object):
    def __call__(self, params_grads):
        raise NotImplementedError


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        block = default_main_program().global_block()
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            ng = block.create_var(
                name=unique_name.generate(g.name + '_clip'),
                shape=p.shape, dtype=p.dtype)
            block.append_op('clip', inputs={'X': g}, outputs={'Out': ng},
                            attrs={'min': self.min, 'max': self.max})
            out.append((p, ng))
        return out


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        block = default_main_program().global_block()
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            ng = block.create_var(
                name=unique_name.generate(g.name + '_clip'),
                shape=p.shape, dtype=p.dtype)
            block.append_op('clip_by_norm', inputs={'X': g},
                            outputs={'Out': ng},
                            attrs={'max_norm': self.clip_norm})
            out.append((p, ng))
        return out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Reference clip.py GradientClipByGlobalNorm: scale all grads by
    clip_norm / max(global_norm, clip_norm)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        from .layers import ops as _ops
        from .layers import tensor as _tensor
        from .layers import nn as _nn
        block = default_main_program().global_block()
        helper = LayerHelper('global_norm_clip')
        sq_sums = []
        live = [(p, g) for p, g in params_grads if g is not None]
        if not live:
            return params_grads
        for p, g in live:
            sq = helper.create_variable_for_type_inference('float32')
            block.append_op('squared_l2_norm', inputs={'X': g},
                            outputs={'Out': sq})
            sq_sums.append(sq)
        total = helper.create_variable_for_type_inference('float32')
        block.append_op('sum', inputs={'X': sq_sums},
                        outputs={'Out': total})
        gnorm = _ops.sqrt(total)
        clipv = _tensor.fill_constant([1], 'float32', self.clip_norm)
        denom = _nn.elementwise_max(gnorm, clipv)
        scale = _nn.elementwise_div(clipv, denom)
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            ng = helper.create_variable_for_type_inference(p.dtype)
            block.append_op('elementwise_mul',
                            inputs={'X': g, 'Y': scale},
                            outputs={'Out': ng}, attrs={'axis': -1},
                            infer_shape=False)
            ng.shape = g.shape
            out.append((p, ng))
        return out


ClipGradByValue = GradientClipByValue
ClipGradByNorm = GradientClipByNorm
ClipGradByGlobalNorm = GradientClipByGlobalNorm

_clip_attr = {}


def set_gradient_clip(clip, param_list=None, program=None):
    program = program or default_main_program()
    _clip_attr[id(program)] = (clip, param_list)


def append_gradient_clip_ops(params_grads):
    program = default_main_program()
    entry = _clip_attr.get(id(program))
    if entry is None:
        return params_grads
    clip, param_list = entry
    if param_list:
        names = set(p if isinstance(p, str) else p.name
                    for p in param_list)
        subset = [(p, g) for p, g in params_grads if p.name in names]
        rest = [(p, g) for p, g in params_grads if p.name not in names]
        return clip(subset) + rest
    return clip(params_grads)


class ErrorClipByValue(object):
    def __init__(self, max, min=None):
        self.max = max
        self.min = min
