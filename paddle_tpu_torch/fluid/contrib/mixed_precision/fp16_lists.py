"""AMP op lists.  Reference:
python/paddle/fluid/contrib/mixed_precision/fp16_lists.py; the JAX
package's lists (fluid/contrib/mixed_precision/fp16_lists.py).

The low-precision dtype is bfloat16, which the card's tensor cores take
natively: the white list holds the products and convolutions, which run
with bf16 operands and f32 accumulation; loss scaling still applies.
"""

white_list = {
    'conv2d', 'depthwise_conv2d', 'conv2d_transpose', 'matmul',
    'matmul_v2', 'mul', 'bmm',
}

black_list = {
    'exp', 'square', 'log', 'mean', 'sum', 'cos_sim',
    'softmax', 'softmax_with_cross_entropy',
    'sigmoid_cross_entropy_with_logits', 'cross_entropy', 'cross_entropy2',
}

gray_list = {
    'elementwise_add', 'elementwise_sub', 'elementwise_mul',
    'elementwise_div', 'relu', 'gelu', 'tanh', 'sigmoid', 'pool2d',
    'batch_norm', 'layer_norm', 'dropout', 'reshape2', 'transpose2',
    'concat', 'split', 'slice', 'scale',
}


class AutoMixedPrecisionLists(object):
    """The white, black and gray lists with the caller's custom
    placements: a custom white op leaves the black and gray lists, a
    custom black op the white and gray lists, and an explicit placement
    overrides the harmonization exemptions (``custom_placed``)."""

    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = set(white_list)
        self.black_list = set(black_list)
        self.gray_list = set(gray_list)
        if custom_white_list:
            self.white_list |= set(custom_white_list)
            self.black_list -= set(custom_white_list)
        if custom_black_list:
            self.black_list |= set(custom_black_list)
            self.white_list -= set(custom_black_list)
        self.gray_list -= set(custom_white_list or ())
        self.gray_list -= set(custom_black_list or ())
        self.custom_placed = set(custom_white_list or ()) | \
            set(custom_black_list or ())
