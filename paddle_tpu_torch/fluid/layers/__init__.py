"""fluid.layers: the subset the BERT, CTR, image, video, recurrent and
structured-prediction models, the learning-rate schedules, gradient
clipping, control flow, beam-search decoding, the distributions and
ordinary Fluid scripts (the core math, activation, tensor, dense
vision, loss and detection layers) use (reference:
python/paddle/fluid/layers/)."""

from . import nn  # noqa: F401
from . import math_op_patch  # noqa: F401
from . import ops  # noqa: F401
from . import tensor  # noqa: F401
from . import io  # noqa: F401
from . import learning_rate_scheduler  # noqa: F401
from . import control_flow  # noqa: F401
from . import sequence_lod  # noqa: F401
from . import rnn  # noqa: F401
from . import extras  # noqa: F401
from . import more_layers  # noqa: F401
from . import distributions  # noqa: F401
from . import detection  # noqa: F401

from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .learning_rate_scheduler import (  # noqa: F401
    noam_decay, exponential_decay, natural_exp_decay, inverse_time_decay,
    polynomial_decay, piecewise_decay, cosine_decay, linear_lr_warmup)
from .control_flow import (  # noqa: F401
    While, increment, Switch, StaticRNN, ConditionalBlock,
    create_array, array_write, array_read, array_length,
    while_loop, cond, case, switch_case, is_empty,
    reorder_lod_tensor_by_rank, IfElse, DynamicRNN)
from .rnn import (  # noqa: F401
    dynamic_lstm, dynamic_gru, lstm_unit, beam_search, gather_tree,
    gru_unit, lstm, dynamic_lstmp, RNNCell, GRUCell, LSTMCell,
    Decoder, BeamSearchDecoder, dynamic_decode, beam_search_decode)
from .sequence_lod import (  # noqa: F401
    sequence_pool, sequence_softmax, sequence_expand, sequence_reshape,
    sequence_first_step, sequence_last_step, sequence_conv,
    sequence_pad, sequence_unpad, sequence_concat, sequence_slice,
    sequence_erase, sequence_enumerate, sequence_reverse,
    sequence_expand_as, sequence_scatter, lod_reset, sequence_mask)
from .extras import *  # noqa: F401,F403
from .more_layers import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403
from .distributions import (Uniform, Normal, Categorical,  # noqa: F401
                            MultivariateNormalDiag)
