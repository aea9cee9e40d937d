"""Model builders of the port (reference: paddle_tpu/models): the JAX
package's model zoo but gpt, and the models of later slices
(mobilenet_v3, seq2seq, label_semantic_roles), each also imported by
its module path."""

from . import lenet  # noqa: F401
from . import resnet  # noqa: F401
from . import se_resnext  # noqa: F401
from . import bert  # noqa: F401
from . import transformer  # noqa: F401
from . import wide_deep  # noqa: F401
from . import word2vec  # noqa: F401
