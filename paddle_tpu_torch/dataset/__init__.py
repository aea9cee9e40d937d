"""Dataset readers (reference: python/paddle/dataset/), the JAX
package's paddle_tpu/dataset/ in numpy alone.  Nothing is downloaded:
a loader with a local route reads its files under
$PADDLE_TPU_DATA_HOME/<name> (read at import, as the JAX modules read
it) when they are there; otherwise, and for the loaders without one,
a reader yields synthetic samples made from a fixed seed, bitwise the
JAX package's (the same numpy draws in the same order)."""

from . import mnist
from . import uci_housing
from . import imdb
from . import cifar
from . import imikolov
from . import movielens
from . import flowers
from . import wmt16
from . import conll05
from . import sentiment
from . import voc2012
from . import wmt14
from . import mq2007
from . import common
from . import image
