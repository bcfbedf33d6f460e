"""Built-in dataset readers (Fluid's paddle.dataset: mnist, cifar, imdb,
movielens, uci_housing, wmt16), copies of the JAX package's datasets/.

Each dataset is generated from a seed with the shapes, dtypes and vocab
conventions of the upstream loaders, so nothing is downloaded; the reader
API (a zero-argument callable yielding example tuples) is the same, and
the samples are byte-equal to the JAX package's.
"""

from . import cifar, imdb, mnist, movielens, uci_housing, wmt16  # noqa: F401
