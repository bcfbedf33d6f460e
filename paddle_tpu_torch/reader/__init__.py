"""Reader decorators and the DataLoader (the JAX package's reader/).

The decorators (map_readers, shuffle, chain, compose, buffered, firstn,
xmap_readers, cache, multiprocess_reader) work on zero-argument reader
callables; `DataLoader` / `PyReader` batch and convert on a host thread
and, with `use_double_buffer=True`, stage batches onto the card ahead of
the step through `DeviceStager` (stager.py).
"""

from .decorator import (  # noqa: F401
    buffered,
    cache,
    chain,
    compose,
    firstn,
    map_readers,
    multiprocess_reader,
    shuffle,
    xmap_readers,
)
from .dataloader import DataLoader, PyReader, batch  # noqa: F401
from .stager import DeviceStager  # noqa: F401
