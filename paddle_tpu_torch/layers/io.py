"""Input layers: `data` declares a feed slot; py_reader,
create_py_reader_by_data, read_file, double_buffer and load are the
reader layers over reader.PyReader and the scope."""

from __future__ import annotations

from ..framework import default_main_program, default_startup_program

__all__ = ["data"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True, stop_gradient=True):
    """Declare an input slot. A leading batch dim of -1 is implied when
    append_batch_size=True."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = default_main_program().current_block()
    var = block.create_var(
        name=name,
        shape=tuple(shape),
        dtype=dtype,
        is_data=True,
        stop_gradient=stop_gradient,
        lod_level=lod_level,
    )
    # mirrored into startup for feed-order bookkeeping, as the JAX package does
    default_startup_program().current_block().create_var(
        name=name, shape=tuple(shape), dtype=dtype, is_data=True
    )
    return var


# -- the reader layers (py_reader, create_py_reader_by_data, read_file,
# double_buffer, load): the pipeline is reader.PyReader / DataLoader (the
# host producer and the device double buffer); these shims keep Fluid's
# layer-level calling convention.


class _PyReaderShim:
    """What layers.py_reader returns: decorate with a sample/batch
    source, start()/reset(), and read via layers.read_file."""

    def __init__(self, data_vars, capacity, use_double_buffer):
        from ..reader.dataloader import PyReader as _PyReader

        self._vars = list(data_vars)
        self._impl = _PyReader(feed_list=self._vars, capacity=capacity,
                               use_double_buffer=use_double_buffer,
                               iterable=True)
        self._iter = None

    # Fluid's decorate surface; `places` picks the staging device
    def decorate_sample_list_generator(self, generator, places=None):
        self._impl.decorate_sample_list_generator(generator, places)

    def decorate_batch_generator(self, generator, places=None):
        self._impl.decorate_batch_generator(generator, places)

    def decorate_tensor_provider(self, generator, places=None):
        self._impl.decorate_batch_generator(generator, places)

    def start(self):
        self._iter = iter(self._impl)

    def reset(self):
        self._iter = None

    def next_feed(self):
        """Feed dict for the next batch (an executor-side pull in place of
        the blocking read_file op)."""
        if self._iter is None:
            self.start()
        return next(self._iter)


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    """Create the data slots and a reader handle; read_file(reader)
    returns the slot Variables."""
    del lod_levels
    from ..framework import unique_name

    vars_ = [
        data(
            f"{name or 'py_reader'}_{unique_name.generate('slot')}",
            list(shape), dtype=dtype, append_batch_size=False,
        )
        for shape, dtype in zip(shapes, dtypes)
    ]
    return _PyReaderShim(vars_, capacity, use_double_buffer)


def create_py_reader_by_data(capacity, feed_list, name=None,
                             use_double_buffer=True):
    """The py_reader shim over existing data vars."""
    del name
    return _PyReaderShim(feed_list, capacity, use_double_buffer)


def read_file(reader):
    """The reader's data Variables (a single var unwraps, as in Fluid)."""
    vs = reader._vars
    return vs[0] if len(vs) == 1 else vs


def double_buffer(reader, place=None, name=None):
    """Identity: the device double buffer is already the shim's PyReader's
    (use_double_buffer)."""
    del place, name
    return reader


def load(out, file_path, load_as_fp16=None):
    """Fill `out` from a `.npy` file that io.save_vars / save_persistables
    wrote: the array goes into the global scope at once, as numpy (the
    Executor moves a scope value to its device at its first read)."""
    import numpy as np

    from ..scope import global_scope

    arr = np.load(file_path + ".npy") if not file_path.endswith(".npy") \
        else np.load(file_path)
    if load_as_fp16:
        arr = arr.astype("float16")
    global_scope().set(out.name, arr)
    return out


__all__ += ["py_reader", "create_py_reader_by_data", "read_file",
            "double_buffer", "load"]
