"""DataFeeder: a minibatch of example tuples becomes the Executor's feed
dict of numpy arrays, with each declared data var's dtype (int64 stays
int64; floats are float32) and its declared trailing shape restored. The
arrays are the JAX package's data_feeder.py's, byte for byte."""

from __future__ import annotations

import numpy as np

from .framework import Variable, convert_dtype

__all__ = ["DataFeeder"]


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None):
        self.feed_vars = []
        for v in feed_list:
            if isinstance(v, str):
                from .framework import default_main_program

                v = (program or default_main_program()).global_block().var(v)
            assert isinstance(v, Variable)
            self.feed_vars.append(v)
        self.place = place

    def feed(self, iterable):
        """iterable: list of example tuples (one entry per feed var)."""
        columns = list(zip(*iterable))
        if len(columns) != len(self.feed_vars):
            raise ValueError(
                f"example arity {len(columns)} != feed vars {len(self.feed_vars)}"
            )
        out = {}
        for var, col in zip(self.feed_vars, columns):
            want = convert_dtype(var.dtype)
            np_dtype = {"int64": np.int64, "int32": np.int32,
                        "bool": np.bool_}.get(want, np.float32)
            arr = np.asarray(col, dtype=np_dtype)
            # restore the declared trailing shape: flat 784 -> [1, 28, 28],
            # and scalar labels -> [N, 1] (fluid convention)
            shape = var.shape
            if shape is not None:
                tail = [s for s in shape[1:]]
                if all(s not in (-1, None) for s in tail) and tail:
                    want_elems = int(np.prod(tail))
                    have_elems = int(np.prod(arr.shape[1:] or (1,)))
                    if want_elems == have_elems:
                        arr = arr.reshape((arr.shape[0],) + tuple(tail))
            out[var.name] = arr
        return out
