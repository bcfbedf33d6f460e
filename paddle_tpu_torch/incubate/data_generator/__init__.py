"""User-side data generator for Dataset slot files (the JAX package's
incubate/data_generator): MultiSlotDataGenerator writes the MultiSlot
text format that dataset.py parses, the same bytes as that package's.

Subclass and implement generate_sample(line) returning an iterator over
[(slot_name, [values...]), ...]; run_from_stdin/run_from_files print lines in
the `<len> v...` MultiSlot format paddle_tpu_torch.dataset parses."""

from __future__ import annotations

import sys

__all__ = ["DataGenerator", "MultiSlotDataGenerator"]


class DataGenerator:
    def __init__(self):
        self._proto_info = None
        self.batch_size_ = 32

    def set_batch(self, batch_size):
        self.batch_size_ = batch_size

    # -- user hooks -----------------------------------------------------
    def generate_sample(self, line):
        """Return an iterator yielding one parsed sample:
        [(slot_name, [v, ...]), ...]."""
        raise NotImplementedError(
            "implement generate_sample in your DataGenerator subclass"
        )

    def generate_batch(self, samples):
        """Optional batch-level hook; default passes samples through."""

        def local_iter():
            for s in samples:
                yield s

        return local_iter

    # -- protocol -------------------------------------------------------
    def _format(self, sample):
        parts = []
        for _name, values in sample:
            parts.append(str(len(values)))
            parts.extend(str(v) for v in values)
        return " ".join(parts)

    def _gen(self, line, out):
        it = self.generate_sample(line)
        if it is None:
            return
        batch = []
        for sample in it():
            batch.append(sample)
            if len(batch) == self.batch_size_:
                for s in self.generate_batch(batch)():
                    out.write(self._format(s) + "\n")
                batch = []
        for s in self.generate_batch(batch)():
            out.write(self._format(s) + "\n")

    def run_from_stdin(self):
        for line in sys.stdin:
            self._gen(line, sys.stdout)

    def run_from_files(self, filelist, output_path_prefix):
        outputs = []
        for i, path in enumerate(filelist):
            out_path = f"{output_path_prefix}_{i}"
            with open(path) as f, open(out_path, "w") as out:
                for line in f:
                    self._gen(line, out)
            outputs.append(out_path)
        return outputs


class MultiSlotDataGenerator(DataGenerator):
    """The exported name of the MultiSlot generator."""
