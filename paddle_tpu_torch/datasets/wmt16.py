"""WMT16 en-de reader API (reference: python/paddle/dataset/wmt16.py),
synthetic: source sequence of token ids, target = reversed source shifted
into the target vocab (a learnable seq2seq toy with the real interface)."""

from __future__ import annotations

import numpy as np

__all__ = ["train", "test", "get_dict"]

BOS, EOS, UNK = 0, 1, 2


def get_dict(lang, dict_size, reverse=False):
    vocab = {f"<{lang}_{i}>": i for i in range(dict_size)}
    if reverse:
        return {v: k for k, v in vocab.items()}
    return vocab


def _gen(n, src_dict_size, trg_dict_size, seed, max_len=16):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            ln = int(rng.randint(4, max_len))
            src = rng.randint(3, src_dict_size, size=ln).tolist()
            trg = [(t * 7 + 3) % (trg_dict_size - 3) + 3
                   for t in reversed(src)]
            yield (
                [BOS] + src + [EOS],
                [BOS] + trg,
                trg + [EOS],
            )

    return reader


def train(src_dict_size=1000, trg_dict_size=1000, src_lang="en", n=4096,
          seed=0):
    return _gen(n, src_dict_size, trg_dict_size, seed)


def test(src_dict_size=1000, trg_dict_size=1000, src_lang="en", n=512,
         seed=1):
    return _gen(n, src_dict_size, trg_dict_size, seed)
