"""Bitset machinery for label/taint/GVK matching at tensor speed.

Label selectors, tolerations, and API enablement are the O(bindings x
clusters) constant factor of the reference's filter loop
(framework/plugins/*). Here every string universe is interned into a bit
vocabulary (label key=value pairs, label keys, taint triples, GVKs) and packed
into uint32 words, so a full selector evaluates as a handful of AND/OR/
popcount ops over ``[C, words]`` arrays — no string work on the hot path.

The port's copy runs on the host in numpy, once per snapshot and placement
compile. ``first_fit_group`` (ranked ClusterAffinities selection) is not in
this slice: the engine raises ``NotImplementedError`` for multi-term
affinities.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence

import numpy as np

WORD = 32


class Vocab:
    """String -> bit-id interning table."""

    def __init__(self) -> None:
        self._ids: dict[str, int] = {}

    def intern(self, s: str) -> int:
        i = self._ids.get(s)
        if i is None:
            i = len(self._ids)
            self._ids[s] = i
        return i

    def get(self, s: str) -> int | None:
        return self._ids.get(s)

    def __len__(self) -> int:
        return len(self._ids)

    def __contains__(self, s: str) -> bool:
        return s in self._ids

    @property
    def words(self) -> int:
        return max(1, (len(self._ids) + WORD - 1) // WORD)


def pack_bits(rows: Sequence[Iterable[int]], words: int) -> np.ndarray:
    """Pack per-row bit-id lists into uint32[rows, words]."""
    out = np.zeros((len(rows), words), dtype=np.uint32)
    for r, ids in enumerate(rows):
        for i in ids:
            out[r, i // WORD] |= np.uint32(1) << np.uint32(i % WORD)
    return out


def bits_from_ids(ids: Iterable[int], words: int) -> np.ndarray:
    """Pack one bit-id list into uint32[words]."""
    return pack_bits([list(ids)], words)[0]


def contains_all(bits, require) -> np.ndarray:
    """bool[...]: every bit of ``require`` present in ``bits``.
    bits: uint32[..., W]; require: uint32[W] (broadcast)."""
    return ((bits & require) == require).all(axis=-1)


def intersects(bits, other) -> np.ndarray:
    """bool[...]: any common bit."""
    return ((bits & other) != 0).any(axis=-1)


def label_pair(key: str, value: str) -> str:
    return f"{key}={value}"


def intern_labels(vocab: Vocab, key_vocab: Vocab, labels: Mapping[str, str]) -> tuple[list[int], list[int]]:
    """Intern a label map into (pair_ids, key_ids)."""
    pair_ids = [vocab.intern(label_pair(k, v)) for k, v in labels.items()]
    key_ids = [key_vocab.intern(k) for k in labels]
    return pair_ids, key_ids
