"""MurmurHash3 (x86 32-bit) for the hashing trick (counterpart of
ops/hashing.py).

Reference: the vectorizers hash text with MurmurHash3
(TransmogrifierDefaults.HashAlgorithm=MurMur3, hashing in
OPCollectionHashingVectorizer.scala). Python and numpy, on the host: the
hashing trick runs before any tensor exists. Strings are hashed as UTF-8
with lone surrogates passed through (`surrogatepass`), as the JAX
package's native path packs them, so every string hashes alike in both.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_MASK = 0xFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3_x86_32 over bytes (matches the standard reference
    vectors)."""
    h = seed & _MASK
    n = len(data)
    nblocks = n // 4
    for i in range(nblocks):
        k = int.from_bytes(data[4 * i:4 * i + 4], "little")
        k = (k * _C1) & _MASK
        k = _rotl32(k, 15)
        k = (k * _C2) & _MASK
        h ^= k
        h = _rotl32(h, 13)
        h = (h * 5 + 0xE6546B64) & _MASK
    tail = data[4 * nblocks:]
    k = 0
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * _C1) & _MASK
        k = _rotl32(k, 15)
        k = (k * _C2) & _MASK
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _MASK
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _MASK
    h ^= h >> 16
    return h


def hash_string(s: str, num_bins: int, seed: int = 0) -> int:
    return murmur3_32(s.encode("utf-8", errors="surrogatepass"),
                      seed) % num_bins


def hash_tokens_to_counts(token_lists: Sequence[Optional[Sequence[str]]],
                          num_bins: int, seed: int = 0,
                          binary: bool = False) -> np.ndarray:
    """[n rows of token lists] -> [n, num_bins] count (or 0/1) matrix.
    Each distinct token is hashed once a call."""
    out = np.zeros((len(token_lists), num_bins), dtype=np.float32)
    bins: Dict[str, int] = {}
    for i, toks in enumerate(token_lists):
        if not toks:
            continue
        row = out[i]
        for t in toks:
            b = bins.get(t)
            if b is None:
                b = bins[t] = hash_string(t, num_bins, seed)
            row[b] += 1.0
    if binary:
        out = np.minimum(out, 1.0)
    return out
