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

from typing import Optional, Sequence

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


def _rotl32_array(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def murmur3_32_array(strings: Sequence[str], seed: int = 0) -> np.ndarray:
    """`murmur3_32` of the UTF-8 bytes (surrogates passed through) of every
    string of `strings` as uint32: all strings of one byte length at once,
    in uint32 numpy arithmetic (which wraps modulo 2^32 as the scalar
    version masks). An all-ASCII list is encoded in one call."""
    n = len(strings)
    out = np.empty(n, np.uint32)
    if not n:
        return out
    joined = "".join(strings)
    if joined.isascii():
        data = np.frombuffer(joined.encode("ascii"), np.uint8)
        lens = np.fromiter(map(len, strings), np.int64, n)
    else:
        encoded = [s.encode("utf-8", errors="surrogatepass")
                   for s in strings]
        data = np.frombuffer(b"".join(encoded), np.uint8)
        lens = np.fromiter(map(len, encoded), np.int64, n)
    starts = np.cumsum(lens) - lens
    c1, c2 = np.uint32(_C1), np.uint32(_C2)
    for L in np.unique(lens).tolist():
        idx = np.flatnonzero(lens == L)
        buf = data[starts[idx, None] + np.arange(L)]     # [m, L] bytes
        h = np.full(len(idx), seed & _MASK, np.uint32)
        nb = L // 4
        if nb:
            blocks = np.ascontiguousarray(buf[:, :4 * nb]).view("<u4")
            for j in range(nb):
                k = _rotl32_array(blocks[:, j] * c1, 15) * c2
                h = _rotl32_array(h ^ k, 13) * np.uint32(5) \
                    + np.uint32(0xE6546B64)
        tail = buf[:, 4 * nb:].astype(np.uint32)
        if tail.shape[1]:
            k = np.zeros(len(idx), np.uint32)
            for j in range(tail.shape[1]):
                k ^= tail[:, j] << np.uint32(8 * j)
            h ^= _rotl32_array(k * c1, 15) * c2
        h ^= np.uint32(L)
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
        out[idx] = h
    return out


def hash_strings(strings: Sequence[str], num_bins: int,
                 seed: int = 0) -> np.ndarray:
    """`hash_string` of every string (int64), in bulk."""
    return (murmur3_32_array(strings, seed)
            % np.uint32(num_bins)).astype(np.int64)


def hash_tokens_to_counts(token_lists: Sequence[Optional[Sequence[str]]],
                          num_bins: int, seed: int = 0,
                          binary: bool = False) -> np.ndarray:
    """[n rows of token lists] -> [n, num_bins] count (or 0/1) matrix: every
    token hashed in bulk (`hash_strings`), then float32 increments of 1 in
    one flat pass over every row's tokens (the counts of a per-token
    loop)."""
    n = len(token_lists)
    out = np.zeros((n, num_bins), dtype=np.float32)
    lengths = np.fromiter((len(t) if t else 0 for t in token_lists),
                          np.int64, n)
    if lengths.any():
        ids = hash_strings([t for toks in token_lists if toks for t in toks],
                           num_bins, seed)
        np.add.at(out, (np.repeat(np.arange(n), lengths), ids),
                  np.float32(1.0))
    if binary:
        out = np.minimum(out, 1.0)
    return out
