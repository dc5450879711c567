"""Word embeddings via hashed co-occurrence factorization (counterpart of
ops/embeddings.py).

Reference: core/.../impl/feature/OpWord2Vec.scala wraps Spark ML Word2Vec
(skip-gram, async SGD over a driver-broadcast vocab). As in the JAX
package, a GloVe-style closed-form pipeline replaces the sampling loop:

1. host: hash tokens into a fixed vocab of V bins (each distinct token
   once, MurmurHash3 as the vectorizers hash) and count a windowed
   co-occurrence matrix C [V, V] in one pass over every document's ids;
2. device: factorize M = log(1 + C) with alternating least squares —
   each half-step is one Gram matrix, one [V, V] x [V, d] matmul and one
   Cholesky solve, repeated a fixed number of iterations, in float64 (the
   card's and the CPU's solves then agree far below a float32 rounding,
   so both give the same float32 word vectors).

Document embeddings are mean-pooled word vectors (Spark Word2Vec.transform
does exactly this average), summed token by token in each document's
order on every device, as the JAX package's `np.add.at` sums them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .hashing import hash_strings

def hash_token_ids(tokens: Sequence[str], vocab_bins: int,
                   seed: int = 0) -> np.ndarray:
    """Token strings -> hashed vocab ids (int64): MurmurHash3 as
    `hashing.hash_string`, every token at once (`hashing.hash_strings`)."""
    return hash_strings(list(tokens), vocab_bins, seed)


def _flat_ids(token_lists: Sequence[Optional[Sequence[str]]],
              vocab_bins: int, seed: int):
    """(hashed ids of every token in order, each token's document)."""
    lengths = np.fromiter((len(t) if t else 0 for t in token_lists),
                          np.int64, len(token_lists))
    ids = hash_token_ids([t for toks in token_lists if toks for t in toks],
                         vocab_bins, seed)
    return ids, np.repeat(np.arange(len(token_lists)), lengths), lengths


def cooccurrence_matrix(token_lists: Sequence[Optional[Sequence[str]]],
                        vocab_bins: int, window: int = 5,
                        seed: int = 0) -> np.ndarray:
    """Symmetric windowed co-occurrence counts [V, V] as float32.

    One pass over all documents' ids: at each offset up to `window`, the
    pairs whose two tokens lie in one document are counted in int64
    (exact at any corpus size) with `bincount` on a * V + b and b * V + a —
    the counts of the JAX package's per-document loop."""
    V = int(vocab_bins)
    ids, doc, _ = _flat_ids(token_lists, V, seed)
    counts = np.zeros(V * V, np.int64)
    for off in range(1, int(window) + 1):
        if off >= len(ids):
            break
        same = doc[:-off] == doc[off:]
        a, b = ids[:-off][same], ids[off:][same]
        counts += np.bincount(a * V + b, minlength=V * V)
        counts += np.bincount(b * V + a, minlength=V * V)
    return counts.reshape(V, V).astype(np.float32)


def factorize_embeddings(C: torch.Tensor, W0: torch.Tensor,
                         H0: torch.Tensor, n_iter: int = 10,
                         reg: float = 1e-2) -> torch.Tensor:
    """ALS factorization of log(1 + C) -> row embeddings [V, dim] (float32)
    on C's device, from the standard-normal draws W0 and H0 [V, dim]
    (scaled by 0.1 here). Each half-step solves the ridge normal equations
    (Gram + reg I, positive definite) by Cholesky, in float64. The two
    factors are averaged at the end (standard GloVe practice: w + w~)."""
    M = torch.log1p(torch.as_tensor(C, dtype=torch.float32)).double()
    W = (W0.to(M.device, torch.float32) * 0.1).double()
    H = (H0.to(M.device, torch.float32) * 0.1).double()
    eye = torch.eye(W.shape[1], dtype=torch.float64, device=M.device)

    def solve(G, B):   # X with X @ G = B, G symmetric positive definite
        return torch.cholesky_solve(B.T, torch.linalg.cholesky(G)).T

    for _ in range(int(n_iter)):
        W = solve(H.T @ H + reg * eye, M @ H)
        H = solve(W.T @ W + reg * eye, M.T @ W)
    return (0.5 * (W + H)).float()


def mean_pool_docs(token_lists: Sequence[Optional[Sequence[str]]],
                   embeddings: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Documents -> [n, dim] mean of hashed word vectors (empty doc -> 0),
    on the embeddings' device. The documents are ordered by length and
    their j-th word vectors added at step j, so every row sums its tokens
    in order (float32, the same sums on every device and as the JAX
    package's), then is divided by its length."""
    V, dim = embeddings.shape
    dev = embeddings.device
    n = len(token_lists)
    ids, doc, lengths = _flat_ids(token_lists, V, seed)
    if not len(ids):
        return torch.zeros((n, dim), dtype=torch.float32, device=dev)
    order = np.argsort(-lengths, kind="stable")      # longest first
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    starts = np.cumsum(lengths) - lengths
    pos = np.arange(len(ids)) - np.repeat(starts, lengths)
    grid = np.zeros((n, int(lengths.max())), np.int64)
    grid[rank[doc], pos] = ids
    grid = torch.as_tensor(grid, device=dev)
    # the documents longer than j come first: their j-th tokens are the
    # first `longer[j]` rows of column j
    longer = np.searchsorted(-lengths[order], -np.arange(grid.shape[1]),
                             side="left")
    acc = torch.zeros((n, dim), dtype=torch.float32, device=dev)
    for j, k in enumerate(longer.tolist()):
        acc[:k] += embeddings[grid[:k, j]]
    out = acc[torch.as_tensor(rank, device=dev)]
    nz = torch.as_tensor(lengths > 0, device=dev)
    out[nz] /= torch.as_tensor(lengths, dtype=torch.float32,
                               device=dev)[nz, None]
    return out
