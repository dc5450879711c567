"""LDA topic modeling as batched EM matmuls (counterpart of ops/lda.py).

Reference: core/.../impl/feature/OpLDA.scala:60 wraps Spark ML's LDA over a
count-vector column. As in the JAX package, MAP-smoothed multinomial EM
runs a fixed number of iterations of four GEMMs on the [docs, vocab] count
matrix, on the device of its input — no sampling and no sparse scatter:

    pred  = theta @ beta                    # [n, v] expected word mass
    R     = C / pred                        # responsibility ratios
    theta <- norm(theta * (R @ beta^T) + (alpha - 1))
    beta  <- norm(beta  * (theta^T @ R) + (eta - 1))

Dirichlet priors (alpha on doc-topic, eta on topic-word) enter as MAP
pseudo-counts. The initial draws are arguments (the stage makes them from
its seed on the CPU), so every device starts from the same numbers. The
iterations run in float64 and return float32: the card's and the CPU's
GEMMs sum in different orders, and in float64 that difference stays far
below a float32 rounding, so both devices give the same topics (and the
features a model is trained on split alike), within the JAX package's
float32 noise of its result.
"""
from __future__ import annotations

from typing import Tuple

import torch

EPS = 1e-12


def _norm_rows(M: torch.Tensor) -> torch.Tensor:
    M = torch.clamp_min(M, EPS)
    return M / M.sum(dim=1, keepdim=True)


def fit_lda(C: torch.Tensor, theta0: torch.Tensor, beta0: torch.Tensor,
            n_iter: int = 50, alpha: float = 1.1, eta: float = 1.01
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit topics on a count matrix C [n, v] from the draws theta0 [n, k]
    and beta0 [k, v] (uniform on [0.5, 1.5), row-normalized here).

    Returns (theta [n, k] doc-topic mix, beta [k, v] topic-word dists,
    float32) on C's device after exactly `n_iter` EM iterations."""
    C = torch.as_tensor(C).to(torch.float64)
    theta = _norm_rows(theta0.to(C.device, torch.float32).double())
    beta = _norm_rows(beta0.to(C.device, torch.float32).double())
    for _ in range(int(n_iter)):
        pred = theta @ beta                                  # [n, v]
        R = C / torch.clamp_min(pred, EPS)
        theta, beta = (_norm_rows(theta * (R @ beta.T) + (alpha - 1.0)),
                       _norm_rows(beta * (theta.T @ R) + (eta - 1.0)))
    return theta.float(), beta.float()


def lda_fold_in(C: torch.Tensor, beta: torch.Tensor, n_iter: int = 25,
                alpha: float = 1.1) -> torch.Tensor:
    """Infer doc-topic mixes (float32) for new documents against frozen
    topics (the transform path: Spark's LDAModel.transform
    topicDistribution), on C's device, iterating in float64 as `fit_lda`."""
    C = torch.as_tensor(C).to(torch.float64)
    beta = beta.to(C.device, torch.float32).double()
    k = beta.shape[0]
    theta = torch.full((C.shape[0], k), 1.0 / k, dtype=torch.float64,
                       device=C.device)
    for _ in range(int(n_iter)):
        R = C / torch.clamp_min(theta @ beta, EPS)
        theta = _norm_rows(theta * (R @ beta.T) + (alpha - 1.0))
    return theta.float()
