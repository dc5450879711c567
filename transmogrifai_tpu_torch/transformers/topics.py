"""Topic-model and embedding stages: OpLDA, OpWord2Vec (counterpart of
transformers/topics.py).

Reference: core/.../impl/feature/OpLDA.scala:60 (LDA over a count vector ->
topic-distribution vector, params k/maxIter/optimizer) and OpWord2Vec.scala
(TextList -> averaged word vectors). The math lives in ops/lda.py and
ops/embeddings.py and runs on the stage's device (None: CUDA); these
stages provide the estimator/model contract, vector metadata and
persistence. Each fit draws its initial factors from a CPU
`torch.Generator` seeded by its `seed` param and moves them to the device,
so the card and the CPU start from the same numbers.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..automl.vectorizers.base import VectorizerModel
from ..data.dataset import Column
from ..data.vector import VectorColumnMetadata, VectorMetadata
from ..device import resolve_device
from ..stages.base import Estimator
from ..stages.params import Param
from ..types import OPVector, TextList


def _as_matrix(col: Column) -> np.ndarray:
    X = np.asarray(col.data, np.float32)
    if X.ndim == 1:
        X = X[:, None]
    return X


def _draws(seed: int, *shapes, normal: bool = False):
    """Tensors of `shapes` drawn in turn from one CPU generator seeded by
    `seed`: standard normal, or uniform on [0.5, 1.5)."""
    g = torch.Generator().manual_seed(int(seed))
    if normal:
        return [torch.randn(s, generator=g) for s in shapes]
    return [torch.rand(s, generator=g) + 0.5 for s in shapes]


def _metadata(stage, default: str, ptype: str, descriptors) -> VectorMetadata:
    parent = stage.input_features[0] if stage.input_features else None
    return VectorMetadata(
        name=stage.output_name(),
        columns=[VectorColumnMetadata(
            parent_feature_name=parent.name if parent else default,
            parent_feature_type=parent.type_name if parent else ptype,
            descriptor_value=d) for d in descriptors])


class OpLDA(Estimator):
    """OPVector (term counts) -> OPVector of topic distributions.

    Reference OpLDA.scala:60 defaults: k=10, maxIter=10 (online) — here EM
    runs a fixed 50 iterations (pure matmuls; far cheaper per iteration
    than Spark's distributed EM)."""

    input_types = (OPVector,)
    output_type = OPVector

    @classmethod
    def _declare_params(cls):
        return [Param("k", "number of topics", 10, lambda v: v >= 2),
                Param("max_iter", "EM iterations", 50, lambda v: v > 0),
                Param("doc_concentration", "alpha prior", 1.1),
                Param("topic_concentration", "eta prior", 1.01),
                Param("seed", "init seed", 42)]

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "lda"), uid=uid,
                         **params)

    def fit_columns(self, *cols: Column) -> "OpLDAModel":
        from ..ops.lda import fit_lda

        dev = resolve_device(self.device)
        C = torch.as_tensor(_as_matrix(cols[0]), device=dev)
        k = int(self.get_param("k"))
        theta0, beta0 = _draws(int(self.get_param("seed")),
                               (C.shape[0], k), (k, C.shape[1]))
        _, beta = fit_lda(
            C, theta0.to(dev), beta0.to(dev),
            n_iter=int(self.get_param("max_iter")),
            alpha=float(self.get_param("doc_concentration")),
            eta=float(self.get_param("topic_concentration")))
        model = OpLDAModel(
            beta=beta.cpu().numpy(),
            alpha=float(self.get_param("doc_concentration")),
            operation_name=self.operation_name)
        model.set_metadata(_metadata(self, "lda", "OPVector",
                                     [f"topic_{t}" for t in range(k)]))
        return model


class OpLDAModel(VectorizerModel):
    """Frozen topics; transform = variational fold-in (topicDistribution)
    on the stage's device."""

    input_types = (OPVector,)

    def __init__(self, beta: Optional[np.ndarray] = None, alpha: float = 1.1,
                 uid: Optional[str] = None, **params):
        self.beta = np.asarray(beta, np.float32) if beta is not None else \
            np.zeros((0, 0), np.float32)
        self.alpha = float(alpha)
        super().__init__(params.pop("operation_name", "lda"), uid=uid,
                         **params)

    def transform_block(self, cols: Sequence[Column]) -> np.ndarray:
        from ..ops.lda import lda_fold_in

        dev = resolve_device(self.device)
        C = torch.as_tensor(_as_matrix(cols[0]), device=dev)
        beta = torch.tensor(self.beta, device=dev)
        return lda_fold_in(C, beta, alpha=self.alpha).cpu().numpy()

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(beta=self.beta, alpha=self.alpha)
        return d


class OpWord2Vec(Estimator):
    """TextList -> OPVector document embedding (mean of word vectors).

    Reference OpWord2Vec.scala wraps Spark Word2Vec (vectorSize=100 default,
    skip-gram SGD); here word vectors come from ALS factorization of the
    hashed windowed co-occurrence matrix (ops/embeddings.py) — deterministic
    given the seed."""

    input_types = (TextList,)
    output_type = OPVector

    @classmethod
    def _declare_params(cls):
        return [Param("vector_size", "embedding dim", 100, lambda v: v >= 2),
                Param("vocab_bins", "hashed vocabulary size", 2048),
                Param("window_size", "co-occurrence window", 5),
                Param("num_iterations", "ALS iterations", 10),
                Param("seed", "hash + init seed", 42)]

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "w2v"), uid=uid,
                         **params)

    def fit_columns(self, *cols: Column) -> "OpWord2VecModel":
        from ..ops.embeddings import cooccurrence_matrix, factorize_embeddings

        seed = int(self.get_param("seed"))
        bins = int(self.get_param("vocab_bins"))
        dim = int(self.get_param("vector_size"))
        dev = resolve_device(self.device)
        C = cooccurrence_matrix(cols[0].data, bins,
                                window=int(self.get_param("window_size")),
                                seed=seed)
        W0, H0 = _draws(seed, (bins, dim), (bins, dim), normal=True)
        emb = factorize_embeddings(
            torch.as_tensor(C, device=dev), W0.to(dev), H0.to(dev),
            n_iter=int(self.get_param("num_iterations")))
        model = OpWord2VecModel(embeddings=emb.cpu().numpy(), seed=seed,
                                operation_name=self.operation_name)
        model.set_metadata(_metadata(self, "w2v", "TextList",
                                     [f"dim_{j}" for j in range(dim)]))
        return model


class OpWord2VecModel(VectorizerModel):
    input_types = (TextList,)

    def __init__(self, embeddings: Optional[np.ndarray] = None, seed: int = 42,
                 uid: Optional[str] = None, **params):
        self.embeddings = np.asarray(embeddings, np.float32) \
            if embeddings is not None else np.zeros((0, 0), np.float32)
        self.seed = int(seed)
        super().__init__(params.pop("operation_name", "w2v"), uid=uid,
                         **params)

    def transform_block(self, cols: Sequence[Column]) -> np.ndarray:
        from ..ops.embeddings import mean_pool_docs

        emb = torch.tensor(self.embeddings, device=resolve_device(self.device))
        return mean_pool_docs(cols[0].data, emb, seed=self.seed).cpu().numpy()

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(embeddings=self.embeddings, seed=self.seed)
        return d
