"""Fixed-range histograms of every column at once (counterpart of the
histogram part of ops/stats.py: `hist_bin_ids` :278, `histogram_batched`
:297).

The JAX package bins with `jax.ops.segment_sum` outside any Pallas kernel;
here the sums are a float64 `torch.bincount` (exact integer counts for
weight 1), on whatever device the matrix lies on.
"""
from __future__ import annotations

from typing import Optional

import torch

EPS = 1e-12


def hist_bin_ids(V: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 bins: int, ok: torch.Tensor) -> torch.Tensor:
    """Flattened column-offset histogram segment ids for a [n, K] f32
    matrix: column k's value lands in segment k*(bins+1) + bin, invalid
    entries (ok False) in the trailing missing segment. The binning rule
    shared by `histogram_batched` (NaN-only missing) and the statistics
    engine's in-pass histograms (finite-only). Every step is the JAX
    package's, in f32 and in its order — (V - lo) / span * bins, no
    reciprocal — so bin ids match bit for bit; the clip runs in float space
    BEFORE the int cast, so +/-inf clips into the edge bins."""
    span = torch.clamp(hi - lo, min=EPS)
    zero = torch.zeros((), dtype=V.dtype, device=V.device)
    scaled = (torch.where(ok, V, zero) - lo[None, :]) / span[None, :] * bins
    # a NaN here (an infinite span: +/-inf ranges) converts to bin 0, as
    # XLA converts NaN to the integer 0
    idx = torch.nan_to_num(torch.clamp(scaled, 0.0, float(bins - 1)),
                           nan=0.0).to(torch.int32)
    idx = torch.where(ok, idx, bins)
    K = V.shape[1]
    offs = torch.arange(K, dtype=torch.int32, device=V.device) * (bins + 1)
    return offs[None, :] + idx


def segment_hist(ids: torch.Tensor, K: int, bins: int,
                 w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[K, bins + 1] float64 sums of the rows' weights `w` (None: counts)
    over the segment ids of `hist_bin_ids`."""
    wt = None if w is None else \
        w.to(torch.float64)[:, None].expand(ids.shape).reshape(-1)
    out = torch.bincount(ids.reshape(-1).to(torch.int64), weights=wt,
                         minlength=K * (bins + 1))
    return out.to(torch.float64).reshape(K, bins + 1)


def histogram_batched(V: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                      bins: int, w: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Fixed-range histograms of EVERY column at once: [n, K] f32 -> [K,
    bins + 1] float64, last bin = missing (NaN) mass. Missing means NaN
    only (the FeatureDistribution convention): +/-inf are valid values and
    clip into the edge bins."""
    V = V.to(torch.float32)
    lo = lo.to(device=V.device, dtype=torch.float32)
    hi = hi.to(device=V.device, dtype=torch.float32)
    ids = hist_bin_ids(V, lo, hi, bins, ~torch.isnan(V))
    return segment_hist(ids, V.shape[1], bins, w)
