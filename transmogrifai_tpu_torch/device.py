"""Device selection for the port (counterpart of utils/platform.py).

Entry points run on CUDA unless the caller asks for the CPU. A CUDA request
on a machine without CUDA raises: nothing carries on quietly on the CPU.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device` as a torch.device: None means "cuda". Raises RuntimeError for
    a CUDA device when CUDA is not available, ValueError for a device type
    the port does not run on."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "transmogrifai_tpu_torch runs on CUDA by default and CUDA is "
                "not available here; pass device='cpu' to run the plain "
                "PyTorch versions of its kernels")
        # float32 matrix products and convolutions stay in full float32:
        # TF32 keeps about three decimal digits, too few for the histogram
        # sums and split gains the reference computes in float32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


class CopyRecorder:
    """Host-to-device copies made through `to_device` onto a CUDA device
    while `record_copies()` is open, in order: {"label", "bytes",
    "seconds"}. Each copy is bracketed by two CUDA events on the current
    stream (no synchronization); the seconds are read once, when the
    recorder closes."""

    def __init__(self):
        self.copies: List[Dict[str, Any]] = []
        self._events: List[tuple] = []

    def add(self, label: str, n_bytes: int, start, end) -> None:
        self._events.append((label, n_bytes, start, end))

    def close(self) -> None:
        if self._events:
            torch.cuda.synchronize()
        self.copies += [{"label": label, "bytes": n_bytes,
                         "seconds": start.elapsed_time(end) / 1e3}
                        for label, n_bytes, start, end in self._events]
        self._events = []


_recorder: Optional[CopyRecorder] = None


@contextlib.contextmanager
def record_copies() -> Iterator[CopyRecorder]:
    """Record the host-to-device copies made inside the block; the
    workflow moves its feature matrix onto the card at a few named points
    (the statistics pass, the layer runner, the sweep, the refit, the
    scoring). Outside such a block `to_device` records nothing."""
    global _recorder
    outer, _recorder = _recorder, CopyRecorder()
    rec = _recorder
    try:
        yield rec
    finally:
        _recorder = outer
        rec.close()


def active_recorder() -> Optional[CopyRecorder]:
    """The recorder of the innermost open `record_copies()` block, else
    None: copies made outside `to_device` (the tileplane's pinned ring)
    report themselves to it."""
    return _recorder


def to_device(a, dev: torch.device, dtype=torch.float32,
              label: str = "") -> torch.Tensor:
    """`a` (numpy array or tensor) as a `dtype` tensor on `dev`."""
    if isinstance(a, torch.Tensor) and a.device == dev:
        return a.to(dtype)
    if dev.type != "cuda" or _recorder is None:
        return torch.as_tensor(a, dtype=dtype, device=dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = torch.as_tensor(a, dtype=dtype, device=dev)
    end.record()
    _recorder.add(label, int(out.numel()) * out.element_size(), start, end)
    return out
