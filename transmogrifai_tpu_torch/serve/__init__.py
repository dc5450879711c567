"""Serving over a fitted workflow (counterpart of serve/).

- :mod:`engine` — ServingEngine: power-of-two batch buckets prewarmed at
  startup, preallocated reused input columns, a post-warmup cold-start
  watch riding utils/tracing.tracker (kernel builds, new allocator
  segments on the serving device);
- :mod:`batcher` — MicroBatcher: bounded admission queue, micro-batches
  that dispatch when full or after ``max_wait_ms``, typed
  :class:`~transmogrifai_tpu_torch.serve.batcher.Overloaded` load-shedding
  and graceful drain;
- :mod:`frontend` — stdlib HTTP/JSON frontend, the in-process
  ``submit()`` API, and the ``python -m transmogrifai_tpu_torch serve``
  CLI body;
- :mod:`reqtrace` — per-request traces, tail sampling, gauge history.

The batch route scores on the model's device (None: CUDA); the
single-record local route replays on the CPU. Not ported: the drift
monitor (transmogrifai_tpu/monitor/) and the serving fleet
(transmogrifai_tpu/fleet/).
"""
from .batcher import MicroBatcher, Overloaded
from .engine import ServingEngine, bucket_ladder, template_record
from .frontend import ServeFrontend, make_http_server, run_serve
from .reqtrace import (BatchTrace, GaugeSampler, ReqTracer, RequestTrace,
                       TailSampler, thread_dump)

__all__ = [
    "MicroBatcher", "Overloaded", "ServingEngine", "bucket_ladder",
    "template_record", "ServeFrontend", "make_http_server", "run_serve",
    "BatchTrace", "GaugeSampler", "ReqTracer", "RequestTrace",
    "TailSampler", "thread_dump",
]
