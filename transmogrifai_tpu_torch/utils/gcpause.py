"""Generational-GC pause for columnar hot paths (counterpart of
utils/gcpause.py).

A workflow over a multi-million-row Dataset keeps millions of tracked
containers alive (object-dtype cells, FeatureType wrappers, per-key dicts),
and every gen-2 collection of CPython's cyclic collector rescans all of
them: a linear columnar pass turns superlinear. ``paused_gc()`` disables
the collector for the duration of a train/score pass and restores the
caller's setting afterwards. Reference counting still frees everything
acyclic at once; only cycle detection is deferred.
"""
from __future__ import annotations

import contextlib
import gc


@contextlib.contextmanager
def paused_gc():
    """Disable cyclic GC inside the block; restore the previous state.

    Re-entrant: nested pauses keep the collector off until the outermost
    block exits (and leave it off if the caller had it off)."""
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()
