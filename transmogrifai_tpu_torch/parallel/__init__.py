"""The streamed data plane (counterpart of parallel/): the tile pipeline
that moves host row tiles onto the device while the device computes
(`tileplane.py`) and the parse-worker pool that feeds it from file shards
(`ingest.py`). The mesh, multi-host and pod modules of the JAX package
are not ported: the port runs on one device."""
