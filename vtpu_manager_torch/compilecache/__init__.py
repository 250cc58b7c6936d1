"""The node's compile cache (see the JAX package's compilecache/); only the
exporter's read of its counters is ported so far."""
