"""Allocation-path traces, read side (see the JAX package's trace/): the
span spools that tracing processes write, assembled into per-pod timelines
for the node exporter's /traces (assemble.py) and its vtpu_trace_*
histograms (metrics.py). The writer side is not ported yet."""
