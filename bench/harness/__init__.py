"""The benchmark's harness: it finds a cell's configuration, traffic and
metrics by name, drives the port (``repro_torch``) through the cell's
window, reduces spans, counters and the profiler's trace to metrics and
decides ``correct`` against the plain reference (``bench/reference``)."""
