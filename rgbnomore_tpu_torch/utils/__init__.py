"""Host-side helpers: the loss window (the JAX package's ``utils/metrics.py``),
timing, the model summary and profiling."""
