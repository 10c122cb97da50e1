"""Small host-side helpers (the JAX package's ``utils/metrics.py``)."""
