"""Host-side data pipeline: index datasets, the loaders and dataset staging.

Nothing is imported here eagerly: ``loader`` builds the host codec, which
needs libjpeg, and the device half of the port must import without it.
"""
