"""Host-side data pipeline: index datasets and the crop-before-pack loader.

Nothing is imported here eagerly: ``loader`` builds the host codec, which
needs libjpeg, and the device half of the port must import without it.
"""
