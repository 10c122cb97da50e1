"""The host JPEG codec's C++ source and its build (see ``build.py``)."""
