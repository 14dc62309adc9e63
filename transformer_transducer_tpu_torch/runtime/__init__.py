"""Host runtime of the port: the native C++ helpers (``native.py``)."""
