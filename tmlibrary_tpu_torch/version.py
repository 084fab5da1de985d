"""Version of the PyTorch port.

Counterpart: ``tmlibrary_tpu/version.py``; the port carries the same
version string as the package it mirrors.
"""

__version__ = "0.1.0"
