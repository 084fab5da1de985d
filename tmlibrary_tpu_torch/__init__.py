"""PyTorch/CUDA port of tmlibrary_tpu for NVIDIA Hopper (H100).

The JAX package ``tmlibrary_tpu`` stays the reference; this package
mirrors its layout and module names.  It imports ``torch`` and nothing
of JAX or of ``tmlibrary_tpu``.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; the hand-written kernels live in
``csrc/`` and are built with ``nvcc`` at first use.
"""
