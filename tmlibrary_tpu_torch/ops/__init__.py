"""Image-analysis ops of the PyTorch port (counterpart: ``tmlibrary_tpu.ops``)."""
