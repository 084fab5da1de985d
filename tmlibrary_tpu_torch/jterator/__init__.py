"""jterator pipeline engine of the PyTorch port (counterpart:
``tmlibrary_tpu.jterator``)."""
