"""Exception hierarchy of the PyTorch port.

Counterpart: ``tmlibrary_tpu/errors.py``.  The port keeps its own copy of
the classes the Cell Painting slice raises, with the same names, so error
handling written against the JAX package maps directly.  ``DeviceError``
is new: the port's entry points run on the card unless the caller asks
for the CPU, and a missing card is an error, never a silent fallback.
"""


class TmError(Exception):
    """Base class for all framework errors."""


class PipelineError(TmError):
    """Error in the jterator pipeline description or execution."""


class PipelineDescriptionError(PipelineError):
    """Invalid ``.pipe`` pipeline description."""


class HandleError(PipelineError):
    """Invalid module handle description or binding."""


class RegistryError(TmError):
    """Error looking up a registered step/module/tool."""


class NotSupportedError(TmError):
    """Requested feature is not supported (not ported yet)."""


class DeviceError(TmError):
    """The requested device is absent, or a kernel failed to build or
    launch on it."""
