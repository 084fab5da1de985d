"""Exception hierarchy of the PyTorch port.

Counterpart: ``tmlibrary_tpu/errors.py``.  The port keeps its own copy of
the classes its slices raise, with the same names and the same hierarchy,
so error handling written against the JAX package maps directly.  ``DeviceError``
is new: the port's entry points run on the card unless the caller asks
for the CPU, and a missing card is an error, never a silent fallback.
"""


class TmError(Exception):
    """Base class for all framework errors."""


class MetadataError(TmError):
    """Error in experiment/image metadata handling."""


class VendorConflictError(MetadataError):
    """Vendor files make mutually-exclusive claims (e.g. two containers on
    one well).  Unlike an unparseable sidecar, this is a data-integrity
    problem: metaconfig's ``auto`` handler loop re-raises it instead of
    falling through to the next handler."""


class PipelineError(TmError):
    """Error in the jterator pipeline description or execution."""


class PipelineDescriptionError(PipelineError):
    """Invalid ``.pipe`` pipeline description."""


class HandleError(PipelineError):
    """Invalid module handle description or binding."""


class JobDescriptionError(TmError):
    """Error in a batch/job description."""


class RegistryError(TmError):
    """Error looking up a registered step/module/tool."""


class StoreError(TmError):
    """Error in the array/feature store layer."""


class WorkflowError(TmError):
    """Error in workflow orchestration (stage/step DAG, ledger, resume)."""


class PreemptedError(TmError):
    """The run was asked to stop and has finished draining: every
    in-flight batch persisted, the rest were never launched.
    ``in_flight`` is the pipelined window size when the drain began,
    ``drained`` how many of those persisted during the drain, and
    ``abandoned`` how many planned batches were never launched."""

    def __init__(self, message: str, step: str | None = None,
                 in_flight: int = 0, drained: int = 0, abandoned: int = 0,
                 reason: str = "signal"):
        super().__init__(message)
        self.step = step
        self.in_flight = in_flight
        self.drained = drained
        self.abandoned = abandoned
        self.reason = reason


class ShardingError(TmError):
    """Error constructing or using a device mesh / sharding."""


class NotSupportedError(TmError):
    """Requested feature is not supported (not ported yet)."""


class DeviceError(TmError):
    """The requested device is absent, or a kernel failed to build or
    launch on it."""


class BuildError(TmError):
    """A host library of the port failed to build or load."""
