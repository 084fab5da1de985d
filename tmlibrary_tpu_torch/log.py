"""Logging configuration.

Counterpart: ``tmlibrary_tpu/log.py``, which imports no JAX; the port keeps
its own copy, held equal to it on the same inputs by
``tests/test_torch_telemetry.py``.

Reference parity: ``tmlib/log.py`` — ``configure_logging`` plus
``map_logging_verbosity`` translating a ``-v`` count into a logging level.
"""

from __future__ import annotations

import logging
import sys

#: verbosity count (number of ``-v`` flags) → logging level
_VERBOSITY_TO_LEVEL = {
    0: logging.WARNING,
    1: logging.INFO,
    2: logging.DEBUG,
}

FORMAT = "%(asctime)s | %(levelname)-8s | %(name)s | %(message)s"


def map_logging_verbosity(verbosity: int) -> int:
    """Map a ``-v`` flag count to a :mod:`logging` level.

    Mirrors the reference's mapping: 0 → WARNING, 1 → INFO, ≥2 → DEBUG.
    """
    if verbosity < 0:
        raise ValueError("verbosity must be non-negative")
    return _VERBOSITY_TO_LEVEL.get(min(verbosity, 2), logging.DEBUG)


def configure_logging(verbosity: int = 0, stream=None) -> logging.Logger:
    """Configure the root framework logger and return it."""
    logger = logging.getLogger("tmlibrary_tpu_torch")
    logger.setLevel(map_logging_verbosity(verbosity))
    if not logger.handlers:
        handler = logging.StreamHandler(stream or sys.stderr)
        handler.setFormatter(logging.Formatter(FORMAT))
        logger.addHandler(handler)
    return logger


#: keys already warned about by :func:`warn_once` this process
_WARNED: set = set()


def warn_once(logger: logging.Logger, key: str, message: str, *args) -> None:
    """Emit ``message`` at WARNING level at most once per process per
    ``key``.  Used for conditions that re-trigger on every poll — e.g. a
    corrupt ledger line re-read by every ``status``/``resume`` call —
    where repeating the warning drowns the signal it carries."""
    if key in _WARNED:
        return
    _WARNED.add(key)
    logger.warning(message, *args)


def reset_warned() -> None:
    """Clear the :func:`warn_once` suppression set.

    The set is process-global, so a warning suppressed in one test would
    otherwise hide the assertion target of another — ``tests/conftest.py``
    calls this between tests."""
    _WARNED.clear()
