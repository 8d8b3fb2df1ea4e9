"""Structured error taxonomy.

The reference collapses every failure class into a single catch block that
logs "Could not access URL - ..." regardless of the actual cause and exits 0
(reference Main.java:36,144-147; quirk #8/#12 in SURVEY.md Appendix A). This
module replaces that with one exception type per failure domain so callers
and the CLI can report and exit meaningfully.
"""

from __future__ import annotations


class EuromillionerError(Exception):
    """Base class for all framework errors."""

    exit_code: int = 1


class FetchError(EuromillionerError):
    """HTTP data acquisition failed (bad status, network error, retries
    exhausted). Covers the reference's ClientProtocolException path
    (Main.java:43-51)."""

    exit_code = 10

    def __init__(self, message: str, status: int | None = None):
        super().__init__(message)
        self.status = status


class ParseError(EuromillionerError):
    """HTML/CSV parsing failed (results table missing, malformed row, bad
    date format). Covers NullPointer-style failures the reference would hit
    at Main.java:62-64 when the table class is absent."""

    exit_code = 11


class DataError(EuromillionerError):
    """Dataset construction/validation failed (shape mismatch, bad label
    column, empty split)."""

    exit_code = 12


class TrainError(EuromillionerError):
    """Training failed (non-finite loss, bad hyperparameter, XGBoostError
    equivalent — Main.java:144)."""

    exit_code = 13


class CheckpointError(EuromillionerError):
    """Checkpoint save/restore failed or checkpoint is incompatible."""

    exit_code = 14


class DistributedError(EuromillionerError):
    """Mesh construction, sharding, or multi-host bootstrap failed."""

    exit_code = 15


class ServeError(EuromillionerError):
    """Inference-engine failure (bad bucket config, engine closed, request
    rejected, transport error)."""

    exit_code = 16


class ConfigError(EuromillionerError):
    """Configuration rejected before any device work starts (serve.mesh
    axes that do not fit the available devices, malformed axis tuples) —
    the clear front-door error instead of a shape mismatch deep in XLA."""

    exit_code = 17
