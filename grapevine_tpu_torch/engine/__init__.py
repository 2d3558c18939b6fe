"""Port of the reference package's same-named subpackage."""

from .step import engine_step  # noqa: F401
