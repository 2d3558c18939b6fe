"""Port of the reference package's same-named subpackage."""

from .path_oram import oram_access  # noqa: F401
