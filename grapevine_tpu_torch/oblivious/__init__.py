"""Port of the reference package's same-named subpackage."""
