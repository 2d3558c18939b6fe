"""Test support shipped with the port (crash-fault injection)."""
