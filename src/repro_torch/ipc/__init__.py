"""Shared-memory primitives of the port.  Only the arena module is here so
far; the tracer maps its rings with it."""
