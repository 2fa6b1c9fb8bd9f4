"""Observability for the port: the span tracer and the hardware-counter
profiler the dispatcher reports into.  Import the submodules directly."""
