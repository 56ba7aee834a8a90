"""Tracing and profiling hooks of the port (``profiling.py``)."""
