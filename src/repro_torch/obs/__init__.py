"""Observability of the port: the monotonic clock and running metrics."""
