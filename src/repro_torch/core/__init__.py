"""Formats, quantization and weight containers of the port."""
