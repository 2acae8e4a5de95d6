"""Quantization, packing and the QMM engine of the port (``repro.core``'s counterpart)."""
