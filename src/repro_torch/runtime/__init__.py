"""Serving runtime of the port (``repro.runtime``'s counterpart)."""
