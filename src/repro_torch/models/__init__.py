"""Serve-mode model code of the port (``repro.models``'s counterpart)."""
