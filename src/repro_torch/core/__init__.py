"""Core solver layers of the port (mirrors :mod:`repro.core`)."""
