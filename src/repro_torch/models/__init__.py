"""Language models (port of :mod:`repro.models` for the dense family)."""
