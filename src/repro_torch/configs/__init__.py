"""Model configurations of the dense decoder-only family (port of
:mod:`repro.configs` for the archs the ported transformer runs)."""
