"""Conversion tools of the port (spec.json + params.npz, the weight bridge)."""
