"""Optimisers (port of ``repro.optim``)."""
