"""Launchers of the port's processes: ``serve`` (port of
``repro.launch.serve``)."""
