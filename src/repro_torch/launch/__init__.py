"""Launchers of the port's processes: ``serve`` and ``loopback`` (ports
of ``repro.launch.serve`` and ``repro.launch.loopback``)."""
