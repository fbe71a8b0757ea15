"""Launchers of the port's processes: ``serve``, ``loopback``, ``mesh``
and ``train`` (ports of the modules of ``repro.launch`` of those names)."""
