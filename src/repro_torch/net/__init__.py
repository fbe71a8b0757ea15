"""The framed wire protocol (port of ``repro.net``); only
``protocol`` is ported so far (ROADMAP.md queue A.10 has the rest)."""
