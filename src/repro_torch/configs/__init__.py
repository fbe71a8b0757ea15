"""The ten assigned LM architectures (port of ``repro.configs``)."""
