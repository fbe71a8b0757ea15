"""Snapshots on disk: ``ckpt`` (port of ``repro.checkpoint``)."""
