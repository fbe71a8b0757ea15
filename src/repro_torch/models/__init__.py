"""The LM side's models (port of ``repro.models``): layers, MoE, linear
attention, SSM blocks and the assembled architectures."""
