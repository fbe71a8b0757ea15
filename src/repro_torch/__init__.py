"""PyTorch/CUDA port of the MHW topic-model sampler (``repro``).

The package mirrors ``repro``'s layout module for module; see each
module's docstring for its counterpart.  It imports torch and numpy only.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(:mod:`repro_torch.device`).  The hand-written Hopper kernels live in
``csrc/`` and are built with ``nvcc`` at first use
(:mod:`repro_torch.kernels._build`).
"""
