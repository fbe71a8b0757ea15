"""Online topic inference (port of ``repro.serve``): the snapshot-frozen
fold-in engine, the INFER service and its client."""

from repro_torch.serve.engine import (FoldInEngine, InferRequest, InferResult,
                                      ServeConfig, Streams,
                                      fold_in_perplexity, reference_fold_in,
                                      result_checksum)
from repro_torch.serve.snapshot import (InferenceSnapshot, freeze,
                                        from_checkpoint, from_servers,
                                        from_trainer)

# The unambiguous name for a top-level re-export.
freeze_snapshot = freeze

__all__ = [
    "freeze_snapshot",
    "FoldInEngine",
    "InferRequest",
    "InferResult",
    "InferenceSnapshot",
    "ServeConfig",
    "Streams",
    "fold_in_perplexity",
    "freeze",
    "from_checkpoint",
    "from_servers",
    "from_trainer",
    "reference_fold_in",
    "result_checksum",
]
