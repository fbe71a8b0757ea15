"""Wrapper of the document-list kernel in ``csrc/doc_topics.cu``: each
document's bitmap of non-zero topics of ``n_dk`` and their counts, which
the sweep kernels 1 and 4 (``kernels/mhw_fused.py``) build once per launch
and read instead of the documents' dense rows.  No TPU kernel computes
it.  CUDA tensors only; its plain version is
``kernels/ref.py::doc_topic_lists_ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import launch
from repro_torch.kernels.alias_build import _check
from repro_torch.kernels.ref import doc_words


def doc_topic_lists(n_dk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """n_dk (D, K) f32 → words (D, W, 2) i32 and counts (D, K) i16, as
    ``doc_topic_lists_ref`` (counts past each document's k_d unwritten).
    The capacity is K a document, so nothing is read back to the host.
    No document, no launch."""
    if n_dk.dim() != 2:
        raise ValueError(f"n_dk must be (D, K), got {tuple(n_dk.shape)}")
    _check("n_dk", n_dk, torch.float32)
    d, k = n_dk.shape
    words = torch.empty((d, doc_words(k), 2), dtype=torch.int32,
                        device=n_dk.device)
    counts = torch.empty((d, k), dtype=torch.int16, device=n_dk.device)
    if d:
        launch("doc_topic_lists", n_dk.data_ptr(), d, k, words.data_ptr(),
               counts.data_ptr())
    return words, counts
