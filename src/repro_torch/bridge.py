"""Carries state between the reference package and the port as numpy
arrays, so tests can start both from the same state.

The reference's state types are NamedTuples of arrays (``SharedStats``,
``LocalState``, ``AliasTable``, ``SortedLayout``) and its configs are
frozen dataclasses.  Here they arrive as mappings of field name to numpy
array (``np.asarray`` of each field, e.g. ``ref_nt._asdict()``) or as the
config object itself, read by field name; nothing of the reference
package is imported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core import lda
from repro_torch.core.alias import AliasTable
from repro_torch.data.segment import SortedLayout


def config_from(ref_cfg: Any) -> lda.LDAConfig:
    """The port's LDAConfig with the reference config's field values."""
    return lda.LDAConfig(**{f.name: getattr(ref_cfg, f.name)
                            for f in dataclasses.fields(lda.LDAConfig)})


def config_to(cfg: lda.LDAConfig, ref_cls: type):
    """A reference config of type ``ref_cls`` with the port's values."""
    return ref_cls(**dataclasses.asdict(cfg))


def from_numpy(cls, arrays: Mapping[str, Any], device="cpu"):
    """A port NamedTuple ``cls`` from numpy arrays keyed by field name."""
    return cls(**{f: torch.tensor(np.asarray(arrays[f]), device=device)
                  for f in cls._fields})


def to_numpy(nt) -> dict[str, np.ndarray]:
    """A port NamedTuple as a dict of numpy arrays (CPU copies)."""
    return {f: getattr(nt, f).detach().cpu().numpy() for f in nt._fields}


def shared_from(arrays, device="cpu") -> lda.SharedStats:
    return from_numpy(lda.SharedStats, arrays, device)


def local_from(arrays, device="cpu") -> lda.LocalState:
    return from_numpy(lda.LocalState, arrays, device)


def layout_from(arrays, device="cpu") -> SortedLayout:
    return from_numpy(SortedLayout, arrays, device)


def proposal_from(table_arrays, stale, device="cpu"
                  ) -> tuple[AliasTable, torch.Tensor]:
    """(AliasTable, stale dense matrix) from the reference's arrays."""
    return (from_numpy(AliasTable, table_arrays, device),
            torch.tensor(np.asarray(stale), device=device))


def proposal_to(tables: AliasTable, stale: torch.Tensor
                ) -> tuple[dict[str, np.ndarray], np.ndarray]:
    return to_numpy(tables), stale.detach().cpu().numpy()
