"""Carries state between the reference package and the port as numpy
arrays, so tests can start both from the same state.

The reference's state types are NamedTuples of arrays (``SharedStats``,
``LocalState``, ``AliasTable``, ``SortedLayout``) and its configs are
frozen dataclasses.  Here they arrive as mappings of field name to numpy
array (``np.asarray`` of each field, e.g. ``ref_nt._asdict()``) or as the
config object itself, read by field name; nothing of the reference
package is imported.  Families are told apart by the reference config's
class name (``LDAConfig``, ``PDPConfig`` or ``HDPConfig``); state
converters take the port's family (or its NamedTuple class), LDA by
default.  Like every entry point of the port, the converters put their
tensors on ``cuda`` unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import hdp, lda, pdp
from repro_torch.core.alias import AliasTable
from repro_torch.data.segment import SortedLayout


CONFIGS = {"LDAConfig": lda.LDAConfig, "PDPConfig": pdp.PDPConfig,
           "HDPConfig": hdp.HDPConfig}


def config_from(ref_cfg: Any):
    """The port's config of the same class name as ``ref_cfg``, with its
    field values."""
    name = type(ref_cfg).__name__
    if name not in CONFIGS:
        raise TypeError(f"no port config for {name}; ported: "
                        f"{sorted(CONFIGS)}")
    cls = CONFIGS[name]
    return cls(**{f.name: getattr(ref_cfg, f.name)
                  for f in dataclasses.fields(cls)})


def config_to(cfg, ref_cls: type):
    """A reference config of type ``ref_cls`` with the port's values."""
    return ref_cls(**dataclasses.asdict(cfg))


def from_numpy(cls, arrays: Mapping[str, Any], device=None):
    """A port NamedTuple ``cls`` from numpy arrays keyed by field name."""
    dev = device_mod.resolve(device)
    return cls(**{f: torch.tensor(np.asarray(arrays[f]), device=dev)
                  for f in cls._fields})


def to_numpy(nt) -> dict[str, np.ndarray]:
    """A port NamedTuple as a dict of numpy arrays (CPU copies)."""
    return {f: getattr(nt, f).detach().cpu().numpy() for f in nt._fields}


def _cls(kind, attr: str) -> type:
    """A NamedTuple class, or the ``attr`` class of a port family."""
    return kind if isinstance(kind, type) else getattr(kind, attr)


def shared_from(arrays, device=None, kind=lda.SharedStats):
    """Shared statistics of ``kind`` (a family or its ``shared_cls``)."""
    return from_numpy(_cls(kind, "shared_cls"), arrays, device)


def local_from(arrays, device=None, kind=lda.LocalState):
    """Local state of ``kind`` (a family or its ``local_cls``)."""
    return from_numpy(_cls(kind, "local_cls"), arrays, device)


def layout_from(arrays, device=None) -> SortedLayout:
    return from_numpy(SortedLayout, arrays, device)


def proposal_from(table_arrays, stale, device=None
                  ) -> tuple[AliasTable, torch.Tensor]:
    """(AliasTable, stale dense matrix) from the reference's arrays."""
    dev = device_mod.resolve(device)
    return (from_numpy(AliasTable, table_arrays, dev),
            torch.tensor(np.asarray(stale), device=dev))


def proposal_to(tables: AliasTable, stale: torch.Tensor
                ) -> tuple[dict[str, np.ndarray], np.ndarray]:
    return to_numpy(tables), stale.detach().cpu().numpy()
