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

The LM side's state is a tree: nested dicts of arrays with the
reference's paths (``jax.tree.map(np.asarray, params)``).  The LM
converters carry parameters, AdamW's ``(step, m, v)`` and the decode cache
leaf by leaf; a bfloat16 leaf (numpy's ``bfloat16`` extension type, the
reference's KV caches) arrives as a bfloat16 tensor and leaves as float32.
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


def _tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32), device=dev).to(
            torch.bfloat16)
    return torch.tensor(a, device=dev)


def _array(t) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _tree_from(tree, dev):
    return {k: _tree_from(v, dev) if isinstance(v, Mapping)
            else _tensor(v, dev) for k, v in tree.items()}


def _tree_to(tree):
    return {k: _tree_to(v) if isinstance(v, Mapping) else _array(v)
            for k, v in tree.items()}


def lm_params_from(tree: Mapping, device=None) -> dict:
    """An LM parameter tree of tensors from the reference's tree of
    arrays (same paths, shapes and dtypes)."""
    return _tree_from(tree, device_mod.resolve(device))


def lm_params_to(params: Mapping) -> dict:
    """An LM parameter tree as nested dicts of numpy arrays."""
    return _tree_to(params)


def adamw_state_from(state, device=None):
    """The port's ``AdamWState`` from the reference's (its NamedTuple or
    ``_asdict()``, arrays or trees of arrays)."""
    from repro_torch.optim.adamw import AdamWState
    fields = state if isinstance(state, Mapping) else state._asdict()
    dev = device_mod.resolve(device)
    return AdamWState(step=_tensor(fields["step"], dev),
                      m=_tree_from(fields["m"], dev),
                      v=_tree_from(fields["v"], dev))


def adamw_state_to(state) -> dict:
    """``{"step", "m", "v"}`` of numpy arrays, the reference's
    ``AdamWState._asdict()`` layout."""
    return {"step": _array(state.step), "m": _tree_to(state.m),
            "v": _tree_to(state.v)}


def lm_cache_from(cache: Mapping, device=None) -> dict:
    """A decode cache (``pos``, ``key_pos``, per-family layers) from the
    reference's ``prefill``/``init_cache`` tree."""
    return _tree_from(cache, device_mod.resolve(device))


def lm_cache_to(cache: Mapping) -> dict:
    return _tree_to(cache)


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
