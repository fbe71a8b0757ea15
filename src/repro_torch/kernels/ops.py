"""Public wrappers of the kernels (port of ``repro.kernels.ops``).

Each wrapper runs on ``device`` (default ``cuda``; see
:mod:`repro_torch.device`) and its tensors must lie there.  On a CUDA
device it launches the hand-written kernel; on the CPU it runs the plain
version (``core.alias.build``, ``kernels/ref.py``, ``core.mhw.sorted_chain``,
``core.pdp.sorted_chain_pdp``), and only there.  A CUDA tensor never
reaches a plain version.  Random streams come from a ``torch.Generator``
or are injected (``uniforms=``, ``u=``), as the reference draws them
outside its kernels.
"""

from __future__ import annotations

import torch

from repro_torch import device as device_mod
from repro_torch.core import alias as alias_mod
from repro_torch.core import mhw, pdp
from repro_torch.core.alias import AliasTable
from repro_torch.kernels import alias_build as _build
from repro_torch.kernels import alias_sample as _sample
from repro_torch.kernels import mh_accept as _accept
from repro_torch.kernels import mhw_fused as _fused
from repro_torch.kernels import ref


def _on(device, *tensors: torch.Tensor) -> bool:
    """Resolve the device and check the tensors lie on it; True for CUDA."""
    dev = device_mod.resolve(device)
    for t in tensors:
        if t.device.type != dev.type:
            raise ValueError(f"tensor on {t.device}, but the call runs on "
                             f"{dev}")
    return dev.type == "cuda"


def build_tables(p: torch.Tensor, *, device=None) -> AliasTable:
    """Alias tables of the rows of ``p`` (R, K): kernel 2 on the card."""
    if not _on(device, p):
        return alias_mod.build(p)
    prob, alias, mass = _build.alias_build(p)
    return AliasTable(prob=prob, alias=alias, mass=mass)


def build_tables_fused_lda(n_wk, n_k, *, alpha: float, beta: float,
                           vocab_size: int, device=None
                           ) -> tuple[AliasTable, torch.Tensor]:
    """Tables of the LDA dense term formed from the raw statistics (kernel
    6 on the card), and the stale matrix α·(n_wk+β)/(n_k+β̄) by the same
    grouping, product first, so the two agree."""
    on_card = _on(device, n_wk, n_k)
    if on_card:
        prob, alias, mass = _build.alias_build_fused(
            n_wk, n_k, alpha=alpha, beta=beta, beta_bar=beta * vocab_size)
    else:
        prob, alias, mass = ref.alias_build_fused_ref(
            n_wk, n_k, alpha=alpha, beta=beta, vocab_size=vocab_size)
    # The wrapper's formula, as the reference's wrapper computes it (not
    # ref.fused_dense_ref, which CUDA tensors do not reach).
    stale = alpha * (n_wk + beta) / (n_k[None, :] + beta * vocab_size)
    return AliasTable(prob=prob, alias=alias, mass=mass), stale


def build_tables_rows(p_rows: torch.Tensor, *, device=None) -> AliasTable:
    """Alias tables of a compacted (R, E) block of gathered changed rows
    (the generic incremental rebuild): kernel 5 on the card."""
    if not _on(device, p_rows):
        return alias_mod.build(p_rows)
    prob, alias, mass = _build.alias_build_rows(p_rows)
    return AliasTable(prob=prob, alias=alias, mass=mass)


def build_tables_gather_fused(n_wk, n_k, prior, rows, *, beta: float,
                              beta_bar: float, device=None
                              ) -> tuple[AliasTable, torch.Tensor]:
    """Tables of the changed ``rows`` of the LM dense term
    prior·((n_wk+β)/(n_k+β̄)) plus those dense rows: kernel 3 on the
    card."""
    fn = (_build.alias_build_gather_fused if _on(device, n_wk, rows)
          else ref.alias_build_gather_fused_ref)
    prob, alias, mass, dense = fn(n_wk, n_k, prior, rows, beta=beta,
                                  beta_bar=beta_bar)
    return AliasTable(prob=prob, alias=alias, mass=mass), dense


def _step_uniforms(generator: torch.Generator, n_outcomes: int,
                   mh_steps: int, b: int, device):
    """The five per-MH-step uniform streams of a sorted chain, each
    (mh_steps, b): slot int32 in [0, n_outcomes), then coin, u_mix,
    u_sparse, u_acc in [0, 1)."""
    slot = torch.randint(0, n_outcomes, (mh_steps, b), generator=generator,
                         device=device, dtype=torch.int32)
    return (slot,) + tuple(
        torch.rand((mh_steps, b), generator=generator, device=device)
        for _ in range(4))


def mhw_sweep_sorted(tables: AliasTable, stale, n_wk, n_k, prior, rows, docs,
                     z0, n_dk, generator: torch.Generator | None, *,
                     mh_steps: int, beta: float, beta_bar: float,
                     uniforms: tuple[torch.Tensor, ...] | None = None,
                     device=None) -> torch.Tensor:
    """Fused sorted-layout MHW chain for the LM families: draws the
    per-step uniforms from ``generator`` and runs kernel 1.  ``uniforms``
    overrides the draw with caller-supplied ``(slot, coin, u_mix,
    u_sparse, u_acc)`` streams, each (mh_steps, B) in sorted order; the
    generator is then unused."""
    on_card = _on(device, n_wk, rows)
    if uniforms is None:
        uniforms = _step_uniforms(generator, tables.prob.shape[-1],
                                  mh_steps, rows.shape[0], n_wk.device)
    fn = _fused.mhw_sweep_fused if on_card else mhw.sorted_chain
    return fn(tables.prob, tables.alias, tables.mass, stale, n_wk, n_k,
              prior, rows, docs, z0, n_dk, *uniforms, beta=beta,
              beta_bar=beta_bar)


def pdp_sweep_sorted(tables: AliasTable, stale, m_wk, s_wk, m_k, s_k, stirl,
                     prior, rows, docs, e0, n_dk,
                     generator: torch.Generator | None, *, mh_steps: int,
                     concentration: float, discount: float, gamma: float,
                     gamma_bar: float,
                     uniforms: tuple[torch.Tensor, ...] | None = None,
                     device=None) -> torch.Tensor:
    """Fused sorted-layout MHW chain over PDP's 2K joint outcomes: draws
    the per-step uniforms (slot over [0, 2K)) and runs kernel 4.
    ``uniforms`` overrides the draw as in :func:`mhw_sweep_sorted`."""
    on_card = _on(device, m_wk, rows)
    if uniforms is None:
        uniforms = _step_uniforms(generator, tables.prob.shape[-1],
                                  mh_steps, rows.shape[0], m_wk.device)
    fn = _fused.pdp_sweep_fused if on_card else pdp.sorted_chain_pdp
    return fn(tables.prob, tables.alias, tables.mass, stale, m_wk, s_wk, m_k,
              s_k, stirl, prior, rows, docs, e0, n_dk, *uniforms,
              b=concentration, a=discount, gamma=gamma, gamma_bar=gamma_bar)


def _draw_uniforms(generator, k: int, rows: torch.Tensor, uniforms):
    """(slot, coin) for one alias draw per row: slot int32 in [0, k), coin
    in [0, 1); ``uniforms`` overrides the draw."""
    if uniforms is not None:
        return uniforms
    slot = torch.randint(0, k, rows.shape, generator=generator,
                         device=rows.device, dtype=torch.int32)
    return slot, torch.rand(rows.shape, generator=generator,
                            device=rows.device)


def sample_rows(tables: AliasTable, rows: torch.Tensor,
                generator: torch.Generator | None = None, *,
                uniforms: tuple[torch.Tensor, torch.Tensor] | None = None,
                device=None) -> torch.Tensor:
    """One alias draw per entry of ``rows`` (any order) from its row's
    table: kernel 8 on the card; rows outside [0, V) give 0.
    ``uniforms`` = (slot, coin) overrides the generator's draw."""
    fn = (_sample.alias_sample if _on(device, tables.prob, rows)
          else ref.alias_sample_ref)
    slot, coin = _draw_uniforms(generator, tables.prob.shape[-1], rows,
                                uniforms)
    return fn(tables.prob, tables.alias, rows, slot, coin)


def sample_rows_sorted(tables: AliasTable, rows: torch.Tensor,
                       vstart: torch.Tensor, vcount: torch.Tensor,
                       generator: torch.Generator | None = None, *,
                       tile_b: int = 1024,
                       uniforms: tuple[torch.Tensor, torch.Tensor]
                       | None = None, device=None) -> torch.Tensor:
    """Draws over a token-sorted stream (``segment`` layout): ascending
    ``rows`` with padding sentinels ≥ V, which give 0; kernel 7 on the
    card.  ``vstart``/``vcount`` are the layout's per-batch-tile vocab
    windows, one per ``tile_b`` draws; they are checked, and only sized
    the TPU kernel's tile staging."""
    on_card = _on(device, tables.prob, rows)
    b = rows.shape[0]
    tile_b = max(1, min(tile_b, b))
    if b % tile_b or tuple(vstart.shape) != (b // tile_b,) \
            or tuple(vcount.shape) != (b // tile_b,):
        raise ValueError(
            f"vstart {tuple(vstart.shape)} and vcount "
            f"{tuple(vcount.shape)} must be ({b // tile_b},): one per "
            f"tile of {tile_b} of the {b} draws")
    fn = _sample.alias_sample_sorted if on_card else ref.alias_sample_sorted_ref
    slot, coin = _draw_uniforms(generator, tables.prob.shape[-1], rows,
                                uniforms)
    return fn(tables.prob, tables.alias, rows, slot, coin)


def mh_accept(z, cand, log_p_z, log_p_cand, log_q_z, log_q_cand,
              generator: torch.Generator | None = None, *,
              u: torch.Tensor | None = None, device=None) -> torch.Tensor:
    """MH accept step (eq. 7) per element: kernel 9 on the card.  ``u``
    overrides the generator's uniform draw."""
    fn = _accept.mh_accept if _on(device, z, cand) else ref.mh_accept_ref
    if u is None:
        u = torch.rand(z.shape, generator=generator, device=z.device)
    return fn(z, cand, log_p_z, log_p_cand, log_q_z, log_q_cand, u)
