"""The port stands alone and never falls back.

* No module of ``src/repro_torch`` nor ``chip_smoke.py`` imports ``jax``
  or the reference package ``repro`` (an AST scan of every import).
* ``Trainer``, the family sweep and ``ops.*`` run on ``cuda`` by default
  and raise when there is no card and the CPU was not asked for.
* On the card (tests marked ``cuda``, skipped here without one): a CUDA
  tensor handed to a kernel wrapper reaches the kernel, as the launch
  counters show, and each kernel agrees with its plain version.
"""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import device as device_mod
from repro_torch.core import alias, family, lda, mhw
from repro_torch.engine import Trainer, TrainerConfig
from repro_torch.kernels import _build, ops

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    bad = [n for n in _imports(path)
           if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_scan_covers_the_package():
    names = {p.name for p in FILES}
    assert {"trainer.py", "family.py", "ops.py", "chip_smoke.py",
            "alias_build.py", "mhw_fused.py"} <= names


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _small():
    cfg = lda.LDAConfig(n_topics=4, vocab_size=16)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, 16, size=(6, 8)),
                             dtype=torch.int32)
    mask = torch.ones((6, 8), dtype=torch.bool)
    return cfg, tokens, mask


def test_default_device_is_cuda_and_raises_without_card(monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_mod.resolve()
    assert device_mod.resolve("cpu").type == "cpu"


def test_trainer_requires_card_unless_cpu_asked(monkeypatch):
    _no_card(monkeypatch)
    cfg, tokens, mask = _small()
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, tokens, mask,
                config=TrainerConfig(layout="sorted", n_clients=2))
    Trainer(cfg, tokens, mask, config=TrainerConfig(layout="sorted"),
            device="cpu").step()


def test_family_sweep_requires_card_unless_cpu_asked(monkeypatch):
    _no_card(monkeypatch)
    cfg, tokens, mask = _small()
    fam = family.get("lda")
    local, shared = fam.init_state(cfg, tokens, mask, (0,))
    tables, stale = fam.build_alias(cfg, shared)
    with pytest.raises(RuntimeError, match="CUDA"):
        fam.sweep_sorted(cfg, local, shared, tables, stale, tokens, mask,
                         (0,), None)
    fam.sweep_sorted(cfg, local, shared, tables, stale, tokens, mask, (0,),
                     None, device="cpu")


@pytest.mark.parametrize("call", ["build_tables", "gather", "sweep"])
def test_ops_require_card_unless_cpu_asked(call, monkeypatch):
    _no_card(monkeypatch)
    cfg, tokens, mask = _small()
    fam = family.get("lda")
    local, shared = fam.init_state(cfg, tokens, mask, (0,))
    dp = lda.dense_probs(cfg, shared)
    prior = torch.full((4,), 0.1)
    rows = torch.arange(3, dtype=torch.int32)
    lay = fam.build_sorted_layouts(cfg, tokens, mask)[0]
    tables = ops.build_tables(dp, device="cpu")
    fns = {
        "build_tables": lambda **kw: ops.build_tables(dp, **kw),
        "gather": lambda **kw: ops.build_tables_gather_fused(
            shared.n_wk, shared.n_k, prior, rows, beta=0.01, beta_bar=0.16,
            **kw),
        "sweep": lambda **kw: ops.mhw_sweep_sorted(
            tables, dp, shared.n_wk, shared.n_k, prior, lay.rows, lay.docs,
            torch.zeros_like(lay.rows), local.n_dk, torch.Generator(),
            mh_steps=2, beta=0.01, beta_bar=0.16, **kw)}
    with pytest.raises(RuntimeError, match="CUDA"):
        fns[call]()
    fns[call](device="cpu")


def test_ops_reject_tensors_on_another_device():
    with pytest.raises(ValueError, match="runs on"):
        ops.build_tables(torch.ones((2, 3), device="meta"), device="cpu")


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_tensors_reach_the_kernels(cuda_device):
    """On the card each wrapper launches its kernel (counter +1) and the
    result agrees with the plain version on the same inputs: tables
    bit-equal (the masses are summed in the same order), sweep draws
    equal except where the block-parallel cumsum rounds across a cdf
    step (at most 1% of 2048 chains here)."""
    cfg = lda.LDAConfig(n_topics=64, vocab_size=512)
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, 512, size=(64, 32)),
                             dtype=torch.int32, device=cuda_device)
    mask = torch.ones_like(tokens, dtype=torch.bool)
    fam = family.get("lda")
    local, shared = fam.init_state(cfg, tokens, mask, (0,))
    dp = lda.dense_probs(cfg, shared)
    prior = torch.full((64,), cfg.alpha, device=cuda_device)
    _build.reset_launches()

    tables = ops.build_tables(dp, device=cuda_device)
    assert _build.LAUNCHES["alias_build"] == 1
    for a, b in zip(tables, alias.build(dp)):
        assert torch.equal(a, b)

    rows = torch.tensor([3, 0, 511, 42], dtype=torch.int32,
                        device=cuda_device)
    sub, dense = ops.build_tables_gather_fused(
        shared.n_wk, shared.n_k, prior, rows, beta=cfg.beta,
        beta_bar=cfg.beta * cfg.vocab_size, device=cuda_device)
    assert _build.LAUNCHES["alias_build_gather_fused"] == 1
    assert torch.equal(dense, dp[rows.long()])
    for a, b in zip(sub, tables):
        assert torch.equal(a, b[rows.long()])

    lay = fam.build_sorted_layouts(cfg, tokens, mask)[0]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    uni = ops._step_uniforms(gen, 64, 2, lay.rows.shape[0], cuda_device)
    z0 = torch.zeros_like(lay.rows)
    z = ops.mhw_sweep_sorted(tables, dp, shared.n_wk, shared.n_k, prior,
                             lay.rows, lay.docs, z0, local.n_dk, None,
                             mh_steps=2, beta=cfg.beta,
                             beta_bar=cfg.beta * cfg.vocab_size,
                             uniforms=uni, device=cuda_device)
    assert _build.LAUNCHES["mhw_sweep_fused"] == 1
    z_ref = mhw.sorted_chain(
        *tables[:3], dp, shared.n_wk, shared.n_k, prior, lay.rows, lay.docs,
        z0, local.n_dk, *uni, beta=cfg.beta,
        beta_bar=cfg.beta * cfg.vocab_size)
    assert float((z != z_ref).float().mean()) <= 0.01
    torch.cuda.synchronize()
