"""The port stands alone and never falls back.

* No module of ``src/repro_torch`` (the pod dry run's ``launch/specs.py``,
  ``roofline.py`` and ``dryrun.py`` among them), nor ``chip_smoke.py`` or
  the ``tools/torch_*.py`` scripts, imports ``jax`` or the reference
  package ``repro`` (an AST scan of every import).
* ``Trainer``, the family sweep, ``ops.*``, the ``bridge`` converters, the
  LM side's (``LM``, ``init_params``, ``make_train_step``, the training
  launcher's CLI, ``bridge.lm_params_from``), the
  serving entry points (``freeze``, ``from_checkpoint``, ``FoldInEngine``,
  ``reference_fold_in``, ``InferenceServer`` and its CLI,
  ``launch_serve``), the wire's (shard servers, the client, their
  CLIs, the tcp Trainer, ``from_servers``) and the pod dry run's
  (``make_production_mesh``, ``make_lowering_spec``) run on ``cuda`` by
  default and raise when there is no card and the CPU was not asked for.
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

from repro_torch import bridge
from repro_torch import device as device_mod
from repro_torch.core import alias, family, hdp, lda, mhw, pdp, stirling
from repro_torch.engine import Trainer, TrainerConfig
from repro_torch.kernels import _build, ops, ref

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "serve_topics_torch.py",
    ROOT / "examples" / "quickstart_torch.py",
    ROOT / "examples" / "distributed_lvm_torch.py",
    ROOT / "examples" / "train_lm_torch.py"
] + sorted((ROOT / "tools").glob("torch_*.py"))


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
            "alias_build.py", "mhw_fused.py", "pdp.py", "stirling.py",
            "hdp.py", "alias_sample.py", "mh_accept.py", "doc_topics.py",
            "torch_sweep_split.py", "torch_alias_split.py",
            "torch_round_split.py", "torch_kernel_split.py",
            "bridge.py", "ckpt.py", "snapshot.py", "engine.py", "client.py",
            "protocol.py", "serve.py", "serve_topics_torch.py",
            "quickstart_torch.py",
            "fault.py", "server.py", "round.py", "distributed.py",
            "mesh.py", "collectives.py", "distributed_lvm_torch.py",
            "model.py", "layers.py", "moe.py", "linear_attn.py", "ssm.py",
            "adamw.py", "loss.py", "train_step.py", "sync.py", "train.py",
            "registry.py", "smollm_360m.py", "train_lm_torch.py",
            "sharding.py", "specs.py", "roofline.py", "dryrun.py"} <= names
    serving = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"src/repro_torch/serve/server.py",
            "src/repro_torch/serve/engine.py",
            "src/repro_torch/launch/serve.py",
            "src/repro_torch/net/protocol.py",
            "src/repro_torch/checkpoint/ckpt.py",
            "src/repro_torch/core/fault.py",
            "src/repro_torch/net/server.py",
            "src/repro_torch/net/client.py",
            "src/repro_torch/net/chaos.py",
            "src/repro_torch/launch/loopback.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/core/collectives.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/configs/base.py",
            "src/repro_torch/models/model.py",
            "src/repro_torch/optim/adamw.py",
            "src/repro_torch/train/train_step.py",
            "src/repro_torch/train/sharding.py",
            "src/repro_torch/train/sync.py",
            "src/repro_torch/launch/specs.py",
            "src/repro_torch/launch/roofline.py",
            "src/repro_torch/launch/dryrun.py"} <= serving


def test_filter_keys_collide_with_no_other_stream(monkeypatch):
    """Client c's filter in round r draws statistic i from
    ``fold_in(filter_key(seed, r, c), i)``.  Over r < 64, c < 8 and every
    family's statistics no such key (nor the filter key itself) equals a
    key of another purpose: INIT's (seed, INIT, c), the sweeps' (seed,
    SWEEP, r, c, s) and their chunks', AUX's (seed, AUX, r) and its
    sub-streams (HDP's clients and θ0), EVAL's (seed, EVAL, 42).  And a
    top-k run draws its random rows from exactly those keys."""
    from repro_torch.core.ps import FilterSpec
    from repro_torch.engine import round as round_mod
    fold = device_mod.fold_in
    seed, n_stats = 0, max(len(f.delta_names)
                           for f in family.FAMILIES.values())
    filt = set()
    for r in range(64):
        for c in range(8):
            key = round_mod.filter_key(seed, r, c)
            filt |= {key} | {fold(key, i) for i in range(n_stats)}
    others = {(seed, device_mod.INIT, c) for c in range(8)}
    others.add((seed, device_mod.EVAL, 42))
    for r in range(64):
        aux = (seed, device_mod.AUX, r)
        others |= {aux, fold(aux, 101)} | {fold(aux, c) for c in range(8)}
        for c in range(8):
            for s in range(4):
                sweep = (seed, device_mod.SWEEP, r, c, s)
                others |= {sweep} | {fold(sweep, ch) for ch in range(8)}
    assert not filt & others

    drawn = []
    real = device_mod.generator
    monkeypatch.setattr(device_mod, "generator",
                        lambda key, dev: drawn.append(key) or real(key, dev))
    cfg, tokens, mask = _small()
    tr = Trainer(cfg, tokens, mask, device="cpu", config=TrainerConfig(
        layout="sorted", n_clients=2,
        filter=FilterSpec("topk", k_rows=2, random_rows=3)))
    for _ in range(2):
        tr.step()
    assert {k for k in drawn if k[1] == device_mod.FILTER} == {
        fold(round_mod.filter_key(0, r, c), 0)
        for r in range(2) for c in range(2)}


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _small():
    cfg = lda.LDAConfig(n_topics=4, vocab_size=16)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, 16, size=(6, 8)),
                             dtype=torch.int32)
    mask = torch.ones((6, 8), dtype=torch.bool)
    return cfg, tokens, mask


def _small_pdp():
    _, tokens, mask = _small()
    cfg = pdp.PDPConfig(n_topics=4, vocab_size=16, stirling_n_max=32)
    return cfg, tokens, mask


def test_default_device_is_cuda_and_raises_without_card(monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_mod.resolve()
    assert device_mod.resolve("cpu").type == "cpu"


@pytest.mark.parametrize("conv", ["from_numpy", "shared_from", "local_from",
                                  "layout_from", "proposal_from"])
def test_bridge_requires_card_unless_cpu_asked(conv, monkeypatch):
    """The converters that carry the reference's state across put it on
    ``cuda`` unless ``device="cpu"`` is passed, and raise with no card."""
    _no_card(monkeypatch)
    cfg, tokens, mask = _small()
    fam = family.get("lda")
    local, shared = fam.init_state(cfg, tokens, mask, (0,))
    tables, stale = fam.build_alias(cfg, shared)
    lay = fam.build_sorted_layouts(cfg, tokens, mask)[0]
    fns = {
        "from_numpy": lambda **kw: bridge.from_numpy(
            lda.SharedStats, bridge.to_numpy(shared), **kw),
        "shared_from": lambda **kw: bridge.shared_from(
            bridge.to_numpy(shared), **kw),
        "local_from": lambda **kw: bridge.local_from(
            bridge.to_numpy(local), **kw),
        "layout_from": lambda **kw: bridge.layout_from(
            bridge.to_numpy(lay), **kw),
        "proposal_from": lambda **kw: bridge.proposal_from(
            bridge.to_numpy(tables), stale.numpy(), **kw)[0]}
    with pytest.raises(RuntimeError, match="CUDA"):
        fns[conv]()
    got = fns[conv](device="cpu")
    assert all(t.device.type == "cpu" for t in got)


def test_trainer_requires_card_unless_cpu_asked(monkeypatch):
    _no_card(monkeypatch)
    cfg, tokens, mask = _small()
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, tokens, mask,
                config=TrainerConfig(layout="sorted", n_clients=2))
    Trainer(cfg, tokens, mask, config=TrainerConfig(layout="sorted"),
            device="cpu").step()


def test_pdp_trainer_requires_card_unless_cpu_asked(monkeypatch):
    _no_card(monkeypatch)
    cfg, tokens, mask = _small_pdp()
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, tokens, mask,
                config=TrainerConfig(layout="sorted", n_clients=2))
    tr = Trainer(cfg, tokens, mask, config=TrainerConfig(
        layout="sorted", n_clients=2, alias_rebuild_threshold=0.0,
        alias_rebuild_rows=4), device="cpu")
    tr.step()
    assert tr.consistency_error() == 0.0


def test_hdp_trainer_requires_card_unless_cpu_asked(monkeypatch):
    _no_card(monkeypatch)
    _, tokens, mask = _small()
    cfg = hdp.HDPConfig(n_topics=4, vocab_size=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, tokens, mask,
                config=TrainerConfig(layout="sorted", n_clients=2))
    tr = Trainer(cfg, tokens, mask, config=TrainerConfig(
        layout="sorted", n_clients=2, alias_rebuild_threshold=0.0,
        alias_rebuild_rows=4), device="cpu")
    tr.step()
    assert tr.consistency_error() == 0.0
    assert sum(tr.family.count_local_violations(loc)
               for loc in tr.locals_) == 0.0


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


@pytest.mark.parametrize("call", ["freeze", "from_checkpoint", "engine",
                                  "reference_fold_in", "server",
                                  "server_cli", "launch_serve"])
def test_serving_requires_card_unless_cpu_asked(call, monkeypatch, tmp_path):
    """The serving entry points run on ``cuda`` unless the CPU is asked
    for, and raise without a card."""
    from repro_torch import serve
    from repro_torch.launch import serve as launch
    from repro_torch.serve import server

    _no_card(monkeypatch)
    cfg, tokens, mask = _small()
    _, shared = family.get("lda").init_state(cfg, tokens, mask, (0,))
    snap = serve.freeze(cfg, shared, device="cpu")
    scfg = serve.ServeConfig(max_slots=2, max_len=8, n_sweeps=1)
    Trainer(cfg, tokens, mask, config=TrainerConfig(
        layout="sorted", snapshot_dir=str(tmp_path)),
        device="cpu").save_snapshot()
    req = serve.InferRequest(uid=0, tokens=[1, 2, 3], seed=0)
    fns = {
        "freeze": lambda **kw: serve.freeze(cfg, shared, **kw),
        "from_checkpoint": lambda **kw: serve.from_checkpoint(
            str(tmp_path), cfg, **kw),
        "engine": lambda **kw: serve.FoldInEngine(snap, scfg, **kw).run(
            [req]),
        "reference_fold_in": lambda **kw: serve.reference_fold_in(
            snap, req.tokens, 0, n_sweeps=1, max_len=8, **kw),
        "server": lambda **kw: server.InferenceServer(snap, scfg,
                                                      **kw).close(),
        "server_cli": lambda device="cuda": server.main([
            "--vocab-size", "16", "--n-topics", "4", "--snapshot-dir",
            str(tmp_path), "--port", "-1", "--device", device]),
        "launch_serve": lambda **kw: launch.launch_serve(
            vocab_size=16, n_topics=4, train_rounds=1,
            workdir=str(tmp_path / "launch"), **kw)}
    with pytest.raises(RuntimeError, match="CUDA"):
        fns[call]()
    if call in ("server_cli", "launch_serve"):
        return          # their CPU runs bind sockets and start processes
    fns[call](device="cpu")


@pytest.mark.parametrize("call", ["shard_server", "server_cli", "client",
                                  "client_cli", "trainer", "from_servers"])
def test_wire_requires_card_unless_cpu_asked(call, monkeypatch):
    """The wire's entry points (shard servers and their CLI, the client
    and the worker CLI, the tcp Trainer, ``from_servers``) run on
    ``cuda`` unless the CPU is asked for, and raise without a card before
    they bind or dial anything."""
    from repro_torch.net import client, server
    from repro_torch.serve import snapshot

    _no_card(monkeypatch)
    cfg, tokens, mask = _small()
    addr = ("127.0.0.1:1",)
    fns = {
        "shard_server": lambda: server.ShardServer(
            "lda", vocab_size=16, n_clients=1),
        "server_cli": lambda: server.main([
            "--vocab-size", "16", "--n-clients", "1"]),
        "client": lambda: client.RemoteParameterServer(
            addr, family="lda", n_clients=1, vocab_size=16),
        "client_cli": lambda: client.main([
            "--mode", "stress", "--addrs", addr[0], "--clients", "0"]),
        "trainer": lambda: Trainer(cfg, tokens, mask, config=TrainerConfig(
            layout="sorted", transport="tcp", server_addrs=addr)),
        "from_servers": lambda: snapshot.from_servers(addr, cfg,
                                                      n_clients=1)}
    with pytest.raises(RuntimeError, match="CUDA"):
        fns[call]()


@pytest.mark.parametrize("call", ["make_host_mesh", "run_on_mesh",
                                  "make_round_fn"])
def test_mesh_requires_card_unless_cpu_asked(call, monkeypatch):
    """The mesh round's entry points run on ``cuda`` unless the CPU is
    asked for, and raise without a card before they start a process or
    touch a process group; the CPU's backend is gloo."""
    from repro_torch.core import distributed
    from repro_torch.launch import mesh

    _no_card(monkeypatch)
    cfg = _small()[0]
    fns = {
        "make_host_mesh": lambda: mesh.make_host_mesh(),
        "run_on_mesh": lambda: mesh.run_on_mesh(print),
        "make_round_fn": lambda: distributed.make_round_fn(
            cfg, distributed.DistConfig(), None)}
    with pytest.raises(RuntimeError, match="CUDA"):
        fns[call]()
    assert mesh.default_backend("cpu") == "gloo"
    assert mesh.default_backend("cuda") == "nccl"


@pytest.mark.parametrize("call", ["LM", "init_params", "make_train_step",
                                  "launch_train", "lm_params_from",
                                  "example"])
def test_lm_requires_card_unless_cpu_asked(call, monkeypatch):
    """The LM side's entry points run on ``cuda`` unless the CPU is asked
    for, and raise without a card: the model, its weights, the training
    step that places its inputs, the launcher's and the example's CLIs and
    the bridge's converter of the reference's weights."""
    import importlib.util

    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.train import train_step

    _no_card(monkeypatch)
    cfg = reduced(ARCHITECTURES["smollm-360m"]).replace(n_layers=1,
                                                        vocab_size=256)
    tree = model.init_params(cfg, device="cpu")
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", ROOT / "examples" / "train_lm_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    tokens = np.zeros((2, 8), np.int32)
    argv = ["--reduced", "--steps", "1", "--batch", "2", "--seq", "8"]
    fns = {
        "LM": lambda **kw: model.LM(cfg, **kw).forward({"tokens": tokens}),
        "init_params": lambda **kw: model.init_params(cfg, **kw),
        "make_train_step": lambda **kw: train_step.make_train_step(
            cfg, train_step.TrainConfig(loss_chunk=8), **kw)(
                tree, adamw.init(tree), {"tokens": tokens}),
        "launch_train": lambda device="cuda": launch_train.main(
            argv + ["--device", device]),
        "lm_params_from": lambda **kw: bridge.lm_params_from(
            bridge.lm_params_to(tree), **kw),
        "example": lambda device="cuda": example.main(
            ["--steps", "1", "--batch", "2", "--seq", "8",
             "--device", device])}
    with pytest.raises(RuntimeError, match="CUDA"):
        fns[call]()
    fns[call](device="cpu")


@pytest.mark.parametrize("call", ["mesh_step", "launch_train_mesh"])
def test_lm_mesh_requires_card_unless_cpu_asked(call, monkeypatch,
                                                tmp_path):
    """The LM side's mesh step and the launcher's ``--mesh`` path run on
    ``cuda`` unless the CPU is asked for, and raise without a card before
    they touch a process group or start a process; asked for, the step
    runs on a mesh of the CPU (here one rank in this process, over
    gloo)."""
    import torch.distributed as dist

    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.train import sharding, train_step

    _no_card(monkeypatch)
    cfg = reduced(ARCHITECTURES["smollm-360m"]).replace(n_layers=1,
                                                        vocab_size=256)
    tcfg = train_step.TrainConfig(loss_chunk=8)
    argv = ["--reduced", "--steps", "1", "--batch", "4", "--seq", "8",
            "--mesh", "data=2,model=2", "--sharding", "zero_batch"]
    fns = {"mesh_step": lambda: train_step.make_train_step(
               cfg, tcfg, mesh=object(), mode="zero_batch"),
           "launch_train_mesh": lambda: launch_train.main(argv)}
    with pytest.raises(RuntimeError, match="CUDA"):
        fns[call]()
    if call == "mesh_step":
        dist.init_process_group("gloo", store=dist.FileStore(
            str(tmp_path / "store"), 1), rank=0, world_size=1)
        try:
            mesh = mesh_mod.make_host_mesh(device="cpu")
            specs = train_step.param_layout(cfg, mesh, "zero_batch")
            tree = sharding.shard_tree(model.init_params(cfg, device="cpu"),
                                       specs, mesh)
            _, _, met = train_step.make_train_step(
                cfg, tcfg, "cpu", mesh=mesh, mode="zero_batch")(
                    tree, adamw.init(tree),
                    {"tokens": np.zeros((2, 8), np.int32)})
            assert np.isfinite(float(met["loss"]))
        finally:
            dist.destroy_process_group()


@pytest.mark.parametrize("call", ["make_production_mesh",
                                  "make_lowering_spec"])
def test_dry_run_requires_card_unless_cpu_asked(call, monkeypatch):
    """The pod dry run's pieces that take a device (the production mesh,
    a workload's spec) run on ``cuda`` unless the CPU is asked for, and
    raise without a card before they touch a process group or build a
    tensor; the dry run itself asks for the CPU (it runs on no device)."""
    from repro_torch.configs.base import InputShape, reduced
    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import specs

    _no_card(monkeypatch)
    cfg = reduced(ARCHITECTURES["smollm-360m"]).replace(vocab_size=256)
    shape = InputShape("tiny_decode", 16, 2, "decode")
    fns = {"make_production_mesh": mesh_mod.make_production_mesh,
           "make_lowering_spec": lambda **kw: specs.make_lowering_spec(
               cfg, shape, {"data": 1, "model": 1}, **kw)}
    with pytest.raises(RuntimeError, match="CUDA"):
        fns[call]()
    if call == "make_production_mesh":
        with pytest.raises(RuntimeError, match="process group"):
            fns[call](device="cpu")
        return
    spec = fns[call](device="cpu")
    assert all(x.device.type == "cpu" for x in model_leaves(spec.args))


def model_leaves(tree) -> list:
    from repro_torch.models import model
    out = []
    for x in tree:
        out += model.leaves(x) if isinstance(x, dict) else [x]
    return out


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


@pytest.mark.parametrize("call", ["build_tables_rows", "pdp_sweep"])
def test_pdp_ops_require_card_unless_cpu_asked(call, monkeypatch):
    _no_card(monkeypatch)
    cfg, tokens, mask = _small_pdp()
    fam = family.get("pdp")
    local, shared = fam.init_state(cfg, tokens, mask, (0,))
    dp = pdp.dense_probs(cfg, shared)
    tables = ops.build_tables(dp, device="cpu")
    lay = fam.build_sorted_layouts(cfg, tokens, mask)[0]
    stirl = stirling.as_tensor(cfg.stirling_n_max, cfg.discount, "cpu")
    fns = {
        "build_tables_rows": lambda **kw: ops.build_tables_rows(dp[:3], **kw),
        "pdp_sweep": lambda **kw: ops.pdp_sweep_sorted(
            tables, dp, shared.m_wk, shared.s_wk, shared.m_k, shared.s_k,
            stirl, torch.full((8,), 0.1), lay.rows, lay.docs,
            torch.zeros_like(lay.rows), local.n_dk, torch.Generator(),
            mh_steps=2, concentration=10.0, discount=0.1, gamma=0.5,
            gamma_bar=8.0, **kw)}
    with pytest.raises(RuntimeError, match="CUDA"):
        fns[call]()
    fns[call](device="cpu")


def _draw_ops(dev="cpu"):
    """The four entry points of kernels 6-9 on small inputs on ``dev``."""
    n_wk = torch.arange(48, dtype=torch.float32, device=dev).reshape(16, 3)
    n_k = n_wk.sum(0)
    tables = alias.build(torch.rand(16, 3).to(dev))
    rows = torch.tensor([0, 3, 3, 15, 16, 16, 16, 16], dtype=torch.int32,
                        device=dev)
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    z = torch.zeros(8, dtype=torch.int32, device=dev)
    lp = torch.zeros(8, device=dev)
    return {
        "fused": lambda **kw: ops.build_tables_fused_lda(
            n_wk, n_k, alpha=0.1, beta=0.01, vocab_size=16, **kw),
        "sample_rows": lambda **kw: ops.sample_rows(
            tables, rows, torch.Generator(), **kw),
        "sample_rows_sorted": lambda **kw: ops.sample_rows_sorted(
            tables, rows, one, one, torch.Generator(), tile_b=8, **kw),
        "mh_accept": lambda **kw: ops.mh_accept(
            z, z + 1, lp, lp, lp, lp, torch.Generator(), **kw)}


@pytest.mark.parametrize("call", ["fused", "sample_rows",
                                  "sample_rows_sorted", "mh_accept"])
def test_draw_and_fused_ops_require_card_unless_cpu_asked(call,
                                                          monkeypatch):
    _no_card(monkeypatch)
    fns = _draw_ops()
    with pytest.raises(RuntimeError, match="CUDA"):
        fns[call]()
    fns[call](device="cpu")
    with pytest.raises(ValueError, match="runs on"):
        _draw_ops("meta")[call](device="cpu")


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


@pytest.mark.cuda
def test_cuda_tensors_reach_the_pdp_kernels(cuda_device):
    """The PDP kernels on the card: the compacted-rows build (kernel 5)
    launches once and is bit-equal to its plain version and to the same
    rows of a full build (kernel 2) at width 2K; the PDP sweep (kernel 4)
    launches once and its chains agree with the plain version except where
    the block-parallel cdf rounds across a step (at most 1% of chains)."""
    cfg = pdp.PDPConfig(n_topics=64, vocab_size=512, stirling_n_max=128)
    rng = np.random.default_rng(2)
    tokens = torch.as_tensor(rng.integers(0, 512, size=(64, 32)),
                             dtype=torch.int32, device=cuda_device)
    mask = torch.ones_like(tokens, dtype=torch.bool)
    fam = family.get("pdp")
    local, shared = fam.init_state(cfg, tokens, mask, (0,))
    _build.reset_launches()
    tables, dp = pdp.build_alias(cfg, shared)
    assert _build.LAUNCHES["alias_build"] == 1
    for a, b in zip(tables, alias.build(dp)):
        assert torch.equal(a, b)

    rows = torch.tensor([3, 0, 511, 42, 7], dtype=torch.int32,
                        device=cuda_device)
    p_rows = fam.dense_probs_rows(cfg, shared, rows)
    sub = ops.build_tables_rows(p_rows, device=cuda_device)
    assert _build.LAUNCHES["alias_build_rows"] == 1
    assert torch.equal(p_rows, dp[rows.long()])
    for a, b, c in zip(sub, alias.build(p_rows), tables):
        assert torch.equal(a, b) and torch.equal(a, c[rows.long()])

    lay = fam.build_sorted_layouts(cfg, tokens, mask)[0]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    uni = ops._step_uniforms(gen, 128, 2, lay.rows.shape[0], cuda_device)
    e0 = torch.randint(0, 128, lay.rows.shape, generator=gen,
                       device=cuda_device, dtype=torch.int32)
    stirl = stirling.as_tensor(cfg.stirling_n_max, cfg.discount, cuda_device)
    prior = fam.sparse_prior(cfg, shared)
    hyper = dict(b=cfg.concentration, a=cfg.discount, gamma=cfg.gamma,
                 gamma_bar=cfg.gamma * cfg.vocab_size)
    args = (*tables, dp, shared.m_wk, shared.s_wk, shared.m_k, shared.s_k,
            stirl, prior, lay.rows, lay.docs, e0, local.n_dk, *uni)
    e = ops.pdp_sweep_sorted(
        tables, dp, shared.m_wk, shared.s_wk, shared.m_k, shared.s_k, stirl,
        prior, lay.rows, lay.docs, e0, local.n_dk, None, mh_steps=2,
        concentration=cfg.concentration, discount=cfg.discount,
        gamma=cfg.gamma, gamma_bar=cfg.gamma * cfg.vocab_size, uniforms=uni,
        device=cuda_device)
    assert _build.LAUNCHES["pdp_sweep_fused"] == 1
    e_ref = pdp.sorted_chain_pdp(*args, **hyper)
    assert float((e != e_ref).float().mean()) <= 0.01
    assert bool(((e >= 0) & (e < 128)).all())
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_pdp_sweep_kernel_clamps_counts_above_the_stirling_table(cuda_device):
    """Kernel 4 on consistent (m, s) statistics far above stirling_n_max
    (16 here, counts in the hundreds), where m is clamped to hi, s to hi+1
    in the same-table ratio and to hi in the new-table ratio, and the
    table's −1e30 entries are reached: its chains agree with the plain
    version's, at most 1% apart as above.  The plain log factors on
    the card equal the CPU's at the clamped cells: non-finite entries
    exactly, the rest within 4 ulp (CUDA's and the CPU's log)."""
    from repro_torch.kernels import mhw_fused

    v, k, n_max, b, n_pad, steps = 64, 64, 16, 1024, 24, 2
    rng = np.random.default_rng(4)
    m = np.floor(rng.gamma(1.0, size=(v, k)) * 400).astype(np.float32)
    s = np.minimum(np.ceil(m * rng.uniform(0.2, 0.8, size=(v, k))), m)
    s = np.where(m > 0, np.maximum(s, 1.0), 0.0).astype(np.float32)
    hi = n_max - 1
    # The first half of the words keep s within the table, so their
    # factors stay finite with m clamped; the rest reach the −1e30 entries.
    s[:v // 2] = np.minimum(s[:v // 2], hi)
    assert (m > hi).mean() > 0.5 and (s > hi).mean() > 0.25
    cfg = pdp.PDPConfig(n_topics=k, vocab_size=v, stirling_n_max=n_max)
    hyper = dict(b=cfg.concentration, a=cfg.discount, gamma=cfg.gamma,
                 gamma_bar=cfg.gamma * v)

    def on(dev):
        mt = torch.as_tensor(m, device=dev)
        st = torch.as_tensor(s, device=dev)
        return pdp.SharedStats(m_wk=mt, s_wk=st, m_k=mt.sum(0),
                               s_k=st.sum(0))

    shared = on(cuda_device)
    stirl = stirling.as_tensor(n_max, cfg.discount, cuda_device)
    f_card = torch.cat(pdp.log_factors(
        stirl, shared.m_wk, shared.s_wk, shared.m_k[None, :],
        shared.s_k[None, :], **hyper), -1).cpu()
    cpu = on("cpu")
    f_cpu = torch.cat(pdp.log_factors(
        stirling.as_tensor(n_max, cfg.discount, "cpu"), cpu.m_wk, cpu.s_wk,
        cpu.m_k[None, :], cpu.s_k[None, :], **hyper), -1)
    clamped = torch.as_tensor(np.concatenate([m > hi, m > hi], -1))
    fin = torch.isfinite(f_cpu)
    assert torch.equal(f_card[clamped & ~fin], f_cpu[clamped & ~fin])
    sel = clamped & fin
    ia = f_card[sel].view(torch.int32).long()
    ib = f_cpu[sel].view(torch.int32).long()
    assert int((ia - ib).abs().max()) <= 4

    dp = pdp.dense_probs(cfg, shared)
    tables = alias.build(dp)
    prior = torch.full((2 * k,), cfg.alpha, device=cuda_device)
    rows = np.concatenate([np.sort(rng.integers(0, v, size=b - n_pad)),
                           np.full(n_pad, v)]).astype(np.int32)
    e0 = rng.integers(0, 2 * k, size=b).astype(np.int32)
    ndk = np.floor(rng.gamma(0.5, size=(b, k)) * 2).astype(np.float32)
    ndk[np.arange(b), e0 % k] += 1.0
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    uni = ops._step_uniforms(gen, 2 * k, steps, b, cuda_device)
    args = (*tables, dp, *shared, stirl, prior,
            torch.as_tensor(rows, device=cuda_device),
            torch.arange(b, dtype=torch.int32, device=cuda_device),
            torch.as_tensor(e0, device=cuda_device),
            torch.as_tensor(ndk, device=cuda_device), *uni)
    _build.reset_launches()
    e = mhw_fused.pdp_sweep_fused(*args, **hyper)
    assert _build.LAUNCHES["pdp_sweep_fused"] == 1
    e_ref = pdp.sorted_chain_pdp(*args, **hyper)
    assert float((e != e_ref).float().mean()) <= 0.01
    assert torch.equal(e[-n_pad:].cpu(), torch.as_tensor(e0[-n_pad:]))
    assert bool(((e >= 0) & (e < 2 * k)).all())
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_tensors_reach_kernels_6_to_9(cuda_device):
    """Kernels 6-9 on the card: each wrapper launches its kernel once and
    agrees with its plain version on the same inputs: the fused build's
    tables bit-equal (row masses summed in the same order) and its stale
    matrix equal to the wrapper's formula; the draws equal, sentinels 0;
    the accept step equal (CUDA's logf is the one torch.log calls)."""
    v, k = 512, 64
    rng = np.random.default_rng(5)
    n_wk = torch.as_tensor(np.floor(rng.gamma(0.4, size=(v, k)) * 3),
                           dtype=torch.float32, device=cuda_device)
    n_k = n_wk.sum(0)
    _build.reset_launches()
    tables, stale = ops.build_tables_fused_lda(
        n_wk, n_k, alpha=0.1, beta=0.01, vocab_size=v, device=cuda_device)
    assert _build.LAUNCHES["alias_build_fused"] == 1
    want = ref.alias_build_fused_ref(n_wk, n_k, alpha=0.1, beta=0.01,
                                     vocab_size=v)
    for a, b in zip(tables, want):
        assert torch.equal(a, b)
    assert torch.equal(stale, ref.fused_dense_ref(
        n_wk, n_k, alpha=0.1, beta=0.01, vocab_size=v))

    b, n_pad = 4096, 300
    rows = torch.as_tensor(np.concatenate([
        np.sort(rng.integers(0, v, size=b - n_pad)), np.full(n_pad, v)]),
        dtype=torch.int32, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    slot = torch.randint(0, k, (b,), generator=gen, device=cuda_device,
                         dtype=torch.int32)
    coin = torch.rand(b, generator=gen, device=cuda_device)
    nb = torch.zeros(b // 1024, dtype=torch.int32, device=cuda_device)
    drawn = ops.sample_rows_sorted(tables, rows, nb, nb, uniforms=(
        slot, coin), device=cuda_device)
    assert _build.LAUNCHES["alias_sample_sorted"] == 1
    assert torch.equal(drawn, ref.alias_sample_sorted_ref(
        tables.prob, tables.alias, rows, slot, coin))
    assert bool((drawn[-n_pad:] == 0).all())
    perm = torch.randperm(b, generator=gen, device=cuda_device)
    shuffled = ops.sample_rows(tables, rows[perm], uniforms=(
        slot[perm], coin[perm]), device=cuda_device)
    assert _build.LAUNCHES["alias_sample"] == 1
    assert torch.equal(shuffled, drawn[perm])

    z = torch.randint(0, k, (b,), generator=gen, device=cuda_device,
                      dtype=torch.int32)
    r = rows.clamp_max(v - 1).long()
    lps = (torch.log(stale[r, slot.long()]), torch.log(stale[r, z.long()]),
           torch.log(tables.prob[r, slot.long()]),
           torch.log(tables.prob[r, z.long()]))
    u = torch.rand(b, generator=gen, device=cuda_device)
    out = ops.mh_accept(z, slot, lps[1], lps[0], lps[3], lps[2], u=u,
                        device=cuda_device)
    assert _build.LAUNCHES["mh_accept"] == 1
    assert torch.equal(out, ref.mh_accept_ref(z, slot, lps[1], lps[0],
                                              lps[3], lps[2], u))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_sweep_kernel_with_a_non_uniform_prior(cuda_device):
    """Kernel 1 with HDP's prior b1·θ0 (a Dirichlet draw, entries orders of
    magnitude apart) agrees with its plain version except where the
    block-parallel cdf rounds across a step (at most 1% of chains)."""
    cfg = hdp.HDPConfig(n_topics=64, vocab_size=512, b1=2.0)
    rng = np.random.default_rng(6)
    tokens = torch.as_tensor(rng.integers(0, 512, size=(64, 32)),
                             dtype=torch.int32, device=cuda_device)
    mask = torch.ones_like(tokens, dtype=torch.bool)
    fam = family.get("hdp")
    local, shared = fam.init_state(cfg, tokens, mask, (0,))
    theta0 = torch.as_tensor(rng.dirichlet(np.full(64, 0.2)),
                             dtype=torch.float32, device=cuda_device)
    shared = shared._replace(theta0=theta0)
    tables, dp = fam.build_alias(cfg, shared)
    prior = fam.sparse_prior(cfg, shared)
    assert float(prior.max() / prior.min()) > 100
    lay = fam.build_sorted_layouts(cfg, tokens, mask)[0]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    uni = ops._step_uniforms(gen, 64, 2, lay.rows.shape[0], cuda_device)
    z0 = torch.zeros_like(lay.rows)
    hyper = dict(beta=cfg.beta, beta_bar=cfg.beta * cfg.vocab_size)
    _build.reset_launches()
    z = ops.mhw_sweep_sorted(tables, dp, shared.n_wk, shared.n_k, prior,
                             lay.rows, lay.docs, z0, local.n_dk, None,
                             mh_steps=2, uniforms=uni, device=cuda_device,
                             **hyper)
    assert _build.LAUNCHES["mhw_sweep_fused"] == 1
    z_ref = mhw.sorted_chain(*tables, dp, shared.n_wk, shared.n_k, prior,
                             lay.rows, lay.docs, z0, local.n_dk, *uni,
                             **hyper)
    assert float((z != z_ref).float().mean()) <= 0.01
    torch.cuda.synchronize()


def test_restore_requires_card_unless_cpu_asked(monkeypatch, tmp_path):
    cfg, tokens, mask = _small()
    tcfg = TrainerConfig(layout="sorted", snapshot_every=1,
                         snapshot_dir=str(tmp_path))
    Trainer(cfg, tokens, mask, config=tcfg, device="cpu").step()
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer.restore(cfg, tokens, mask, config=tcfg)
    assert Trainer.restore(cfg, tokens, mask, config=tcfg,
                           device="cpu").round_idx == 1
