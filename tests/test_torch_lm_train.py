"""The port's LM training on its own and across packages.

* The mirrors of ``tests/test_arch_smoke.py``'s train-step tests: one
  step of every architecture is finite, moves the weights and counts the
  step; two microbatches against one within the reference's own bound
  (5e-2 relative); eight decode steps of mixtral (its ring cache), rwkv6
  and zamba2 stay finite and advance ``pos``.
* Checkpoints: a ``{"params", "opt"}`` tree written by the reference's
  ``ckpt.save`` is resumed by the port's launcher, and one written by the
  port's launcher is resumed by the reference's; the tensors read back
  bit-equal to the ones written.
* The launcher and the example on ``--device cpu``, a few steps each,
  ``--stale-sync`` included; the launcher on a 2×2 mesh of four CPU
  processes under ``zero_seq`` and ``zero_batch``, 3 steps each, its
  checkpoint resumed by the port's one-card launcher and by the
  reference's.
* The sync's filter over a gradient tree and its traffic estimate equal
  the reference's (top-k without random rows: the port draws those from
  its own stream).
* ``LM`` holds the reference's tree under its paths; the bridge carries
  parameters, AdamW's state and a decode cache across and back bit for
  bit.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.core import ps as ref_ps
from repro.launch import train as ref_launch
from repro.models import model as ref_model
from repro.optim import adamw as ref_adamw
from repro.train import sync as ref_sync
from repro_torch import bridge
from repro_torch import device as device_mod
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import ARCHITECTURES
from repro_torch.core import ps
from repro_torch.launch import train as launch
from repro_torch.models import model
from repro_torch.optim import adamw
from repro_torch.train import sync, train_step
from tests.test_torch_lm_common import (ALL_ARCHS, batch, configs, ref_jit,
                                   torch_batch)
from tests.test_torch_lm_common import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def port_state():
    """(cfg, params, batch) per architecture, the port's own weights."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = reduced(ARCHITECTURES[arch])
            seed = ALL_ARCHS.index(arch)
            cache[arch] = (cfg, model.init_params(cfg, seed, device="cpu"),
                           batch(cfg, seed))
        return cache[arch]

    return get


def clone(tree):
    return model.map_tree(lambda t: t.detach().clone(), tree)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_step(arch, port_state):
    cfg, params, b = port_state(arch)
    params = clone(params)
    before = clone(params)
    tcfg = train_step.TrainConfig(microbatches=1, loss_chunk=16, warmup=0,
                                  total_steps=10)
    step = train_step.make_train_step(cfg, tcfg, device="cpu")
    params2, opt2, metrics = step(params, adamw.init(params), b)
    assert set(metrics) == {"loss", "lr", "grad_norm", "ce", "aux"}
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert float(metrics["grad_norm"]) > 0.0
    moved = [float((a - w).abs().max()) for a, w in
             zip(model.leaves(params2), model.leaves(before))]
    assert max(moved) > 0.0
    assert all(bool(torch.isfinite(p).all()) for p in model.leaves(params2))
    assert int(opt2.step) == 1


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_step_microbatched_matches(arch, port_state):
    """Gradient accumulation over 2 microbatches ≈ single-shot step."""
    cfg, params, b = port_state(arch)
    out = {}
    for mb in (1, 2):
        p = clone(params)
        tcfg = train_step.TrainConfig(microbatches=mb, loss_chunk=16,
                                      warmup=0, total_steps=10)
        step = train_step.make_train_step(cfg, tcfg, device="cpu")
        _, _, metrics = step(p, adamw.init(p), b)
        out[mb] = float(metrics["loss"])
    assert abs(out[1] - out[2]) < 5e-2 * max(1.0, abs(out[1]))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "rwkv6-3b", "zamba2-2.7b"])
def test_multi_step_decode(arch):
    cfg = reduced(ARCHITECTURES[arch])
    tree = model.init_params(cfg, 3, device="cpu")
    b = torch_batch(batch(cfg, 3, b=2, s=8))
    logits, cache = model.prefill(cfg, tree, b, 32)
    tok = logits[..., :cfg.vocab_size].argmax(-1)
    for i in range(8):
        logits, cache = model.decode_step(cfg, tree, cache, tok)
        assert bool(torch.isfinite(logits).all()), f"{arch}: step {i}"
        tok = logits[..., :cfg.vocab_size].argmax(-1)
    assert int(cache["pos"]) == 16


# ---------------------------------------------------------------------------
# Checkpoints across packages, the launcher
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", "smollm-360m", "--reduced", "--batch", "2", "--seq",
          "16", "--device", "cpu"]


def _ref_tree():
    """The launcher's reduced smollm as the reference builds it, with an
    optimizer state of random moments at step 5."""
    ref_cfg, _ = configs("smollm-360m", vocab_size=512)
    params = ref_jit(lambda k: ref_model.init_params(ref_cfg, k))(
        jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)
    moment = lambda p: jnp.asarray(rng.random(p.shape, np.float32))
    opt = ref_adamw.AdamWState(step=jnp.asarray(5, jnp.int32),
                               m=jax.tree.map(moment, params),
                               v=jax.tree.map(moment, params))
    return ref_cfg, params, opt


def test_reference_checkpoint_resumed_by_the_port(tmp_path, capsys):
    ref_cfg, params, opt = _ref_tree()
    ref_ckpt.save(str(tmp_path), ref_cfg.name, 5,
                  {"params": params, "opt": opt._asdict()})
    launch.main(LAUNCH + ["--steps", "7", "--ckpt-dir", str(tmp_path),
                          "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 5" in out and "training complete" in out
    assert "step     6" in out

    # what the port restores is what the reference wrote, bit for bit
    cfg = reduced(ARCHITECTURES["smollm-360m"]).replace(vocab_size=512)
    tree = model.init_params(cfg, device="cpu")
    template = {"params": tree, "opt": adamw.init(tree)._asdict()}
    got = ckpt.restore(str(tmp_path), cfg.name, template, step=5)
    assert bridge.adamw_state_from(got["opt"], device="cpu").step == 5
    want = {"params": jax.tree.map(np.asarray, params),
            "opt": jax.tree.map(np.asarray, opt._asdict())}
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            model.leaves(got)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))


def test_port_checkpoint_resumed_by_the_reference(tmp_path, capsys):
    launch.main(LAUNCH + ["--steps", "2", "--ckpt-dir", str(tmp_path),
                          "--ckpt-every", "2"])
    assert "checkpoint:" in capsys.readouterr().out
    step, raw = ckpt.load_raw(str(tmp_path), "smollm-360m")
    assert step == 2 and raw["opt/step"] == 2
    ref_cfg, params, opt = _ref_tree()
    back = ref_ckpt.restore(str(tmp_path), ref_cfg.name,
                            {"params": params, "opt": opt._asdict()})
    for path, leaf in jax.tree_util.tree_flatten_with_path(back)[0]:
        key = "/".join(str(p.key) for p in path)
        np.testing.assert_array_equal(np.asarray(leaf), raw[key],
                                      err_msg=key)
    ref_launch.main(["--arch", "smollm-360m", "--reduced", "--batch", "2",
                     "--seq", "16", "--steps", "3", "--ckpt-dir",
                     str(tmp_path), "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "training complete" in out


MESH = ["--arch", "smollm-360m", "--reduced", "--batch", "8", "--seq", "16",
        "--device", "cpu", "--mesh", "data=2,model=2"]


@pytest.mark.parametrize("mode", ["zero_seq", "zero_batch"])
def test_launcher_trains_on_a_mesh_and_both_launchers_resume(mode, tmp_path,
                                                            capfd):
    """``--mesh data=2,model=2 --sharding MODE`` trains 3 steps in four
    processes (rank 0 prints) and writes a checkpoint at step 2 holding
    the full tree, gathered from the ranks, in the reference's format:
    the port's one-card launcher and the reference's launcher resume it."""
    launch.main(MESH + ["--sharding", mode, "--steps", "3", "--ckpt-dir",
                        str(tmp_path), "--ckpt-every", "2"])
    out = capfd.readouterr().out
    assert f"mesh 2x2 (gloo), sharding {mode}" in out
    assert out.count("step     2") == 1 and "training complete" in out
    assert out.count("checkpoint:") == 1
    step, raw = ckpt.load_raw(str(tmp_path), "smollm-360m")
    shapes = model.param_shapes(
        reduced(ARCHITECTURES["smollm-360m"]).replace(vocab_size=512))
    assert step == 2 and raw["opt/step"] == 2
    for key, leaf in zip(("/".join(p) for p in _paths(shapes)),
                         model.leaves(shapes)):
        for pre in ("params/", "opt/m/", "opt/v/"):
            assert raw[pre + key].shape == tuple(leaf.shape), pre + key
    launch.main(MESH[:-2] + ["--steps", "3", "--ckpt-dir", str(tmp_path),
                             "--resume"])
    out = capfd.readouterr().out
    assert "resumed from step 2" in out and "step     2" in out
    ref_launch.main(["--arch", "smollm-360m", "--reduced", "--batch", "8",
                     "--seq", "16", "--steps", "3", "--ckpt-dir",
                     str(tmp_path), "--resume"])
    out = capfd.readouterr().out
    assert "resumed from step 2" in out and "training complete" in out


def _paths(tree, pre=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _paths(tree[k], pre + (k,))
        else:
            yield pre + (k,)


def _example():
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", ROOT / "examples" / "train_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("extra", [[], ["--stale-sync", "--clients", "2",
                                        "--sync-every", "1"]])
def test_example_on_the_cpu(extra, capsys):
    _example().main(["--device", "cpu", "--steps", "3", "--batch", "4",
                     "--seq", "16"] + extra)
    out = capsys.readouterr().out
    assert "arch=smollm-360m preset=tiny" in out and "step    2" in out
    if extra:
        assert "sync traffic:" in out and "reduction" in out


# ---------------------------------------------------------------------------
# The sync's filter
# ---------------------------------------------------------------------------

def test_filter_tree_and_traffic_match_the_reference():
    rng = np.random.default_rng(9)
    grads = {"w": rng.standard_normal((64, 8)).astype(np.float32),
             "b": rng.standard_normal(8).astype(np.float32),
             "blocks": {"wq": rng.standard_normal((2, 16, 4)).astype(
                 np.float32)}}
    jg = jax.tree.map(jnp.asarray, grads)
    tg = model.map_tree(torch.tensor, grads)
    key = (0, device_mod.FILTER, 3, 1)
    for kind, kw in (("topk", dict(k_rows=5)), ("threshold",
                                                dict(threshold=6.0)),
                     ("dense", {})):
        want = ref_sync.filter_tree(jg, ref_ps.FilterSpec(kind=kind, **kw),
                                    jax.random.PRNGKey(3))
        got = sync.filter_tree(tg, ps.FilterSpec(kind=kind, **kw), key)
        for a, b in zip(model.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # random rows: the top 5 by L1 mass and up to 3 drawn from the key's
    # stream, each kept whole
    got = sync.filter_tree(tg, ps.FilterSpec(kind="topk", k_rows=5,
                                             random_rows=3), key)["w"]
    kept = torch.nonzero(got.abs().sum(1) > 0).reshape(-1)
    top = torch.argsort(-tg["w"].abs().sum(1), stable=True)[:5]
    assert set(top.tolist()) <= set(kept.tolist()) and 5 <= len(kept) <= 8
    torch.testing.assert_close(got[kept], tg["w"][kept], rtol=0, atol=0)
    spec = ps.FilterSpec(kind="topk", k_rows=64, random_rows=16)
    assert sync.sync_bytes_estimate(tg, spec) == ref_sync.sync_bytes_estimate(
        jg, ref_ps.FilterSpec(kind="topk", k_rows=64, random_rows=16))


# ---------------------------------------------------------------------------
# The module and the bridge
# ---------------------------------------------------------------------------

def test_lm_module_holds_the_reference_tree():
    """``LM`` registers the tree under the reference's paths (stacked
    leaves), and its methods are the functions on that tree."""
    ref_cfg, cfg = configs("mixtral-8x7b")
    params = ref_jit(lambda k: ref_model.init_params(ref_cfg, k))(
        jax.random.PRNGKey(5))
    lm = model.LM(cfg, bridge.lm_params_from(
        jax.tree.map(np.asarray, params), device="cpu"), device="cpu")
    names = dict(lm.named_parameters())
    assert names["blocks.attn.wq"].shape == (cfg.n_layers, cfg.d_model,
                                             cfg.n_heads, cfg.head_dim_)
    assert names["blocks.moe.w_gate"].shape == (
        cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff)
    assert sum(p.numel() for p in lm.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    b = batch(cfg, 5)
    with torch.no_grad():
        hidden, aux = lm(b)
        want, want_aux = model.forward(cfg, lm.tree(),
                                       model.to_batch(b, "cpu"), remat=False)
    assert torch.equal(hidden, want) and torch.equal(aux, want_aux)
    logits, cache = lm.prefill(b, 40)
    got, cache = lm.decode_step(cache, b["tokens"][:, :1])
    assert got.shape == (2, 1, cfg.padded_vocab) and int(cache["pos"]) == 33
    assert torch.equal(lm.logits(hidden[:, -1:]), logits)


def test_bridge_round_trips_params_optimizer_and_cache():
    """The reference's parameters, AdamW state and decode cache (its bf16
    keys included) go into the port and come back bit for bit."""
    ref_cfg, _ = configs("mixtral-8x7b")
    params = ref_jit(lambda k: ref_model.init_params(ref_cfg, k))(
        jax.random.PRNGKey(6))
    opt = ref_adamw.init(params)._replace(step=jnp.asarray(3, jnp.int32))
    cache = ref_model.init_cache(ref_cfg, 2, 40)
    cache["layers"]["k"] = jnp.ones_like(cache["layers"]["k"]) * 1.5
    for want, there, back in (
            (params, bridge.lm_params_from, bridge.lm_params_to),
            (opt._asdict(), bridge.adamw_state_from, bridge.adamw_state_to),
            (cache, bridge.lm_cache_from, bridge.lm_cache_to)):
        got = back(there(jax.tree.map(np.asarray, want), device="cpu"))
        flat = dict(jax.tree_util.tree_flatten_with_path(want)[0])
        for path, leaf in flat.items():
            node = got
            for p in path:
                node = node[p.key]
            np.testing.assert_array_equal(np.asarray(node),
                                          np.asarray(leaf, np.float32)
                                          if leaf.dtype == jnp.bfloat16
                                          else np.asarray(leaf))
    port_cache = bridge.lm_cache_from(jax.tree.map(np.asarray, cache),
                                      device="cpu")
    assert port_cache["layers"]["k"].dtype == torch.bfloat16
    assert port_cache["key_pos"].dtype == torch.int32
