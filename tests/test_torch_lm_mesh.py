"""The LM side over a ``torch.distributed`` mesh on the CPU: the port's own
properties and the pieces the parity files do not reach.

* At world size 1 (a 1×1 gloo mesh in a process of its own) the mesh step
  is the one-card step bit for bit at the default bf16 compute, two steps
  of smollm-360m and mixtral-8x7b at ``reduced()``: under
  ``megatron`` against ``make_train_step`` without a mesh; under the zero
  modes against it run under the mode's activation spec (which holds the
  block weights in bf16, the norm scales included, as the reference's
  zero modes do): parameters, m, v and every metric equal.
* ``_moe_a2a`` on a 2×2 gloo mesh (the mirror of
  ``tests/test_moe_dispatch.py``'s shard_map test): mixtral reduced,
  capacity factor 8, ``moe_groups`` 4 under ``zero_batch``, each rank's
  block of 8 × 16 tokens and its two experts; the ``all_to_all`` spans of
  the dispatch and the combine are in the rank's profile, and the
  gathered output equals the reference's ``moe_block`` with
  ``moe_groups=0`` on all tokens (float32 compute, relative 1e-5); the
  gradients of a random projection of the output, to the rank's tokens
  and to its experts' weights, equal the port's one-process grouped
  dispatch's (relative 1e-5).
* ``make_sync_fns``' push on the same mesh: each client's top-k filtered
  residual summed over the ``data`` group equals the sum of the clients'
  ``filter_tree`` computed in one process, and the new residual is the
  residual less what was sent, bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced as ref_reduced
from repro.configs.registry import ARCHITECTURES as REF_ARCHS
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro_torch import device as device_mod
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import ARCHITECTURES
from repro_torch.core import ps
from repro_torch.launch.mesh import run_on_mesh
from repro_torch.models import layers, model, moe
from repro_torch.optim import adamw
from repro_torch.train import sharding, sync, train_step
from tests.test_torch_lm_common import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_lm_mesh_common import batches, config, tree_of, weights

WORLD1 = ("smollm-360m", "mixtral-8x7b")


def _state(params, opt) -> list:
    return model.leaves(params) + model.leaves(opt.m) + model.leaves(
        opt.v) + [opt.step]


def world1_rank(mesh, dev, archs) -> dict:
    """Each architecture and mode: two mesh steps and two one-card steps
    from the same weights; what differs, by name."""
    torch.set_num_threads(1)
    out = {}
    tcfg = train_step.TrainConfig(peak_lr=1e-3, warmup=0, total_steps=10,
                                  loss_chunk=16)
    for i, arch in enumerate(archs):
        cfg = config(arch)
        np_tree, data = weights(cfg, 40 + i), batches(cfg, 50 + i)
        for mode in ("megatron", "zero_seq", "zero_batch"):
            mesh_step = train_step.make_train_step(cfg, tcfg, dev, mesh=mesh,
                                                   mode=mode)
            one_step = train_step.make_train_step(cfg, tcfg, dev)
            act = sharding.activation_spec(sharding.axis_sizes(mesh), mode)
            a = tree_of(np_tree)
            a = (a, adamw.init(a))
            b = tree_of(np_tree)
            b = (b, adamw.init(b))
            diff = []
            for s, batch in enumerate(data):
                *a, ma = mesh_step(*a, batch)
                with layers.mesh_hooks(act):
                    *b, mb = one_step(*b, batch)
                diff += [f"step {s} {k}" for k in ma
                         if not torch.equal(ma[k], mb[k])]
            diff += [f"leaf {j}" for j, (x, y) in enumerate(zip(
                _state(*a), _state(*b))) if not torch.equal(x, y)]
            out[f"{arch} {mode}"] = diff
    return out


def test_world1_mesh_step_is_the_one_card_step():
    got = run_on_mesh(world1_rank, 1, 1, device="cpu", args=(WORLD1,))[0]
    assert len(got) == 6
    assert {k: v for k, v in got.items() if v} == {}


# ---------------------------------------------------------------------------
# _moe_a2a and the sync push on a 2x2 mesh
# ---------------------------------------------------------------------------

A2A = {"capacity_factor": 8.0, "moe_groups": 4}
TOPK = ps.FilterSpec(kind="topk", k_rows=5, random_rows=2)


def a2a_inputs():
    """The MoE block's weights (the port's, layer 0), tokens (8, 16, d)
    and the output projection, from numpy seeds."""
    cfg = reduced(ARCHITECTURES["mixtral-8x7b"]).replace(**A2A)
    p = model.layers(model.init_params(cfg, 3, device="cpu")["blocks"])[0]
    p = {k: v.detach().numpy() for k, v in p["moe"].items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 16, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((8, 16, cfg.d_model)).astype(np.float32)
    return cfg, p, x, r


def residuals(c: int) -> dict:
    rng = np.random.default_rng(60 + c)
    return {"w": rng.standard_normal((64, 8)).astype(np.float32),
            "b": rng.standard_normal(8).astype(np.float32),
            "blocks": {"wq": rng.standard_normal((2, 16, 4)).astype(
                np.float32)}}


def sync_key(c: int):
    return (0, device_mod.FILTER, 3, c)


def mesh_rank(mesh, dev) -> dict:
    """This rank's a2a output, its gradients and whether the all-to-all ran;
    then the sync push of its client's residual."""
    from torch.profiler import profile

    torch.set_num_threads(1)
    layers.COMPUTE_DTYPE = torch.float32
    cfg, p, x, r = a2a_inputs()
    rank = torch.distributed.get_rank()
    m, e = mesh.get_local_rank("model"), cfg.n_experts
    rows = slice(2 * rank, 2 * rank + 2)                 # (data, model)
    xs = torch.tensor(x[rows], requires_grad=True)
    experts = slice(m * e // 2, (m + 1) * e // 2)
    pl = {k: torch.tensor(v[experts] if k != "router" else v,
                          requires_grad=True) for k, v in p.items()}
    act = sharding.activation_spec(sharding.axis_sizes(mesh), "zero_batch")
    with layers.mesh_hooks(act, None, mesh), profile() as prof:
        taken = moe.a2a_applies(cfg, 8 * 16)
        out, aux = moe.moe_block(cfg, pl, xs)
        (out * torch.tensor(r[rows])).sum().backward()
    names = {ev.name.split(" (")[0] for ev in prof.events()}
    c = mesh.get_local_rank("data")
    push = sync.make_sync_fns(mesh, sync.SyncConfig(filter=TOPK))
    synced, left = push(model.map_tree(torch.tensor, residuals(c)),
                        sync_key(c))
    return {"taken": taken, "spans": sorted(n for n in names
                                           if n.startswith("all_to_all")),
            "out": out.detach().numpy(), "aux": float(aux.detach()),
            "grad_x": xs.grad.numpy(),
            "grad_w": {k: v.grad.numpy() for k, v in pl.items()},
            "synced": model.map_tree(lambda t: t.numpy(), synced),
            "left": model.map_tree(lambda t: t.numpy(), left)}


@pytest.fixture(scope="module")
def mesh_results():
    return run_on_mesh(mesh_rank, 2, 2, device="cpu")


def rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_moe_a2a_matches_the_reference_moe_block(mesh_results):
    cfg, p, x, r = a2a_inputs()
    assert all(res["taken"] for res in mesh_results)
    for res in mesh_results:
        assert res["spans"] == ["all_to_all moe combine",
                                "all_to_all moe combine grad",
                                "all_to_all moe dispatch",
                                "all_to_all moe dispatch grad"]
    got = np.concatenate([res["out"] for res in mesh_results])
    ref_cfg = ref_reduced(REF_ARCHS["mixtral-8x7b"]).replace(**A2A)
    saved = ref_layers.COMPUTE_DTYPE
    ref_layers.COMPUTE_DTYPE = jnp.float32
    try:
        want, _ = jax.jit(lambda pp, xx: ref_moe.moe_block(
            ref_cfg.replace(moe_groups=0), pp, xx))(
                jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    finally:
        ref_layers.COMPUTE_DTYPE = saved
    assert rel(got, np.asarray(want)) <= 1e-5

    # gradients against the port's one-process grouped dispatch
    saved = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    try:
        xt = torch.tensor(x, requires_grad=True)
        pt = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
        out, aux = moe.moe_block(cfg, pt, xt)
        (out * torch.tensor(r)).sum().backward()
        aux = float(aux.detach())
    finally:
        layers.COMPUTE_DTYPE = saved
    assert rel(got, out.detach().numpy()) <= 1e-5
    assert all(abs(res["aux"] - aux) <= 1e-6 * aux for res in mesh_results)
    assert rel(np.concatenate([res["grad_x"] for res in mesh_results]),
               xt.grad.numpy()) <= 1e-5
    e = cfg.n_experts
    for name, g in pt.items():
        # each expert's gradient from the rank that owns it (model rank m
        # of either data row; the two rows' shares summed), the router's
        # summed over every rank
        want_g = g.grad.numpy()
        if name == "router":
            got_g = sum(res["grad_w"][name] for res in mesh_results)
        else:
            got_g = np.concatenate([
                mesh_results[m]["grad_w"][name]
                + mesh_results[2 + m]["grad_w"][name] for m in range(2)])
            assert got_g.shape[0] == e
        assert rel(got_g, want_g) <= 1e-5, name


def test_sync_push_is_the_sum_of_the_clients_filters(mesh_results):
    sent = [sync.filter_tree(model.map_tree(torch.tensor, residuals(c)),
                             TOPK, sync_key(c)) for c in range(2)]
    want = model.map2(torch.add, sent[0], sent[1])
    for rank, res in enumerate(mesh_results):
        c = rank // 2
        for g, w in zip(model.leaves(res["synced"]), model.leaves(want)):
            np.testing.assert_array_equal(g, w.numpy())
        left = model.map2(torch.sub, model.map_tree(torch.tensor,
                                                    residuals(c)), sent[c])
        for g, w in zip(model.leaves(res["left"]), model.leaves(left)):
            np.testing.assert_array_equal(g, w.numpy())
    # the filter kept rows: top 5 and up to 2 random ones of 64
    kept = int((np.abs(mesh_results[0]["synced"]["w"]).sum(1) > 0).sum())
    assert 5 <= kept <= 14
