"""Megatron's tensor-parallel products (``layers.tensor_parallel``) block by
block on a 2×2 gloo mesh of four CPU processes (one ``run_on_mesh`` spawn
for the file), against the same block in one process, float32 compute:

* attention with uneven heads and a shared K/V head (H = 9, KV = 3 on two
  model ranks: heads 0-4 and 5-8 read K/V heads 0-1 and 1-2), with qk-norm
  and the q/k/v biases;
* attention with one head (model rank 1 holds none and adds zero);
* cross-attention (H = KV = 5: three heads and two);
* the SwiGLU and the GELU MLPs, and a SwiGLU MLP of d_ff 47 (stored split
  over d_model, computed in d_ff slices of 24 and 23);
* a MoE whose 4 experts split over the model ranks (expert parallel) and
  one whose 3 do not (each rank its d_ff slice of every expert), the
  token group spanning the data ranks (``moe_groups`` unset);
* the vocabulary-parallel embedding and chunked loss (vocabulary 500 in a
  512-row table, chunks of 8);
* RWKV-6's time mix with 3 heads of 8 (two heads and one; its
  projections stored split over their output channels, so moved within
  that dim), random mixes, ``w0``, ``u`` and output-norm scales, the
  decay LoRA split by its 32 columns, and with one head (rank 1 none);
  its channel mix of d_ff 47 (stored split over d_model, computed in
  d_ff slices of 24 and 23);
* Mamba-2 blocks: 3 heads of 16 (``w_in``'s 107 columns are odd, so it is
  stored split over d_model, as at 16×16; each rank takes its heads' z, x
  and dt columns and all of B and C); 4 heads, whose ``w_in`` is stored
  split over its 108 columns with the cut inside x (at 54) (an odd head count
  makes them odd: the two cases cannot be one); one head (rank 1 none);
* serving: a two-layer dense model's megatron prefill of 16 tokens and 3
  decode steps (``tests/test_torch_lm_serve_mesh.serve``) from weights
  re-laid by ``model.serve_params``, with 3 heads reading one K/V head
  (two heads and one) and with one head (rank 1 none); a two-layer RWKV-6
  model and a two-layer Zamba2 model (its shared block after each Mamba-2
  layer) with 3 SSM heads, whose SSM states stay split over their value
  dim and whose conv carries split over d_inner (24 and 24) are not the
  ranks' heads' channels (32 and 16).

Each rank holds its blocks of the weights under megatron's
``param_specs`` (FSDP over ``data``) and its rows of the inputs, runs the
block on ``layers.block_params``' compute slices, and takes the gradient
of a fixed random projection of the output (plus the MoE's aux loss, the
loss itself).  The outputs of the model ranks of a row block are equal
bit for bit and within FWD_TOL of one process's rows; the weights'
gradients (summed over ``data`` as the train step's sync sums them,
gathered whole) and the inputs' within GRAD_TOL (each relative to the
leaf's largest value; measured at most 4.2e-7 and 3.2e-7).  The served
prefill's logits within FWD_TOL of the one-process run's range (measured
3.1e-7), the decode steps' within SERVE_TOL (measured 3.2e-4: both runs
store the K/V cache in bf16, and one value of it lands one bf16 step
apart at these widths, 8 per head); the served SSMs' state, conv and
token-shift blocks within ``tests/test_torch_lm_serve_mesh.STATE_TOL`` of
one process's.  The tally of every collective a block called, by
process group, holds no all-gather over the model group (the decay
LoRA's activation moves by an all-to-all), and a decode step's none of a
weight; a served decode step gathers no SSM state.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig

B, S, D, F_FF = 4, 8, 24, 48
FWD_TOL = 1e-5
GRAD_TOL = 1e-5
SERVE_TOL = 1e-3       # decode steps after a bf16 cache (see below)
PROMPT, MAX_LEN = 16, 20


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfg(**kw) -> ModelConfig:
    base = dict(name="tp", family="dense", n_layers=1, d_model=D, n_heads=4,
                n_kv_heads=4, head_dim=8, d_ff=F_FF, vocab_size=512)
    return ModelConfig(**{**base, **kw})


def _rwkv(**kw) -> ModelConfig:
    return _cfg(family="ssm", ssm_kind="rwkv6", ssm_state=8, **kw)


def _mamba(**kw) -> ModelConfig:
    return _cfg(family="hybrid", ssm_kind="mamba2", ssm_state=4,
                ssm_conv=4, attn_every=1, **kw)


# name: (config, kind)
CASES = {
    "attn-uneven-gqa": (_cfg(n_heads=9, n_kv_heads=3, qk_norm=True,
                             attn_bias=True), "attn"),
    "attn-one-head": (_cfg(n_heads=1, n_kv_heads=1), "attn"),
    "xattn": (_cfg(n_heads=5, n_kv_heads=5, family="audio"), "xattn"),
    "mlp-swiglu": (_cfg(), "mlp"),
    "mlp-odd-dff": (_cfg(d_ff=47), "mlp"),
    "mlp-gelu": (_cfg(family="audio"), "gelu"),
    "moe-expert-parallel": (_cfg(family="moe", n_experts=4, top_k=2),
                            "moe"),
    "moe-dff-split": (_cfg(family="moe", n_experts=3, top_k=2), "moe"),
    "vocab": (_cfg(vocab_size=500, tie_embeddings=True), "vocab"),
    "rwkv-tmix-uneven": (_rwkv(ssm_heads=3), "tmix"),
    "rwkv-tmix-one-head": (_rwkv(ssm_heads=1), "tmix"),
    "rwkv-cmix-odd-dff": (_rwkv(ssm_heads=3, d_ff=47), "cmix"),
    "mamba-uneven": (_mamba(ssm_heads=3), "mamba"),
    "mamba-cut-in-x": (_mamba(ssm_heads=4), "mamba"),
    "mamba-one-head": (_mamba(ssm_heads=1), "mamba"),
}


# name: config of a served model
SERVE = {"serve-uneven-gqa": _cfg(n_layers=2, n_heads=3, n_kv_heads=1),
         "serve-one-head": _cfg(n_layers=2, n_heads=1, n_kv_heads=1),
         "serve-rwkv": _rwkv(n_layers=2, ssm_heads=3),
         "serve-zamba": _mamba(n_layers=2, ssm_heads=3, n_heads=3,
                               n_kv_heads=1)}


def serve_inputs(name: str) -> dict:
    from repro_torch.models import model

    seed = 50 + sorted(SERVE).index(name)
    tree = model.init_params(SERVE[name], seed, device="cpu")
    tokens = np.random.default_rng(seed).integers(
        0, SERVE[name].vocab_size, (B, PROMPT + 3)).astype(np.int32)
    return {"tree": model.map_tree(lambda t: t.numpy(), tree),
            "tokens": tokens}


def inputs(name: str) -> dict:
    """The case's weights (a one-block tree) and inputs, numpy, from a
    seed."""
    from repro_torch.models import layers, model, moe, ssm

    cfg, kind = CASES[name]
    seed = sorted(CASES).index(name)
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    rand = lambda t, lo, hi: torch.tensor(rng.uniform(lo, hi, t.shape)
                                          .astype(np.float32))
    if kind in ("attn", "xattn"):
        tree = {kind: layers.init_attention(cfg, gen, "cpu")}
        for k in ("bq", "bk", "bv", "q_norm", "k_norm"):
            if k in tree[kind]:       # not the init's zeros and ones
                tree[kind][k] = torch.tensor(rng.standard_normal(
                    tree[kind][k].shape).astype(np.float32))
    elif kind in ("mlp", "gelu"):
        tree = {"mlp": layers.init_mlp(cfg, gen, "cpu", kind={
            "mlp": "swiglu", "gelu": "gelu"}[kind])}
    elif kind == "moe":
        tree = {"moe": moe.init_moe(cfg, gen, "cpu")}
    elif kind == "tmix":     # mixes, w0, u, norm: not the init's constants
        p = ssm.init_rwkv6_time_mix(cfg, gen, "cpu")
        tree = {kind: {k: rand(v, 0.0, 1.0) if k.startswith("mix_")
                       else rand(v, -3.0, -1.0) if k == "w0"
                       else rand(v, -0.5, 0.5) if k == "u"
                       else rand(v, 0.5, 1.5) if k == "ln_out" else v
                       for k, v in p.items()}}
    elif kind == "cmix":
        p = ssm.init_rwkv6_channel_mix(cfg, gen, "cpu")
        tree = {kind: dict(p, mix_k=rand(p["mix_k"], 0.0, 1.0))}
    elif kind == "mamba":
        p = ssm.init_mamba2(cfg, gen, "cpu")
        tree = {kind: {k: rand(v, -0.5, 0.5) if k in ("conv_b", "dt_bias")
                       else rand(v, 0.5, 1.5) if k in ("d_skip", "norm")
                       else v for k, v in p.items()}}
    else:
        tree = {"embed": layers.init_embed(cfg, gen, "cpu")}
    x = {"x": rng.standard_normal((B, S, D)).astype(np.float32)}
    if kind == "xattn":
        x["mem"] = rng.standard_normal((B, 6, D)).astype(np.float32)
    if kind == "vocab":
        x["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
        x["targets"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
        x["mask"] = (rng.random((B, S)) < 0.8).astype(np.float32)
    x["proj"] = rng.standard_normal((B, S, D)).astype(np.float32)
    return {"tree": model.map_tree(lambda t: t.numpy(), tree), "x": x}


def run_block(name: str, tree: dict, x: dict) -> tuple:
    """(output, loss) of the case's block on ``tree`` (the compute
    slices under the hooks' layout) and the inputs ``x``."""
    from repro_torch.models import layers, model, moe, ssm
    from repro_torch.train.loss import chunked_ce_loss

    cfg, kind = CASES[name]
    pos = torch.arange(S)
    if kind == "attn":
        out = layers.attention_block(cfg, tree["attn"], x["x"], pos)
    elif kind == "xattn":
        mk, mv = model._cross_kv(tree, x["mem"])
        out = layers.cross_attention_block(cfg, tree["xattn"], x["x"], mk, mv)
    elif kind in ("mlp", "gelu"):
        out = layers.mlp_block(tree["mlp"], x["x"])
    elif kind == "moe":
        out, aux = moe.moe_block(cfg, tree["moe"], x["x"])
        return out, (out * x["proj"]).sum() + aux
    elif kind == "tmix":
        out = ssm.rwkv6_time_mix(cfg, tree["tmix"], x["x"])[0]
    elif kind == "cmix":
        out = ssm.rwkv6_channel_mix(cfg, tree["cmix"], x["x"])[0]
    elif kind == "mamba":
        out = ssm.mamba2_block(cfg, tree["mamba"], x["x"])[0]
    else:
        out = model._embed(cfg, tree, x["tokens"])
        ce = chunked_ce_loss(cfg, tree, x["x"], x["targets"], x["mask"],
                             chunk=8)
        return out, (out * x["proj"]).sum() + ce
    return out, (out * x["proj"]).sum()


def _float32():
    from repro_torch.models import layers
    layers.COMPUTE_DTYPE = torch.float32


def tp_rank(mesh, dev, cases: dict, served: dict) -> dict:
    """One rank: each case's block on its blocks and rows; its output,
    its input gradients, the weights' gradients summed over ``data`` and
    gathered whole, and the tally of the collectives by group; then each
    served model's logits (its rows) and its decode steps' collectives."""
    from tests.test_torch_lm_serve_mesh import serve
    import torch.distributed as dist

    from repro_torch.core import collectives
    from repro_torch.models import layers, model
    from repro_torch.train import sharding

    torch.set_num_threads(1)
    _float32()
    data = mesh.get_group("data")
    out = {"coords": {a: mesh.get_local_rank(a) for a in
                      mesh.mesh_dim_names},
           "model_group": tuple(dist.get_process_group_ranks(
               mesh.get_group("model")))}
    for name, case in cases.items():
        full = model.map_tree(torch.tensor, case["tree"])
        specs = sharding.param_specs(full, mesh=mesh, fsdp=True)
        local = model.map_tree(lambda t: t.requires_grad_(True),
                               sharding.shard_tree(full, specs, mesh))
        xs = {k: torch.tensor(v) for k, v in case["x"].items()}
        xs = {k: sharding.local_shard(v, sharding.data_specs(v, mesh), mesh)
              .clone() for k, v in xs.items()}
        for k in ("x", "mem"):
            if k in xs:
                xs[k].requires_grad_(True)
        with layers.mesh_hooks(None, specs, mesh), \
                collectives.tally(by="group") as counts:
            assert layers.tensor_parallel()
            # the tables' users take the storage blocks themselves
            got, loss = run_block(name, local if CASES[name][1] == "vocab"
                                  else layers.block_params(
                                      CASES[name][0], local, specs), xs)
            wrt = model.leaves(local) + [xs[k] for k in ("x", "mem")
                                         if k in xs]
            grads = torch.autograd.grad(loss, wrt)
        n = len(model.leaves(local))
        wgrads = []
        for g, sp in zip(grads[:n], model.leaves(specs)):
            if "data" not in sharding.spec_axes(sp):   # the step's sync
                collectives.all_reduce_sum(g, data, "grad")
            wgrads.append(g)
        full_g = sharding.gather_tree(model.unflatten(local, wgrads), specs,
                                      mesh)
        out[name] = {"out": got.detach().numpy(),
                     "xgrads": [g.numpy() for g in grads[n:]],
                     "wgrads": [g.numpy() for g in model.leaves(full_g)],
                     "tally": counts}
    for name, case in served.items():
        cfg = SERVE[name]
        params = model.serve_params(cfg, sharding.shard_tree(
            model.map_tree(torch.tensor, case["tree"]),
            model.serve_param_specs(cfg, mesh), mesh), mesh)
        run = serve(cfg, params, case["tokens"], PROMPT, MAX_LEN, mesh)
        out[name] = {"logits": [x.numpy() for x in run["logits"]],
                     "decode": run["decode_collectives"],
                     "states": {k: v.numpy() for k, v in
                                run["cache"]["layers"].items()
                                if k not in ("k", "v")}}
    return out


def one_process(name: str, case: dict) -> dict:
    from repro_torch.models import layers, model

    saved = layers.COMPUTE_DTYPE
    _float32()
    try:
        tree = model.map_tree(lambda t: torch.tensor(t).requires_grad_(True),
                              case["tree"])
        xs = {k: torch.tensor(v) for k, v in case["x"].items()}
        for k in ("x", "mem"):
            if k in xs:
                xs[k].requires_grad_(True)
        got, loss = run_block(name, tree, xs)
        wrt = model.leaves(tree) + [xs[k] for k in ("x", "mem") if k in xs]
        grads = torch.autograd.grad(loss, wrt)
        n = len(model.leaves(tree))
        return {"out": got.detach().numpy(),
                "wgrads": [g.numpy() for g in grads[:n]],
                "xgrads": [g.numpy() for g in grads[n:]]}
    finally:
        layers.COMPUTE_DTYPE = saved


@pytest.fixture(scope="module")
def runs():
    from repro_torch.launch.mesh import run_on_mesh

    cases = {name: inputs(name) for name in CASES}
    served = {name: serve_inputs(name) for name in SERVE}
    ranks = run_on_mesh(tp_rank, 2, 2, device="cpu", args=(cases, served),
                        timeout=300)
    return {**cases, **served}, ranks


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp_block_matches_one_process(name, runs):
    cases, ranks = runs
    want = one_process(name, cases[name])
    half = B // 2
    by_rows: dict = {}
    for r in ranks:
        d = r["coords"]["data"]
        rows = slice(d * half, (d + 1) * half)
        got = r[name]["out"]
        if d in by_rows:
            assert np.array_equal(by_rows[d], got), (name, "model ranks")
        by_rows[d] = got
        assert _rel(got, want["out"][rows]) <= FWD_TOL, name
        for g, w in zip(r[name]["xgrads"], want["xgrads"]):
            assert _rel(g, w[rows]) <= GRAD_TOL, (name, "input grad")
        for i, (g, w) in enumerate(zip(r[name]["wgrads"], want["wgrads"])):
            assert _rel(g, w) <= GRAD_TOL, (name, "weight grad", i)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp_block_gathers_no_weight_over_model(name, runs):
    _, ranks = runs
    for r in ranks:
        over_model = [k for k in r[name]["tally"]
                      if k.startswith("all_gather")
                      and k.endswith(f"@{r['model_group']}")]
        assert over_model == [], (name, over_model)
        kinds = {k.split()[0] for k in r[name]["tally"]}
        assert "all_reduce" in kinds, (name, r[name]["tally"])


@pytest.mark.parametrize("name", sorted(SERVE))
def test_tp_serving_matches_one_process(name, runs):
    from repro_torch.models import layers, model
    from tests.test_torch_lm_serve_mesh import STATE_TOL, block, serve

    cases, ranks = runs
    saved = layers.COMPUTE_DTYPE
    _float32()
    try:
        one = serve(SERVE[name], model.map_tree(
            torch.tensor, cases[name]["tree"]), cases[name]["tokens"],
            PROMPT, MAX_LEN)
    finally:
        layers.COMPUTE_DTYPE = saved
    want = one["logits"]
    layout = model.cache_layout(SERVE[name], {"data": 2, "model": 2}, B,
                                MAX_LEN)["layers"]
    half = B // 2
    for r in ranks:
        for k, got in r[name]["states"].items():      # SSM states, shifts
            w = block(one["cache"]["layers"][k].numpy(), layout[k],
                      r["coords"], {"data": 2, "model": 2})
            assert got.shape == w.shape, (name, k)
            scale = max(float(np.abs(w).max()), 1.0)
            assert np.abs(got - w).max() <= STATE_TOL * scale, (name, k)
        assert not any(k.startswith("all_gather decode state")
                       for k in r[name]["decode"]), name
        rows = slice(r["coords"]["data"] * half,
                     (r["coords"]["data"] + 1) * half)
        for i, (g, w) in enumerate(zip(r[name]["logits"], want)):
            w = w.numpy()[rows]
            err = np.abs(g - w).max() / (w.max() - w.min())
            assert err <= (FWD_TOL if i == 0 else SERVE_TOL), (name, i, err)
        moved = [k for k in r[name]["decode"] if "weights" in k
                 or "relayout" in k]
        assert moved == [], (name, moved)
