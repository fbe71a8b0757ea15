"""zero_seq's rank-local MoE token groups (``layers.seq_groups``) on gloo
meshes of four CPU processes, 2 × 2 and 1 × 4, both built in one
``run_on_mesh`` spawn for the file, float32 compute, mixtral-8x7b at
``reduced()`` (4 experts, top 2, d 256) with capacity factor 0.5, so
that every group drops tokens, and ``moe_groups`` = the batch rows (a
group a row, as the dry run sets it under zero_seq):

* ``moe_block`` on 4 rows of 32 tokens (one group a rank on both meshes)
  and on 2 rows (2 × 2: the second model rank of each data rank holds no
  group; 1 × 4: ranks 1 and 3 hold none), each rank its rows and
  positions: its block of the output, the aux loss, its block of the
  input's gradient and the router's and experts' gradients (summed over
  the ranks) within TOL of the leaf's largest value of the port's one
  process on the same tokens, and the output within TOL of the
  reference's ``moe_block`` with the same ``moe_groups``;
* a zero_seq prefill of 16 tokens and 3 decode steps (``tests/
  test_torch_lm_serve_mesh.serve``) against one process, by the serve-mesh
  file's bounds, its ``moe seq`` exchange taken and no token-group gather;
* a zero_seq train step (4 × 32): its loss within the mesh files' TOL of
  one process's, no ``moe tokens``, ``moe gates`` or ``moe ids`` gather
  in its tally, and rank 0's ``moe seq`` exchanges (the tokens, the
  routes, the outputs back, their gradients) equal in calls and bytes to
  ``tools/torch_mesh_tally.py``'s count of the same step on a fake group;
  no tensor of the step left in a reference cycle (such tensors, the
  gathered weights among them, lived until the garbage collector ran,
  which raised the dry run's peaks of deep models);
* mutants: a group sent to the wrong model rank (ranks 0 and 1 swap their
  blocks on the way out), and the return exchange skipped; the outputs
  part from one process's by far more than TOL.
"""

from __future__ import annotations

import gc
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_lm_common import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
S, D_SEED = 32, 81
CF = 0.5
ROWS = (4, 2)
TOL = 1e-5          # of the leaf's largest value
MUTANT_MIN = 1e-2   # a mutant must part by at least this
MUTANTS = ("wrong-rank", "back-skipped")
PROMPT, MAX_LEN, PREFILL_SEED = 16, 20, 83
TRAIN_ROWS, TRAIN_SEED = 4, 85
MOE_SEQ = ("all_to_all moe seq", "all_to_all moe seq route",
           "all_to_all moe seq back", "all_to_all moe seq grad",
           "all_to_all moe seq route grad", "all_to_all moe seq back grad")
GATHERS = ("all_gather moe tokens", "all_gather moe gates",
           "all_gather moe ids")


def config(rows: int):
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import ARCHITECTURES
    return reduced(ARCHITECTURES["mixtral-8x7b"]).replace(
        vocab_size=512, capacity_factor=CF, moe_groups=rows)


def inputs(rows: int) -> dict:
    """The block's weights, tokens and the output's projection, numpy,
    from a seed."""
    cfg = config(rows)
    rng = np.random.default_rng(D_SEED + rows)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    f32 = lambda scale, *shape: (rng.standard_normal(shape)
                                 * scale).astype(np.float32)
    w = {"router": f32(d ** -0.5, d, e), "w_gate": f32(d ** -0.5, e, d, f),
         "w_up": f32(d ** -0.5, e, d, f), "w_down": f32(f ** -0.5, e, f, d)}
    return {"w": w, "x": f32(1.0, rows, S, d), "proj": f32(1.0, rows, S, d)}


def _float32():
    from repro_torch.models import layers
    layers.COMPUTE_DTYPE = torch.float32


def _block_run(rows: int, case: dict, mesh) -> dict:
    """The block on the rank's rows and positions under zero_seq's hooks:
    its output block, aux loss, input gradient block and the weights'
    gradients summed over the ranks."""
    from repro_torch.core import collectives
    from repro_torch.models import layers, moe
    from repro_torch.train import sharding

    cfg = config(rows)
    w = {k: torch.tensor(v).requires_grad_(True)
         for k, v in case["w"].items()}
    spec = sharding.P("data", "model")
    x = sharding.local_shard(torch.tensor(case["x"]), spec,
                             mesh).clone().requires_grad_(True)
    proj = sharding.local_shard(torch.tensor(case["proj"]), spec, mesh)
    act = sharding.activation_spec(mesh, "zero_seq")
    with layers.mesh_hooks(act, None, mesh):
        out, aux = moe.moe_block(cfg, w, x)
        loss = (out * proj).sum() + aux
        grads = torch.autograd.grad(loss, list(w.values()) + [x])
    for g in grads[:-1]:
        collectives.all_reduce_sum(g, None, "grad")
    return {"out": out.detach().numpy(), "aux": float(aux.detach()),
            "wgrads": [g.numpy() for g in grads[:-1]],
            "xgrad": grads[-1].numpy()}


def _mutant(kind: str):
    """Patch the exchange ``kind`` breaks; returns the restore."""
    from repro_torch.models import layers

    if kind == "wrong-rank":
        saved = layers.to_groups

        def swapped(x, parts, what):
            have, want = parts
            return saved(x, (have, [want[1], want[0]] + list(want[2:])),
                         what)
        layers.to_groups = swapped
        return lambda: setattr(layers, "to_groups", saved)
    saved = layers.from_groups
    layers.from_groups = lambda x, parts, b, what: x.reshape(
        (b, -1) + tuple(x.shape[1:]))
    return lambda: setattr(layers, "from_groups", saved)


def _prefill(case: dict, mesh) -> dict:
    from repro_torch.core import collectives
    from repro_torch.models import model
    from repro_torch.train import sharding
    from tests.test_torch_lm_mesh_common import tree_of
    from tests.test_torch_lm_serve_mesh import serve

    cfg = config(4)
    params = model.serve_params(cfg, sharding.shard_tree(
        tree_of(case["tree"]), model.serve_param_specs(cfg, mesh), mesh),
        mesh)
    with collectives.tally(by="what") as counts:
        run = serve(cfg, params, case["tokens"], PROMPT, MAX_LEN, mesh,
                    "zero_seq")
    return {"logits": [x.numpy() for x in run["logits"]],
            "collectives": sorted(counts)}


def _train(data: list, mesh, dev) -> dict:
    from repro_torch.core import collectives
    from repro_torch.optim import adamw
    from repro_torch.train import sharding, train_step
    from tests.test_torch_lm_mesh_common import TRAIN, tree_of, weights

    cfg = config(TRAIN_ROWS)
    specs = train_step.param_layout(cfg, mesh, "zero_seq")
    params = sharding.shard_tree(tree_of(weights(cfg, TRAIN_SEED)), specs,
                                 mesh)
    step = train_step.make_train_step(cfg, train_step.TrainConfig(**TRAIN),
                                      dev, mesh=mesh, mode="zero_seq")
    opt = adamw.init(params)
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        with collectives.tally(by="what") as counts:
            _, _, met = step(params, opt, data[0])
        gc.collect()
        cyclic = sum(isinstance(o, torch.Tensor) for o in gc.garbage)
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    return {"loss": float(met["loss"]), "tally": counts, "cyclic": cyclic}


def moe_seq_rank(mesh22, dev, blocks: dict, prefill: dict,
                 train: list) -> dict:
    """One rank: every block case, the prefill and the train step on the
    2 × 2 mesh the spawn built and on a 1 × 4 mesh over the same ranks,
    then the mutants on each."""
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    _float32()
    meshes = {"2x2": mesh22, "1x4": make_host_mesh(1, 4, device=dev)}
    out = {}
    for key, mesh in meshes.items():
        rec = {"coords": {a: mesh.get_local_rank(a)
                          for a in mesh.mesh_dim_names}}
        for rows, case in blocks.items():
            rec[rows] = _block_run(rows, case, mesh)
        rec["prefill"] = _prefill(prefill, mesh)
        rec["train"] = _train(train, mesh, dev)
        for mutant in MUTANTS:
            restore = _mutant(mutant)
            try:
                rec[mutant] = _block_run(4, blocks[4], mesh)
            finally:
                restore()
        out[key] = rec
    return out


@pytest.fixture(scope="module")
def runs():
    from repro_torch.launch.mesh import run_on_mesh
    from tests.test_torch_lm_mesh_common import batches, weights
    from tests.test_torch_lm_serve_mesh import tokens_of

    blocks = {rows: inputs(rows) for rows in ROWS}
    prefill = {"tree": weights(config(4), PREFILL_SEED),
               "tokens": tokens_of(PREFILL_SEED, PROMPT + 3)}
    train = batches(config(TRAIN_ROWS), TRAIN_SEED + 1, n=1,
                    b=TRAIN_ROWS, s=S)
    ranks = run_on_mesh(moe_seq_rank, 2, 2, device="cpu",
                        args=(blocks, prefill, train), timeout=300)
    return blocks, prefill, train, ranks


def one_process(rows: int, case: dict) -> dict:
    """The block on all the tokens in one process."""
    from repro_torch.models import layers, moe

    saved = layers.COMPUTE_DTYPE
    _float32()
    try:
        w = {k: torch.tensor(v).requires_grad_(True)
             for k, v in case["w"].items()}
        x = torch.tensor(case["x"]).requires_grad_(True)
        out, aux = moe.moe_block(config(rows), w, x)
        loss = (out * torch.tensor(case["proj"])).sum() + aux
        grads = torch.autograd.grad(loss, list(w.values()) + [x])
        return {"out": out.detach().numpy(), "aux": float(aux.detach()),
                "wgrads": [g.numpy() for g in grads[:-1]],
                "xgrad": grads[-1].numpy()}
    finally:
        layers.COMPUTE_DTYPE = saved


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _sizes(key: str) -> dict:
    d, m = MESHES[key]
    return {"data": d, "model": m}


def _block(x: np.ndarray, coords: dict, sizes: dict) -> np.ndarray:
    """The rank's rows (over ``data``) and positions (over ``model``) of a
    global (B, S, ...) array."""
    nb = x.shape[0] // sizes["data"]
    ns = x.shape[1] // sizes["model"]
    return x[coords["data"] * nb:(coords["data"] + 1) * nb,
             coords["model"] * ns:(coords["model"] + 1) * ns]


def _whole(ranks: list, key: str, name) -> np.ndarray:
    """A case's output put together from the ranks' blocks."""
    sizes = _sizes(key)
    blocks = {}
    for r in ranks:
        c = r[key]["coords"]
        blocks[(c["data"], c["model"])] = r[key][name]["out"]
    return np.concatenate([np.concatenate(
        [blocks[(i, j)] for j in range(sizes["model"])], axis=1)
        for i in range(sizes["data"])], axis=0)


BLOCK_IDS = [(k, rows) for k in MESHES for rows in ROWS]


@pytest.mark.parametrize("key,rows", BLOCK_IDS,
                         ids=[f"{k}-rows{r}" for k, r in BLOCK_IDS])
def test_rank_local_groups_match_one_process(key, rows, runs):
    blocks, _, _, ranks = runs
    want = one_process(rows, blocks[rows])
    sizes = _sizes(key)
    for rank in ranks:
        got, c = rank[key][rows], rank[key]["coords"]
        assert _rel(got["out"], _block(want["out"], c, sizes)) <= TOL
        assert abs(got["aux"] - want["aux"]) <= TOL * abs(want["aux"])
        assert _rel(got["xgrad"], _block(want["xgrad"], c, sizes)) <= TOL
        for i, (g, w) in enumerate(zip(got["wgrads"], want["wgrads"])):
            assert _rel(g, w) <= TOL, ("weight grad", i)


@pytest.mark.parametrize("key,rows", BLOCK_IDS,
                         ids=[f"{k}-rows{r}" for k, r in BLOCK_IDS])
def test_rank_local_groups_match_the_reference(key, rows, runs):
    import jax.numpy as jnp

    from repro.configs.base import reduced as ref_reduced
    from repro.configs.registry import ARCHITECTURES as REF_ARCHS
    from repro.models import moe as ref_moe
    from tests.test_torch_lm_common import float32_compute, ref_jit

    blocks, _, _, ranks = runs
    case = blocks[rows]
    ref_cfg = ref_reduced(REF_ARCHS["mixtral-8x7b"]).replace(
        vocab_size=512, capacity_factor=CF, moe_groups=rows)
    p = {k: jnp.asarray(v) for k, v in case["w"].items()}
    with float32_compute():
        want, want_aux = ref_jit(lambda a: ref_moe.moe_block(
            ref_cfg, p, a))(jnp.asarray(case["x"]))
    assert _rel(_whole(ranks, key, rows), np.asarray(want)) <= TOL
    for rank in ranks:
        assert abs(rank[key][rows]["aux"] - float(want_aux)) <= \
            TOL * abs(float(want_aux))


def test_every_group_drops_tokens():
    """Capacity factor 0.5 leaves each expert 8 slots for a group's 64
    (token, slot) pairs over 4 experts: every group drops some."""
    from repro_torch.models import moe

    cfg = config(4)
    case = inputs(4)
    x = torch.tensor(case["x"])
    probs = torch.softmax(x.reshape(-1, cfg.d_model)
                          @ torch.tensor(case["w"]["router"]), -1)
    _, ids = moe.top_k(probs, cfg.top_k)
    c = moe.capacity(cfg, S)
    for g in ids.reshape(4, S * cfg.top_k):
        assert int(torch.bincount(g, minlength=cfg.n_experts).max()) > c


@pytest.mark.parametrize("key,mutant", [(k, m) for k in MESHES
                                        for m in MUTANTS])
def test_broken_exchange_is_wrong(key, mutant, runs):
    blocks, _, _, ranks = runs
    want = one_process(4, blocks[4])
    sizes = _sizes(key)
    worst = max(_rel(rank[key][mutant]["out"],
                     _block(want["out"], rank[key]["coords"], sizes))
                for rank in ranks)
    assert worst > MUTANT_MIN, (mutant, worst)


@pytest.mark.parametrize("key", sorted(MESHES))
def test_zero_seq_prefill_matches_one_process(key, runs):
    from repro_torch.models import layers
    from tests.test_torch_lm_mesh_common import tree_of
    from tests.test_torch_lm_serve_mesh import LOGITS_TOL, rel_range, serve

    _, prefill, _, ranks = runs
    cfg = config(4)
    saved = layers.COMPUTE_DTYPE
    _float32()
    try:
        one = serve(cfg, tree_of(prefill["tree"]), prefill["tokens"],
                    PROMPT, MAX_LEN)
    finally:
        layers.COMPUTE_DTYPE = saved
    sizes = _sizes(key)
    vocab = cfg.vocab_size
    for rank in ranks:
        r, c = rank[key]["prefill"], rank[key]["coords"]
        nb = 4 // sizes["data"]
        for i, (g, w) in enumerate(zip(r["logits"], one["logits"])):
            w = w.numpy()[c["data"] * nb:(c["data"] + 1) * nb]
            assert rel_range(g[..., :vocab], w[..., :vocab]) <= LOGITS_TOL, i
        # the prefill's groups moved over ``model``, none gathered
        assert "all_to_all moe seq" in r["collectives"]
        assert not set(GATHERS) & set(r["collectives"]), r["collectives"]


@pytest.fixture(scope="module")
def tool_counts():
    """``tools/torch_mesh_tally.py``'s count of the train step on a fake
    group, each mesh, float32 compute as the ranks'."""
    from repro_torch.models import layers

    spec = importlib.util.spec_from_file_location(
        "torch_mesh_tally", ROOT / "tools" / "torch_mesh_tally.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = {}
    saved = layers.COMPUTE_DTYPE
    _float32()
    try:
        for key, mesh in MESHES.items():
            rec = tool.step_record(config(TRAIN_ROWS), "train", TRAIN_ROWS,
                                   S, mesh, "zero_seq")
            assert rec["status"] == "ok", rec.get("error")
            assert rec["moe_groups"] == TRAIN_ROWS
            out[key] = rec["collectives"]
    finally:
        layers.COMPUTE_DTYPE = saved
    return out


@pytest.mark.parametrize("key", sorted(MESHES))
def test_train_step_exchanges_only_over_model(key, runs, tool_counts):
    from tests.test_torch_lm_mesh_common import TOL as MESH_TOL
    from tests.test_torch_lm_mesh_common import port_one, weights

    _, _, train, ranks = runs
    cfg_kw = {"capacity_factor": CF, "moe_groups": TRAIN_ROWS}
    want = port_one("mixtral-8x7b", cfg_kw, "zero_seq",
                    weights(config(TRAIN_ROWS), TRAIN_SEED),
                    train)["metrics"][0]["loss"]
    for rank in ranks:
        r = rank[key]["train"]
        assert not set(GATHERS) & set(r["tally"]), key
        assert set(MOE_SEQ) <= set(r["tally"]), sorted(r["tally"])
        assert abs(r["loss"] - want) / abs(want) <= MESH_TOL["loss1"]
        # nothing of the step waits for the garbage collector to be freed
        assert r["cyclic"] == 0, r["cyclic"]
    mine = ranks[0][key]["train"]["tally"]
    tool = tool_counts[key]
    for name in MOE_SEQ:
        assert (mine[name]["calls"], mine[name]["bytes"]) == (
            tool[name]["calls"], tool[name]["bytes"]), name
    assert not set(GATHERS) & set(tool)
