"""Serving the LM over a mesh: the port's ``prefill`` and ``decode_step``
in the serve layout (``model.serve_hooks``) on a 2×2 gloo mesh of four
CPU processes (``launch.mesh.run_on_mesh``), against the port's own
one-process prefill and decode on the same weights and tokens, both in
float32 (``COMPUTE_DTYPE`` patched), at ``reduced()`` size, vocabulary
512, batch 4:

* smollm-360m, prefill of 16 tokens under megatron, zero_seq and
  zero_batch (the cache blocks moved from the rank's rows to the cache's
  by an all-to-all over ``model``), each then 3 decode steps;
* mixtral-8x7b under megatron: window 16 and ``max_len`` 24, so the
  cache is a 16-slot ring split 8 and 8 over ``model``; a 14-token prompt
  and 3 steps write slots 14, 15 (rank 1's block) and 0 (rank 0's);
* rwkv6-3b under megatron and zero_batch, zamba2-2.7b under megatron and
  zero_seq: the SSM and conv states and token shifts split over
  ``model``; under megatron each model rank projects its heads, every
  head's per-token inputs are gathered and the rank steps its block of
  the state in place (its value dim), the token shifts and, where its
  block is not the rank's heads' channels, the conv carry gathered at
  use; zamba2's zero_seq prefill runs each rank's Mamba-2 blocks on its
  positions and takes the carries from the last model rank.

Each rank's cache leaves have the shapes ``local_shape`` gives under
``cache_specs``; its blocks equal the one-process cache's blocks (the K/V
within 2^-8 of the leaf's largest value, measured 9.5e-4: they are
stored in bf16, where one rounding step of a product that moved by ~1e-7
shows; the states within 1e-5, measured 1.4e-6); the two model ranks of a
row block return the same logits, bit for bit; the logits of the prefill
and of every decode step are within 5e-5 of the logits' range of the
one-process run's (measured at most 9.8e-6, mixtral, and 9.1e-6, zamba2;
1.9e-6 smollm, 4.8e-7 rwkv6: the partial softmaxes' log-sum-exp combine
reorders float32 sums, ~1e-6, and a key or value that lands one bf16
step apart in the cache moves the next steps' logits by ~1e-5); no
decode step gathers a K/V cache, an SSM state, a block weight or a table
(the tally of its collectives by name holds the new token's q/k/v, the
softmax partials', the logits' vocabulary slices', the MoE's token
gathers, the SSM heads' per-token inputs and the token shifts' and conv
carries' gathers only), and every attention step sums its embedding and
its heads' output projection over ``model`` (megatron's tensor-parallel
products; the serve weights re-laid into their compute split once,
``model.serve_params``).
smollm's decode steps on the mesh also match the reference's decode as
its dry run lowers it (``make_lowering_spec``'s decode kind jitted on a
forced 4-device ``make_host_mesh(2, 2)``, from its own prefill), within
1e-4 of the range (measured 1.5e-5).  At world size 1
(a 1×1 gloo mesh in this process) prefill and decode at the default bf16
compute, from bf16 serve weights, are the one-process runs bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import ARCHITECTURES
from repro_torch.models import layers, model
from repro_torch.train import sharding
from tests.test_torch_lm_mesh_common import (reference_decode_result,
                                             start_reference_decode, tree_of,
                                             weights)

VOCAB, BATCH, STEPS = 512, 4, 3
# name: (arch, prefill modes, prompt, max_len, seed)
JOBS = {"smollm-360m": ("smollm-360m", ("megatron", "zero_seq",
                                        "zero_batch"), 16, 20, 51),
        "mixtral-8x7b": ("mixtral-8x7b", ("megatron",), 14, 24, 53),
        "rwkv6-3b": ("rwkv6-3b", ("megatron", "zero_batch"), 16, 20, 55),
        "zamba2-2.7b": ("zamba2-2.7b", ("megatron", "zero_seq"), 16, 20, 57)}
LOGITS_TOL = 5e-5      # of the one-process logits' range
REF_TOL = 1e-4         # against the reference's served decode
KV_TOL = 2.0 ** -8     # bf16 K/V blocks, of a value
STATE_TOL = 1e-5       # float32 states, of the leaf's largest value
# what a decode step may gather: the new token's q/k/v of every head, the
# softmax partials, the logits' vocabulary slices, the MoE's token group
# over ``data``, the SSM heads' per-token inputs, the token shifts and the
# conv carries (activations of at most (B, W-1, d_inner)); never an SSM
# state, a block weight or a table
DECODE_GATHERS = {"all_gather decode qkv", "all_gather decode softmax",
                  "all_gather logits", "all_gather moe tokens",
                  "all_gather moe gates", "all_gather moe ids",
                  "all_gather decode inputs", "all_gather decode shift",
                  "all_gather decode conv"}
# the activations' sums over ``model`` every attention decode step makes
DECODE_SUMS = {"all_reduce embed", "all_reduce attn out"}


def config(arch: str):
    return reduced(ARCHITECTURES[arch]).replace(vocab_size=VOCAB)


def tokens_of(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, VOCAB, (BATCH, n)).astype(np.int32)


def serve(cfg, params, tokens: np.ndarray, s: int, max_len: int,
          mesh=None, mode: str = "megatron") -> dict:
    """Prefill of ``tokens[:, :s]`` then STEPS decode steps fed the next
    tokens; on ``mesh`` the rank's rows under ``mode``'s layout and the
    serve hooks.  Returns each call's logits, the cache and the tally of
    the decode steps' collectives by name."""
    from repro_torch.core import collectives

    prompt = torch.as_tensor(tokens[:, :s])
    if mesh is None:
        logits, cache = model.prefill(cfg, params, {"tokens": prompt},
                                      max_len)
        out = [logits]
        for i in range(STEPS):
            logits, cache = model.decode_step(
                cfg, params, cache,
                torch.as_tensor(tokens[:, s + i:s + i + 1]))
            out.append(logits)
        return {"logits": out, "cache": cache}
    with model.serve_hooks(cfg, mesh, batch=BATCH, max_len=max_len, seq=s,
                           mode=mode):
        spec = sharding.data_specs(prompt, mesh, mode)
        logits, cache = model.prefill(
            cfg, params, {"tokens": sharding.local_shard(prompt, spec, mesh)},
            max_len)
    out = [logits]
    with model.serve_hooks(cfg, mesh, batch=BATCH, max_len=max_len), \
            collectives.tally(by="what") as counts:
        for i in range(STEPS):
            t = torch.as_tensor(tokens[:, s + i:s + i + 1])
            t = sharding.local_shard(t, sharding.data_specs(t, mesh), mesh)
            logits, cache = model.decode_step(cfg, params, cache, t)
            out.append(logits)
    return {"logits": out, "cache": cache, "decode_collectives": counts}


def serve_rank(mesh, dev, jobs: dict) -> dict:
    """One rank's served runs of ``jobs`` ({name: (arch, modes, prompt,
    max_len, np_tree, tokens)}), float32 compute on one thread: per mode
    its logits and rows, its cache blocks and their shapes against
    ``local_shape``, the decode steps' collectives."""
    torch.set_num_threads(1)
    layers.COMPUTE_DTYPE = torch.float32
    out = {"coords": {a: mesh.get_local_rank(a)
                      for a in mesh.mesh_dim_names}}
    for name, (arch, modes, s, max_len, np_tree, tokens) in jobs.items():
        cfg = config(arch)
        params = model.serve_params(cfg, sharding.shard_tree(
            tree_of(np_tree), model.serve_param_specs(cfg, mesh), mesh),
            mesh)
        layout = model.cache_layout(cfg, mesh, BATCH, max_len)
        full = model.cache_shapes(cfg, BATCH, max_len)
        for mode in modes:
            assert sharding.resolve_mode(mesh, mode, BATCH, s) == mode
            run = serve(cfg, params, tokens, s, max_len, mesh, mode)
            wrong = []
            sharding.map_with_path(
                lambda p, x: None if tuple(x.shape) == sharding.local_shape(
                    model.specs_at(full, p).shape, model.specs_at(layout, p),
                    mesh) else wrong.append(p), run["cache"])
            out[(name, mode)] = {
                "logits": [x.numpy() for x in run["logits"]],
                "rows": sharding.data_specs(torch.empty(BATCH, s), mesh,
                                            mode)[0],
                "cache": model.map_tree(lambda x: x.float().numpy(),
                                        run["cache"]),
                "wrong_shapes": wrong,
                "decode_collectives": run["decode_collectives"]}
    return out


def block(x: np.ndarray, spec, coords: dict, sizes: dict) -> np.ndarray:
    """A rank's block of the full ``x`` under ``spec`` at ``coords``."""
    for dim, entry in enumerate(spec):
        axes = sharding.entry_axes(entry)
        if axes:
            idx, n = 0, 1
            for a in axes:
                idx, n = idx * sizes[a] + coords[a], n * sizes[a]
            size = x.shape[dim] // n
            x = np.take(x, range(idx * size, (idx + 1) * size), axis=dim)
    return x


def one_process(name: str, job: tuple) -> dict:
    arch, _, s, max_len, np_tree, tokens = job
    saved = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    try:
        return serve(config(arch), tree_of(np_tree), tokens, s, max_len)
    finally:
        layers.COMPUTE_DTYPE = saved


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.mesh import run_on_mesh

    torch.set_num_threads(1)
    jobs = {}
    for name, (arch, modes, s, max_len, seed) in JOBS.items():
        jobs[name] = (arch, modes, s, max_len, weights(config(arch), seed),
                      tokens_of(seed + 1, s + STEPS))
    arch, _, s, max_len, np_tree, tokens = jobs["smollm-360m"]
    handle = start_reference_decode(tmp_path_factory.mktemp("serve"), arch,
                                    np_tree, tokens, s, max_len, STEPS)
    try:
        ranks = run_on_mesh(serve_rank, 2, 2, device="cpu", args=(jobs,),
                            timeout=600)
    except BaseException:
        handle[0].kill()
        handle[0].communicate()
        raise
    return jobs, ranks, reference_decode_result(handle)


def gathered_logits(ranks: list, name: str, mode: str) -> list:
    """Each call's (B, 1, Vp) logits put together from the ranks' rows
    (the model ranks of a row block checked equal first)."""
    sizes = {"data": 2, "model": 2}
    out = []
    for i in range(1 + STEPS):
        # the prefill's rows follow its mode, a decode step's megatron's
        rows = sharding.entry_axes(ranks[0][(name, mode)]["rows"]) \
            if i == 0 else ("data",)
        full = [None] * BATCH
        for r in ranks:
            got = r[(name, mode)]["logits"][i]
            c = r["coords"]
            idx, n = 0, 1
            for a in rows:
                idx, n = idx * sizes[a] + c[a], n * sizes[a]
            per = BATCH // n
            for j in range(per):
                row = got[j]
                if full[idx * per + j] is not None:
                    assert np.array_equal(full[idx * per + j], row), (
                        name, mode, i, "model ranks differ")
                full[idx * per + j] = row
        out.append(np.stack(full))
    return out


def rel_range(got: np.ndarray, want: np.ndarray) -> float:
    want = want.astype(np.float64)
    return float(np.abs(got - want).max() / (want.max() - want.min()))


CASES = [(name, mode) for name, job in JOBS.items() for mode in job[1]]


@pytest.mark.parametrize("name,mode", CASES,
                         ids=[f"{n}-{m}" for n, m in CASES])
def test_served_mesh_matches_one_process(name, mode, runs):
    jobs, ranks, _ = runs
    arch, _, s, max_len, _, _ = jobs[name]
    one = one_process(name, jobs[name])
    got = gathered_logits(ranks, name, mode)
    vocab = config(arch).vocab_size
    for i, (g, w) in enumerate(zip(got, one["logits"])):
        err = rel_range(g[..., :vocab], w.numpy()[..., :vocab])
        assert err <= LOGITS_TOL, (name, mode, i, err)
    cfg = config(arch)
    layout = model.cache_layout(cfg, {"data": 2, "model": 2}, BATCH, max_len)
    want_cache = model.map_tree(lambda x: x.float().numpy(), one["cache"])
    for r in ranks:
        rec = r[(name, mode)]
        assert rec["wrong_shapes"] == [], (name, mode, rec["wrong_shapes"])
        for path, spec in _paths(layout):
            w = block(model.specs_at(want_cache, path), spec, r["coords"],
                      {"data": 2, "model": 2})
            g = model.specs_at(rec["cache"], path)
            tol = KV_TOL if path[-1] in ("k", "v") else STATE_TOL
            scale = max(float(np.abs(w).max()), 1.0)
            assert np.abs(g - w).max() <= tol * scale, (name, mode, path)
        gathers = {k for k in rec["decode_collectives"]
                   if k.startswith("all_gather")}
        assert gathers <= DECODE_GATHERS, (name, mode, gathers)
        assert "all_gather logits" in gathers, (name, mode, gathers)
        if cfg.family != "ssm":
            assert {"all_gather decode softmax",
                    "all_gather decode qkv"} <= gathers, (name, mode)
            assert DECODE_SUMS <= set(rec["decode_collectives"]), (name,
                                                                   mode)


def _paths(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, pre + (k,))
        else:
            yield pre + (k,), v


def test_served_decode_matches_reference(runs):
    jobs, ranks, ref = runs
    got = gathered_logits(ranks, "smollm-360m", "megatron")[1:]
    for i, (g, w) in enumerate(zip(got, ref)):
        err = rel_range(g[:, 0, :VOCAB], w[:, :VOCAB])
        assert err <= REF_TOL, (i, err)


@pytest.mark.parametrize("arch,mode", [("smollm-360m", "megatron"),
                                       ("smollm-360m", "zero_seq"),
                                       ("mixtral-8x7b", "megatron"),
                                       ("zamba2-2.7b", "zero_seq"),
                                       ("rwkv6-3b", "zero_batch")])
def test_world_size_one_is_one_process(arch, mode, tmp_path):
    """A 1×1 gloo mesh in this process: prefill and decode at the default
    bf16 compute from bf16 serve weights, bit-equal to the same calls
    without a mesh."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    _, _, s, max_len, seed = JOBS[arch]
    cfg = config(arch)
    params = model.map_tree(lambda x: x.to(torch.bfloat16),
                            model.init_params(cfg, seed, device="cpu"))
    tokens = tokens_of(seed, s + STEPS)
    want = serve(cfg, params, tokens, s, max_len)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_host_mesh(device="cpu")
        got = serve(cfg, params, tokens, s, max_len, mesh, mode)
    finally:
        dist.destroy_process_group()
    for g, w in zip(got["logits"], want["logits"]):
        assert torch.equal(g, w)
    for g, w in zip(model.leaves(got["cache"]), model.leaves(want["cache"])):
        assert torch.equal(g, w)
