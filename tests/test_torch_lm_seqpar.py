"""zero_seq's sequence-parallel recurrences (``layers.seq_group``) on gloo
meshes of four CPU processes, 1 × 4 (the state scan's combine crossing
three ranks) and 2 × 2, both built in one ``run_on_mesh`` spawn for the
file, against the same functions on the whole sequence in one process,
float32 compute:

* ``linear_attn.linear_attention`` inclusive (Mamba-2's form), exclusive
  with the bonus ``u`` (RWKV-6's), inclusive from an initial state (the
  first rank's), with chunks of 4, so a rank's range is several chunks;
  and at S = 192 with the default chunk of 64, whose ranges of 96 (2 × 2)
  end on a chunk of 32 and of 48 (1 × 4) are one short chunk;
* RWKV-6's time mix and channel mix and ``mamba2_block`` at ``reduced()``
  widths (each rank's token shift and causal conv taking the rows before
  its range from the ranks before it, ``layers.seq_halo``), and
  ``mamba2_block`` at S = 8, whose ranges of 2 on 1 × 4 are shorter than
  the conv's look-back of ``ssm_conv − 1`` = 3: the halo then takes rows
  from two ranks back (the documented behaviour: it runs);
* whisper's ``_encode`` (``reduced()``, 16 frames: 4 or 8 a rank), its
  weights rounded to bf16 values, so that the zero mode's bf16 gathers
  give the one process's values;
* zero_seq prefills of rwkv6-3b and zamba2-2.7b (``reduced()``, 16
  tokens: the carries taken from the last model rank, ``model.
  _carry_block``) and 3 decode steps, by
  ``tests/test_torch_lm_serve_mesh.serve``.

Compared: each rank's block of the outputs, of the inputs' gradients and
of the carries (the state after the sequence, the token shift, the conv
window; on the last model rank), and the weights' gradients summed over
the ranks, within TOL of the leaf's largest value (measured at most
3.7e-6, ``la-ragged-192``, whose chunks and ranges meet at other
positions; the SSM blocks run in one process at a chunk of the ranks'
range, see ``_rank_chunk``); the served logits and cache blocks by the
serve-mesh file's bounds (measured: logits 1.1e-5 of their range, carries
1.5e-6 of the leaf).  The gradient is that of a fixed random projection of the output
and of the final carries.  A train step of each of rwkv6, zamba2 and
whisper (``reduced()``, 8 × 32) under zero_seq tallies its collectives by
name: no ``sequence in`` or ``frames`` gather (no (B, S, D) activation
gathered over ``model`` for these blocks), a ``seq state`` and a ``seq
halo`` exchange for the SSMs; its loss within the mesh files' TOL of one
process's.  Mutants: with the state exchange, or the halo, skipped, the
outputs part from one process's by far more than TOL (measured 0.41-0.93
of the output's largest value).
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
B = 4
TOL = 1e-5          # of the leaf's largest value
MUTANT_MIN = 1e-2   # a skipped exchange must part by at least this


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _arch(name: str):
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import ARCHITECTURES
    return reduced(ARCHITECTURES[name]).replace(vocab_size=512)


# name: (kind, arch or None, S, options)
CASES = {
    "la-inclusive": ("la", None, 32, dict(inclusive=True, chunk=4)),
    "la-exclusive-u": ("la", None, 32, dict(inclusive=False, u=True,
                                            chunk=4)),
    "la-initial-state": ("la", None, 32, dict(inclusive=True, init=True,
                                              chunk=4)),
    "la-ragged-192": ("la", None, 192, dict(inclusive=False, u=True,
                                            chunk=64)),
    "tmix": ("tmix", "rwkv6-3b", 32, {}),
    "cmix": ("cmix", "rwkv6-3b", 32, {}),
    "mamba": ("mamba", "zamba2-2.7b", 32, {}),
    "mamba-short-range": ("mamba", "zamba2-2.7b", 8, {}),
    "encode": ("encode", "whisper-large-v3", 0, {}),
}
LA_DIMS = (2, 8, 4)                  # heads, key dim, value dim
MUTANTS = {"state-skipped": "la-inclusive", "halo-skipped": "mamba"}
PREFILL = {"rwkv6-3b": 61, "zamba2-2.7b": 63}    # arch: seed
PROMPT, MAX_LEN = 16, 20
TRAIN_ARCHS = ("rwkv6-3b", "zamba2-2.7b", "whisper-large-v3")


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.tensor(x).to(torch.bfloat16).float().numpy()


def inputs(name: str) -> dict:
    """The case's weights and inputs, numpy, from a seed: ``"w"`` the
    weights (whole on every rank), ``"x"`` the (B, S, ...) inputs split
    over rows and positions, ``"rows"`` the (B, ...) ones split over rows
    (an initial state), ``"proj"`` the projections the loss takes."""
    from repro_torch.models import model, ssm

    kind, arch, s, opt = CASES[name]
    seed = sorted(CASES).index(name)
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    uni = lambda lo, hi, shape: rng.uniform(lo, hi, shape).astype(np.float32)
    w, x, rows = {}, {}, {}
    if kind == "la":
        h, kd, p = LA_DIMS
        x = {"r": f32(B, s, h, kd), "k": f32(B, s, h, kd),
             "v": f32(B, s, h, p), "log_w": uni(-1.5, -0.01, (B, s, h, kd))}
        if opt.get("u"):
            w["u"] = uni(-0.5, 0.5, (h, kd))
        if opt.get("init"):
            rows["init"] = f32(B, h, kd, p)
        out_shape, carries = (B, s, h, p), {"state": (B, h, kd, p)}
    elif kind == "encode":
        cfg = _arch(arch)
        tree = model.init_params(cfg, seed, device="cpu")["encoder"]
        w = model.map_tree(lambda t: _bf16(t.numpy()), tree)
        x = {"frames": f32(B, cfg.n_frames, cfg.d_model)}
        out_shape, carries = (B, cfg.n_frames, cfg.d_model), {}
    else:
        cfg = _arch(arch)
        init = {"tmix": ssm.init_rwkv6_time_mix,
                "cmix": ssm.init_rwkv6_channel_mix,
                "mamba": ssm.init_mamba2}[kind](cfg, gen, "cpu")
        w = {k: v.numpy() for k, v in init.items()}
        for k in w:      # not the init's constants
            if k.startswith("mix_"):
                w[k] = uni(0.0, 1.0, w[k].shape)
            elif k in ("w0",):
                w[k] = uni(-3.0, -1.0, w[k].shape)
            elif k in ("u", "conv_b", "dt_bias"):
                w[k] = uni(-0.5, 0.5, w[k].shape)
            elif k in ("ln_out", "d_skip", "norm"):
                w[k] = uni(0.5, 1.5, w[k].shape)
        x = {"x": f32(B, s, cfg.d_model)}
        out_shape = (B, s, cfg.d_model)
        d_inner, h, hd = ssm.mamba2_dims(cfg)
        hr, pr = ssm.rwkv_dims(cfg)
        carries = {"tmix": {"shift": (B, 1, cfg.d_model),
                            "state": (B, hr, pr, pr)},
                   "cmix": {"shift": (B, 1, cfg.d_model)},
                   "mamba": {"conv": (B, cfg.ssm_conv - 1, d_inner),
                             "state": (B, h, cfg.ssm_state, hd)}}[kind]
    proj = {"out": f32(*out_shape)}
    proj.update({k: f32(*shape) for k, shape in carries.items()})
    return {"w": w, "x": x, "rows": rows, "proj": proj}


def run_case(name: str, w: dict, x: dict, rows: dict, group,
             chunk: int = 64) -> tuple:
    """(output, {carry: value}) of the case on ``w``, ``x``, ``rows``;
    ``group`` the linear attention's (None: the whole sequence), ``chunk``
    the SSM blocks'."""
    from repro_torch.models import linear_attn as la
    from repro_torch.models import model, ssm

    kind, arch, _, opt = CASES[name]
    if kind == "la":
        out, state = la.linear_attention(
            x["r"], x["k"], x["v"], x["log_w"], chunk=opt["chunk"],
            inclusive=opt["inclusive"], u=w.get("u"),
            initial_state=rows.get("init"), group=group)
        return out, {"state": state}
    cfg = _arch(arch)
    if kind == "encode":
        return model._encode(cfg, w, x["frames"], remat=False), {}
    if kind == "tmix":
        out, shift, state = ssm.rwkv6_time_mix(cfg, w, x["x"], chunk=chunk)
        return out, {"shift": shift, "state": state}
    if kind == "cmix":
        out, shift = ssm.rwkv6_channel_mix(cfg, w, x["x"])
        return out, {"shift": shift}
    out, conv, state = ssm.mamba2_block(cfg, w, x["x"], chunk=chunk)
    return out, {"conv": conv, "state": state}


def _loss(out, carries: dict, proj: dict, last: bool):
    """The projection of the output and, where ``last`` (the rank that
    holds the sequence's carries), of the carries."""
    loss = (out * proj["out"]).sum()
    if last:
        for k, v in carries.items():
            loss = loss + (v * proj[k]).sum()
    return loss


def _tensors(tree, grad: bool):
    from repro_torch.models import model
    return model.map_tree(lambda a: torch.tensor(a).requires_grad_(grad),
                          tree)


def _float32():
    from repro_torch.models import layers
    layers.COMPUTE_DTYPE = torch.float32


def _mesh_case(name: str, case: dict, mesh) -> dict:
    """The case on the rank's rows and positions under zero_seq's hooks:
    its output block, carries (all ranks'; the last model rank's are the
    sequence's), the gradients of its (B, S, ...) inputs (its block), of
    its row inputs (summed over ``model``) and of the weights (summed over
    the ranks that hold distinct tokens, as the train step's sync sums
    them, gathered whole)."""
    from repro_torch.core import collectives
    from repro_torch.models import layers, model
    from repro_torch.train import sharding, train_step

    kind, arch, _, _ = CASES[name]
    m = mesh.get_local_rank("model")
    last = m == sharding.axis_sizes(mesh)["model"] - 1
    xs = {k: sharding.local_shard(torch.tensor(v), sharding.P(
        "data", "model"), mesh).clone().requires_grad_(True)
        for k, v in case["x"].items()}
    rows = {k: sharding.local_shard(torch.tensor(v), sharding.P("data"),
                                    mesh).clone().requires_grad_(True)
            for k, v in case["rows"].items()}
    proj = {k: sharding.local_shard(torch.tensor(v), sharding.P(
        "data", "model" if k == "out" else None), mesh)
        for k, v in case["proj"].items()}
    specs = None
    if kind == "encode":
        specs = train_step.param_layout(_arch(arch), mesh,
                                        "zero_seq")["encoder"]
        w = model.map_tree(lambda t: t.requires_grad_(True),
                           sharding.shard_tree(_tensors(case["w"], False),
                                               specs, mesh))
    else:
        w = _tensors(case["w"], True)
    if kind == "encode":
        hooks = layers.mesh_hooks(sharding.activation_spec(mesh, "zero_seq"),
                                  {"encoder": specs}, mesh)
    else:       # zero_seq's token layout, float32 weights (as serving's)
        hooks = layers.mesh_hooks(None, None, mesh, {
            "tokens": sharding.P("data", "model"), "cache": None})
    with hooks:
        out, carries = run_case(name, w, xs, rows, layers.seq_group())
        loss = _loss(out, carries, proj, last)
        wl = model.leaves(w)
        wrt = wl + list(xs.values()) + list(rows.values())
        # a row input (the initial state) counts on the first model rank
        grads = [g if g is not None else torch.zeros_like(t) for g, t in zip(
            torch.autograd.grad(loss, wrt, allow_unused=True), wrt)]
    wg, xg, rg = (grads[:len(wl)], grads[len(wl):len(wl) + len(xs)],
                  grads[len(wl) + len(xs):])
    if specs is None:
        for g in wg:
            collectives.all_reduce_sum(g, None, "grad")
    else:
        for g, sp in zip(wg, model.leaves(specs)):
            axes = tuple(a for a in ("data", "model")
                         if a not in sharding.spec_axes(sp)
                         and sharding.axis_sizes(mesh)[a] > 1)
            if axes:
                collectives.all_reduce_sum(g, sharding.group_of(mesh, axes),
                                           "grad")
        wg = model.leaves(sharding.gather_tree(model.unflatten(w, list(wg)),
                                               specs, mesh))
    for g in rg:
        collectives.all_reduce_sum(g, mesh.get_group("model"), "grad")
    return {"out": out.detach().numpy(),
            "carries": {k: v.detach().float().numpy()
                        for k, v in carries.items()},
            "wgrads": [g.numpy() for g in wg],
            "xgrads": [g.numpy() for g in xg],
            "rgrads": [g.numpy() for g in rg]}


def _mutant(kind: str):
    """Patch the exchange ``kind`` skips to give zeros, with no
    collective on any rank; returns the restore."""
    from repro_torch.models import layers
    from repro_torch.models import linear_attn as la

    if kind == "state-skipped":
        saved = la._from_rank_before
        la._from_rank_before = lambda pair, d, group: (
            torch.zeros_like(pair[0]), torch.zeros_like(pair[1]))
        return lambda: setattr(la, "_from_rank_before", saved)
    saved = layers.seq_halo
    layers.seq_halo = lambda x, n, prev, what="": x.new_zeros(
        (x.shape[0], n) + x.shape[2:])
    return lambda: setattr(layers, "seq_halo", saved)


def _prefill(arch: str, case: dict, mesh) -> dict:
    from tests.test_torch_lm_serve_mesh import serve
    from repro_torch.models import model
    from repro_torch.train import sharding

    cfg = _arch(arch)
    params = model.serve_params(cfg, sharding.shard_tree(
        _tensors(case["tree"], False), model.serve_param_specs(cfg, mesh),
        mesh), mesh)
    run = serve(cfg, params, case["tokens"], PROMPT, MAX_LEN, mesh,
                "zero_seq")
    return {"logits": [x.numpy() for x in run["logits"]],
            "cache": model.map_tree(lambda x: x.float().numpy(),
                                    run["cache"])}


def _train(arch: str, data: list, mesh, dev) -> dict:
    from repro_torch.core import collectives
    from repro_torch.optim import adamw
    from repro_torch.train import sharding, train_step
    from tests.test_torch_lm_mesh_common import TRAIN, tree_of, weights

    cfg = _arch(arch)
    specs = train_step.param_layout(cfg, mesh, "zero_seq")
    params = sharding.shard_tree(tree_of(weights(cfg, 71)), specs, mesh)
    step = train_step.make_train_step(cfg, train_step.TrainConfig(**TRAIN),
                                      dev, mesh=mesh, mode="zero_seq")
    with collectives.tally(by="what") as counts:
        _, _, met = step(params, adamw.init(params), data[0])
    return {"loss": float(met["loss"]), "tally": counts}


def seqpar_rank(mesh22, dev, cases: dict, prefills: dict,
                trains: dict) -> dict:
    """One rank: every case, prefill and train step on the 2 × 2 mesh the
    spawn built and on a 1 × 4 mesh over the same ranks, then the
    mutants on each."""
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    _float32()
    meshes = {"2x2": mesh22, "1x4": make_host_mesh(1, 4, device=dev)}
    out = {}
    for key, mesh in meshes.items():
        rec = {"coords": {a: mesh.get_local_rank(a)
                          for a in mesh.mesh_dim_names}}
        for name, case in cases.items():
            rec[name] = _mesh_case(name, case, mesh)
        for arch, case in prefills.items():
            rec["prefill " + arch] = _prefill(arch, case, mesh)
        for arch, data in trains.items():
            rec["train " + arch] = _train(arch, data, mesh, dev)
        for mutant, name in MUTANTS.items():
            restore = _mutant(mutant)
            try:
                rec[mutant] = _mesh_case(name, cases[name], mesh)
            finally:
                restore()
        out[key] = rec
    return out


def one_process(name: str, case: dict, chunk: int = 64) -> dict:
    """The case on the whole sequence in one process (the encoder under
    zero_seq's activation spec with no mesh, as the mesh files' one
    process runs a zero mode)."""
    from repro_torch.models import layers, model
    from repro_torch.train import sharding

    saved = layers.COMPUTE_DTYPE
    _float32()
    try:
        w = _tensors(case["w"], True)
        xs, rows = _tensors(case["x"], True), _tensors(case["rows"], True)
        proj = _tensors(case["proj"], False)
        act = sharding.activation_spec({"data": 2, "model": 2}, "zero_seq")
        with layers.mesh_hooks(act if CASES[name][0] == "encode" else None):
            out, carries = run_case(name, w, xs, rows, None, chunk)
        loss = _loss(out, carries, proj, True)
        wl = model.leaves(w)
        grads = torch.autograd.grad(loss, wl + list(xs.values())
                                    + list(rows.values()))
        n, nx = len(wl), len(xs)
        return {"out": out.detach().numpy(),
                "carries": {k: v.detach().numpy()
                            for k, v in carries.items()},
                "wgrads": [g.numpy() for g in grads[:n]],
                "xgrads": [g.numpy() for g in grads[n:n + nx]],
                "rgrads": [g.numpy() for g in grads[n + nx:]]}
    finally:
        layers.COMPUTE_DTYPE = saved


@pytest.fixture(scope="module")
def runs():
    from repro_torch.launch.mesh import run_on_mesh
    from tests.test_torch_lm_mesh_common import batches, weights
    from tests.test_torch_lm_serve_mesh import tokens_of

    cases = {name: inputs(name) for name in CASES}
    prefills = {arch: {"tree": weights(_arch(arch), seed),
                       "tokens": tokens_of(seed, PROMPT + 3)}
                for arch, seed in PREFILL.items()}
    trains = {arch: batches(_arch(arch), 73, n=1) for arch in TRAIN_ARCHS}
    ranks = run_on_mesh(seqpar_rank, 2, 2, device="cpu",
                        args=(cases, prefills, trains), timeout=300)
    return cases, prefills, trains, ranks


def _rank_chunk(name: str, key: str) -> int:
    """The one process's chunk for an SSM block: the ranks' range, so that
    its chunks and the ranks' ranges meet at the same positions (the
    chunk choice alone moves zamba2's served carries by up to 5.3e-5 of
    the leaf, measured at 64 against 8; ``linear_attention`` is held at
    other chunkings by its own cases)."""
    return CASES[name][2] // MESHES[key][1] if CASES[name][0] in (
        "tmix", "mamba") else 64


@contextlib.contextmanager
def _ssm_chunk(chunk: int):
    """The SSM blocks' default chunk set to ``chunk`` (the one process's
    prefill, at the ranks' ranges as :func:`_rank_chunk` says)."""
    from repro_torch.models import ssm

    fns = (ssm.rwkv6_time_mix, ssm.mamba2_block)
    saved = [fn.__kwdefaults__["chunk"] for fn in fns]
    for fn in fns:
        fn.__kwdefaults__["chunk"] = chunk
    try:
        yield
    finally:
        for fn, c in zip(fns, saved):
            fn.__kwdefaults__["chunk"] = c


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _block(x: np.ndarray, coords: dict, sizes: dict, seq: bool = True):
    """The rank's rows (over ``data``) and, where ``seq``, positions (over
    ``model``) of a global (B, S, ...) array."""
    nb = x.shape[0] // sizes["data"]
    x = x[coords["data"] * nb:(coords["data"] + 1) * nb]
    if seq:
        ns = x.shape[1] // sizes["model"]
        x = x[:, coords["model"] * ns:(coords["model"] + 1) * ns]
    return x


def _sizes(key: str) -> dict:
    d, m = MESHES[key]
    return {"data": d, "model": m}


CASE_IDS = [(k, n) for k in MESHES for n in CASES]


@pytest.mark.parametrize("key,name", CASE_IDS,
                         ids=[f"{k}-{n}" for k, n in CASE_IDS])
def test_sequence_parallel_matches_one_process(key, name, runs):
    cases, _, _, ranks = runs
    want = one_process(name, cases[name], _rank_chunk(name, key))
    sizes = _sizes(key)
    for rank in ranks:
        r = rank[key]
        got, c = r[name], r["coords"]
        assert _rel(got["out"], _block(want["out"], c, sizes)) <= TOL, name
        for g, w in zip(got["xgrads"], want["xgrads"]):
            assert _rel(g, _block(w, c, sizes)) <= TOL, (name, "input grad")
        for g, w in zip(got["rgrads"], want["rgrads"]):
            assert _rel(g, _block(w, c, sizes, False)) <= TOL, (name,
                                                                "row grad")
        for i, (g, w) in enumerate(zip(got["wgrads"], want["wgrads"])):
            assert _rel(g, w) <= TOL, (name, "weight grad", i)
        if c["model"] == sizes["model"] - 1:
            for k, w in want["carries"].items():
                assert _rel(got["carries"][k],
                            _block(w, c, sizes, False)) <= TOL, (name, k)


@pytest.mark.parametrize("key", sorted(MESHES))
def test_short_range_takes_rows_from_further_ranks(key, runs):
    """``mamba-short-range``: on 1 × 4 a rank's range (2) is shorter than
    the conv's look-back (3), so the halo of ranks 2 and 3 holds a row of
    two ranks back; the conv window each rank returns (its last 3
    positions, the halo's rows among them) is that of one process."""
    cases, _, _, ranks = runs
    cfg = _arch("zamba2-2.7b")
    sizes = _sizes(key)
    per_rank = CASES["mamba-short-range"][2] // sizes["model"]
    assert (per_rank < cfg.ssm_conv - 1) == (key == "1x4")
    name = "mamba-short-range"
    x = cases[name]["x"]["x"]
    for rank in ranks:
        c = rank[key]["coords"]
        got = rank[key][name]["carries"]["conv"]
        end = (c["model"] + 1) * per_rank
        if end < cfg.ssm_conv - 1:
            continue        # its window reaches before the sequence
        # the window of the one-process conv ending at the rank's last
        # position: rerun the one process on the prefix up to it
        prefix = {"w": cases[name]["w"], "rows": {}, "x": {"x": x[:, :end]},
                  "proj": {"out": cases[name]["proj"]["out"][:, :end],
                           "conv": cases[name]["proj"]["conv"],
                           "state": cases[name]["proj"]["state"]}}
        w = one_process(name, prefix, per_rank)["carries"]["conv"]
        assert _rel(got, _block(w, c, sizes, False)) <= TOL, (key, c)


@pytest.mark.parametrize("key,mutant", [(k, m) for k in MESHES
                                        for m in MUTANTS])
def test_skipped_exchange_is_wrong(key, mutant, runs):
    cases, _, _, ranks = runs
    name = MUTANTS[mutant]
    want = one_process(name, cases[name], _rank_chunk(name, key))
    sizes = _sizes(key)
    worst = max(_rel(rank[key][mutant]["out"],
                     _block(want["out"], rank[key]["coords"], sizes))
                for rank in ranks)
    assert worst > MUTANT_MIN, (mutant, worst)


@pytest.mark.parametrize("key,arch", [(k, a) for k in MESHES
                                      for a in PREFILL])
def test_zero_seq_prefill_matches_one_process(key, arch, runs):
    from repro_torch.models import model
    from tests.test_torch_lm_serve_mesh import (KV_TOL, LOGITS_TOL,
                                                STATE_TOL, block, rel_range,
                                                serve)
    from repro_torch.models import layers

    _, prefills, _, ranks = runs
    cfg = _arch(arch)
    saved = layers.COMPUTE_DTYPE
    _float32()
    try:
        with _ssm_chunk(PROMPT // MESHES[key][1]):
            one = serve(cfg, _tensors(prefills[arch]["tree"], False),
                        prefills[arch]["tokens"], PROMPT, MAX_LEN)
    finally:
        layers.COMPUTE_DTYPE = saved
    sizes = _sizes(key)
    layout = model.cache_layout(cfg, sizes, B, MAX_LEN)
    want_cache = model.map_tree(lambda x: x.float().numpy(), one["cache"])
    vocab = cfg.vocab_size
    for rank in ranks:
        r, c = rank[key]["prefill " + arch], rank[key]["coords"]
        for i, (g, w) in enumerate(zip(r["logits"], one["logits"])):
            w = _block(w.numpy(), c, sizes, False)
            assert rel_range(g[..., :vocab], w[..., :vocab]) <= LOGITS_TOL, \
                (arch, i)
        for path, spec in _paths(layout):
            w = block(model.specs_at(want_cache, path), spec, c, sizes)
            g = model.specs_at(r["cache"], path)
            assert g.shape == w.shape, (arch, path)
            tol = KV_TOL if path[-1] in ("k", "v") else STATE_TOL
            assert np.abs(g - w).max() <= tol * max(float(np.abs(w).max()),
                                                     1.0), (arch, path)


def _paths(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, pre + (k,))
        else:
            yield pre + (k,), v


@pytest.mark.parametrize("key,arch", [(k, a) for k in MESHES
                                      for a in TRAIN_ARCHS])
def test_train_step_gathers_no_sequence(key, arch, runs):
    from tests.test_torch_lm_mesh_common import TOL as MESH_TOL
    from tests.test_torch_lm_mesh_common import port_one, weights

    _, _, trains, ranks = runs
    want = port_one(arch, {}, "zero_seq", weights(_arch(arch), 71),
                    trains[arch])["metrics"][0]["loss"]
    for rank in ranks:
        r = rank[key]["train " + arch]
        names = set(r["tally"])
        assert not {"all_gather sequence in", "all_gather frames"} & names
        if arch != "whisper-large-v3":
            assert {"all_to_all seq state", "all_to_all seq halo"} <= names
        assert abs(r["loss"] - want) / abs(want) <= MESH_TOL["loss1"], \
            (arch, r["loss"], want)
