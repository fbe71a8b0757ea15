"""Shared set-up of the LM mesh tests (``tests/test_torch_lm_mesh.py``,
``tests/test_torch_lm_mesh_parity.py`` and ``_parity_seq.py``): the
reduced configs, weights and
global batches made from a seed, the port's rank function for
``launch.mesh.run_on_mesh`` and its one-process counterpart, the
reference's sharded step for a subprocess, and the measures they are
compared by.  It holds no test of its own and imports no JAX at module
level: the mesh's rank processes import it.

Both packages compute in float32 (their ``COMPUTE_DTYPE`` patched), as
``tests/test_torch_lm_model_*.py`` do.  The zero modes still hold the block
weights in bf16 (``_maybe_cast_blocks``, the reference's as much as the
port's), so their one-process counterpart here runs under the mode's
activation spec with no mesh, which casts the blocks as the mesh does.
AdamW's second step amplifies a gradient's last-bit differences where the
gradient changes sign between the steps, so the parameters are compared by
the Frobenius norm of their difference over that of their update.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import ARCHITECTURES
from repro_torch.models import layers, model
from repro_torch.optim import adamw
from repro_torch.train import sharding, train_step

ROOT = Path(__file__).resolve().parents[1]
B, S, VOCAB, STEPS = 8, 32, 512, 2
MODES = ("megatron", "zero_seq", "zero_batch")
# warmup 0: with warmup > 0 the cosine schedule's lr is 0 at step 0
TRAIN = dict(peak_lr=1e-3, warmup=0, total_steps=10, loss_chunk=16)

# Tolerances, against the port's one-process step and the reference's
# sharded step alike (the largest of either measured on the CPU over the
# cases of the parity files): step 1's loss (≤ 2.2e-7 relative) and
# grad_norm (≤ 2.4e-6); step 2's loss (≤ 1.8e-5) and grad_norm (≤ 5.5e-4,
# zamba2 under the zero modes); the parameters after step 2, Frobenius of
# the difference over that of the update (megatron ≤ 3.3e-3, rwkv6 against
# the reference, the port's one-process step differing as much; zero modes
# ≤ 1.7e-2, zamba2); the first step's gradients against the one-process
# step's, Frobenius by leaf (megatron ≤ 6.3e-6; zero modes ≤ 2.9e-3,
# zamba2's shared block, which one process accumulates over its two uses
# in bf16 and the mesh in float32), read as AdamW's m after that step.
# Against the reference also the first step's gradients (megatron ≤ 8.5e-5,
# zamba2, where the reference's own one-device step is 7.3e-5 from its
# sharded one; zero modes ≤ 5.4e-3, zamba2) and the parameters after it
# (megatron ≤ 1.7e-3; zero modes ≤ 2.2e-2, zamba2).
TOL = {"loss1": 1e-5, "gnorm1": 2e-5, "loss2": 1e-4, "gnorm2": 3e-3,
       "params": {"megatron": 1e-2, "zero": 5e-2},
       "grads": {"megatron": 1e-4, "zero": 1e-2}}


def config(arch: str, **kw):
    return reduced(ARCHITECTURES[arch]).replace(vocab_size=VOCAB, **kw)


def weights(cfg, seed: int) -> dict:
    """The port's initial weights from ``seed`` as a numpy tree."""
    return model.map_tree(lambda t: t.numpy(),
                          model.init_params(cfg, seed, device="cpu"))


def batches(cfg, seed: int, n: int = STEPS, b: int = B,
            s: int = S) -> list[dict]:
    """``n`` global batches drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)}
        if cfg.family == "audio":
            x["frames"] = rng.standard_normal(
                (b, cfg.n_frames, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            x["patch_embeds"] = rng.standard_normal(
                (b, cfg.n_patches, cfg.vision_dim)).astype(np.float32)
        out.append(x)
    return out


def tree_of(np_tree: dict) -> dict:
    return model.map_tree(lambda a: torch.tensor(np.asarray(a)), np_tree)


def zero(mode: str) -> str:
    return "megatron" if mode == "megatron" else "zero"


def update_err(got: list, want: list, init: list) -> float:
    """max over leaves of ||got − want|| / ||want − init||."""
    out = 0.0
    for g, w, i in zip(got, want, init):
        den = np.linalg.norm(np.asarray(w, np.float64) - i)
        if den > 0:
            out = max(out, float(np.linalg.norm(
                np.asarray(g, np.float64) - w) / den))
    return out


def grad_err(got: list, want: list) -> float:
    """max over leaves of ||got − want|| / ||want||."""
    return max(float(np.linalg.norm(np.asarray(g, np.float64) - w)
                     / max(np.linalg.norm(w), 1e-30))
               for g, w in zip(got, want))


def check_run(label: str, got: dict, want: dict, init: list,
              mode: str, keep: list | None = None) -> None:
    """A run's metrics and final parameters against another's, by TOL;
    ``keep`` (a flag a leaf) the leaves whose final parameters count."""
    z = zero(mode)
    (g1, g2), (w1, w2) = got["metrics"], want["metrics"]
    rel = lambda a, b: abs(a - b) / abs(b)
    kept = lambda xs: [x for x, k in zip(xs, keep or [True] * len(xs)) if k]
    errs = {"loss1": rel(g1["loss"], w1["loss"]),
            "gnorm1": rel(g1["grad_norm"], w1["grad_norm"]),
            "loss2": rel(g2["loss"], w2["loss"]),
            "gnorm2": rel(g2["grad_norm"], w2["grad_norm"]),
            "params": update_err(kept(got["params"]), kept(want["params"]),
                                 kept(init))}
    bounds = {k: (v[z] if isinstance(v, dict) else v)
              for k, v in TOL.items() if k in errs}
    bad = {k: (errs[k], bounds[k]) for k in errs if errs[k] > bounds[k]}
    assert not bad, f"{label} {mode}: {bad} (all: {errs})"


# ---------------------------------------------------------------- the port

def _float32() -> None:
    layers.COMPUTE_DTYPE = torch.float32


def _metrics(m: dict) -> dict:
    return {k: float(v) for k, v in m.items()}


def port_rank(mesh, dev, jobs: dict) -> dict:
    """One rank of the port's mesh runs of ``jobs`` ({name: (arch, cfg_kw,
    modes, np_tree, data)}): :func:`port_run` of each, on one torch
    thread (the file's four ranks share the cores with other workers)."""
    torch.set_num_threads(1)
    return {name: port_run(mesh, dev, *job) for name, job in jobs.items()}


def port_run(mesh, dev, arch: str, cfg_kw: dict, modes, np_tree: dict,
             data: list) -> dict:
    """Per mode, STEPS steps from the full weights ``np_tree`` on the
    global batches ``data`` (float32 compute): the global metrics, the
    gathered parameters after the first step and after the last and
    AdamW's m after the first (0.1 × the first step's clipped gradient),
    and every local block of the parameters, m and v whose shape is not
    the one its spec gives."""
    _float32()
    cfg = config(arch, **cfg_kw)
    tcfg = train_step.TrainConfig(**TRAIN)
    out = {}
    for mode in modes:
        specs = train_step.param_layout(cfg, mesh, mode)
        params = sharding.shard_tree(tree_of(np_tree), specs, mesh)
        opt = adamw.init(params)
        step = train_step.make_train_step(cfg, tcfg, dev, mesh=mesh,
                                          mode=mode)
        mets, m1, params1 = [], None, None
        for b in data:
            params, opt, m = step(params, opt, b)
            mets.append(_metrics(m))
            if m1 is None:          # step 2 writes m and the parameters
                m1 = [x.numpy().copy() for x in model.leaves(
                    sharding.gather_tree(opt.m, specs, mesh))]
                params1 = [x.numpy().copy() for x in model.leaves(
                    sharding.gather_tree(params, specs, mesh))]
        wrong = []
        full = model.param_shapes(cfg)
        for name, tree in (("params", params), ("m", opt.m), ("v", opt.v)):
            for x, f, sp in zip(model.leaves(tree), model.leaves(full),
                                model.leaves(specs)):
                want = sharding.local_shape(f.shape, sp, mesh)
                if tuple(x.shape) != want:
                    wrong.append((name, tuple(x.shape), want))
        out[mode] = {"metrics": mets, "wrong_shapes": wrong, "m1": m1,
                     "params1": params1,
                     "params": [x.numpy() for x in model.leaves(
                         sharding.gather_tree(params, specs, mesh))]}
    return out


def port_one(arch: str, cfg_kw: dict, mode: str, np_tree: dict,
             data: list) -> dict:
    """The port's one-process steps on the global batches, as
    :func:`port_run` records them, under the mode's activation spec with
    no mesh (so the zero modes' blocks are cast to bf16 before use, as on
    the mesh), float32 compute."""
    saved = layers.COMPUTE_DTYPE
    _float32()
    try:
        cfg = config(arch, **cfg_kw)
        step = train_step.make_train_step(
            cfg, train_step.TrainConfig(**TRAIN), "cpu")
        params = tree_of(np_tree)
        opt, mets, m1 = adamw.init(params), [], None
        act = sharding.activation_spec({"data": 2, "model": 2}, mode)
        with layers.mesh_hooks(act):
            for b in data:
                params, opt, m = step(params, opt, b)
                mets.append(_metrics(m))
                if m1 is None:
                    m1 = [x.numpy().copy() for x in model.leaves(opt.m)]
        return {"metrics": mets, "m1": m1, "params": [
            x.detach().numpy() for x in model.leaves(params)]}
    finally:
        layers.COMPUTE_DTYPE = saved


# ----------------------------------------------------------- the reference

SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
from tests.test_torch_lm_mesh_reference import reference_runs
reference_runs(sys.argv[1])
"""


def _flat(tree: dict, pre: str = "") -> dict:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "/"))
        else:
            out[pre + k] = v
    return out


def start_reference(tmp: Path, jobs: dict):
    """Start the reference's sharded runs of ``jobs`` ({name: (arch,
    cfg_kw, modes, np_tree, data)}; ``test_torch_lm_mesh_reference.
    reference_run``) in a subprocess, so that they run beside the port's
    mesh; :func:`reference_result` waits for them."""
    spec = []
    for name, (arch, cfg_kw, modes, np_tree, data) in jobs.items():
        np.savez(tmp / f"{name}-weights.npz", **_flat(np_tree))
        np.savez(tmp / f"{name}-batches.npz", **{
            f"{i}/{k}": v for i, b in enumerate(data) for k, v in b.items()})
        spec.append({"name": name, "arch": arch, "cfg_kw": cfg_kw,
                     "modes": list(modes), "vocab": VOCAB, "batch": B,
                     "seq": S, "train": TRAIN,
                     "weights": str(tmp / f"{name}-weights.npz"),
                     "batches": str(tmp / f"{name}-batches.npz"),
                     "out": str(tmp / f"{name}-ref.npz")})
    (tmp / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.Popen([sys.executable, "-c", SCRIPT,
                             str(tmp / "spec.json")], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, spec


def reference_result(handle) -> dict:
    """{name: {mode: {"metrics", "m1", "params1", "params"}}} of the
    reference's runs, as ``port_run`` gives them."""
    proc, spec = handle
    _, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-4000:]
    res = {}
    for job_ in spec:
        got = np.load(job_["out"])
        res[job_["name"]] = {}
        for mode in job_["modes"]:
            n = len([k for k in got.files
                     if k.startswith(f"{mode}/metrics/") and
                     k.endswith("/loss")])
            mets = [{"loss": float(got[f"{mode}/metrics/{i}/loss"]),
                     "grad_norm": float(got[f"{mode}/metrics/{i}/grad_norm"])}
                    for i in range(n)]
            leaves = lambda what: [got[k] for k in sorted(got.files)
                                   if k.startswith(f"{mode}/{what}/")]
            res[job_["name"]][mode] = {"metrics": mets,
                                       "m1": leaves("m1"),
                                       "params1": leaves("params1"),
                                       "params": leaves("params")}
    return res


def run_jobs(tmp: Path, jobs: dict) -> tuple[list, dict]:
    """The port's mesh runs of ``jobs`` on a 2×2 gloo mesh of four CPU
    processes beside the reference's sharded runs in a subprocess:
    (each rank's results, the reference's)."""
    from repro_torch.launch.mesh import run_on_mesh

    handle = start_reference(tmp, jobs)
    try:
        ranks = run_on_mesh(port_rank, 2, 2, device="cpu", args=(jobs,),
                            timeout=600)
    except BaseException:
        handle[0].kill()
        handle[0].communicate()
        raise
    return ranks, reference_result(handle)


def check_job(name: str, job_: tuple, ranks: list, ref: dict,
              omit: tuple = ()) -> None:
    """Every rank's shapes and metrics; the mesh run against the port's
    one-process run and the reference's sharded run, per mode: by
    :func:`check_run`, and against the reference also the first step's
    gradients and the parameters after it.  ``omit`` names the leaves
    (paths as ``_flat`` gives them) left out of the final parameters'
    comparison with the reference."""
    arch, cfg_kw, modes, np_tree, data = job_
    init = [np.asarray(x) for x in model.leaves(np_tree)]
    keep = [path not in omit for path in _flat(np_tree)]
    for mode in modes:
        got = ranks[0][name][mode]
        for r, res in enumerate(ranks):
            assert res[name][mode]["wrong_shapes"] == [], (name, mode, r)
            assert res[name][mode]["metrics"] == got["metrics"], (name, r)
        one = port_one(arch, cfg_kw, mode, np_tree, data)
        err = grad_err(got["m1"], one["m1"])
        assert err <= TOL["grads"][zero(mode)], (name, mode, err)
        check_run(f"{name} against one process", got, one, init, mode)
        want = ref[name][mode]
        check_run(f"{name} against the reference", got, want, init, mode,
                  keep)
        err = grad_err(got["m1"], want["m1"])
        assert err <= TOL["grads"][zero(mode)], (name, mode, "ref", err)
        err = update_err(got["params1"], want["params1"], init)
        assert err <= TOL["params"][zero(mode)], (name, mode, "ref", err)


def job(arch: str, modes, seed: int, **cfg_kw) -> tuple:
    """(arch, cfg_kw, modes, weights, batches) from ``seed``."""
    cfg = config(arch, **cfg_kw)
    return arch, cfg_kw, tuple(modes), weights(cfg, seed), batches(
        cfg, seed + 1)


# ------------------------------------------- the reference's served decode

SERVE_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
from tests.test_torch_lm_mesh_common import reference_decode
reference_decode(sys.argv[1])
"""


def start_reference_decode(tmp: Path, arch: str, np_tree: dict,
                           tokens: np.ndarray, prompt: int, max_len: int,
                           steps: int):
    """Start the reference's served decode (:func:`reference_decode`) of
    ``arch`` from ``np_tree`` on ``tokens`` in a subprocess; returns a
    handle for :func:`reference_decode_result`."""
    np.savez(tmp / "serve-weights.npz", **_flat(np_tree))
    np.save(tmp / "serve-tokens.npy", tokens)
    spec = {"arch": arch, "vocab": VOCAB, "prompt": prompt,
            "max_len": max_len, "steps": steps,
            "weights": str(tmp / "serve-weights.npz"),
            "tokens": str(tmp / "serve-tokens.npy"),
            "out": str(tmp / "serve-ref.npy")}
    (tmp / "serve.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.Popen([sys.executable, "-c", SERVE_SCRIPT,
                             str(tmp / "serve.json")], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, spec


def reference_decode_result(handle) -> np.ndarray:
    """(steps, B, Vp) logits of the reference's served decode steps."""
    proc, spec = handle
    _, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-4000:]
    return np.load(spec["out"])


def reference_decode(spec_path: str) -> None:
    """The reference's decode as its dry run lowers it, run: the prompt
    through its ``prefill`` (one device), then the spec's decode steps
    under ``make_lowering_spec``'s decode kind (the serve layout: weights
    over ``model``, rows over ``data``, the K/V sequence over ``model``)
    jitted on a forced 4-device ``make_host_mesh(2, 2)`` with the spec's
    shardings; float32 compute, the spec's weights in float32.  Writes the
    steps' logits."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import InputShape
    from repro.configs.base import reduced as ref_reduced
    from repro.configs.registry import ARCHITECTURES as REF_ARCHS
    from repro.launch.mesh import make_host_mesh
    from repro.launch.specs import make_lowering_spec
    from repro.models import layers as ref_layers
    from repro.models import model as ref_model
    from tests.test_torch_lm_mesh_reference import FAST_COMPILE, _tree

    spec = json.loads(Path(spec_path).read_text())
    ref_layers.COMPUTE_DTYPE = jnp.float32
    cfg = ref_reduced(REF_ARCHS[spec["arch"]]).replace(
        vocab_size=spec["vocab"])
    params = jax.tree.map(jnp.asarray, _tree(np.load(spec["weights"])))
    tokens = jnp.asarray(np.load(spec["tokens"]))
    s, max_len = spec["prompt"], spec["max_len"]
    _, cache = jax.jit(lambda p, t: ref_model.prefill(
        cfg, p, {"tokens": t}, max_len))(params, tokens[:, :s])
    mesh = make_host_mesh(2, 2)
    shape = InputShape("serve", max_len, int(tokens.shape[0]), "decode")
    with mesh:
        ls = make_lowering_spec(cfg, shape, mesh)
        fn = jax.jit(ls.fn, in_shardings=ls.in_shardings,
                     out_shardings=ls.out_shardings)
        args = (params, cache, tokens[:, s:s + 1])
        step = fn.lower(*args).compile(compiler_options=FAST_COMPILE)
        out = []
        for i in range(spec["steps"]):
            logits, cache = step(params, cache, tokens[:, s + i:s + i + 1])
            out.append(np.asarray(logits)[:, 0])
    ref_model.set_activation_spec(None)
    np.save(spec["out"], np.stack(out))
