"""The reference's sharded LM train step for the mesh parity tests
(``tests/test_torch_lm_mesh_common.py`` starts it in a subprocess with
four forced host devices).  It holds no test of its own and imports
neither torch nor the port, so the subprocess starts quickly."""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import reduced
from repro.configs.registry import ARCHITECTURES
from repro.launch.mesh import make_host_mesh
from repro.models import layers, model
from repro.optim import adamw
from repro.train import sharding as sh
from repro.train.train_step import TrainConfig, make_train_step

# tests/test_torch_lm_common.py's FAST_COMPILE
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _tree(blob) -> dict:
    tree: dict = {}
    for key in blob.files:
        node = tree
        *pre, last = key.split("/")
        for k in pre:
            node = node.setdefault(k, {})
        node[last] = blob[key]
    return tree


def reference_runs(spec_path: str) -> None:
    """:func:`reference_run` of each job of the spec file."""
    for spec in json.loads(Path(spec_path).read_text()):
        reference_run(spec)


def reference_run(spec: dict) -> None:
    """The reference's sharded train step on a forced 4-device
    ``make_host_mesh(2, 2)`` (``Auto`` axes: ``jax.make_mesh``'s default
    ``Explicit`` axes refuse the zero modes' sharding constraints under
    JAX 0.9), built as its launcher builds it (``repro/launch/train.py``:
    ``resolve_mode``, the activation spec, the parameter and optimizer
    shardings, ``jax.jit`` with them), compiled at XLA's lowest
    optimisation level, float32 compute; the spec's steps for each of its
    modes, the metrics, AdamW's m and the parameters after the first step
    and the final parameters to the job's npz."""
    layers.COMPUTE_DTYPE = jnp.float32
    cfg = reduced(ARCHITECTURES[spec["arch"]]).replace(
        vocab_size=spec["vocab"], **spec["cfg_kw"])
    tree = _tree(np.load(spec["weights"]))
    data = np.load(spec["batches"])
    n = len({k.split("/")[0] for k in data.files})
    steps = [{k.split("/")[1]: jnp.asarray(data[k]) for k in data.files
              if k.startswith(f"{i}/")} for i in range(n)]
    mesh = make_host_mesh(2, 2)
    out = {}
    for mode in spec["modes"]:
        with mesh:
            got = sh.resolve_mode(mesh, mode, spec["batch"], spec["seq"])
            assert got == mode, (mode, got)
            param_mode = "zero_seq" if mode == "zero_batch" else mode
            model.set_activation_spec(
                sh.activation_spec(mesh, mode),
                mesh=mesh if mode != "megatron" else None)
            params = jax.tree.map(jnp.asarray, tree)
            opt = adamw.init(params)
            pshard = sh.named(sh.param_specs(params, mesh=mesh, fsdp=True,
                                             mode=param_mode), mesh)
            oshard = type(opt)(step=sh.named(
                jax.sharding.PartitionSpec(), mesh), m=pshard, v=pshard)
            params = jax.tree.map(jax.device_put, params, pshard)
            opt = adamw.AdamWState(
                step=opt.step,
                m=jax.tree.map(jax.device_put, opt.m, pshard),
                v=jax.tree.map(jax.device_put, opt.v, pshard))
            fn = jax.jit(make_train_step(cfg, TrainConfig(**spec["train"])),
                         in_shardings=(pshard, oshard, None),
                         out_shardings=(pshard, oshard, None))
            compiled = fn.lower(params, opt, steps[0]).compile(
                compiler_options=FAST_COMPILE)
            for i, b in enumerate(steps):
                params, opt, m = compiled(params, opt, b)
                out[f"{mode}/metrics/{i}/loss"] = np.asarray(m["loss"])
                out[f"{mode}/metrics/{i}/grad_norm"] = np.asarray(
                    m["grad_norm"])
                if i == 0:              # AdamW's m and the parameters
                    for j, (g, x) in enumerate(zip(   # after step 1
                            jax.tree.leaves(opt.m),
                            jax.tree.leaves(params))):
                        out[f"{mode}/m1/{j:04d}"] = np.asarray(g)
                        out[f"{mode}/params1/{j:04d}"] = np.asarray(x)
            for j, leaf in enumerate(jax.tree.leaves(params)):
                out[f"{mode}/params/{j:04d}"] = np.asarray(leaf)
        model.set_activation_spec(None)
    np.savez(spec["out"], **out)
