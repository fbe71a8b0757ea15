"""The pod dry run (``repro_torch.launch.dryrun``) on torch.distributed's
fake process group, the mirror of ``tests/test_lowering_modes.py``:

* reduced smollm-360m, mixtral-8x7b and rwkv6-3b (vocabulary 512) on a
  2×4 (data, model) mesh: a train step of 8 × 64 tokens in each of
  megatron, zero_seq and zero_batch, a zero_seq prefill and a decode step
  against a 64-position cache, each run once as rank 0 under
  ``FakeTensorMode``: status ``ok``, the rank's resident bytes those of
  its blocks' ``local_shape``s (a served weight with a compute split,
  ``layers.leaf_layout``, that of rank 0's range), collectives counted;

``tests/test_torch_dryrun_pod.py`` holds the pod axis, the mode logic
against the reference's, ``skip_reason`` and the CLI.  One fake group a
module fixture, destroyed after, so the worker's later tests may start
real groups.
"""

from __future__ import annotations

import math

import pytest

from repro_torch.configs.base import InputShape, reduced
from repro_torch.configs.registry import ARCHITECTURES
from repro_torch.core import collectives
from repro_torch.launch import dryrun
from repro_torch.models import layers, model
from repro_torch.train import sharding

TRAIN = InputShape("tiny_train", 64, 8, "train")
PREFILL = InputShape("tiny_prefill", 64, 8, "prefill")
DECODE = InputShape("tiny_decode", 64, 8, "decode")
MODES = ("megatron", "zero_seq", "zero_batch")
ARCHS = ("smollm-360m", "mixtral-8x7b", "rwkv6-3b")
MESH = {"data": 2, "model": 4}
POD = {"pod": 2, "data": 2, "model": 2}


def config(arch: str):
    return reduced(ARCHITECTURES[arch]).replace(vocab_size=512)


def cases():
    """(arch, shape, mode, mesh) of the 2×4 runs."""
    out = [(a, TRAIN.name, m, "2x4") for a in ARCHS for m in MODES]
    out += [(a, DECODE.name, "megatron", "2x4") for a in ARCHS]
    out += [("smollm-360m", PREFILL.name, "zero_seq", "2x4")]
    return out


CASES = cases()
SHAPES = {s.name: s for s in (TRAIN, PREFILL, DECODE)}


def run_cases(cases_) -> dict:
    """The dry run's record of each case, in one fake group of 8 ranks."""
    out = {}
    with dryrun.fake_group(8):
        for arch, shape, mode, mesh in cases_:
            out[(arch, shape, mode, mesh)] = dryrun.run_one(
                arch, SHAPES[shape], cfg=config(arch), sharding_mode=mode,
                mesh_shape=MESH if mesh == "2x4" else POD, verbose=False)
    return out


@pytest.fixture(scope="module")
def records():
    return run_cases(CASES)


def _resident(arch: str, shape, mode: str, sizes: dict) -> dict:
    """The bytes of rank 0's blocks from ``local_shape`` of their specs
    (the serve weights re-laid into their compute split: rank 0's range
    of its dim)."""
    cfg = config(arch)
    act = mode if shape.kind != "decode" else "megatron"
    act = sharding.resolve_mode(sizes, act, shape.global_batch,
                                shape.seq_len)
    if cfg.n_experts and act != "megatron":
        cfg = cfg.replace(moe_groups=8 if act == "zero_batch"
                          else shape.global_batch)

    def nbytes(shapes, spec_tree, itemsize=None):
        return sum(
            math.prod(sharding.local_shape(x.shape, sp, sizes))
            * (itemsize or x.element_size())
            for x, sp in zip(model.leaves(shapes), model.leaves(spec_tree)))

    shapes = model.param_shapes(cfg)
    if shape.kind == "train":
        specs_ = sharding.param_specs(
            shapes, mesh=sizes, fsdp=True,
            mode="zero_seq" if act == "zero_batch" else act)
        one = nbytes(shapes, specs_)
        return {"params": one, "opt": 2 * one + 4}
    m = sizes["model"]

    def served(path, x, sp):
        local = list(sharding.local_shape(x.shape, sp, sizes))
        lay = layers.leaf_layout(cfg, path, m) if m > 1 else None
        if lay is not None:
            local = list(x.shape)
            local[lay[0]] = collectives.span_len(lay[1][0])
        return math.prod(local) * 2

    specs_ = sharding.param_specs(shapes, mesh=sizes, fsdp=False)
    got = []
    sharding.map_with_path(lambda p, x: got.append(served(
        p, x, model.specs_at(specs_, p))), shapes)
    out = {"params": sum(got)}
    if shape.kind == "decode":
        cache = model.cache_shapes(cfg, shape.global_batch, shape.seq_len)
        out["cache"] = nbytes(cache, sharding.cache_specs(cache, sizes))
    return out


def check_record(rec: dict, arch: str, shape: str, mode: str,
                 mesh: str) -> None:
    assert rec["status"] == "ok", rec.get("error")
    sizes = MESH if mesh == "2x4" else POD
    assert rec["resident_bytes"] == _resident(arch, SHAPES[shape], mode,
                                              sizes)
    assert rec["peak_bytes"] >= rec["resident_total_bytes"]
    assert rec["coll_bytes"] > 0 and rec["chips"] == 8
    assert rec["t_collective_s"] > 0 and rec["t_compute_s"] > 0
    if SHAPES[shape].kind == "decode":
        assert rec["act_mode"] == "megatron"
        kinds = {"all_gather", "all_reduce"}
        if config(arch).family in ("ssm", "hybrid"):
            kinds.add("all_to_all")  # the SSM heads' outputs, back to them
        assert set(rec["collectives"]) <= kinds


@pytest.mark.parametrize("arch,shape,mode,mesh", CASES,
                         ids=["-".join(c) for c in CASES])
def test_dry_run_workload_runs(arch, shape, mode, mesh, records):
    check_record(records[(arch, shape, mode, mesh)], arch, shape, mode, mesh)


@pytest.mark.parametrize("arch,mode", [("smollm-360m", "megatron"),
                                       ("mixtral-8x7b", "zero_seq")])
def test_repeated_microbatches_count_as_the_full_run(arch, mode):
    """A train step of 4 microbatches on the fake group: running the first
    two and counting the others as repeats of the second gives the full
    run's collectives, call for call and byte for byte, and its peak but
    for the later microbatches' metrics (two float32 scalars each, kept
    to the step's end).  A first run warms the group's caches, which add
    to the first peak taken in it."""
    runs = []
    with dryrun.fake_group(8):
        for rep in (True, False, True):
            runs.append(dryrun.run_one(
                arch, TRAIN, cfg=config(arch), sharding_mode=mode,
                mesh_shape=MESH, verbose=False, microbatches=4,
                repeat_second=rep))
    _, full, fast = runs
    for rec in runs:
        assert rec["status"] == "ok", rec.get("error")
        assert rec["microbatches_run"] == 4
    assert fast["collectives"] == full["collectives"]
    assert fast["coll_bytes"] == full["coll_bytes"]
    assert 0 <= full["peak_bytes"] - fast["peak_bytes"] <= 8 * (4 - 2)
