"""The pod dry run (``repro_torch.launch.dryrun``), continued from
``tests/test_torch_dryrun.py``:

* the pod axis: reduced smollm-360m and mixtral-8x7b on a 2×2×2 (pod,
  data, model) mesh of the fake group, a megatron train step (its token
  group (pod, data), whose gradients reduce-scatter over ``data`` and are
  summed over ``pod``) and a decode step: status ``ok``, resident bytes
  those of the blocks' ``local_shape``s;
* ``make_lowering_spec``'s mode logic against the reference's (a
  subprocess with 512 forced host devices): the activation mode after
  ``resolve_mode``, the MoE's ``moe_groups`` and the microbatches, for
  reduced mixtral in the three modes at train_4k and prefill_32k on 16×16
  and 2×16×16 (zero_batch at 512 ranks and a batch of 256 falls back to
  zero_seq);
* ``skip_reason``, ``SHAPE_OVERRIDES`` and ``default_microbatches`` equal
  to the reference's for all ten architectures and four shapes, and the
  CLI's flags and its JSON records.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import ARCHITECTURES
from repro_torch.launch import dryrun, specs
from repro_torch.train import sharding
from tests.test_torch_dryrun import (DECODE, MODES, TRAIN, check_record,
                                     config, run_cases)

ROOT = Path(__file__).resolve().parents[1]
CASES = [(a, s.name, "megatron", "2x2x2")
         for a in ("smollm-360m", "mixtral-8x7b") for s in (TRAIN, DECODE)]


@pytest.fixture(scope="module")
def records():
    return run_cases(CASES)


@pytest.mark.parametrize("arch,shape,mode,mesh", CASES,
                         ids=["-".join(c) for c in CASES])
def test_pod_workload_runs(arch, shape, mode, mesh, records):
    rec = records[(arch, shape, mode, mesh)]
    check_record(rec, arch, shape, mode, mesh)
    if shape == TRAIN.name:
        assert rec["collectives"]["reduce_scatter"]["calls"] > 0
        assert rec["collectives"]["all_reduce"]["calls"] > 0


REF_SCRIPT = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from repro.configs.base import INPUT_SHAPES, reduced
from repro.configs.registry import ARCHITECTURES
from repro.launch import specs
from repro.models import model
out = []
for multi in (False, True):
    shape = (2, 16, 16) if multi else (16, 16)
    axes = ("pod", "data", "model") if multi else ("data", "model")
    mesh = jax.make_mesh(shape, axes, axis_types=(
        jax.sharding.AxisType.Auto,) * len(axes))
    cfg = reduced(ARCHITECTURES["mixtral-8x7b"]).replace(vocab_size=512)
    for shape_name in ("train_4k", "prefill_32k"):
        for mode in ("megatron", "zero_seq", "zero_batch"):
            with mesh:
                ls = specs.make_lowering_spec(cfg, INPUT_SHAPES[shape_name],
                                              mesh, mode=mode)
            act = model.get_activation_spec()
            cells = [c.cell_contents for c in (ls.fn.__closure__ or ())]
            cfgs = [c for c in cells if hasattr(c, "moe_groups")]
            tcfgs = [c for c in cells if hasattr(c, "microbatches")]
            out.append({"multi": multi, "shape": shape_name, "mode": mode,
                        "act": None if act is None else [
                            list(e) if isinstance(e, tuple) else e
                            for e in act],
                        "moe_groups": cfgs[0].moe_groups,
                        "microbatches": tcfgs[0].microbatches
                        if tcfgs else 1})
            model.set_activation_spec(None)
print("RESULT " + json.dumps(out))
"""


def test_mode_logic_matches_reference():
    """``make_lowering_spec``'s resolved activation mode, ``moe_groups``
    and microbatches equal the reference's on the production meshes."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import make_production_mesh

    got = []
    cfg = config("mixtral-8x7b")
    try:
        for multi in (False, True):
            with dryrun.fake_group(512 if multi else 256):
                mesh = make_production_mesh(multi_pod=multi, device="cpu")
                dryrun.mesh_groups(mesh)
                for shape_name in ("train_4k", "prefill_32k"):
                    for mode in MODES:
                        with FakeTensorMode():
                            ws = specs.make_lowering_spec(
                                cfg, INPUT_SHAPES[shape_name], mesh,
                                mode=mode, device="cpu")
                        act = sharding.activation_spec(mesh, ws.act_mode)
                        got.append({
                            "multi": multi, "shape": shape_name,
                            "mode": mode,
                            "act": None if act is None else [
                                list(e) if isinstance(e, tuple) else e
                                for e in act],
                            "moe_groups": ws.cfg.moe_groups,
                            "microbatches": ws.microbatches})
    finally:
        out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    want = json.loads(out.split("RESULT ", 1)[1])
    assert got == want
    zb = [g for g in got if g["multi"] and g["mode"] == "zero_batch"
          and g["shape"] == "train_4k"][0]
    assert zb["act"] == [["pod", "data"], "model", None]   # zero_seq
    assert zb["moe_groups"] == 256


def test_skip_reason_matches_reference():
    from repro.configs.base import INPUT_SHAPES as REF_SHAPES
    from repro.configs.registry import ARCHITECTURES as REF_ARCHS
    from repro.launch import specs as ref_specs

    assert sorted(ARCHITECTURES) == sorted(REF_ARCHS)
    skipped = 0
    for arch in ARCHITECTURES:
        for name in INPUT_SHAPES:
            got = specs.skip_reason(ARCHITECTURES[arch], INPUT_SHAPES[name])
            want = ref_specs.skip_reason(REF_ARCHS[arch], REF_SHAPES[name])
            assert got == want, (arch, name)
            skipped += got is not None
    assert skipped == 7          # the seven full-attention architectures
    for (arch, shape), over in specs.SHAPE_OVERRIDES.items():
        assert ref_specs.SHAPE_OVERRIDES[(arch, shape)] == over
    for arch in ARCHITECTURES:
        assert specs.default_microbatches(ARCHITECTURES[arch]) == \
            ref_specs.default_microbatches(REF_ARCHS[arch])


def test_cli_flags_and_records(tmp_path):
    """The CLI with the reference's flags: a documented skip, one mesh
    only, the JSON records; the fake group gone after."""
    import torch.distributed as dist

    out = tmp_path / "dry.json"
    rc = dryrun.main(["--arch", "qwen3-14b", "--shape", "long_500k",
                      "--multi-pod", "--json", str(out)])
    assert rc == 0 and not dist.is_initialized()
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "skip" and rec["mesh"] == "pod2x16x16"
    assert rec["reason"].startswith("pure full-attention")


def test_mesh_microbatches_merge_until_they_split():
    """The mesh step's microbatches: the reference's count where a
    microbatch's rows split over the ranks holding distinct rows, else
    consecutive microbatches merged until they do."""
    from repro_torch.train.train_step import mesh_microbatches

    single = {"data": 16, "model": 16}
    multi = {"pod": 2, "data": 16, "model": 16}
    assert mesh_microbatches(16, 256, single) == 16
    assert mesh_microbatches(16, 256, multi) == 8         # 32 rows a step
    assert mesh_microbatches(8, 256, multi) == 8
    assert mesh_microbatches(4, 256, multi, "zero_seq") == 4
    assert mesh_microbatches(16, 256, single, "zero_batch") == 1
    assert mesh_microbatches(3, 8, {"data": 2, "model": 2}) == 1
    assert mesh_microbatches(4, 1, multi) == 4             # cannot split
