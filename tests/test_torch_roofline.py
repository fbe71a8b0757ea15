"""The dry run's roofline (``repro_torch.launch.roofline``) against the
reference's (``repro.launch.roofline``), and the collectives' tally:

* ``analytic_flops``, ``analytic_hbm_bytes`` and ``model_flops`` equal the
  reference's, exactly, for the ten architectures × the four input shapes
  × 256 and 512 chips (the shape's overrides applied, as the dry runs
  apply them);
* ``Roofline``'s three terms over the H100 SXM constants of
  ``launch/mesh.py`` (989e12 FLOP/s, 3.35e12 B/s, NVLink 450e9 B/s), its
  bottleneck, useful ratio, step time and MFU bound, and the keys of
  ``row()`` that ``benchmarks/bench_roofline.py`` reads;
* ``core.collectives.tally`` on a 2-rank gloo group: a bucketed gather of
  two tensors and its backward's reduce-scatter, an all-reduce and an
  all-to-all, their calls, input bytes and output bytes.
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import ARCHITECTURES
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_analytic_terms_equal_reference(arch):
    from repro.configs.base import INPUT_SHAPES as REF_SHAPES
    from repro.configs.registry import ARCHITECTURES as REF_ARCHS
    from repro.launch import roofline as ref_rl
    from repro.launch import specs as ref_specs

    for name in INPUT_SHAPES:
        cfg = specs.apply_overrides(ARCHITECTURES[arch], INPUT_SHAPES[name])
        ref_cfg = ref_specs.apply_overrides(REF_ARCHS[arch],
                                            REF_SHAPES[name])
        shape, ref_shape = INPUT_SHAPES[name], REF_SHAPES[name]
        assert rl.analytic_flops(cfg, shape) == ref_rl.analytic_flops(
            ref_cfg, ref_shape)
        assert rl.model_flops(cfg, shape, shape.kind) == ref_rl.model_flops(
            ref_cfg, ref_shape, ref_shape.kind)
        n_mb = specs.default_microbatches(cfg)
        for chips in (256, 512):
            assert rl.analytic_hbm_bytes(cfg, shape, chips, n_mb) == \
                ref_rl.analytic_hbm_bytes(ref_cfg, ref_shape, chips, n_mb)


def test_roofline_terms_use_h100_constants():
    assert (mesh_mod.PEAK_FLOPS_BF16, mesh_mod.HBM_BW, mesh_mod.NVLINK_BW) \
        == (989e12, 3.35e12, 450e9)
    tally = {"all_gather": {"calls": 3, "bytes": 100, "out_bytes": 1600},
             "reduce_scatter": {"calls": 1, "bytes": 1600,
                                "out_bytes": 100}}
    cfg, shape = ARCHITECTURES["qwen3-14b"], INPUT_SHAPES["decode_32k"]
    r = rl.analyze(tally, cfg=cfg, shape=shape, mesh_name="pod16x16",
                   chips=256)
    flops = rl.analytic_flops(cfg, shape)["flops"]
    hbm = rl.analytic_hbm_bytes(cfg, shape, 256)
    assert r.t_compute == flops / (256 * 989e12)
    assert r.t_memory == hbm / 3.35e12
    assert r.coll_bytes == 1700 and r.t_collective == 1700 / 450e9
    assert r.coll_by_kind == {"all_gather": 1600, "reduce_scatter": 100}
    assert r.coll_counts == {"all_gather": 3, "reduce_scatter": 1}
    assert r.step_time == max(r.t_compute, r.t_memory, r.t_collective)
    assert r.bottleneck == "memory"          # decode reads the weights
    assert r.useful_ratio == rl.model_flops(cfg, shape, "decode") / flops
    assert r.mfu == r.model_flops / (r.step_time * 256 * 989e12)
    row = r.row()
    for key in ("arch", "shape", "mesh", "t_compute_s", "t_memory_s",
                "t_collective_s", "bottleneck", "useful_ratio"):
        assert key in row
    assert not [k for k in row if "hlo" in k or "loop" in k]


def tally_rank(mesh, dev) -> dict:
    """One rank of the tally check: a bucketed gather of a (3, 4) and a
    (2, 5) float32 tensor over the 2-rank group, its backward's
    reduce-scatter, an all-reduce of 6 float32 and an all-to-all of 8
    bfloat16, counted by kind and by name."""
    from repro_torch.core import collectives

    group = mesh.get_group("model")
    a = torch.ones(3, 4, requires_grad=True)
    b = torch.ones(2, 5, requires_grad=True)
    with collectives.tally() as kinds, collectives.tally("what") as names:
        ga, gb = collectives.gather_leaves([a, b], [(group, True,
                                                     {0: 0, 1: 1})],
                                           what="w")
        (ga.sum() + gb.sum()).backward()
        collectives.all_reduce_sum(torch.ones(6), group, "m")
        collectives.all_to_all(torch.ones(8, dtype=torch.bfloat16), group,
                               "x")
    return {"kinds": kinds, "names": names}


def test_tally_counts_known_collectives():
    got = mesh_mod.run_on_mesh(tally_rank, 1, 2, device="cpu", timeout=120)
    assert got[0] == got[1]
    inp = (12 + 10) * 4                      # the bucket's input, float32
    assert got[0]["kinds"] == {
        "all_gather": {"calls": 1, "bytes": inp, "out_bytes": 2 * inp},
        "reduce_scatter": {"calls": 1, "bytes": 2 * inp, "out_bytes": inp},
        "all_reduce": {"calls": 1, "bytes": 24, "out_bytes": 24},
        "all_to_all": {"calls": 1, "bytes": 16, "out_bytes": 16}}
    assert set(got[0]["names"]) == {"all_gather w", "reduce_scatter w grad",
                                    "all_reduce m", "all_to_all x"}
