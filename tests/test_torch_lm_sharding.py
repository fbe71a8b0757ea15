"""The port's sharding rules (``repro_torch.train.sharding``) against the
reference's (``repro.train.sharding``), entry for entry, in one process and
without a mesh: ``param_specs`` (the megatron rule and the zero rule, FSDP
on and off), ``data_specs`` (the three modes), ``resolve_mode``,
``activation_spec`` and ``cache_specs`` for each of the ten architectures'
full-size shapes (``jax.eval_shape`` of the reference's ``init_params``
and ``init_cache``; the port's ``model.param_shapes`` must give the same
shapes), at the meshes 2×2, 16×16 and the pod's 2×16×16.

The reference's functions read only a mesh's ``axis_names``, ``devices``'
shape and ``shape``: they get a stand-in carrying those (an empty numpy
array of the mesh's shape as ``devices``); the port's get the mapping
{axis: size}.  Every parameter spec divides its leaf: the local blocks
(``local_shape``) tile it.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.configs.registry import ARCHITECTURES as REF_ARCHS
from repro.models import model as ref_model
from repro.train import sharding as ref_sh
from repro_torch.configs.registry import ARCHITECTURES
from repro_torch.models import model
from repro_torch.train import sharding

ALL_ARCHS = sorted(ARCHITECTURES)
MESHES = {"2x2": {"data": 2, "model": 2},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def stand_in(sizes: dict):
    """What the reference's rules read of a ``jax.sharding.Mesh``."""
    return SimpleNamespace(axis_names=tuple(sizes),
                           devices=np.empty(tuple(sizes.values())),
                           shape=dict(sizes))


def flat(tree, pre=()) -> dict:
    """{path: leaf} of a nested dict."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, pre + (k,)))
        else:
            out[pre + (k,)] = v
    return out


def specs_equal(got, want) -> None:
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys()
    bad = {p: (g[p], tuple(w[p])) for p in w if tuple(g[p]) != tuple(w[p])}
    assert not bad, bad


@pytest.fixture(scope="module")
def shapes():
    """Per architecture: (the reference's abstract parameters, the port's
    meta-tensor parameters, the reference's abstract decode cache)."""
    out = {}
    for arch in ALL_ARCHS:
        ref_cfg = REF_ARCHS[arch]
        ref = jax.eval_shape(lambda k: ref_model.init_params(ref_cfg, k),
                             jax.random.PRNGKey(0))
        cache = jax.eval_shape(lambda: ref_model.init_cache(ref_cfg, 32,
                                                            1024))
        out[arch] = (ref, model.param_shapes(ARCHITECTURES[arch]), cache)
    return out


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_shapes_are_the_reference_shapes(arch, shapes):
    ref, port, _ = shapes[arch]
    want = {p: tuple(x.shape) for p, x in flat(ref).items()}
    got = {p: tuple(x.shape) for p, x in flat(port).items()}
    assert got == want
    assert all(x.device.type == "meta" for x in flat(port).values())


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_equal_the_reference(arch, mesh, shapes):
    ref, port, _ = shapes[arch]
    sizes = MESHES[mesh]
    for mode in ("megatron", "zero_seq"):
        for fsdp in (True, False):
            want = ref_sh.param_specs(ref, mesh=stand_in(sizes), fsdp=fsdp,
                                      mode=mode)
            got = sharding.param_specs(port, mesh=sizes, fsdp=fsdp,
                                       mode=mode)
            specs_equal(got, want)
            # every spec divides its leaf: the blocks tile the leaf
            for p, sp in flat(got).items():
                shape = flat(port)[p].shape
                local = sharding.local_shape(shape, sp, sizes)
                assert np.prod(local) * np.prod(
                    [sizes[a] for a in sharding.spec_axes(sp)]) == \
                    np.prod(shape), (p, sp)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_data_activation_and_mode_rules_equal_the_reference(mesh):
    sizes = MESHES[mesh]
    ref_mesh = stand_in(sizes)
    for b, s in ((1024, 4096), (256, 4096), (32, 1500), (8, 30), (2, 64)):
        template = {"tokens": np.zeros((b, s)),
                    "frames": np.zeros((b, 1500, 8)),
                    "patch_embeds": np.zeros((b, 256, 8)),
                    "scalar": np.zeros(())}
        for mode in ("megatron", "zero_seq", "zero_batch"):
            want = jax.tree.map(tuple, ref_sh.data_specs(
                template, ref_mesh, mode), is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))
            got = sharding.data_specs(template, sizes, mode)
            assert {k: tuple(v) for k, v in got.items()} == want, (b, s,
                                                                   mode)
            assert sharding.resolve_mode(sizes, mode, b, s) == \
                ref_sh.resolve_mode(ref_mesh, mode, b, s)
            assert sharding.resolve_mode(sizes, mode, b) == \
                ref_sh.resolve_mode(ref_mesh, mode, b)
    for mode in ("megatron", "zero_seq", "zero_batch"):
        want = ref_sh.activation_spec(ref_mesh, mode)
        got = sharding.activation_spec(sizes, mode)
        assert (got is None and want is None) or tuple(got) == tuple(want)
    assert sharding.batch_axes(sizes) == ref_sh.batch_axes(ref_mesh)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_specs_equal_the_reference(arch, mesh, shapes):
    _, _, cache = shapes[arch]
    sizes = MESHES[mesh]
    want = ref_sh.cache_specs(cache, stand_in(sizes))
    port_cache = {p: SimpleNamespace(shape=tuple(x.shape))
                  for p, x in flat(cache).items()}
    tree: dict = {}
    for p, x in port_cache.items():
        node = tree
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = x
    specs_equal(sharding.cache_specs(tree, sizes), want)
