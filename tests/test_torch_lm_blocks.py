"""The LM side's pieces against the reference, each on the same inputs
(made with numpy from a seed) and the reference's weights:

* configs field for field; ``count_params_analytic`` and ``lm_batches``
  bit-equal; the port's initial tree has the reference's paths and shapes;
* ``rms_norm`` and rope (1e-6), ``sdpa`` causal, windowed, with ``kv_len``
  and ``q_offset``, chunked against unchunked (1e-5, gradients too);
* ``linear_attention`` against ``linear_attention_ref`` and against the
  reference's, both recurrences, with a carried state, at three chunk
  sizes (3e-5: the reference's chunked form is 3.3e-6 from its own oracle
  at chunk 8; the port's at chunk 32 1.3e-5), and the step form (1e-6);
* the MoE dispatch: the stable sort's slots, drops and order equal to the
  reference's ``_dispatch`` on ids full of ties; ``moe_block`` against
  ``moe_block_dense_ref`` with capacity lifted (the reference's own 5e-2)
  and against the reference's ``moe_block`` with drops (float32, 1e-5);
* the RWKV-6 and Mamba-2 blocks and their decode steps (float32, 1e-5);
* AdamW fed the reference's gradients: parameters and moments within
  8 ulp (of each leaf's largest magnitude) of the reference's over three
  steps (bit-equal for one leaf; over several, the clip scale follows the
  global norm, whose sum runs in another order, and v carries its
  square: measured 5); the schedule equal, the norm within 1e-6.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.data.synthetic import lm_batches as ref_lm_batches
from repro.models import layers as ref_layers
from repro.models import linear_attn as ref_la
from repro.models import moe as ref_moe
from repro.models import model as ref_model
from repro.models import ssm as ref_ssm
from repro.optim import adamw as ref_adamw
from repro_torch.configs import base
from repro_torch.configs.registry import ARCHITECTURES
from repro_torch.data.synthetic import lm_batches
from repro_torch.models import layers, linear_attn, moe, model, ssm
from repro_torch.optim import adamw
from tests.test_torch_lm_common import (ALL_ARCHS, REF_ARCHS, configs,
                                   float32_compute, np32, ref_jit, rel_err)
from tests.test_torch_lm_common import one_torch_thread  # noqa: F401 (autouse)


def t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x))


def j(x) -> jax.Array:
    return jnp.asarray(np.asarray(x))


# ---------------------------------------------------------------------------
# Configs, counts, data, the initial tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_configs_and_param_counts_equal_the_reference(arch):
    ref, cfg = REF_ARCHS[arch], ARCHITECTURES[arch]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(base.reduced(cfg)) == dataclasses.asdict(
        ref_base.reduced(ref))
    for c, rc in ((cfg, ref), (base.reduced(cfg), ref_base.reduced(ref))):
        assert c.param_count() == rc.param_count()
        assert c.active_param_count() == rc.active_param_count()
        assert c.padded_vocab == rc.padded_vocab
    assert {k: dataclasses.asdict(v) for k, v in base.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in ref_base.INPUT_SHAPES.items()}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_init_tree_has_the_reference_paths_and_shapes(arch):
    ref_cfg, cfg = configs(arch)
    shapes = jax.eval_shape(lambda k: ref_model.init_params(ref_cfg, k),
                            jax.random.PRNGKey(0))
    want = {"/".join(str(p.key) for p in path): (leaf.shape, leaf.dtype)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    tree = model.init_params(cfg, seed=1, device="cpu")

    def flat(tr, pre=()):
        for k, v in tr.items():
            if isinstance(v, dict):
                yield from flat(v, pre + (k,))
            else:
                yield "/".join(pre + (k,)), v

    got = {k: (tuple(v.shape), v.dtype) for k, v in flat(tree)}
    assert set(got) == set(want)
    for k, (shape, dtype) in want.items():
        assert got[k] == (tuple(shape), torch.float32), k
    # norms start at one, biases at zero, as the reference's
    assert bool((tree["final_norm"] == 1).all())
    std = float(tree["embed"].std()) * np.sqrt(cfg.d_model)
    assert 0.9 < std < 1.1


@pytest.mark.parametrize("kind", ["affine", "markov"])
def test_lm_batches_bit_equal(kind):
    for vocab, b, s, seed in ((512, 4, 64, 1), (49152, 2, 128, 3)):
        ours = list(lm_batches(vocab, b, s, 3, seed=seed, kind=kind))
        theirs = list(ref_lm_batches(vocab, b, s, 3, seed=seed, kind=kind))
        assert len(ours) == len(theirs) == 3
        for x, y in zip(ours, theirs):
            assert x["tokens"].dtype == y["tokens"].dtype
            np.testing.assert_array_equal(x["tokens"], y["tokens"])


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 4, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    got = layers.rms_norm(t(x), t(scale), 1e-5)
    want = ref_layers.rms_norm(j(x), j(scale), 1e-5)
    assert rel_err(np32(got), want) <= 1e-6
    pos = np.arange(8) + 5
    for p in (pos, np.stack([pos, pos + 3])):
        got = layers.apply_rope(t(x), t(p), 1e6)
        want = ref_layers.apply_rope(j(x), j(p), 1e6)
        assert rel_err(np32(got), want) <= 1e-6


@pytest.mark.parametrize("case", ["causal", "window", "kv_len", "cross"])
def test_sdpa_against_the_reference(case):
    rng = np.random.default_rng(1)
    b, sq, h, kv, hd = 2, 24, 4, 2, 16
    sk = 40 if case in ("kv_len", "cross") else sq
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, hd)).astype(np.float32)
    kw = {"causal": dict(causal=True),
          "window": dict(causal=True, window=5),
          "kv_len": dict(causal=True, q_offset=7, kv_len=31),
          "cross": dict(causal=False)}[case]
    want = ref_layers.sdpa(j(q), j(k), j(v), **kw)
    pkw = dict(kw)
    if "kv_len" in pkw:
        pkw["kv_len"] = torch.tensor(pkw["kv_len"])
        pkw["q_offset"] = torch.tensor(pkw["q_offset"])
    for chunk in (1024, 8, 7):        # unchunked; 3 chunks of 8; 24 → 6
        got = layers.sdpa(t(q), t(k), t(v), q_chunk=chunk, **pkw)
        assert rel_err(np32(got), want) <= 1e-5, chunk
    # the chunked backward (each chunk recomputed) equals the plain one
    grads = []
    for chunk in (1024, 8):
        qs, ks, vs = (t(a).requires_grad_(True) for a in (q, k, v))
        out = layers.sdpa(qs, ks, vs, q_chunk=chunk, **pkw)
        out.square().sum().backward()
        grads.append([a.grad.numpy() for a in (qs, ks, vs)])
    for g1, g2 in zip(*grads):
        assert rel_err(g2, g1) <= 1e-5


# ---------------------------------------------------------------------------
# Linear attention
# ---------------------------------------------------------------------------

def _la_inputs(seed, inclusive, s=32):
    rng = np.random.default_rng(seed)
    b, h, kd, p = 2, 3, 40, 8        # kd not a multiple of K_BLOCK
    r = rng.standard_normal((b, s, h, kd)).astype(np.float32)
    k = rng.standard_normal((b, s, h, kd)).astype(np.float32) * 0.5
    v = rng.standard_normal((b, s, h, p)).astype(np.float32)
    shape = (b, s, h, 1) if inclusive else (b, s, h, kd)
    # decays from near 1 down to below the MIN_LOG_W floor
    log_w = -np.exp(rng.uniform(-6.0, 4.5, size=shape)).astype(np.float32)
    u = rng.standard_normal((h, kd)).astype(np.float32) * 0.1
    state = rng.standard_normal((b, h, kd, p)).astype(np.float32)
    return r, k, v, log_w, u, state


@pytest.mark.parametrize("inclusive", [True, False])
def test_linear_attention_against_oracle_and_reference(inclusive):
    r, k, v, log_w, u, state = _la_inputs(2, inclusive)
    kw = dict(inclusive=inclusive, u=None if inclusive else u)
    for st in (None, state):
        ref_out, ref_st = ref_la.linear_attention(
            j(r), j(k), j(v), j(log_w), chunk=8,
            initial_state=None if st is None else j(st),
            **{**kw, "u": None if inclusive else j(u)})
        pkw = {**kw, "u": None if inclusive else t(u)}
        init = None if st is None else t(st)
        oracle = linear_attn.linear_attention_ref(
            t(r), t(k), t(v), t(log_w), initial_state=init, **pkw)
        for chunk in (8, 16, 32):
            out, fin = linear_attn.linear_attention(
                t(r), t(k), t(v), t(log_w), chunk=chunk, initial_state=init,
                **pkw)
            assert rel_err(np32(out), np32(oracle[0])) <= 3e-5
            assert rel_err(np32(fin), np32(oracle[1])) <= 3e-5
            assert rel_err(np32(out), ref_out) <= 3e-5
            assert rel_err(np32(fin), ref_st) <= 3e-5
    # one decode step from a carried state
    got = linear_attn.linear_attention_step(
        t(r[:, 0]), t(k[:, 0]), t(v[:, 0]), t(log_w[:, 0]), t(state),
        inclusive=inclusive, u=None if inclusive else t(u))
    want = ref_la.linear_attention_step(
        j(r[:, 0]), j(k[:, 0]), j(v[:, 0]), j(log_w[:, 0]), j(state),
        inclusive=inclusive, u=None if inclusive else j(u))
    for g, w in zip(got, want):
        assert rel_err(np32(g), w) <= 1e-6


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def test_dispatch_sorts_stably_as_the_reference():
    """Ids full of ties, a capacity that drops: slots, drops and the
    sorted tokens equal the reference's ``_dispatch`` exactly."""
    _, cfg = configs("phi3.5-moe-42b-a6.6b")
    ref_cfg = cfg
    rng = np.random.default_rng(3)
    t_, d, k, e = 40, 8, cfg.top_k, cfg.n_experts
    ids = np.stack([rng.permutation(e)[:k] for _ in range(t_)])
    ids[::3] = [0, 1]                  # expert 0 and 1 oversubscribed
    x = rng.standard_normal((t_, d)).astype(np.float32)
    gates = rng.uniform(size=(t_, k)).astype(np.float32)
    c = 16
    rbuf, rslot, rkeep, (rtok, rgate) = ref_moe._dispatch(
        ref_cfg, j(x), j(gates), j(ids.astype(np.int32)), c)
    buf, slot, keep, (tok, gate) = moe._dispatch(
        cfg, t(x)[None], t(gates)[None], t(ids.astype(np.int64))[None], c)
    assert not bool(keep.all())
    np.testing.assert_array_equal(keep[0].numpy(), np.asarray(rkeep))
    np.testing.assert_array_equal(slot[0].numpy(), np.asarray(rslot))
    np.testing.assert_array_equal(tok[0].numpy(), np.asarray(rtok))
    np.testing.assert_array_equal(gate[0].numpy(), np.asarray(rgate))
    np.testing.assert_array_equal(buf[0].numpy(), np.asarray(rbuf))


@pytest.fixture(scope="module")
def moe_setup():
    ref_cfg, cfg = configs("mixtral-8x7b")
    p = ref_moe.init_moe(ref_cfg, jax.random.PRNGKey(0))
    tree = {k: t(v) for k, v in p.items()}
    x = np.random.default_rng(1).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32)
    return ref_cfg, cfg, p, tree, x


def test_moe_matches_dense_oracle_without_drops(moe_setup):
    _, cfg, _, tree, x = moe_setup
    cfg = cfg.replace(capacity_factor=8.0)
    out, aux = moe.moe_block(cfg, tree, t(x))
    ref = moe.moe_block_dense_ref(cfg, tree, t(x))
    np.testing.assert_allclose(np32(out), np32(ref), atol=5e-2, rtol=5e-2)
    assert float(aux) > 0.0
    for groups in (2, 4):             # grouped == global without drops
        out_g, _ = moe.moe_block(cfg.replace(moe_groups=groups), tree, t(x))
        np.testing.assert_allclose(np32(out_g), np32(out), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("cf,groups", [(0.5, 0), (0.5, 4), (1.25, 2)])
def test_moe_with_drops_against_the_reference(moe_setup, cf, groups):
    ref_cfg, cfg, p, tree, x = moe_setup
    kw = dict(capacity_factor=cf, moe_groups=groups)
    with float32_compute():
        want, want_aux = ref_jit(lambda a: ref_moe.moe_block(
            ref_cfg.replace(**kw), p, a))(j(x))
        got, aux = moe.moe_block(cfg.replace(**kw), tree, t(x))
    assert rel_err(np32(got), want) <= 1e-5
    assert abs(float(aux) - float(want_aux)) <= 1e-6


# ---------------------------------------------------------------------------
# SSM blocks
# ---------------------------------------------------------------------------

def test_rwkv6_blocks_and_steps():
    ref_cfg, cfg = configs("rwkv6-3b")
    kt, kc = jax.random.split(jax.random.PRNGKey(4))
    pt = ref_ssm.init_rwkv6_time_mix(ref_cfg, kt)
    pc = ref_ssm.init_rwkv6_channel_mix(ref_cfg, kc)
    tt = {k: t(v) for k, v in pt.items()}
    tc = {k: t(v) for k, v in pc.items()}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    h, hd = ssm.rwkv_dims(cfg)
    state = rng.standard_normal((2, h, hd, hd)).astype(np.float32) * 0.1
    prev = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    with float32_compute():
        want = ref_jit(lambda *a: ref_ssm.rwkv6_time_mix(
            ref_cfg, pt, a[0], chunk=8, shift_prev=a[1], state=a[2]))(
                j(x), j(prev), j(state))
        got = ssm.rwkv6_time_mix(cfg, tt, t(x), chunk=8, shift_prev=t(prev),
                                 state=t(state))
        for g, w in zip(got, want):
            assert rel_err(np32(g), w) <= 1e-5
        want = ref_jit(lambda *a: ref_ssm.rwkv6_time_mix_step(
            ref_cfg, pt, *a))(j(x[:, :1]), j(prev), j(state))
        got = ssm.rwkv6_time_mix_step(cfg, tt, t(x[:, :1]), t(prev),
                                      t(state))
        for g, w in zip(got, want):
            assert rel_err(np32(g), w) <= 1e-5
        for sp in (None, prev):
            want = ref_ssm.rwkv6_channel_mix(
                ref_cfg, pc, j(x), shift_prev=None if sp is None else j(sp))
            got = ssm.rwkv6_channel_mix(
                cfg, tc, t(x), shift_prev=None if sp is None else t(sp))
            for g, w in zip(got, want):
                assert rel_err(np32(g), w) <= 1e-5


def test_mamba2_block_and_step():
    ref_cfg, cfg = configs("zamba2-2.7b")
    p = ref_ssm.init_mamba2(ref_cfg, jax.random.PRNGKey(6))
    tp = {k: t(v) for k, v in p.items()}
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    d_inner, h, hd = ssm.mamba2_dims(cfg)
    conv = rng.standard_normal((2, cfg.ssm_conv - 1, d_inner)).astype(
        np.float32)
    state = rng.standard_normal((2, h, cfg.ssm_state, hd)).astype(
        np.float32) * 0.1
    with float32_compute():
        for cp, st in ((None, None), (conv, state)):
            want = ref_jit(lambda *a: ref_ssm.mamba2_block(
                ref_cfg, p, a[0], chunk=8, conv_prev=a[1], state=a[2]))(
                    j(x), None if cp is None else j(cp),
                    None if st is None else j(st))
            got = ssm.mamba2_block(
                cfg, tp, t(x), chunk=8,
                conv_prev=None if cp is None else t(cp),
                state=None if st is None else t(st))
            for g, w in zip(got, want):
                assert rel_err(np32(g), w) <= 1e-5
        want = ref_jit(lambda *a: ref_ssm.mamba2_step(ref_cfg, p, *a))(
            j(x[:, :1]), j(conv), j(state))
        got = ssm.mamba2_step(cfg, tp, t(x[:, :1]), t(conv), t(state))
        for g, w in zip(got, want):
            assert rel_err(np32(g), w) <= 1e-5


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _ulps(a: np.ndarray, b: np.ndarray) -> float:
    """max |a − b| in ulps of b's largest magnitude (the sums of an
    update cancel, so an ulp of the operands is the unit)."""
    unit = np.spacing(np.float32(np.abs(b).max()))
    return float(np.abs(a.astype(np.float64) - b).max() / unit)


def test_adamw_update_from_the_reference_gradients():
    """Three steps fed the same gradients (the second clipped):
    parameters and moments within 8 ulp."""
    rng = np.random.default_rng(8)
    shapes = {"w": (6, 5), "b": (5,), "blocks": {"wq": (2, 4, 3, 2),
                                                 "ln": (2, 4)}}

    def draw(tree, scale):
        return {k: draw(v, scale) if isinstance(v, dict) else
                (rng.standard_normal(v) * scale).astype(np.float32)
                for k, v in tree.items()}

    params = draw(shapes, 1.0)
    grads = [draw(shapes, s) for s in (0.01, 5.0, 0.3)]
    jp = jax.tree.map(jnp.asarray, params)
    jst = ref_adamw.init(jp)
    tp = model.map_tree(torch.tensor, params)
    tst = adamw.init(tp)
    for i, g in enumerate(grads):
        lr_ref = ref_adamw.cosine_schedule(jst.step, peak_lr=1e-2, warmup=1,
                                           total=5)
        lr = adamw.cosine_schedule(tst.step, peak_lr=1e-2, warmup=1, total=5)
        assert float(lr) == float(lr_ref)
        jg = jax.tree.map(jnp.asarray, g)
        assert abs(float(adamw.global_norm(model.map_tree(torch.tensor, g)))
                   - float(ref_adamw.global_norm(jg))) <= 1e-6 * float(
                       ref_adamw.global_norm(jg))
        jp, jst = ref_adamw.update(jp, jg, jst, lr=lr_ref)
        tp, tst = adamw.update(tp, model.map_tree(torch.tensor, g), tst,
                               lr=lr)
        assert int(tst.step) == int(jst.step) == i + 1
        for got, want in ((tp, jp), (tst.m, jst.m), (tst.v, jst.v)):
            for a, b in zip(model.leaves(got), jax.tree.leaves(want)):
                assert _ulps(a.numpy(), np.asarray(b)) <= 8
