"""Shared set-up of the LM parity tests (``tests/test_torch_lm_*.py``): the
reference's reduced configs and weights, the same batch for both packages
made with numpy from a seed, the float32 switch of both packages'
``COMPUTE_DTYPE``, and the checks the model files run per architecture.
It holds no test of its own."""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced as ref_reduced
from repro.configs.registry import ARCHITECTURES as REF_ARCHS
from repro.models import layers as ref_layers
from repro.models import model as ref_model
from repro_torch import bridge
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import ARCHITECTURES
from repro_torch.models import layers, model

ALL_ARCHS = sorted(ARCHITECTURES)
B, S = 2, 32
# XLA's CPU backend at its lowest optimisation level for the reference's
# functions: they compile ~30% faster, and the tests' small shapes run no
# slower (the tolerances below hold at either level).
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def ref_jit(fn):
    """``jax.jit(fn)``, compiled with FAST_COMPILE at its first call."""
    def call(*args):
        return jax.jit(fn).lower(*args).compile(
            compiler_options=FAST_COMPILE)(*args)
    return call


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's many small CPU ops on one intra-op thread, restored after
    the module: with several test workers on one machine, torch's default
    thread pool a worker oversubscribes the cores (a reduced train step
    went from 0.2 s alone to 19 s under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch: str, **kw):
    """(reference config, port config) of ``arch`` at ``reduced()`` size."""
    return (ref_reduced(REF_ARCHS[arch]).replace(**kw),
            reduced(ARCHITECTURES[arch]).replace(**kw))


def ref_params(ref_cfg, seed: int):
    """The reference's initial weights and the port's copy of them."""
    params = ref_jit(lambda k: ref_model.init_params(ref_cfg, k))(
        jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    return params, bridge.lm_params_from(tree, device="cpu")


def batch(cfg, seed: int, b: int = B, s: int = S) -> dict[str, np.ndarray]:
    """Tokens (and the VLM's patch embeddings or the audio frames) drawn
    with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.vision_dim)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (b, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return out


def jax_batch(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def torch_batch(b: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in b.items()}


@contextlib.contextmanager
def float32_compute():
    """Both packages' matmuls in float32 (their ``COMPUTE_DTYPE``)."""
    saved = ref_layers.COMPUTE_DTYPE, layers.COMPUTE_DTYPE
    ref_layers.COMPUTE_DTYPE, layers.COMPUTE_DTYPE = jnp.float32, torch.float32
    try:
        yield
    finally:
        ref_layers.COMPUTE_DTYPE, layers.COMPUTE_DTYPE = saved


def rel_err(got, want) -> float:
    """max |got − want| over max |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def margin_argmax_agree(got: np.ndarray, want: np.ndarray,
                        tol: float) -> bool:
    """Argmax equal wherever ``want``'s top-2 margin exceeds ``tol`` (a
    near tie may go either way in either package)."""
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > tol
    return bool(np.all((got.argmax(-1) == want.argmax(-1)) | ~decided))


def check_float32(arch: str, params, tree) -> None:
    """forward, logits, ``chunked_ce_loss`` and the gradients of
    ``loss_fn`` against the reference with both packages computing in
    float32, from the reference's weights ``params`` and the port's copy
    ``tree``: relative error ≤ 1e-4 (gradients ≤ 2e-4, each leaf's max
    error over its max)."""
    from repro.train import loss as ref_loss
    from repro.train import train_step as ref_ts
    from repro_torch.train import loss, train_step

    ref_cfg, cfg = configs(arch)
    seed = ALL_ARCHS.index(arch)
    with float32_compute():
        b = batch(cfg, seed)
        rb = jax_batch(b)
        ref_tc = ref_ts.TrainConfig(loss_chunk=16)

        def ref_fn(p):
            (l, met), g = jax.value_and_grad(
                lambda q: ref_ts.loss_fn(ref_cfg, ref_tc, q, rb),
                has_aux=True)(p)
            h, aux = ref_model.forward(ref_cfg, p, rb, remat=False)
            _, targets, mask = ref_ts.shift_targets(rb["tokens"])
            ce12 = ref_loss.chunked_ce_loss(ref_cfg, p, h, targets, mask,
                                            chunk=12)
            return l, met, g, h, aux, ref_model.logits_fn(ref_cfg, p, h), ce12

        l, met, g, h, aux, logits, ce12 = ref_jit(ref_fn)(params)
        tb = torch_batch(b)
        ph, paux = model.forward(cfg, tree, tb, remat=False)
        plogits = model.logits_fn(cfg, tree, ph)
        _, targets, mask = train_step.shift_targets(tb["tokens"])
        pce12 = loss.chunked_ce_loss(cfg, tree, torch.tensor(np.asarray(h)),
                                     targets, mask, chunk=12)
        pl, pmet, pg = train_step.grads_of(
            cfg, train_step.TrainConfig(loss_chunk=16), tree, tb)

    assert rel_err(np32(ph), h) <= 1e-4
    assert rel_err(np32(plogits), logits) <= 1e-4
    assert abs(float(paux) - float(aux)) <= 1e-4 * max(float(aux), 1e-3)
    assert abs(float(pce12) - float(ce12)) <= 1e-5 * float(ce12)
    assert abs(float(pl) - float(l)) <= 1e-4 * float(l)
    assert abs(float(pmet["ce"]) - float(met["ce"])) <= 1e-4 * float(met["ce"])
    want = jax.tree_util.tree_flatten_with_path(g)[0]
    got = model.leaves(pg)
    assert len(got) == len(want)
    for (path, w), gl in zip(want, got):
        assert gl.shape == w.shape, path
        assert rel_err(np32(gl), w) <= 2e-4, (arch, path)


def frob(got, want) -> float:
    """||got − want|| / ||want||, Frobenius."""
    got, want = np32(got).astype(np.float64), np32(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def bf16_grad_gaps(arch: str, params, tree, b: int = B,
                   s: int = S) -> dict:
    """The bf16 comparison of ``check_bf16`` from the reference's weights
    ``params`` (the port's copy ``tree``) on its batch of ``b`` × ``s``:
    the hidden states' and the logits' relative Frobenius errors, the
    losses, and for each gradient leaf of ``loss_fn`` (its path) the
    port's bf16 gradient's error against the reference's bf16 gradient
    and the reference's own bf16 gradient's against its float32 one.  The
    reference computes all of it in one compiled call, its float32
    gradient traced with both packages' ``COMPUTE_DTYPE`` patched."""
    from repro.train import train_step as ref_ts
    from repro_torch.train import train_step

    ref_cfg, cfg = configs(arch)
    bt = batch(cfg, 100 + ALL_ARCHS.index(arch), b, s)
    rb = jax_batch(bt)
    ref_tc = ref_ts.TrainConfig(loss_chunk=16)

    def ref_loss(p):
        return ref_ts.loss_fn(ref_cfg, ref_tc, p, rb)[0]

    def ref_fn(p):
        h, _ = ref_model.forward(ref_cfg, p, rb, remat=False)
        loss, g = jax.value_and_grad(ref_loss)(p)
        with float32_compute():
            g32 = jax.grad(ref_loss)(p)
        return h, ref_model.logits_fn(ref_cfg, p, h), loss, g, g32

    h, logits, loss, g, g32 = ref_jit(ref_fn)(params)
    tb = torch_batch(bt)
    with torch.no_grad():
        ph, _ = model.forward(cfg, tree, tb, remat=False)
        plogits = model.logits_fn(cfg, tree, ph)
    ploss, _, pg = train_step.grads_of(
        cfg, train_step.TrainConfig(loss_chunk=16), tree, tb)
    assert ph.dtype == torch.bfloat16 and plogits.dtype == torch.float32
    want = jax.tree_util.tree_flatten_with_path(g)[0]
    want32 = jax.tree_util.tree_leaves(g32)
    got = model.leaves(pg)
    assert len(got) == len(want) == len(want32)
    grads = {}
    for (path, w), w32, gl in zip(want, want32, got):
        assert gl.shape == w.shape, path
        grads[jax.tree_util.keystr(path)] = (frob(gl, w), frob(w, w32))
    return {"h": frob(ph, h), "logits": frob(plogits, logits),
            "loss": (float(ploss), float(loss)), "grads": grads}


# check_bf16's bounds (relative Frobenius errors, port against reference
# at bf16; measured figures in its docstring): hidden states and logits,
# dense and MoE; a gradient leaf within GRAD_GAP times the reference's own
# bf16-vs-float32 gap of that leaf, or the floor where that is larger.
FORWARD_BOUND, MOE_BOUND = 3e-2, 0.15
GRAD_GAP, GRAD_FLOOR, MOE_GRAD_FLOOR = 1.5, 1e-2, 0.15


def check_bf16(arch: str, params, tree, b: int = B, s: int = S) -> None:
    """forward, logits, ``loss_fn``'s value and its gradients against the
    reference at the default bf16 compute (:func:`bf16_grad_gaps`).  The
    port keeps in float32 every product the reference keeps in float32
    (``models/layers.py``'s ``einsum_f32``) but Mamba-2's in-projection
    (``ssm._mamba2_core``), so elsewhere the two packages' bf16
    computations differ in the order of their float32 sums alone, and a
    bf16 rounding of two such sums may land an ulp apart.

    * Hidden states and logits within FORWARD_BOUND (3e-2; measured 5.7e-3
      to 9.7e-3, zamba2 1.54e-2), the MoE pair within
      MOE_BOUND (0.15; measured 0.033 and 0.077: one or two of the 128
      routing decisions sit at a near tie that an ulp upstream flips, with
      the capacity lifted too, while the MoE block on equal inputs agrees
      to 1e-5 in ``test_torch_lm_blocks.py``).
    * The loss within 1e-3 relative (measured at most 3.1e-4), the MoE
      pair 5e-3 (measured 1.8e-4; a flipped token's own loss moves the
      mean by ~1/62).
    * Every gradient leaf within GRAD_GAP (1.5) times the reference's own
      bf16-vs-float32 gap of that leaf, or GRAD_FLOOR (1e-2) where that is
      larger: the ratio measured at most 1.05 (internvl2's ``ln1``) for
      the dense eight, 0.71 for zamba2; the smallest own gap 5.5e-3
      (whisper), where the ratio reads ~1.  The MoE pair's floor is
      MOE_GRAD_FLOOR (0.15, its forward bound, for the same flipped
      routes): phi3.5's router read 0.128 against its own 0.088 (1.46×).
      One bf16 rounding of a product the reference keeps in float32 shows
      here: rwkv6's ``tmix/u`` reads 2.29× with one.  Mamba-2's rounded
      in-projection does not at 2 × 32; at 4 × 64 zamba2's ``dt_bias``
      reads 1.76× (ROADMAP C.5; ``test_torch_lm_f32_products.py`` pins
      that rounding)."""
    got = bf16_grad_gaps(arch, params, tree, b, s)
    moe = configs(arch)[1].family == "moe"
    bound = MOE_BOUND if moe else FORWARD_BOUND
    assert got["h"] <= bound
    assert got["logits"] <= bound
    ploss, loss = got["loss"]
    assert abs(ploss - loss) <= (5e-3 if moe else 1e-3) * loss
    floor = MOE_GRAD_FLOOR if moe else GRAD_FLOOR
    for path, (gap, own) in got["grads"].items():
        assert gap <= max(GRAD_GAP * own, floor), (arch, path, gap, own)


# Prefill and decode

S, MAX_LEN = 32, 40


def lifted(arch: str) -> dict:
    cfg = ARCHITECTURES[arch]
    return {"capacity_factor": float(min(cfg.n_experts, 4))} \
        if cfg.n_experts else {}


def flat(tree, pre=()):
    """(path, leaf) of a nested dict, keys sorted."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from flat(v, pre + (k,))
        else:
            yield "/".join(pre + (k,)), v


def check_decode_against_reference(arch: str, params, tree) -> None:
    """Prefill and one decode step against the reference's, from its
    weights ``params`` (the port's copy ``tree``), both packages in
    float32 (their caches in bf16): the tolerances are the decode tests'
    (``test_torch_lm_model_a.py``)."""
    ref_cfg, cfg = configs(arch, **lifted(arch))
    seed = 200 + ALL_ARCHS.index(arch)
    with float32_compute():
        b = batch(cfg, seed, s=S + 1)
        pre = dict(b, tokens=b["tokens"][:, :S])
        nxt = b["tokens"][:, S:S + 1]
        logits, cache = ref_jit(lambda p, x: ref_model.prefill(
            ref_cfg, p, x, MAX_LEN))(params, jax_batch(pre))
        cache_np = jax.tree.map(np.asarray, cache)
        logits2, _ = ref_jit(lambda p, c, t: ref_model.decode_step(
            ref_cfg, p, c, t))(params, cache, jnp.asarray(nxt))

        plogits, pcache = model.prefill(cfg, tree, torch_batch(pre), MAX_LEN)
        assert rel_err(np32(plogits), logits) <= 1e-4
        want = dict(flat(cache_np))
        got = dict(flat(pcache))
        assert set(got) == set(want)
        for key, w in want.items():
            g = got[key]
            assert tuple(g.shape) == w.shape, key
            if key in ("pos", "key_pos"):
                np.testing.assert_array_equal(g.numpy(), w)
            else:
                w64 = np.asarray(w, np.float64)
                err = np.linalg.norm(np32(g) - w64) / max(
                    np.linalg.norm(w64), 1e-30)
                assert err <= 1e-2, key

        # one step from the reference's own cache, and from the port's
        from_ref, _ = model.decode_step(
            cfg, tree, bridge.lm_cache_from(cache_np, device="cpu"),
            torch.as_tensor(nxt))
        assert rel_err(np32(from_ref), logits2) <= 1e-4
        own, pcache = model.decode_step(cfg, tree, pcache,
                                        torch.as_tensor(nxt))
        assert rel_err(np32(own), logits2) <= 1e-3
        assert int(pcache["pos"]) == S + 1


def check_roundtrip(arch: str) -> None:
    """prefill(S tokens) then decode_step agrees with forward on S + 1."""
    cfg = reduced(ARCHITECTURES[arch]).replace(**lifted(arch))
    seed = 300 + ALL_ARCHS.index(arch)
    tree = model.init_params(cfg, seed, device="cpu")
    b = torch_batch(batch(cfg, seed, b=2, s=S + 1))
    with torch.no_grad():
        hidden, _ = model.forward(cfg, tree, b, remat=False)
        want = np32(model.logits_fn(cfg, tree, hidden[:, -1:]))
    first, cache = model.prefill(cfg, tree, dict(b, tokens=b["tokens"][:, :S]),
                                 MAX_LEN)
    assert int(cache["pos"]) == S
    got, cache = model.decode_step(cfg, tree, cache, b["tokens"][:, S:])
    assert got.shape == (2, 1, cfg.padded_vocab)
    assert int(cache["pos"]) == S + 1
    v = cfg.vocab_size
    got, want = np32(got)[:, 0, :v], want[:, 0, :v]
    assert np.isfinite(got).all()
    assert margin_argmax_agree(got, want, 1e-2)
    for g, w in zip(got, want):
        assert np.corrcoef(g, w)[0, 1] > 0.99
