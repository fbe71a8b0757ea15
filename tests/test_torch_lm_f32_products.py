"""``models/layers.py``'s ``einsum_f32``, the product whose result the
reference keeps in float32 (``jnp.einsum(..., preferred_element_type=
jnp.float32)`` with no ``.astype`` after it), against ``jax.vjp`` of that
einsum on the same bf16 operands drawn with numpy.

* Two bf16 operands take ``_F32Product`` on every device: the spec laid
  out as (batch, m, k) @ (batch, k, n), and a hand-written backward, the
  reference's transpose (the float32 cotangent against the other operand
  widened, rounded once to the operand's dtype, as ``dot_general`` with
  ``preferred_element_type=float32`` and one ``convert_element_type``).
  Only its GEMM depends on the device: on the CPU the operands widened to
  a float32 ``bmm``/``mm``, on the card ``out_dtype=float32`` on the
  tensor cores, which has no CPU kernel.  That GEMM is held against the
  widened product by ``chip_smoke.py``'s phase 16.
* Tolerance: the float32 results differ only in the order of their sums,
  so |got − want| ≤ ``layers.f32_sum_bound`` = 2·k·2⁻²⁴·(|a|·|b|)
  elementwise for a sum over k terms (the accumulation bound γ_k, twice
  for two orders); a bf16 gradient may round the other way where the two
  float32 values straddle a bf16 rounding point, so it also gets one bf16
  ulp (at most 2⁻⁷ of its size).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models import layers

# (spec, a's shape, b's shape): the MLP's projection, attention's scores
# with its (g, r) heads, the MoE experts' product in the reference's 3-D
# form (XLA's CPU runs no 4-D grouped bf16 product with a float32 result)
SPECS = {
    "projection": ("bsd,df->bsf", (2, 5, 48), (48, 24)),
    "scores": ("bqgrh,bkgh->bgrqk", (2, 7, 2, 3, 16), (2, 9, 2, 16)),
    "experts": ("ecd,edf->ecf", (3, 4, 32), (3, 32, 8)),
}
# the port's grouped form (a batch letter that is not the output's
# first), held against the widened einsum
GROUPED = ("gecd,edf->gecf", (2, 3, 4, 32), (3, 32, 8))


def operands(spec: str, shape_a, shape_b, seed: int):
    """a, b with bf16 values (exactly representable, so both packages see
    the same numbers) and a float32 cotangent of the product's shape."""
    rng = np.random.default_rng(seed)
    a, b = (np.asarray(jnp.asarray(rng.standard_normal(sh), jnp.bfloat16)
                       .astype(jnp.float32)) for sh in (shape_a, shape_b))
    ct = rng.standard_normal(np.einsum(spec, a, b).shape).astype(np.float32)
    return a, b, ct


def reference(spec: str, a: np.ndarray, b: np.ndarray, ct: np.ndarray,
              dtype):
    """The reference's product and its VJP at cotangent ``ct``, as
    float32 arrays."""
    fn = lambda x, y: jnp.einsum(spec, x, y,
                                 preferred_element_type=jnp.float32)
    y, vjp = jax.vjp(fn, jnp.asarray(a, dtype), jnp.asarray(b, dtype))
    ga, gb = vjp(jnp.asarray(ct))
    assert y.dtype == jnp.float32 and ga.dtype == gb.dtype == dtype
    return tuple(np.asarray(x.astype(jnp.float32)) for x in (y, ga, gb))


def port(spec: str, a: np.ndarray, b: np.ndarray, ct: np.ndarray, dtype,
         fn=layers.einsum_f32):
    ta = torch.tensor(a).to(dtype).requires_grad_()
    tb = torch.tensor(b).to(dtype).requires_grad_()
    y = fn(spec, ta, tb)
    ga, gb = torch.autograd.grad(y, (ta, tb), torch.tensor(ct))
    return y, ga, gb


def bound(spec: str, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return layers.f32_sum_bound(spec, torch.tensor(x),
                                torch.tensor(y)).numpy()


def tolerances(spec: str, a, b, ct, want_ga, want_gb) -> tuple:
    """(product, a's gradient, b's gradient) tolerances: the accumulation
    bound, and for a bf16 gradient one bf16 ulp more (at most 2⁻⁷ of
    it)."""
    ins, out = spec.split("->")
    sa, sb = ins.split(",")
    return (bound(spec, a, b),
            bound(f"{out},{sb}->{sa}", ct, b) + 2.0 ** -7 * np.abs(want_ga),
            bound(f"{sa},{out}->{sb}", a, ct) + 2.0 ** -7 * np.abs(want_gb))


def assert_close(got, want, tol) -> None:
    got = (got.detach().float().cpu().numpy()
           if isinstance(got, torch.Tensor) else np.asarray(got))
    got, want = got.astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= tol), float(
        np.max(np.abs(got - want) - tol))


def check(spec, shape_a, shape_b, seed, against_reference=True):
    """``einsum_f32``'s bf16 product and gradients against the reference's
    (else against ``torch.einsum`` of the operands widened, under
    autograd)."""
    a, b, ct = operands(spec, shape_a, shape_b, seed)
    y, ga, gb = port(spec, a, b, ct, torch.bfloat16)
    assert type(y.grad_fn).__name__ == "_F32ProductBackward"
    want = reference(spec, a, b, ct, jnp.bfloat16) if against_reference \
        else [x.detach().float().numpy() for x in port(
            spec, a, b, ct, torch.bfloat16,
            lambda sp, x, w: torch.einsum(sp, x.float(), w.float()))]
    assert y.dtype == torch.float32
    assert ga.dtype == gb.dtype == torch.bfloat16
    for got, w, tol in zip((y, ga, gb), want,
                           tolerances(spec, a, b, ct, *want[1:])):
        assert_close(got, w, tol)


@pytest.mark.parametrize("case", sorted(SPECS))
def test_cpu_product_and_gradients_against_the_reference(case):
    spec, sa, sb = SPECS[case]
    check(spec, sa, sb, seed=sorted(SPECS).index(case))


@pytest.mark.parametrize("case", sorted(SPECS) + ["grouped"])
def test_layout_and_backward_against_the_widened_einsum(case):
    spec, sa, sb = SPECS.get(case, GROUPED)
    check(spec, sa, sb, seed=10 + len(case), against_reference=False)


def test_float32_operands_take_a_float32_product():
    """With ``COMPUTE_DTYPE = float32`` the helper is the float32 product:
    equal to ``torch.einsum`` and within the bound of the reference's."""
    spec, sa, sb = SPECS["projection"]
    a, b, ct = operands(spec, sa, sb, 20)
    y, ga, gb = port(spec, a, b, ct, torch.float32)
    assert y.dtype == ga.dtype == gb.dtype == torch.float32
    assert torch.equal(y, torch.einsum(spec, torch.tensor(a),
                                       torch.tensor(b)))
    want = reference(spec, a, b, ct, jnp.float32)
    for got, w, tol in zip((y, ga, gb), want,
                           tolerances(spec, a, b, ct, *want[1:])):
        assert_close(got, w, tol)


def test_cpu_tensors_never_reach_the_card_path(monkeypatch):
    """The GEMM is chosen by the operands' device: on CPU tensors, bf16 or
    float32, no ``bmm``/``mm`` is asked for ``out_dtype`` (the card's
    overload), forward or backward."""
    for name in ("bmm", "mm"):
        def refuse(x, y, _orig=getattr(torch, name), **kw):
            assert not kw, "the card's GEMM on CPU tensors"
            return _orig(x, y)

        monkeypatch.setattr(torch, name, refuse)
    for case in sorted(SPECS) + ["grouped"]:
        spec, sa, sb = SPECS.get(case, GROUPED)
        a, b, ct = operands(spec, sa, sb, 30)
        for dt in (torch.bfloat16, torch.float32):
            y, ga, gb = port(spec, a, b, ct, dt)
            assert y.dtype == torch.float32 and ga.dtype == gb.dtype == dt


def test_a_spec_that_is_not_a_matrix_product_is_refused():
    with pytest.raises(ValueError, match="not a matrix product"):
        layers._mm_plan("bsd,df->bf")


def test_mamba2_in_projection_is_the_one_product_still_rounded():
    """The one product the reference keeps in float32 that the port rounds
    (ROADMAP C.5): Mamba-2's in-projection (``ssm._mamba2_core``) is
    rounded once to bf16 and widened.  So on bf16 operands it is within
    one bf16 rounding (2⁻⁸ of its size) plus the accumulation bound of the
    reference's float32 product, and off it by more than the accumulation
    bound alone.  Where C.5 is repaired that last assertion fails, and the
    test is to hold the product within the accumulation bound alone."""
    from repro.models import ssm as ref_ssm
    from repro_torch.models import ssm
    from tests.test_torch_lm_common import configs, ref_jit

    ref_cfg, cfg = configs("zamba2-2.7b")
    p = ref_ssm.init_mamba2(ref_cfg, jax.random.PRNGKey(8))
    tp = {k: torch.tensor(np.asarray(v)) for k, v in p.items()}
    xb = torch.tensor(np.random.default_rng(40).standard_normal(
        (2, 16, cfg.d_model)), dtype=torch.float32).bfloat16()
    want = np.concatenate(ref_jit(lambda q, y: ref_ssm._mamba2_core(
        ref_cfg, q, y))(p, jnp.asarray(xb.float().numpy(), jnp.bfloat16)),
        -1)
    got = torch.cat(ssm._mamba2_core(cfg, tp, xb), -1)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, got.bfloat16().float())
    tol = layers.f32_sum_bound("bsd,de->bse", xb,
                               layers.cast(tp["w_in"])).numpy()
    gap = np.abs(got.numpy().astype(np.float64) - want)
    assert np.all(gap <= 2.0 ** -8 * np.abs(want) + tol)
    assert np.any(gap > tol)
