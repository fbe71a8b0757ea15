"""Wrapper of the MH accept kernel in ``csrc/mh_accept.cu``, which replaces
``repro/kernels/mh_accept.py::mh_accept`` (kernel 9): per element,
``cand`` if log(u + 1e-30) < ((lp_c − lp_z) + lq_z) − lq_c, else ``z``.
CUDA tensors only; ``kernels/ops.py`` routes CPU tensors to
``kernels/ref.py::mh_accept_ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import launch
from repro_torch.kernels.alias_build import _check


def mh_accept(z, cand, log_p_z, log_p_cand, log_q_z, log_q_cand,
              u) -> torch.Tensor:
    """z/cand (B,) i32, the four log densities and u (B,) f32 → (B,)
    i32."""
    if z.dim() != 1:
        raise ValueError(f"z must be (B,), got {tuple(z.shape)}")
    b = z.shape[0]
    for arg, t, dt in (("z", z, torch.int32), ("cand", cand, torch.int32),
                       ("log_p_z", log_p_z, torch.float32),
                       ("log_p_cand", log_p_cand, torch.float32),
                       ("log_q_z", log_q_z, torch.float32),
                       ("log_q_cand", log_q_cand, torch.float32),
                       ("u", u, torch.float32)):
        _check(arg, t, dt, (b,))
    out = torch.empty((b,), dtype=torch.int32, device=z.device)
    launch("mh_accept", *(t.data_ptr() for t in (
        z, cand, log_p_z, log_p_cand, log_q_z, log_q_cand, u)), b,
        out.data_ptr())
    return out
