"""Public fused-DDIM-step wrapper: any latent shape, no padding.

A tensor on the CPU goes to the plain version (``ref.ddim_step_ref``); a
tensor on the card launches the CUDA kernel (``csrc/ddim_step.cu``) or
raises, and raises too under grad mode when an input needs a gradient (the
kernel has no backward).  ``ddim_step.launches`` counts the kernel launches and nothing
else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ddim_step.ref import ddim_coefs, ddim_step_ref


def ddim_step(x: torch.Tensor, eps: torch.Tensor, alpha_t,
              alpha_prev) -> torch.Tensor:
    """One deterministic DDIM update, ``c1*x + c2*eps``.  ``alpha_t`` and
    ``alpha_prev`` are host scalars from the float32 schedule, so the
    coefficients are computed here and nothing syncs with the card."""
    if eps.shape != x.shape:
        raise ValueError(f"x {tuple(x.shape)} and eps {tuple(eps.shape)} differ")
    c1, c2 = ddim_coefs(alpha_t, alpha_prev)
    if x.device.type == "cpu":
        return ddim_step_ref(x, eps.to(x.dtype), c1, c2)
    _build.refuse_grad("ddim_step", x, eps)

    for name, t in (("x", x), ("eps", eps)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel needs x and "
                             f"eps on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")

    out = torch.empty_like(x)
    lib = _build.library()
    err = lib.repro_ddim_step_f32(
        x.data_ptr(), eps.data_ptr(), out.data_ptr(), x.numel(), c1, c2,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ddim_step")
    _build.count_launch(ddim_step)
    return out


ddim_step.launches = 0
