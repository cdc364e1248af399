from repro_torch.kernels.ddim_step.ops import ddim_step
from repro_torch.kernels.ddim_step.ref import ddim_coefs, ddim_step_ref

__all__ = ["ddim_coefs", "ddim_step", "ddim_step_ref"]
