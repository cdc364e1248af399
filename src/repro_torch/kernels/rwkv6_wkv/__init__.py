from repro_torch.kernels.rwkv6_wkv.ops import wkv6, wkv6_backward
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_bwd_ref, wkv6_ref

__all__ = ["wkv6", "wkv6_backward", "wkv6_bwd_ref", "wkv6_ref"]
