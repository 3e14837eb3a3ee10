"""RMSNorm with fp32 statistics (counterpart of `mm_interleaved_tpu/ops/rmsnorm.py`):
variance in fp32, weight multiply in the input dtype."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    x32 = x32 * torch.rsqrt(var + eps)
    return x32.to(dtype) * weight
