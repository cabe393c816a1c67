"""RMSNorm / LayerNorm (fp32 accumulation, cast back to the input dtype)."""

from __future__ import annotations

import torch

__all__ = ["init_norm", "apply_norm"]


def init_norm(d: int, kind: str = "rmsnorm", device="cpu") -> dict:
    params = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        params["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return params


def apply_norm(params: dict, x: torch.Tensor, kind: str = "rmsnorm", eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * (var + eps) ** -0.5
    elif kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * (var + eps) ** -0.5
    else:
        raise ValueError(kind)
    y = y * params["scale"].to(torch.float32)
    if "bias" in params:
        y = y + params["bias"].to(torch.float32)
    return y.to(x.dtype)
