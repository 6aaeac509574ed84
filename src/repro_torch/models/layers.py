"""Shared numeric primitives and the forward-pass context object."""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class Ctx:
    """What the forward pass needs to know besides the weights: the
    device everything lives on, the compute dtype matrices are cast to,
    and the chunk length of the plain WKV6 version (the reference's
    ``Ctx`` without a mesh)."""

    device: torch.device
    dtype: torch.dtype = torch.bfloat16
    rwkv_chunk: int = 32


def resolve_device(device=None) -> torch.device:
    """The entry points' device rule: ``cuda`` unless the caller names
    another device.  No card and no explicit device is an error, never a
    silent run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' (--device cpu) to run "
                "the port on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32, cast back.  ``scale`` is the learned gain."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Tanh soft-capping computed in fp32; identity when ``cap == 0``."""
    if not cap:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies, fp32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate ``x (..., seq, heads, head_dim)`` at absolute ``positions``
    ``(seq,)`` or broadcastable ``(..., seq)``; split-half rotation in
    fp32, cast back."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    ang = positions.float()[..., None] * freqs          # (..., seq, hd/2)
    ang = ang[..., None, :]                             # broadcast over heads
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense_ffn(p, x: torch.Tensor, act: str) -> torch.Tensor:
    """SwiGLU MLP: wd( act(x wg) * (x wu) )."""
    h = activation(x @ p["wg"], act) * (x @ p["wu"])
    return h @ p["wd"]
