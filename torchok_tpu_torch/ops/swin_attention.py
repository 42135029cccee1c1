"""Fused SwinV2 shifted-window attention (forward) on the unpartitioned
spatial layout.

``fused_swin_attention`` is the port of ``torchok_tpu.ops.swin_attention.
fused_swin_attention``: qkv ``(B, Hp, Wp, 3C)`` in, ``(B, Hp, Wp, C)`` out,
with window partition and reverse folded into the op. A CUDA tensor goes to
the hand-written Hopper kernel ``csrc/swin_attention_fwd.cu`` (it launches or
raises); a CPU tensor goes to :func:`swin_attention_fwd_plain`, the plain
PyTorch version of the same arithmetic, which the CPU tests compare with the
JAX package and ``chip_smoke.py`` compares with the kernel on the card.

Both follow the Pallas kernel ``_fwd_kernel`` in cosine mode, rounding where
it rounds: q and k are normalised in f32 and cast to the input dtype for
QK^T, the logits and softmax are f32, and the attention weights are cast to
the input dtype for PV.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from torchok_tpu_torch.ops.window_attention import LN_100

_EPS = 1e-12

# launches per path; the kernel wrapper adds one per kernel launch and the
# dispatcher one per plain call, so a run can show which path it took
LAUNCHES: collections.Counter = collections.Counter()
KERNEL = "swin_attention_fwd"
PLAIN = "swin_attention_fwd_plain"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_WS = 8
_KERNEL_D = 32


# window_partition / window_reverse are the counterparts of torchok_tpu's
# helpers; the fused op folds both into its indexing and calls neither.
def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C)"""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B*nW, ws*ws, C) -> (B, H, W, C)"""
    c = windows.shape[-1]
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def _norm_rows(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + _EPS)


def swin_attention_fwd_plain(qkv: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor, mask: Optional[torch.Tensor],
                             ws: int, nheads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel. ``scale`` is the (H,) f32
    per-head multiplier (already exp/clamped), ``bias`` (H, L, L) f32,
    ``mask`` (nW, L, L) f32 in row-major window order, or None."""
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    d = c // nheads
    ngy, ngx = hp // ws, wp // ws
    L = ws * ws
    dtype = qkv.dtype
    # (3, B, H, nW, L, D): windows and heads out of the spatial layout
    win = qkv.reshape(b, ngy, ws, ngx, ws, 3, nheads, d)
    win = win.permute(5, 0, 6, 1, 3, 2, 4, 7).reshape(3, b, nheads, ngy * ngx, L, d)
    q, k, v = win[0], win[1], win[2]
    # the rounding points are explicit, so autocast must not add its own
    with torch.autocast(qkv.device.type, enabled=False):
        qn = _norm_rows(q.float()).to(dtype)
        kn = _norm_rows(k.float()).to(dtype)
        logits = torch.matmul(qn.float(), kn.float().transpose(-1, -2))
        logits = logits * scale.view(1, nheads, 1, 1, 1) + bias.view(1, nheads, 1, L, L)
        if mask is not None:
            logits = logits + mask.view(1, 1, ngy * ngx, L, L)
        a = torch.softmax(logits, dim=-1).to(dtype)
        o = torch.matmul(a.float(), v.float()).to(dtype)  # (B, H, nW, L, D)
    o = o.reshape(b, nheads, ngy, ngx, ws, ws, d).permute(0, 2, 4, 3, 5, 1, 6)
    return o.reshape(b, hp, wp, c)


def _library() -> ctypes.CDLL:
    from torchok_tpu_torch.utils.cuda_build import load_library
    lib = load_library(KERNEL)
    fn = lib.swin_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel's library."""
    _library()


def _check(t: torch.Tensor, name: str, shape, dtype, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def swin_attention_fwd_cuda(qkv: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, mask: Optional[torch.Tensor],
                            ws: int, nheads: int) -> torch.Tensor:
    """Launch the Hopper kernel (same arguments as the plain version).
    Raises on devices, shapes, types or layouts the kernel does not take."""
    if qkv.device.type != "cuda":
        raise ValueError(f"qkv must be a CUDA tensor, got {qkv.device}")
    if qkv.dtype not in _DTYPE_CODE:
        raise TypeError(f"swin_attention_fwd takes float32 or bfloat16 qkv, got {qkv.dtype}")
    if qkv.dim() != 4 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, Hp, Wp, 3C), got {tuple(qkv.shape)}")
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    if ws != _KERNEL_WS or c != nheads * _KERNEL_D:
        raise ValueError(f"swin_attention_fwd takes ws={_KERNEL_WS} (L=64) and head dim "
                         f"{_KERNEL_D}; got ws={ws}, head dim {c / nheads:g}")
    if hp % ws or wp % ws:
        raise ValueError(f"Hp={hp}, Wp={wp} must be multiples of ws={ws}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    L = ws * ws
    nw = (hp // ws) * (wp // ws)
    _check(scale, "scale", (nheads,), torch.float32, qkv.device)
    _check(bias, "bias", (nheads, L, L), torch.float32, qkv.device)
    if mask is not None:
        _check(mask, "mask", (nw, L, L), torch.float32, qkv.device)
    out = torch.empty((b, hp, wp, c), dtype=qkv.dtype, device=qkv.device)
    lib = _library()
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = lib.swin_attention_fwd(
        qkv.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(),
        _DTYPE_CODE[qkv.dtype], b, hp, wp, c, nheads, ws, stream)
    if err != 0:
        raise RuntimeError(f"swin_attention_fwd launch failed: CUDA error {err}")
    LAUNCHES[KERNEL] += 1
    return out


def fused_swin_attention(qkv: torch.Tensor, logit_scale: torch.Tensor,
                         bias: torch.Tensor, mask: Optional[torch.Tensor],
                         ws: int, nheads: int) -> torch.Tensor:
    """Fused shifted-window attention on the unpartitioned spatial layout.

    Args:
        qkv: (B, Hp, Wp, 3C) qkv projection of the (possibly pre-rolled)
            feature map; Hp, Wp multiples of ``ws``; C = nheads * head_dim.
        logit_scale: (H,) learned log temperatures (clamped at ln 100).
        bias: (H, L, L) continuous relative position bias, L = ws*ws.
        mask: compact (nW, L, L) additive window-type mask (row-major window
            order), or None for unshifted blocks.

    Returns:
        (B, Hp, Wp, C) attention output, same dtype as ``qkv``.
    """
    scale = torch.exp(torch.clamp(logit_scale.float(), max=LN_100)).contiguous()
    bias = bias.float().contiguous()
    mask = None if mask is None else mask.float().contiguous()
    if qkv.device.type == "cuda":
        return swin_attention_fwd_cuda(qkv, scale, bias, mask, ws, nheads)
    if qkv.device.type != "cpu":
        raise ValueError(f"fused_swin_attention runs on CUDA or the CPU, not {qkv.device}")
    LAUNCHES[PLAIN] += 1
    return swin_attention_fwd_plain(qkv, scale, bias, mask, ws, nheads)

