"""SwinV2 cosine window attention on pre-partitioned windows (port of
``torchok_tpu.ops.window_attention``).

Block-diagonal attention over (shifted) spatial windows with cosine
similarity, a learned per-head temperature (clamped at ln 100: the
reference's ``clamp(max=log(100))`` caps the effective scale at 100), a
relative position bias and an additive window-type mask.

Two execution paths, as in the JAX package:

* :func:`window_attention_einsum` -- the counterpart of
  ``_window_attention_xla``: plain tensor code in both layouts, unit vectors
  rounded to the input type before the product. It is the default and the
  hybrid's backward.
* ``use_kernel=True`` -- the counterpart of ``use_pallas=True``: the fused
  forward of ``_wa_kernel_mw`` (f32 from the loads to the one rounding of the
  output). A CUDA tensor goes to the hand-written Hopper kernel
  ``csrc/window_attention_mw_fwd.cu`` (it launches or raises), a CPU tensor to
  :func:`window_attention_mw_plain`, the plain PyTorch version of the same
  arithmetic. :class:`WindowAttentionHybrid` ties that forward to a backward
  that recomputes through the einsum formulation, as ``_window_attention_hybrid``
  does: the JAX package has no backward kernel here, so neither has the port.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from torchok_tpu_torch.ops.common import DTYPE_CODE, LAUNCHES, LN_100, check_tensor

_EPS = 1e-12

KERNEL = "window_attention_mw_fwd"
PLAIN = "window_attention_mw_plain"
# the tokens per window and head dims the kernel is instantiated for
KERNEL_L = (16, 64)
KERNEL_D = (8, 32)
# q, k, v, logit_scale, bias, mask, out; dtype, B_, H, L, D, n_mask; stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _normalize(x: torch.Tensor, dim: int = -1, eps: float = _EPS) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + eps)


def _add_mask(attn: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """attn (B_, H, L, L) plus a tiled (B_, L, L) or compact (nW, L, L) mask;
    window order is batch-major, so window ``i`` has type ``i % nW``."""
    mask = mask.float()
    if mask.shape[0] == attn.shape[0]:
        return attn + mask[:, None]
    nw = mask.shape[0]
    if attn.shape[0] % nw:
        raise ValueError(f"mask of {nw} window types does not divide {attn.shape[0]} windows")
    b = attn.shape[0] // nw
    return (attn.reshape(b, nw, *attn.shape[1:]) + mask[None, :, None]).reshape(attn.shape)


def window_attention_einsum(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            logit_scale: torch.Tensor, bias: torch.Tensor,
                            mask: Optional[torch.Tensor], layout: str = "bhld") -> torch.Tensor:
    """The batched-product formulation. q/k/v ``(B_, H, L, D)`` for layout
    ``bhld`` or ``(B_, L, H, D)`` for ``blhd``; ``logit_scale (H,)``; ``bias
    (H, L, L)``; ``mask`` additive, tiled ``(B_, L, L)`` or compact ``(nW, L,
    L)``, or None. q and k are normalised in f32 (``x / (|x| + 1e-12)``) and
    rounded to the input type, the logits and softmax are f32, the weights are
    rounded to the input type for the second product."""
    if layout == "blhd":
        eq_qk, eq_pv = "bqhd,bkhd->bhqk", "bhqk,bkhd->bqhd"
    elif layout == "bhld":
        eq_qk, eq_pv = "bhqd,bhkd->bhqk", "bhqk,bhkd->bhqd"
    else:
        raise ValueError(f"layout must be 'bhld' or 'blhd', got {layout!r}")
    dtype = q.dtype
    # the rounding points are explicit, so autocast must not add its own
    with torch.autocast(q.device.type, enabled=False):
        qn = _normalize(q.float()).to(dtype)
        kn = _normalize(k.float()).to(dtype)
        scale = torch.exp(torch.clamp(logit_scale.float(), max=LN_100))
        attn = torch.einsum(eq_qk, qn.float(), kn.float())
        attn = attn * scale[None, :, None, None] + bias.float()[None]
        if mask is not None:
            attn = _add_mask(attn, mask)
        attn = torch.softmax(attn, dim=-1)
        return torch.einsum(eq_pv, attn.to(dtype).float(), v.float()).to(dtype)


def window_attention_mw_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              logit_scale: torch.Tensor, bias: torch.Tensor,
                              mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of the kernel: head-major ``(B_, H, L, D)``, f32
    throughout (``x * rsqrt(sum x^2 + 1e-12)``, no rounding of the unit
    vectors or of the weights), one rounding to q's dtype. ``mask`` is
    ``(n_mask, L, L)`` with ``n_mask`` dividing ``B_`` (window ``i`` takes row
    ``i % n_mask``), or None."""
    with torch.autocast(q.device.type, enabled=False):
        qf, kf = q.float(), k.float()
        qn = qf * torch.rsqrt(torch.sum(qf * qf, dim=-1, keepdim=True) + _EPS)
        kn = kf * torch.rsqrt(torch.sum(kf * kf, dim=-1, keepdim=True) + _EPS)
        scale = torch.exp(torch.clamp(logit_scale.float(), max=LN_100))
        attn = torch.matmul(qn, kn.transpose(-1, -2)) * scale[None, :, None, None]
        attn = attn + bias.float()[None]
        if mask is not None:
            attn = _add_mask(attn, mask)
        attn = torch.softmax(attn, dim=-1)
        return torch.matmul(attn, v.float()).to(q.dtype)


def window_attention_mw_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             logit_scale: torch.Tensor, bias: torch.Tensor,
                             mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch the Hopper kernel (same arguments as the plain version). Raises
    on devices, shapes, types or layouts it does not take: f32 or bf16, L in
    ``KERNEL_L``, D in ``KERNEL_D``, everything contiguous."""
    if q.device.type != "cuda":
        raise ValueError(f"q must be a CUDA tensor, got {q.device}")
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"{KERNEL} takes float32 or bfloat16 q, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B_, H, L, D), got {tuple(q.shape)}")
    b, h, L, d = q.shape
    if L not in KERNEL_L or d not in KERNEL_D:
        raise ValueError(f"{KERNEL} takes L in {KERNEL_L} and head dim in {KERNEL_D}; "
                         f"got L={L}, head dim {d}")
    check_tensor(q, "q", (b, h, L, d), q.dtype, q.device)
    check_tensor(k, "k", (b, h, L, d), q.dtype, q.device)
    check_tensor(v, "v", (b, h, L, d), q.dtype, q.device)
    check_tensor(logit_scale, "logit_scale", (h,), torch.float32, q.device)
    check_tensor(bias, "bias", (h, L, L), torch.float32, q.device)
    n_mask = 1
    if mask is not None:
        n_mask = mask.shape[0]
        check_tensor(mask, "mask", (n_mask, L, L), torch.float32, q.device)
        if n_mask < 1 or b % n_mask:
            raise ValueError(f"mask of {n_mask} window types does not divide {b} windows")
    from torchok_tpu_torch.utils.cuda_build import load_function
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = load_function(KERNEL, _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), logit_scale.data_ptr(), bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(),
        DTYPE_CODE[q.dtype], b, h, L, d, n_mask, stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err}")
    LAUNCHES[KERNEL] += 1
    return out


def _forward(q, k, v, logit_scale, bias, mask) -> torch.Tensor:
    if q.device.type == "cuda":
        return window_attention_mw_cuda(q, k, v, logit_scale, bias, mask)
    if q.device.type != "cpu":
        raise ValueError(f"window_attention runs on CUDA or the CPU, not {q.device}")
    LAUNCHES[PLAIN] += 1
    return window_attention_mw_plain(q, k, v, logit_scale, bias, mask)


class WindowAttentionHybrid(torch.autograd.Function):
    """``(q, k, v, logit_scale, bias, mask) -> out``: the fused forward, and a
    backward that recomputes through :func:`window_attention_einsum` (head-
    major) and differentiates that. Gradients for q, k, v, ``logit_scale`` and
    ``bias``; none for ``mask``."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v, logit_scale, bias, mask):
        ctx.save_for_backward(q, k, v, logit_scale, bias, mask)
        return _forward(q, k, v, logit_scale, bias, mask)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dout):
        q, k, v, logit_scale, bias, mask = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(True) for t in (q, k, v, logit_scale, bias)]
        with torch.enable_grad():
            out = window_attention_einsum(*inputs, mask)
        grads = torch.autograd.grad(out, inputs, dout.to(out.dtype))
        needs = ctx.needs_input_grad
        return tuple(g if need else None for g, need in zip(grads, needs)) + (None,)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     logit_scale: torch.Tensor, bias: torch.Tensor,
                     mask: Optional[torch.Tensor] = None, use_kernel: Optional[bool] = None,
                     layout: str = "bhld") -> torch.Tensor:
    """Fused SwinV2 cosine window attention. q/k/v ``(B_, H, L, D)``, or
    ``(B_, L, H, D)`` with ``layout="blhd"``; ``logit_scale (H,)``; ``bias (H,
    L, L)``; ``mask`` additive, tiled ``(B_, L, L)`` or compact ``(nW, L, L)``.

    The einsum formulation by default; ``use_kernel=True`` (the JAX package's
    ``use_pallas``, in the same position and off by default) takes the fused
    forward with the recompute backward. The kernel works on head-major
    blocks, so ``blhd`` callers are transposed around it."""
    if not use_kernel:
        return window_attention_einsum(q, k, v, logit_scale, bias, mask, layout)
    if layout not in ("bhld", "blhd"):
        raise ValueError(f"layout must be 'bhld' or 'blhd', got {layout!r}")
    if layout == "blhd":
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    q, k, v = (t.contiguous() for t in (q, k, v))
    logit_scale = logit_scale.float().contiguous()
    bias = bias.float().contiguous()
    mask = None if mask is None else mask.float().contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, logit_scale, bias)):
        out = WindowAttentionHybrid.apply(q, k, v, logit_scale, bias, mask)
    else:
        out = _forward(q, k, v, logit_scale, bias, mask)
    return out.transpose(1, 2) if layout == "blhd" else out
