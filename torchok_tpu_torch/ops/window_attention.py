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
  arithmetic. The kernel routes by dtype and shape (:func:`forward_route`,
  launches counted per route in :data:`FWD_ROUTE_LAUNCHES`): bf16 at head
  dim 32 takes ``csrc/window_attention_mw_mma.cuh`` on the tensor cores (raw
  bf16 q k^T scaled by the f32 inverse norms, the f32 weights split into two
  bf16 terms against v: the same f32 numerics), a block per (mask row, head,
  slice of that row's windows) sized by :func:`forward_plan`; f32, and bf16
  at head dim 8, take the FMA template. :class:`WindowAttentionHybrid` ties
  that forward to a backward that recomputes through the einsum
  formulation, as ``_window_attention_hybrid`` does: the JAX package has no
  backward kernel here, so neither has the port.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from torchok_tpu_torch.ops import swin_attention
from torchok_tpu_torch.ops.common import DTYPE_CODE, LAUNCHES, LN_100, check_tensor

_EPS = 1e-12

KERNEL = "window_attention_mw_fwd"
PLAIN = "window_attention_mw_plain"
# the tokens per window and head dims the kernel is instantiated for
KERNEL_L = (16, 64)
KERNEL_D = (8, 32)
# q, k, v, logit_scale, bias, mask, out; dtype, B_, H, L, D, n_mask, windows; stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
# the kernel's routes, as window_attention_mw_fwd_route numbers them, and the
# launches per route (the wrapper adds one per launch)
FWD_ROUTES = ("fma", "mma")
FWD_ROUTE_LAUNCHES: collections.Counter = collections.Counter()
# blocks an SM of the tensor-core route (shared memory: 62 KB with a mask
# tile at L = 64, 46 KB without), for which forward_plan sizes the slices
_MMA_BLOCKS_PER_SM = {True: 3, False: 4}
_MMA_THREADS = 128


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


def forward_route(dtype: torch.dtype, L: int, d: int) -> str:
    """The route (one of :data:`FWD_ROUTES`) a launch takes: ``mma`` (the
    tensor-core kernel) for bf16 at head dim 32, ``fma`` (the FMA template)
    for f32 and for bf16 at head dim 8. Raises on what the kernel does not
    take."""
    if dtype not in DTYPE_CODE:
        raise TypeError(f"{KERNEL} takes float32 or bfloat16, got {dtype}")
    if L not in KERNEL_L or d not in KERNEL_D:
        raise ValueError(f"{KERNEL} takes L in {KERNEL_L} and head dim in {KERNEL_D}; "
                         f"got L={L}, head dim {d}")
    return FWD_ROUTES[int(dtype == torch.bfloat16 and d == 32)]


class ForwardPlan(NamedTuple):
    """Grid of one launch of the tensor-core route."""
    windows_per_block: int   # windows of one mask row a block walks
    grid: Tuple[int, int]    # (mask rows x slices, heads)
    threads: int             # per block


@functools.lru_cache(maxsize=None)
def forward_plan(b: int, heads: int, n_mask: int, L: int, device: torch.device) -> ForwardPlan:
    """The tensor-core route's grid for ``b`` windows, ``n_mask`` mask rows
    (0: no mask, one row of windows sharing the bias). Block ``x`` takes mask
    row ``x % rows`` and windows ``w + (j0 + j) rows`` of it, ``j0 = (x //
    rows) windows_per_block``, ``j < windows_per_block`` (the last slice of a
    row may be shorter): each bias and mask tile is loaded once a slice. The
    slices are as many as put about one wave of blocks on the card (3 an SM
    with a mask, 4 without), so the largest slices go where the (row, head)
    pairs are fewest."""
    rows = max(n_mask, 1)
    per_row = b // rows
    slots = _MMA_BLOCKS_PER_SM[n_mask > 0] * swin_attention._sm_count(device)
    slices = max(1, min(per_row, round(slots / (rows * heads))))
    per = -(-per_row // slices)
    return ForwardPlan(per, (rows * -(-per_row // per), heads), _MMA_THREADS)


@functools.lru_cache(maxsize=None)
def _function():
    from torchok_tpu_torch.utils.cuda_build import load_function
    return load_function(KERNEL, _ARGTYPES)


def window_attention_mw_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             logit_scale: torch.Tensor, bias: torch.Tensor,
                             mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch the Hopper kernel (same arguments as the plain version). Raises
    on devices, shapes, types or layouts it does not take: f32 or bf16, L in
    ``KERNEL_L``, D in ``KERNEL_D``, everything contiguous (and 16-byte
    aligned on the tensor-core route)."""
    if q.device.type != "cuda":
        raise ValueError(f"q must be a CUDA tensor, got {q.device}")
    if q.dtype not in DTYPE_CODE:
        raise TypeError(f"{KERNEL} takes float32 or bfloat16 q, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B_, H, L, D), got {tuple(q.shape)}")
    b, h, L, d = q.shape
    route = forward_route(q.dtype, L, d)
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
    out = torch.empty_like(q)
    windows = 0
    if route == "mma":  # rows and tiles load 16 bytes a thread
        if any(t is not None and t.data_ptr() % 16
               for t in (q, k, v, bias, mask, out)):
            raise ValueError(f"{KERNEL} in bf16 takes 16-byte aligned tensors")
        windows = forward_plan(b, h, 0 if mask is None else n_mask, L,
                               q.device).windows_per_block
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _function()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), logit_scale.data_ptr(), bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(),
        DTYPE_CODE[q.dtype], b, h, L, d, n_mask, windows, stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err}")
    LAUNCHES[KERNEL] += 1
    FWD_ROUTE_LAUNCHES[route] += 1
    return out


def library_route(dtype: torch.dtype, L: int, d: int) -> str:
    """The route the built library reports for these arguments (it must be
    :func:`forward_route`'s)."""
    from torchok_tpu_torch.utils.cuda_build import load_function
    _function()
    fn = load_function(KERNEL, [ctypes.c_int] * 3, f"{KERNEL}_route")
    return FWD_ROUTES[fn(DTYPE_CODE[dtype], L, d)]


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
