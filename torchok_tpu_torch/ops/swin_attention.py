"""Fused SwinV2 shifted-window attention on the unpartitioned spatial layout,
forward and backward.

``fused_swin_attention`` is the port of ``torchok_tpu.ops.swin_attention.
fused_swin_attention``: qkv ``(B, Hp, Wp, 3C)`` in, ``(B, Hp, Wp, C)`` out,
with window partition and reverse folded into the op. A CUDA tensor goes to
the hand-written Hopper kernels ``csrc/swin_attention_fwd.cu`` and, for the
gradient, ``csrc/swin_attention_bwd.cu`` (they launch or raise); a CPU tensor
goes to :func:`swin_attention_fwd_plain` and :func:`swin_attention_bwd_plain`,
the plain PyTorch versions of the same arithmetic, which the CPU tests compare
with the JAX package and ``chip_smoke.py`` compares with the kernels on the
card. :class:`SwinAttentionFunction` ties a forward to its backward for
autograd, as ``jax.custom_vjp`` does in the JAX package.

All follow the Pallas kernels ``_fwd_kernel`` / ``_bwd_kernel`` in cosine
mode, rounding where they round: q and k are normalised in f32 and cast to
the input dtype for QK^T, the logits and softmax are f32, the attention
weights are cast to the input dtype for PV, and in the backward the scaled
logit gradient is cast to the input dtype before the two products with it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from torchok_tpu_torch.ops.common import DTYPE_CODE, LAUNCHES, LN_100, check_tensor

_EPS = 1e-12

KERNEL = "swin_attention_fwd"
PLAIN = "swin_attention_fwd_plain"
KERNEL_BWD = "swin_attention_bwd"
PLAIN_BWD = "swin_attention_bwd_plain"

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


def to_windows(x: torch.Tensor, ws: int, parts: int, nheads: int) -> torch.Tensor:
    """(B, Hp, Wp, parts*C) -> (parts, B, H, nW, L, D): windows and heads out
    of the spatial layout."""
    b, hp, wp, width = x.shape
    d = width // parts // nheads
    ngy, ngx = hp // ws, wp // ws
    win = x.reshape(b, ngy, ws, ngx, ws, parts, nheads, d)
    return win.permute(5, 0, 6, 1, 3, 2, 4, 7).reshape(parts, b, nheads, ngy * ngx, ws * ws, d)


def from_windows(win: torch.Tensor, ws: int, hp: int, wp: int) -> torch.Tensor:
    """Inverse of :func:`to_windows`: (parts, B, H, nW, L, D) -> (B, Hp, Wp, parts*C)."""
    parts, b, nheads, _, _, d = win.shape
    ngy, ngx = hp // ws, wp // ws
    x = win.reshape(parts, b, nheads, ngy, ngx, ws, ws, d).permute(1, 3, 5, 4, 6, 0, 2, 7)
    return x.reshape(b, hp, wp, parts * nheads * d)


def swin_attention_fwd_plain(qkv: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor, mask: Optional[torch.Tensor],
                             ws: int, nheads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel. ``scale`` is the (H,) f32
    per-head multiplier (already exp/clamped), ``bias`` (H, L, L) f32,
    ``mask`` (nW, L, L) f32 in row-major window order, or None."""
    _, hp, wp, _ = qkv.shape
    L = ws * ws
    dtype = qkv.dtype
    q, k, v = to_windows(qkv, ws, 3, nheads)
    # the rounding points are explicit, so autocast must not add its own
    with torch.autocast(qkv.device.type, enabled=False):
        qn = _norm_rows(q.float()).to(dtype)
        kn = _norm_rows(k.float()).to(dtype)
        logits = torch.matmul(qn.float(), kn.float().transpose(-1, -2))
        logits = logits * scale.view(1, nheads, 1, 1, 1) + bias.view(1, nheads, 1, L, L)
        if mask is not None:
            logits = logits + mask.view(1, 1, -1, L, L)
        a = torch.softmax(logits, dim=-1).to(dtype)
        o = torch.matmul(a.float(), v.float()).to(dtype)  # (B, H, nW, L, D)
    return from_windows(o[None], ws, hp, wp)


def swin_attention_bwd_plain(qkv: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor, mask: Optional[torch.Tensor],
                             dout: torch.Tensor, ws: int, nheads: int
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel, written out step by step
    with the kernel's rounding points (it is not autograd of the plain
    forward, which would not round the scaled logit gradient). ``dout`` is
    (B, Hp, Wp, C). Returns ``dqkv`` in qkv's dtype, ``dbias`` (H, L, L) f32
    and ``dscale`` (H,) f32."""
    _, hp, wp, _ = qkv.shape
    L = ws * ws
    dtype = qkv.dtype
    q, k, v = to_windows(qkv, ws, 3, nheads)
    do = to_windows(dout, ws, 1, nheads)[0]
    with torch.autocast(qkv.device.type, enabled=False):
        q, k, v, do = q.float(), k.float(), v.float(), do.float()
        s = scale.view(1, nheads, 1, 1, 1)
        rq = torch.rsqrt(torch.sum(q * q, dim=-1, keepdim=True) + _EPS)
        rk = torch.rsqrt(torch.sum(k * k, dim=-1, keepdim=True) + _EPS)
        qn = (q * rq).to(dtype).float()
        kn = (k * rk).to(dtype).float()
        cos = torch.matmul(qn, kn.transpose(-1, -2))
        logits = cos * s + bias.view(1, nheads, 1, L, L)
        if mask is not None:
            logits = logits + mask.view(1, 1, -1, L, L)
        a32 = torch.softmax(logits, dim=-1)
        a = a32.to(dtype).float()
        dv = torch.matmul(a.transpose(-1, -2), do)
        da = torch.matmul(do, v.transpose(-1, -2))
        dl = a32 * (da - torch.sum(da * a32, dim=-1, keepdim=True))
        dbias = dl.sum(dim=(0, 2))
        dscale = (dl * cos).sum(dim=(0, 2, 3, 4))
        dls = (dl * s).to(dtype).float()
        dqn = torch.matmul(dls, kn)
        dkn = torch.matmul(dls.transpose(-1, -2), qn)
        # through the f32 row normalisation: d(x * r), r = rsqrt(sum x^2 + eps)
        dq = rq * dqn - rq ** 3 * q * torch.sum(q * dqn, dim=-1, keepdim=True)
        dk = rk * dkn - rk ** 3 * k * torch.sum(k * dkn, dim=-1, keepdim=True)
        dwin = torch.stack([dq, dk, dv]).to(dtype)
    return from_windows(dwin, ws, hp, wp), dbias, dscale


_ARGTYPES = {
    # qkv, scale, bias, mask, out; dtype, B, Hp, Wp, C, nheads, ws; stream
    KERNEL: [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    # qkv, scale, bias, mask, dout, dqkv, dbias, dscale, partial_bias,
    # partial_scale; dtype, B, Hp, Wp, C, nheads, ws, images_per_block; stream
    KERNEL_BWD: [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
}


def _function(name: str):
    """The ``extern "C"`` entry of ``csrc/<name>.cu`` (built at first use)."""
    from torchok_tpu_torch.utils.cuda_build import load_function
    return load_function(name, _ARGTYPES[name])


def _check_attention_args(kernel: str, qkv: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, mask: Optional[torch.Tensor],
                          ws: int, nheads: int) -> None:
    """Raise on devices, shapes, types or layouts the kernels do not take."""
    if qkv.device.type != "cuda":
        raise ValueError(f"qkv must be a CUDA tensor, got {qkv.device}")
    if qkv.dtype not in DTYPE_CODE:
        raise TypeError(f"{kernel} takes float32 or bfloat16 qkv, got {qkv.dtype}")
    if qkv.dim() != 4 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, Hp, Wp, 3C), got {tuple(qkv.shape)}")
    _, hp, wp, c3 = qkv.shape
    c = c3 // 3
    if ws != _KERNEL_WS or c != nheads * _KERNEL_D:
        raise ValueError(f"{kernel} takes ws={_KERNEL_WS} (L=64) and head dim "
                         f"{_KERNEL_D}; got ws={ws}, head dim {c / nheads:g}")
    if hp % ws or wp % ws:
        raise ValueError(f"Hp={hp}, Wp={wp} must be multiples of ws={ws}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    L = ws * ws
    nw = (hp // ws) * (wp // ws)
    check_tensor(scale, "scale", (nheads,), torch.float32, qkv.device)
    check_tensor(bias, "bias", (nheads, L, L), torch.float32, qkv.device)
    if mask is not None:
        check_tensor(mask, "mask", (nw, L, L), torch.float32, qkv.device)


def swin_attention_fwd_cuda(qkv: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, mask: Optional[torch.Tensor],
                            ws: int, nheads: int) -> torch.Tensor:
    """Launch the Hopper forward kernel (same arguments as the plain
    version). Raises on devices, shapes, types or layouts it does not take."""
    _check_attention_args(KERNEL, qkv, scale, bias, mask, ws, nheads)
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    out = torch.empty((b, hp, wp, c), dtype=qkv.dtype, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = _function(KERNEL)(
        qkv.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(),
        DTYPE_CODE[qkv.dtype], b, hp, wp, c, nheads, ws, stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err}")
    LAUNCHES[KERNEL] += 1
    return out


def _images_per_block(b: int, positions: int, device: torch.device) -> int:
    """Images each backward block loops over: few enough blocks to keep the
    partial sums small, enough (about four per SM) to fill the card at every
    stage (stage 1 has 64 windows x 3 heads, stage 4 one window x 24)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    slices = max(1, min(b, -(-4 * sms // positions)))
    return -(-b // slices)


def swin_attention_bwd_cuda(qkv: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, mask: Optional[torch.Tensor],
                            dout: torch.Tensor, ws: int, nheads: int
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the Hopper backward kernel and its reduction (same arguments
    and results as :func:`swin_attention_bwd_plain`). Raises on devices,
    shapes, types or layouts it does not take."""
    _check_attention_args(KERNEL_BWD, qkv, scale, bias, mask, ws, nheads)
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    check_tensor(dout, "dout", (b, hp, wp, c), qkv.dtype, qkv.device)
    L = ws * ws
    nw = (hp // ws) * (wp // ws)
    per_block = _images_per_block(b, nw * nheads, qkv.device)
    slots = nw * -(-b // per_block)
    f32 = dict(dtype=torch.float32, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((nheads, L, L), **f32)
    dscale = torch.empty((nheads,), **f32)
    partial_bias = torch.empty((slots, nheads, L, L), **f32)
    partial_scale = torch.empty((slots, nheads), **f32)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = _function(KERNEL_BWD)(
        qkv.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, dout.data_ptr(),
        dqkv.data_ptr(), dbias.data_ptr(), dscale.data_ptr(),
        partial_bias.data_ptr(), partial_scale.data_ptr(),
        DTYPE_CODE[qkv.dtype], b, hp, wp, c, nheads, ws, per_block, stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL_BWD} launch failed: CUDA error {err}")
    LAUNCHES[KERNEL_BWD] += 1
    return dqkv, dbias, dscale


def _forward(qkv, scale, bias, mask, ws: int, nheads: int) -> torch.Tensor:
    if qkv.device.type == "cuda":
        return swin_attention_fwd_cuda(qkv, scale, bias, mask, ws, nheads)
    if qkv.device.type != "cpu":
        raise ValueError(f"fused_swin_attention runs on CUDA or the CPU, not {qkv.device}")
    LAUNCHES[PLAIN] += 1
    return swin_attention_fwd_plain(qkv, scale, bias, mask, ws, nheads)


class SwinAttentionFunction(torch.autograd.Function):
    """``(qkv, scale, bias, mask, ws, nheads) -> out`` with the hand-written
    backward: gradients for ``qkv``, ``scale`` and ``bias``, none for
    ``mask``. Only the inputs are saved; the backward recomputes the
    attention weights."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, qkv, scale, bias, mask, ws: int, nheads: int):
        ctx.save_for_backward(qkv, scale, bias, mask)
        ctx.ws, ctx.nheads = ws, nheads
        return _forward(qkv, scale, bias, mask, ws, nheads)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dout):
        qkv, scale, bias, mask = ctx.saved_tensors
        if dout.dtype not in DTYPE_CODE:
            raise TypeError(f"{KERNEL_BWD} takes a float32 or bfloat16 dout, got {dout.dtype}")
        # proj's backward may hand over a strided or f32 gradient
        dout = dout.to(qkv.dtype).contiguous()
        if qkv.device.type == "cuda":
            dqkv, dbias, dscale = swin_attention_bwd_cuda(
                qkv, scale, bias, mask, dout, ctx.ws, ctx.nheads)
        else:
            LAUNCHES[PLAIN_BWD] += 1
            dqkv, dbias, dscale = swin_attention_bwd_plain(
                qkv, scale, bias, mask, dout, ctx.ws, ctx.nheads)
        needs = ctx.needs_input_grad
        return (dqkv if needs[0] else None, dscale if needs[1] else None,
                dbias if needs[2] else None, None, None, None)


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
        (B, Hp, Wp, C) attention output, same dtype as ``qkv``. Differentiable
        in ``qkv``, ``logit_scale`` and ``bias`` (the exp/clamp of the scale
        is left to autograd).
    """
    scale = torch.exp(torch.clamp(logit_scale.float(), max=LN_100)).contiguous()
    bias = bias.float().contiguous()
    mask = None if mask is None else mask.float().contiguous()
    if torch.is_grad_enabled() and (qkv.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return SwinAttentionFunction.apply(qkv, scale, bias, mask, ws, nheads)
    # no graph to build (eval under inference_mode): nothing is saved
    return _forward(qkv, scale, bias, mask, ws, nheads)

