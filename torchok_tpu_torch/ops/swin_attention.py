"""Fused SwinV2 shifted-window attention on the unpartitioned spatial layout,
forward and backward.

``fused_swin_attention`` is the port of ``torchok_tpu.ops.swin_attention.
fused_swin_attention``: qkv ``(B, Hp, Wp, 3C)`` in, ``(B, Hp, Wp, C)`` out,
with window partition and reverse folded into the op. A CUDA tensor goes to
the hand-written Hopper kernels ``csrc/swin_attention_fwd.cu`` and, for the
gradient, ``csrc/swin_attention_bwd.cu`` (they launch or raise) at every
window size of the registered SwinV2 variants (ws 6 to 24, L = 36 to 576;
head dim 32). Both route by dtype (:func:`forward_route`,
:func:`backward_route`; launches counted per route in
:data:`FWD_ROUTE_LAUNCHES` and :data:`ROUTE_LAUNCHES`). bf16, what inference
and training run under autocast, goes to the tensor-core kernels at every L:
``csrc/swin_attention_fwd_mma.cuh`` (the key tiles walked twice on
``mma.sync``, row statistics then ``bf16(a32) v``) and
``csrc/swin_attention_bwd_mma.cuh`` (two passes on ``mma.sync``), bounded by
their tile and bias loads and f32 softmax arithmetic rather than by their
products. f32 stays on the FMA templates (``window_attention_fwd.cuh``
and ``window_attention_bwd.cuh`` up to L = 256, the key-tiled path
``window_attention_tiled.cuh`` above it), bounded by shared-memory
bandwidth. :func:`forward_scratch` and :func:`backward_scratch` size the
tensor-core kernels' grids and scratch. The JAX package sends L = 576 to an
XLA formulation on its TPU (a VMEM gate); no CUDA tensor is ever sent to a
plain version here. A CPU tensor
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

import collections
import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from torchok_tpu_torch.ops.common import (DTYPE_CODE, LAUNCHES, LN_100, check_tensor,
                                          refuse_in_export)

_EPS = 1e-12

KERNEL = "swin_attention_fwd"
PLAIN = "swin_attention_fwd_plain"
KERNEL_BWD = "swin_attention_bwd"
PLAIN_BWD = "swin_attention_bwd_plain"

_KERNEL_D = 32
_KERNEL_MAX_L = 576  # ws 24; above 256 the kernels walk the keys in tiles
_TILED_ABOVE_L = 256
_MMA_TILE = 64  # most rows of a tile of the tensor-core kernels

# the routes, as swin_attention_{fwd,bwd}_route number them (alike)
BWD_ROUTES = ("templates", "tiled", "mma")
FWD_ROUTES = BWD_ROUTES
# launches of the forward and of the backward per route (the wrappers add one
# per launch)
FWD_ROUTE_LAUNCHES: collections.Counter = collections.Counter()
ROUTE_LAUNCHES: collections.Counter = collections.Counter()


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
    # qkv, scale, bias, mask, out, kn, bias_mask; dtype, B, Hp, Wp, C, nheads,
    # ws, images_per_block; stream
    KERNEL: [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    # qkv, scale, bias, mask, dout, dqkv, dbias, dscale, partial_bias,
    # partial_scale, row_stats, work; dtype, B, Hp, Wp, C, nheads, ws,
    # images_per_block; stream
    KERNEL_BWD: [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
}


def _function(name: str):
    """The ``extern "C"`` entry of ``csrc/<name>.cu`` (built at first use)."""
    from torchok_tpu_torch.utils.cuda_build import load_function
    return load_function(name, _ARGTYPES[name])


def _route(kernel: str, dtype: torch.dtype, ws: int) -> int:
    from torchok_tpu_torch.utils.cuda_build import load_function
    return load_function(kernel, [ctypes.c_int, ctypes.c_int],
                         f"{kernel}_route")(DTYPE_CODE[dtype], ws)


def forward_route(dtype: torch.dtype, ws: int) -> str:
    """The route (one of :data:`FWD_ROUTES`) the forward kernel's entry
    takes for this dtype and window side, as the built library reports it."""
    return FWD_ROUTES[_route(KERNEL, dtype, ws)]


def backward_route(dtype: torch.dtype, ws: int) -> str:
    """The route (one of :data:`BWD_ROUTES`) the backward kernel's entry
    takes for this dtype and window side, as the built library reports it."""
    return BWD_ROUTES[_route(KERNEL_BWD, dtype, ws)]


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
    if c != nheads * _KERNEL_D or not 1 <= ws * ws <= _KERNEL_MAX_L:
        raise ValueError(f"{kernel} takes head dim {_KERNEL_D} and L = ws*ws <= "
                         f"{_KERNEL_MAX_L}; got head dim {c / nheads:g}, ws={ws}")
    if hp % ws or wp % ws:
        raise ValueError(f"Hp={hp}, Wp={wp} must be multiples of ws={ws}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if qkv.data_ptr() % 16:  # rows of 32 channels move 16 bytes per thread
        raise ValueError("qkv must start on a 16-byte boundary")
    L = ws * ws
    nw = (hp // ws) * (wp // ws)
    check_tensor(scale, "scale", (nheads,), torch.float32, qkv.device)
    check_tensor(bias, "bias", (nheads, L, L), torch.float32, qkv.device)
    if mask is not None:
        check_tensor(mask, "mask", (nw, L, L), torch.float32, qkv.device)


def _tile_rows(L: int) -> int:
    """The tensor-core kernels' tile height: L cut into ceil(L / 64) tiles
    of one height, a multiple of 16 (48 at L = 36 and 144, else 64), as
    ``swin_mma::tile_rows``."""
    tiles = -(-L // _MMA_TILE)
    return -(-(-(-L // tiles)) // 16) * 16


def _fwd_tile_rows(L: int) -> int:
    """The tensor-core forward's tile height, as ``swin_fwd::fwd_tile_rows``:
    :func:`_tile_rows`, and 48 where that would be shorter (L <= 32)."""
    return 64 if _tile_rows(L) > 48 else 48


class ForwardScratch(NamedTuple):
    """Grid and scratch of one launch of the bf16 tensor-core forward."""
    images_per_block: int      # images whose rows a block's warps take in turn
    tile_rows: int             # query (and key) rows of a tile; a warp per 16
    grid: Tuple[int, int, int]  # (window positions x query tiles, heads, slices of the images)
    threads: int               # per block
    kn: int                    # bf16 entries of kn, (B, Hp, Wp, C)
    bias_mask: int             # f32 entries of a shifted block's bias + mask, (nW, H, L, L)


# images a block of the bf16 forward takes (1 or 2)
_FWD_IMAGES = 2


def forward_scratch(b: int, hp: int, wp: int, nheads: int, ws: int,
                    masked: bool = False) -> ForwardScratch:
    """Grid and scratch of the bf16 forward (``csrc/swin_attention_fwd_mma.
    cuh``): a block per (window position, query tile, head, slice of two
    images), a warp per 16 query rows of each image in turn, so each bias
    tile the block loads serves two images (its loads bound the kernel:
    PERF.md); kn of every token normalised once per launch into a scratch
    the size of the output, and in shifted blocks bias + mask added once
    into an (nW, H, L, L) f32 scratch."""
    L = ws * ws
    nw = (hp // ws) * (wp // ws)
    tr = _fwd_tile_rows(L)
    per_block = min(_FWD_IMAGES, b)
    return ForwardScratch(per_block, tr, (nw * -(-L // _MMA_TILE), nheads, -(-b // per_block)),
                          2 * tr, b * hp * wp * nheads * _KERNEL_D,
                          nw * nheads * L * L if masked else 0)


def swin_attention_fwd_cuda(qkv: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, mask: Optional[torch.Tensor],
                            ws: int, nheads: int) -> torch.Tensor:
    """Launch the Hopper forward kernel (same arguments as the plain
    version). Raises on devices, shapes, types or layouts it does not take."""
    _check_attention_args(KERNEL, qkv, scale, bias, mask, ws, nheads)
    b, hp, wp, c3 = qkv.shape
    c = c3 // 3
    out = torch.empty((b, hp, wp, c), dtype=qkv.dtype, device=qkv.device)
    kn = bias_mask = None
    images_per_block = 1
    if qkv.dtype == torch.bfloat16:
        plan = forward_scratch(b, hp, wp, nheads, ws, mask is not None)
        images_per_block = plan.images_per_block
        kn = torch.empty((plan.kn,), dtype=torch.bfloat16, device=qkv.device)
        if plan.bias_mask:
            bias_mask = torch.empty((plan.bias_mask,), dtype=torch.float32, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = _function(KERNEL)(
        qkv.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(),
        kn.data_ptr() if kn is not None else None,
        bias_mask.data_ptr() if bias_mask is not None else None,
        DTYPE_CODE[qkv.dtype], b, hp, wp, c, nheads, ws, images_per_block, stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err}")
    FWD_ROUTE_LAUNCHES[forward_route(qkv.dtype, ws)] += 1
    LAUNCHES[KERNEL] += 1
    return out


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _images_per_block(b: int, positions: int, device: torch.device,
                      blocks_per_sm: int = 4) -> int:
    """Images each backward block loops over: few enough blocks to keep the
    partial sums small, enough (about ``blocks_per_sm`` per SM) to fill the
    card at every stage (stage 1 has 64 windows x 3 heads, stage 4 one window
    x 24)."""
    slices = max(1, min(b, -(-blocks_per_sm * _sm_count(device) // positions)))
    return -(-b // slices)


class BackwardScratch(NamedTuple):
    """Grid and scratch of one backward launch (all scratch f32)."""
    images_per_block: int     # images a block of the dbias-summing pass loops over
    slots: int                # dbias slabs: (slots, H, L, L)
    scale_slots: int          # dscale sums: (scale_slots, H)
    row_stats: int            # entries of the bf16 row statistics (3, B, H, nW, L)
    work: int                 # entries of the bf16 kernel's work: a shifted block's
    #                           bias + mask (nW, H, L, L), 16-byte aligned, then 1 / |k|

    def nbytes(self, nheads: int, L: int) -> int:
        return 4 * (self.slots * nheads * L * L + self.scale_slots * nheads + self.row_stats
                    + self.work)


# the bf16 backward's dbias slabs stay under this many bytes when the grid
# would otherwise slice the images finer
_MMA_SLAB_BYTES = 64 * 2 ** 20


def mma_images_per_block(b: int, positions: int, slab_bytes: int,
                         device: torch.device) -> int:
    """Images a dk/dv block of the bf16 tensor-core backward
    (``csrc/swin_attention_bwd_mma.cuh``, every mode) loops over, with
    ``positions`` blocks per slice of the images and ``slab_bytes`` of
    dbias slabs per slice (0 without a bias): about four waves of one block
    per SM (fewer images per block balance the SMs better) while the slabs
    stay under 64 MiB."""
    per_block = _images_per_block(b, positions, device, 4)
    max_slices = max(1, _MMA_SLAB_BYTES // slab_bytes) if slab_bytes else b
    if -(-b // per_block) > max_slices:
        per_block = -(-b // max_slices)
    return per_block


def backward_scratch(b: int, nw: int, nheads: int, ws: int, dtype: torch.dtype,
                     device: torch.device, masked: bool = False) -> BackwardScratch:
    """Grid and scratch of the backward for ``dtype``. f32, on the FMA
    templates: one dbias slab per (window position, slice of the images);
    the key-tiled path (L > 256) holds one block per SM, so it aims at two
    per SM (at swinv2_base_window12to24's stages at batch 32 the slabs take
    425, 340 and 340 MB). bf16, on the tensor-core kernel: its dk/dv pass has
    a block per (window position, 64-key tile, head, slice) holding the
    block's (L, 64) dbias column in shared memory over its images, so one
    slab per (window position, slice) and one dscale slot per block; it
    aims at about four waves of one block per SM (fewer images per block
    balance the SMs better) while the slabs stay under 64 MiB. Its dq pass
    has a block per image (never slower than a few images per block on the
    H100, PERF.md). Its row statistics take 3 floats per token and head;
    its work scratch holds a shifted block's bias + mask (one (L, L) matrix
    per window and head) and 1 / |k| (a float per token and head; kn itself
    waits in dqkv's dv channels)."""
    L = ws * ws
    if dtype != torch.bfloat16:
        per_sm = 2 if L > _TILED_ABOVE_L else 4
        per_block = _images_per_block(b, nw * nheads, device, per_sm)
        slots = nw * -(-b // per_block)
        return BackwardScratch(per_block, slots, slots, 0, 0)
    tiles = -(-L // _MMA_TILE)
    per_block = mma_images_per_block(b, nw * tiles * nheads, nw * nheads * L * L * 4, device)
    slots = nw * -(-b // per_block)
    pixels = b * nw * L
    work = (-(-nw * nheads * L * L // 4) * 4 if masked else 0) + pixels * nheads
    return BackwardScratch(per_block, slots, slots * tiles, 3 * b * nheads * nw * L, work)


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
    if dout.data_ptr() % 16:
        raise ValueError("dout must start on a 16-byte boundary")
    L = ws * ws
    nw = (hp // ws) * (wp // ws)
    plan = backward_scratch(b, nw, nheads, ws, qkv.dtype, qkv.device, mask is not None)
    f32 = dict(dtype=torch.float32, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((nheads, L, L), **f32)
    dscale = torch.empty((nheads,), **f32)
    partial_bias = torch.empty((plan.slots, nheads, L, L), **f32)
    partial_scale = torch.empty((plan.scale_slots, nheads), **f32)
    row_stats = torch.empty((plan.row_stats,), **f32) if plan.row_stats else None
    work = torch.empty((plan.work,), **f32) if plan.work else None
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = _function(KERNEL_BWD)(
        qkv.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        mask.data_ptr() if mask is not None else None, dout.data_ptr(),
        dqkv.data_ptr(), dbias.data_ptr(), dscale.data_ptr(),
        partial_bias.data_ptr(), partial_scale.data_ptr(),
        row_stats.data_ptr() if row_stats is not None else None,
        work.data_ptr() if work is not None else None,
        DTYPE_CODE[qkv.dtype], b, hp, wp, c, nheads, ws, plan.images_per_block, stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL_BWD} launch failed: CUDA error {err}")
    ROUTE_LAUNCHES[backward_route(qkv.dtype, ws)] += 1
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
    refuse_in_export("K1")
    scale = torch.exp(torch.clamp(logit_scale.float(), max=LN_100)).contiguous()
    bias = bias.float().contiguous()
    mask = None if mask is None else mask.float().contiguous()
    if torch.is_grad_enabled() and (qkv.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return SwinAttentionFunction.apply(qkv, scale, bias, mask, ws, nheads)
    # no graph to build (eval under inference_mode): nothing is saved
    return _forward(qkv, scale, bias, mask, ws, nheads)

