"""Fused plain (scaled dot-product) window attention on the unpartitioned
spatial layout, forward and backward: the non-cosine sibling of
``ops/swin_attention.py`` for DaViT spatial blocks and GCViT local and global
blocks.

Port of ``torchok_tpu.ops.swin_attention.fused_window_attention``,
``fused_window_attention_global`` and their common entry
``window_attention_spatial``. The projection stays ``(B, Hp, Wp, 3C)`` (qkv)
or ``(B, Hp, Wp, 2C)`` (kv, with the image's shared ``(B, L, C)`` global
queries beside it) and the result is ``(B, Hp, Wp, C)``: partition and
reverse are folded into the op. The JAX package partitions in XLA for the
window sizes its TPU compiler cannot relayout (7, 14) and so takes windowed
kv in its global op; here every window size up to 16 goes through the same
spatial indexing.

A CUDA tensor goes to the hand-written Hopper kernels
``csrc/window_attention_{fwd,bwd}.cu`` and
``csrc/window_attention_global_{fwd,bwd}.cu`` (they launch or raise); a CPU
tensor goes to the plain PyTorch versions of the same arithmetic below, which
the CPU tests compare with the JAX package and ``chip_smoke.py`` compares
with the kernels on the card. All four kernels route by dtype
(:func:`forward_route`, :func:`backward_route`; launches counted per kernel
and route in :data:`FWD_ROUTE_LAUNCHES` and :data:`ROUTE_LAUNCHES`). bf16,
what inference and training run under autocast, goes to the plain-dot modes
of SwinV2's tensor-core kernels on ``mma.sync``: the forward
``csrc/swin_attention_fwd_mma.cuh`` (one QK^T in registers per window at L
<= 64, the key tiles walked twice at L = 196; the global mode walks a slice
of an image's windows with its q tile held in registers) and the backward
``csrc/swin_attention_bwd_mma.cuh`` (two passes; the global mode sums dq
over an image's windows in one block). f32 stays on the FMA templates
``csrc/window_attention_{fwd,bwd}.cuh``. :func:`forward_scratch` and
:func:`backward_scratch` size the grids and scratch.

Rounding points (those of the Pallas kernels): q and k enter the product in
the input dtype with f32 accumulation; the logits, the per-head scale (applied
to the logits, not to q), the bias and the softmax are f32; the weights are
cast to the input dtype for ``a v``; the output is cast to the input dtype. In
the backward ``dl`` is f32, ``dls = dl * scale`` is cast to the input dtype
before the two products with it, and ``dbias`` sums the f32 ``dl``. The global
queries are cast to kv's dtype; their gradient leaves the backward in f32 and
is cast to the queries' dtype by the autograd function. ``scale`` gets no
gradient.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from torchok_tpu_torch.ops import swin_attention
from torchok_tpu_torch.ops.common import DTYPE_CODE, LAUNCHES, check_tensor, refuse_in_export
from torchok_tpu_torch.ops.swin_attention import (_MMA_TILE, _fwd_tile_rows, _images_per_block,
                                                  from_windows, mma_images_per_block,
                                                  to_windows)

KERNEL = "window_attention_fwd"
PLAIN = "window_attention_fwd_plain"
KERNEL_BWD = "window_attention_bwd"
PLAIN_BWD = "window_attention_bwd_plain"
KERNEL_GLOBAL = "window_attention_global_fwd"
PLAIN_GLOBAL = "window_attention_global_fwd_plain"
KERNEL_GLOBAL_BWD = "window_attention_global_bwd"
PLAIN_GLOBAL_BWD = "window_attention_global_bwd_plain"
KERNELS = (KERNEL, KERNEL_BWD, KERNEL_GLOBAL, KERNEL_GLOBAL_BWD)

# the kernels' routes, as window_attention{,_global}_{fwd,bwd}_route number
# them (alike)
BWD_ROUTES = ("templates", "mma")
FWD_ROUTES = BWD_ROUTES
# launches of the two forward and of the two backward kernels per (kernel,
# route) (the wrappers add one per launch)
FWD_ROUTE_LAUNCHES: collections.Counter = collections.Counter()
ROUTE_LAUNCHES: collections.Counter = collections.Counter()

_KERNEL_D = 32
_KERNEL_MAX_WS = 16  # L = ws * ws <= 256 keys held in shared memory

_VOID, _INT = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # qkv, scale, bias, out, work; dtype, B, Hp, Wp, C, nheads, ws; stream
    KERNEL: [_VOID] * 5 + [_INT] * 7 + [_VOID],
    # qkv, scale, bias, dout, dqkv, dbias, partial, row_stats, work; dtype,
    # B, Hp, Wp, C, nheads, ws, images_per_block; stream
    KERNEL_BWD: [_VOID] * 9 + [_INT] * 8 + [_VOID],
    # kv, qg, scale, bias, out, work; dtype, B, Hp, Wp, C, nheads, ws,
    # windows_per_block; stream
    KERNEL_GLOBAL: [_VOID] * 6 + [_INT] * 8 + [_VOID],
    # kv, qg, scale, bias, dout, dkv, dqg, dbias, partial, row_stats, work;
    # dtype, B, Hp, Wp, C, nheads, ws, images_per_block; stream
    KERNEL_GLOBAL_BWD: [_VOID] * 11 + [_INT] * 8 + [_VOID],
}


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------
def _global_queries(qg: torch.Tensor, nheads: int, dtype: torch.dtype) -> torch.Tensor:
    """(B, L, C) -> (B, H, 1, L, D) f32 values of ``dtype``, to broadcast over
    the image's windows."""
    b, L, c = qg.shape
    q = qg.to(dtype).reshape(b, L, nheads, c // nheads).permute(0, 2, 1, 3)
    return q[:, :, None].float()


def _weights(q: torch.Tensor, k: torch.Tensor, scale: torch.Tensor,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
    """f32 softmax(q k^T * scale_h + bias_h) over (B, H, nW, L, D) f32 operands."""
    nheads, L = k.shape[1], k.shape[3]
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale.view(1, nheads, 1, 1, 1)
    if bias is not None:
        logits = logits + bias.view(1, nheads, 1, L, L)
    return torch.softmax(logits, dim=-1)


def window_attention_fwd_plain(qkv: torch.Tensor, scale: torch.Tensor,
                               bias: Optional[torch.Tensor], ws: int,
                               nheads: int) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/window_attention_fwd.cu``. ``qkv``
    (B, Hp, Wp, 3C), ``scale`` (H,) f32, ``bias`` (H, L, L) f32 or None."""
    _, hp, wp, _ = qkv.shape
    dtype = qkv.dtype
    q, k, v = to_windows(qkv, ws, 3, nheads)
    # the rounding points are explicit, so autocast must not add its own
    with torch.autocast(qkv.device.type, enabled=False):
        a = _weights(q.float(), k.float(), scale, bias).to(dtype)
        o = torch.matmul(a.float(), v.float()).to(dtype)  # (B, H, nW, L, D)
    return from_windows(o[None], ws, hp, wp)


def window_attention_global_fwd_plain(kv: torch.Tensor, qg: torch.Tensor,
                                      scale: torch.Tensor, bias: torch.Tensor, ws: int,
                                      nheads: int) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/window_attention_global_fwd.cu``. ``kv``
    (B, Hp, Wp, 2C), ``qg`` (B, L, C) shared by the image's windows."""
    _, hp, wp, _ = kv.shape
    dtype = kv.dtype
    k, v = to_windows(kv, ws, 2, nheads)
    with torch.autocast(kv.device.type, enabled=False):
        a = _weights(_global_queries(qg, nheads, dtype), k.float(), scale, bias).to(dtype)
        o = torch.matmul(a.float(), v.float()).to(dtype)
    return from_windows(o[None], ws, hp, wp)


def _backward_core(q, k, v, do, scale, bias, dtype):
    """The shared steps of both plain backwards on f32 (B, H, nW, L, D)
    operands (``q`` may have one window, broadcast): (dq per window, dk, dv,
    dbias or None), all f32."""
    a32 = _weights(q, k, scale, bias)
    a = a32.to(dtype).float()
    dv = torch.matmul(a.transpose(-1, -2), do)
    da = torch.matmul(do, v.transpose(-1, -2))
    dl = a32 * (da - torch.sum(da * a32, dim=-1, keepdim=True))
    dbias = None if bias is None else dl.sum(dim=(0, 2))
    dls = (dl * scale.view(1, -1, 1, 1, 1)).to(dtype).float()
    dq = torch.matmul(dls, k)
    dk = torch.matmul(dls.transpose(-1, -2), q)
    return dq, dk, dv, dbias


def window_attention_bwd_plain(qkv: torch.Tensor, scale: torch.Tensor,
                               bias: Optional[torch.Tensor], dout: torch.Tensor, ws: int,
                               nheads: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of ``csrc/window_attention_bwd.cu``, written out
    step by step with the kernel's rounding points. ``dout`` is (B, Hp, Wp, C).
    Returns ``dqkv`` in qkv's dtype and ``dbias`` (H, L, L) f32, None without
    a bias."""
    _, hp, wp, _ = qkv.shape
    dtype = qkv.dtype
    q, k, v = to_windows(qkv, ws, 3, nheads)
    do = to_windows(dout, ws, 1, nheads)[0]
    with torch.autocast(qkv.device.type, enabled=False):
        dq, dk, dv, dbias = _backward_core(q.float(), k.float(), v.float(), do.float(),
                                           scale, bias, dtype)
        dwin = torch.stack([dq, dk, dv]).to(dtype)
    return from_windows(dwin, ws, hp, wp), dbias


def window_attention_global_bwd_plain(kv: torch.Tensor, qg: torch.Tensor, scale: torch.Tensor,
                                      bias: torch.Tensor, dout: torch.Tensor, ws: int,
                                      nheads: int
                                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``csrc/window_attention_global_bwd.cu``.
    Returns ``dkv`` in kv's dtype, ``dqg`` (B, L, C) f32 summed over each
    image's windows and ``dbias`` (H, L, L) f32."""
    b, hp, wp, _ = kv.shape
    dtype = kv.dtype
    k, v = to_windows(kv, ws, 2, nheads)
    do = to_windows(dout, ws, 1, nheads)[0]
    with torch.autocast(kv.device.type, enabled=False):
        q = _global_queries(qg, nheads, dtype)
        dq, dk, dv, dbias = _backward_core(q, k.float(), v.float(), do.float(),
                                           scale, bias, dtype)
        dqg = dq.sum(dim=2).permute(0, 2, 1, 3).reshape(b, ws * ws, -1)
        dwin = torch.stack([dk, dv]).to(dtype)
    return from_windows(dwin, ws, hp, wp), dqg, dbias


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _function(name: str):
    """The ``extern "C"`` entry of ``csrc/<name>.cu``. The first call builds
    all four sources side by side: a model that needs one needs the others."""
    from torchok_tpu_torch.utils.cuda_build import load_function, load_libraries
    load_libraries(KERNELS)
    return load_function(name, _ARGTYPES[name])


def _route(kernel: str, dtype: torch.dtype) -> int:
    from torchok_tpu_torch.utils.cuda_build import load_function
    _function(kernel)  # builds the four sources side by side
    return load_function(kernel, [_INT], f"{kernel}_route")(DTYPE_CODE[dtype])


def forward_route(kernel: str, dtype: torch.dtype) -> str:
    """The route (one of :data:`FWD_ROUTES`) the forward kernel ``kernel``
    (:data:`KERNEL` or :data:`KERNEL_GLOBAL`) takes for this dtype at every
    window size, as the built library reports it."""
    return FWD_ROUTES[_route(kernel, dtype)]


def backward_route(kernel: str, dtype: torch.dtype) -> str:
    """The route (one of :data:`BWD_ROUTES`) the backward kernel ``kernel``
    (:data:`KERNEL_BWD` or :data:`KERNEL_GLOBAL_BWD`) takes for this dtype
    at every window size, as the built library reports it."""
    return BWD_ROUTES[_route(kernel, dtype)]


class ForwardScratch(NamedTuple):
    """Grid and scratch of one bf16 forward launch."""
    images_per_block: int      # images whose rows a block's warps take in turn
    windows_per_block: int     # windows of an image a block walks (global mode, L <= 64)
    tile_rows: int             # query (and key) rows of a tile; a warp per 16
    grid: Tuple[int, int, int]
    threads: int               # per block
    work: int                  # f32 entries of the bias in rows of L rounded up to 4, (H, L, ld)


# images a block of the bf16 forward takes (swin_fwd::kPlainImages), and the
# blocks per SM the global walk's window slices are sized for
_FWD_IMAGES = 2
_WALK_BLOCKS_PER_SM = 4


def forward_scratch(b: int, hp: int, wp: int, nheads: int, ws: int, device: torch.device,
                    has_bias: bool = True, global_queries: bool = False) -> ForwardScratch:
    """Grid and scratch of the bf16 forward (``csrc/swin_attention_fwd_mma.
    cuh``, its plain modes). Local, and global above L = 64: a block per
    (window position, query tile, head, two images), a warp per 16 query rows
    of each image in turn, so each bias tile the block loads serves two
    images. Global at L <= 64 (one key tile): a block per (slice of an
    image's windows, head, image) walks its slice with the image's q tile in
    registers and the head's bias tile in shared memory; the slices are as
    many as put about four blocks on every SM of the card (GCViT's stage 1:
    two slices of 32 windows; one slice where heads x images fill the card
    alone). With a bias and L not a multiple of 4 (L = 49) the bias is
    copied into rows of L rounded up to 4 floats, so that its tiles load 16
    bytes a thread; not for the walk, which loads its tile once per slice
    4 bytes a thread."""
    L = ws * ws
    nw = (hp // ws) * (wp // ws)
    tiles = -(-L // _MMA_TILE)
    tr = _fwd_tile_rows(L)
    walk = global_queries and tiles == 1
    work = nheads * L * (-(-L // 4) * 4) if has_bias and L % 4 and not walk else 0
    if walk:
        slots = _WALK_BLOCKS_PER_SM * swin_attention._sm_count(device)
        slices = max(1, min(nw, round(slots / (nheads * b))))
        per = -(-nw // slices)
        return ForwardScratch(1, per, tr, (-(-nw // per), nheads, b), 2 * tr, work)
    return ForwardScratch(_FWD_IMAGES, 1, tr, (nw * tiles, nheads, -(-b // _FWD_IMAGES)),
                          2 * tr, work)


class BackwardScratch(NamedTuple):
    """Grid and scratch of one backward launch (all scratch f32)."""
    images_per_block: int  # images a dk/dv block (f32: a block) loops over
    slots: int             # dbias slabs (slots, H, L, L); 0 without a bias
    row_stats: int         # entries of the bf16 row statistics (3, B, H, nW, L)
    work: int              # entries of the bf16 bias in rows of L rounded up to 4, (H, L, ld)

    def nbytes(self, nheads: int, L: int) -> int:
        return 4 * (self.slots * nheads * L * L + self.row_stats + self.work)


def backward_scratch(b: int, nw: int, nheads: int, ws: int, dtype: torch.dtype,
                     device: torch.device, has_bias: bool = True,
                     global_queries: bool = False) -> BackwardScratch:
    """Grid and scratch of a backward launch for ``dtype``. f32, on the FMA
    template: a block per (window position, head) and slice of the images
    (global: per head and slice, looping over each image's windows), about
    four blocks per SM, one dbias slab per (window position,) slice. bf16, on
    the tensor-core kernel: its dq pass has a block per (window position,
    query tile, head, image) (global: per (query tile, head, image), walking
    the windows); its dk/dv pass a block per (window position, 64-key tile,
    head, slice of the images) holding the block's dbias column in shared
    memory over its images, so one slab per (window position, slice), sliced
    as the SwinV2 backward's (``ops.swin_attention.mma_images_per_block``:
    about four waves, slabs under 64 MiB). Its row statistics take 3 floats
    per token and head; with a bias and L not a multiple of 4 (L = 49) the
    bias is copied into rows of L rounded up to 4 floats, so that its tiles
    load 16 bytes a thread."""
    L = ws * ws
    if dtype != torch.bfloat16:
        per_block = _images_per_block(b, nheads if global_queries else nw * nheads, device)
        slices = -(-b // per_block)
        return BackwardScratch(per_block, slices if global_queries else nw * slices, 0, 0)
    tiles = -(-L // _MMA_TILE)
    slab = nw * nheads * L * L * 4 if has_bias else 0
    per_block = mma_images_per_block(b, nw * tiles * nheads, slab, device)
    slots = nw * -(-b // per_block) if has_bias else 0
    work = nheads * L * (-(-L // 4) * 4) if has_bias and L % 4 else 0
    return BackwardScratch(per_block, slots, 3 * b * nheads * nw * L, work)


def _check_args(kernel: str, proj: torch.Tensor, parts: int, scale: torch.Tensor,
                bias: Optional[torch.Tensor], ws: int, nheads: int) -> int:
    """Raise on devices, shapes, types or layouts the kernels do not take;
    returns C."""
    if proj.device.type != "cuda":
        raise ValueError(f"{kernel} takes CUDA tensors, got {proj.device}")
    if proj.dtype not in DTYPE_CODE:
        raise TypeError(f"{kernel} takes float32 or bfloat16, got {proj.dtype}")
    if proj.dim() != 4 or proj.shape[-1] % parts:
        raise ValueError(f"{kernel} takes (B, Hp, Wp, {parts}C), got {tuple(proj.shape)}")
    _, hp, wp, width = proj.shape
    c = width // parts
    if c != nheads * _KERNEL_D or not 1 <= ws <= _KERNEL_MAX_WS:
        raise ValueError(f"{kernel} takes head dim {_KERNEL_D} and ws <= {_KERNEL_MAX_WS} "
                         f"(L <= {_KERNEL_MAX_WS ** 2}); got head dim {c / nheads:g}, ws={ws}")
    if hp % ws or wp % ws:
        raise ValueError(f"Hp={hp}, Wp={wp} must be multiples of ws={ws}")
    if not proj.is_contiguous():
        raise ValueError("the projection must be contiguous")
    _check_aligned(proj, "the projection")
    check_tensor(scale, "scale", (nheads,), torch.float32, proj.device)
    if bias is not None:
        check_tensor(bias, "bias", (nheads, ws * ws, ws * ws), torch.float32, proj.device)
    return c


def _check_aligned(t: torch.Tensor, name: str) -> None:
    """The kernels move rows of 32 channels 16 bytes per thread."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
    LAUNCHES[kernel] += 1


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _scratch(plan: BackwardScratch, f32: dict) -> Tuple[Optional[torch.Tensor], ...]:
    """The bf16 route's row statistics and padded bias, None where the plan
    has none."""
    return tuple(torch.empty((n,), **f32) if n else None for n in (plan.row_stats, plan.work))


def _forward_plan(proj: torch.Tensor, ws: int, nheads: int, has_bias: bool,
                  global_queries: bool) -> Tuple[int, Optional[torch.Tensor]]:
    """(windows a block walks, padded-bias scratch or None) of a forward
    launch; f32 takes neither."""
    if proj.dtype != torch.bfloat16:
        return 1, None
    b, hp, wp, _ = proj.shape
    plan = forward_scratch(b, hp, wp, nheads, ws, proj.device, has_bias, global_queries)
    work = torch.empty((plan.work,), dtype=torch.float32, device=proj.device) if plan.work \
        else None
    return plan.windows_per_block, work


def window_attention_fwd_cuda(qkv: torch.Tensor, scale: torch.Tensor,
                              bias: Optional[torch.Tensor], ws: int, nheads: int) -> torch.Tensor:
    """Launch the Hopper forward kernel (arguments as the plain version)."""
    c = _check_args(KERNEL, qkv, 3, scale, bias, ws, nheads)
    b, hp, wp, _ = qkv.shape
    _, work = _forward_plan(qkv, ws, nheads, bias is not None, False)
    out = torch.empty((b, hp, wp, c), dtype=qkv.dtype, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = _function(KERNEL)(qkv.data_ptr(), scale.data_ptr(), _ptr(bias), out.data_ptr(),
                            _ptr(work), DTYPE_CODE[qkv.dtype], b, hp, wp, c, nheads, ws, stream)
    _raise_on(err, KERNEL)
    FWD_ROUTE_LAUNCHES[(KERNEL, forward_route(KERNEL, qkv.dtype))] += 1
    return out


def window_attention_global_fwd_cuda(kv: torch.Tensor, qg: torch.Tensor, scale: torch.Tensor,
                                     bias: torch.Tensor, ws: int, nheads: int) -> torch.Tensor:
    """Launch the Hopper global-query forward kernel (arguments as the plain
    version; ``qg`` in kv's dtype)."""
    c = _check_args(KERNEL_GLOBAL, kv, 2, scale, bias, ws, nheads)
    b, hp, wp, _ = kv.shape
    check_tensor(qg, "q_global", (b, ws * ws, c), kv.dtype, kv.device)
    _check_aligned(qg, "q_global")
    windows, work = _forward_plan(kv, ws, nheads, True, True)
    out = torch.empty((b, hp, wp, c), dtype=kv.dtype, device=kv.device)
    stream = torch.cuda.current_stream(kv.device).cuda_stream
    err = _function(KERNEL_GLOBAL)(kv.data_ptr(), qg.data_ptr(), scale.data_ptr(),
                                   bias.data_ptr(), out.data_ptr(), _ptr(work),
                                   DTYPE_CODE[kv.dtype], b, hp, wp, c, nheads, ws, windows,
                                   stream)
    _raise_on(err, KERNEL_GLOBAL)
    FWD_ROUTE_LAUNCHES[(KERNEL_GLOBAL, forward_route(KERNEL_GLOBAL, kv.dtype))] += 1
    return out


def window_attention_bwd_cuda(qkv: torch.Tensor, scale: torch.Tensor,
                              bias: Optional[torch.Tensor], dout: torch.Tensor, ws: int,
                              nheads: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the Hopper backward kernel and, with a bias, its reduction
    (arguments and results as the plain version)."""
    c = _check_args(KERNEL_BWD, qkv, 3, scale, bias, ws, nheads)
    b, hp, wp, _ = qkv.shape
    check_tensor(dout, "dout", (b, hp, wp, c), qkv.dtype, qkv.device)
    _check_aligned(dout, "dout")
    L = ws * ws
    nw = (hp // ws) * (wp // ws)
    plan = backward_scratch(b, nw, nheads, ws, qkv.dtype, qkv.device, bias is not None)
    f32 = dict(dtype=torch.float32, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    dbias = partial = None
    if bias is not None:
        dbias = torch.empty((nheads, L, L), **f32)
        partial = torch.empty((plan.slots, nheads, L, L), **f32)
    row_stats, work = _scratch(plan, f32)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    err = _function(KERNEL_BWD)(qkv.data_ptr(), scale.data_ptr(), _ptr(bias), dout.data_ptr(),
                                dqkv.data_ptr(), _ptr(dbias), _ptr(partial), _ptr(row_stats),
                                _ptr(work), DTYPE_CODE[qkv.dtype], b, hp, wp, c, nheads, ws,
                                plan.images_per_block, stream)
    _raise_on(err, KERNEL_BWD)
    ROUTE_LAUNCHES[(KERNEL_BWD, backward_route(KERNEL_BWD, qkv.dtype))] += 1
    return dqkv, dbias


def window_attention_global_bwd_cuda(kv: torch.Tensor, qg: torch.Tensor, scale: torch.Tensor,
                                     bias: torch.Tensor, dout: torch.Tensor, ws: int,
                                     nheads: int
                                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the Hopper global-query backward kernel and its reduction
    (arguments and results as the plain version; ``qg`` in kv's dtype)."""
    c = _check_args(KERNEL_GLOBAL_BWD, kv, 2, scale, bias, ws, nheads)
    b, hp, wp, _ = kv.shape
    L = ws * ws
    check_tensor(qg, "q_global", (b, L, c), kv.dtype, kv.device)
    check_tensor(dout, "dout", (b, hp, wp, c), kv.dtype, kv.device)
    _check_aligned(qg, "q_global")
    _check_aligned(dout, "dout")
    nw = (hp // ws) * (wp // ws)
    plan = backward_scratch(b, nw, nheads, ws, kv.dtype, kv.device, True, True)
    f32 = dict(dtype=torch.float32, device=kv.device)
    dkv = torch.empty_like(kv)
    dqg = torch.empty((b, L, c), **f32)
    dbias = torch.empty((nheads, L, L), **f32)
    partial = torch.empty((plan.slots, nheads, L, L), **f32)
    row_stats, work = _scratch(plan, f32)
    stream = torch.cuda.current_stream(kv.device).cuda_stream
    err = _function(KERNEL_GLOBAL_BWD)(
        kv.data_ptr(), qg.data_ptr(), scale.data_ptr(), bias.data_ptr(), dout.data_ptr(),
        dkv.data_ptr(), dqg.data_ptr(), dbias.data_ptr(), partial.data_ptr(), _ptr(row_stats),
        _ptr(work), DTYPE_CODE[kv.dtype], b, hp, wp, c, nheads, ws, plan.images_per_block,
        stream)
    _raise_on(err, KERNEL_GLOBAL_BWD)
    ROUTE_LAUNCHES[(KERNEL_GLOBAL_BWD, backward_route(KERNEL_GLOBAL_BWD, kv.dtype))] += 1
    return dkv, dqg, dbias


# ---------------------------------------------------------------------------
# dispatch and autograd
# ---------------------------------------------------------------------------
def _on_cuda(t: torch.Tensor, op: str) -> bool:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{op} runs on CUDA or the CPU, not {t.device}")
    return t.device.type == "cuda"


def _forward(qkv, scale, bias, ws: int, nheads: int) -> torch.Tensor:
    if _on_cuda(qkv, "fused_window_attention"):
        return window_attention_fwd_cuda(qkv, scale, bias, ws, nheads)
    LAUNCHES[PLAIN] += 1
    return window_attention_fwd_plain(qkv, scale, bias, ws, nheads)


def _forward_global(kv, qg, scale, bias, ws: int, nheads: int) -> torch.Tensor:
    if _on_cuda(kv, "fused_window_attention_global"):
        return window_attention_global_fwd_cuda(kv, qg, scale, bias, ws, nheads)
    LAUNCHES[PLAIN_GLOBAL] += 1
    return window_attention_global_fwd_plain(kv, qg, scale, bias, ws, nheads)


def _cast_dout(dout: torch.Tensor, like: torch.Tensor, kernel: str) -> torch.Tensor:
    if dout.dtype not in DTYPE_CODE:
        raise TypeError(f"{kernel} takes a float32 or bfloat16 dout, got {dout.dtype}")
    # proj's backward may hand over a strided or f32 gradient
    return dout.to(like.dtype).contiguous()


class WindowAttentionFunction(torch.autograd.Function):
    """``(qkv, scale, bias, ws, nheads) -> out`` with the hand-written
    backward: gradients for ``qkv`` and ``bias``, none for ``scale``. Only
    the inputs are saved; the backward recomputes the attention weights."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, qkv, scale, bias, ws: int, nheads: int):
        ctx.save_for_backward(qkv, scale, bias)
        ctx.ws, ctx.nheads = ws, nheads
        return _forward(qkv, scale, bias, ws, nheads)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dout):
        qkv, scale, bias = ctx.saved_tensors
        dout = _cast_dout(dout, qkv, KERNEL_BWD)
        if qkv.device.type == "cuda":
            dqkv, dbias = window_attention_bwd_cuda(qkv, scale, bias, dout, ctx.ws, ctx.nheads)
        else:
            LAUNCHES[PLAIN_BWD] += 1
            dqkv, dbias = window_attention_bwd_plain(qkv, scale, bias, dout, ctx.ws, ctx.nheads)
        needs = ctx.needs_input_grad
        return (dqkv if needs[0] else None, None,
                dbias if bias is not None and needs[2] else None, None, None)


class WindowAttentionGlobalFunction(torch.autograd.Function):
    """``(kv, qg, scale, bias, ws, nheads) -> out`` with the hand-written
    backward: gradients for ``kv``, ``qg`` (in qg's dtype) and ``bias``, none
    for ``scale``. ``qg`` arrives in kv's dtype."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, kv, qg, scale, bias, ws: int, nheads: int):
        ctx.save_for_backward(kv, qg, scale, bias)
        ctx.ws, ctx.nheads = ws, nheads
        return _forward_global(kv, qg, scale, bias, ws, nheads)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dout):
        kv, qg, scale, bias = ctx.saved_tensors
        dout = _cast_dout(dout, kv, KERNEL_GLOBAL_BWD)
        if kv.device.type == "cuda":
            dkv, dqg, dbias = window_attention_global_bwd_cuda(kv, qg, scale, bias, dout,
                                                               ctx.ws, ctx.nheads)
        else:
            LAUNCHES[PLAIN_GLOBAL_BWD] += 1
            dkv, dqg, dbias = window_attention_global_bwd_plain(kv, qg, scale, bias, dout,
                                                                ctx.ws, ctx.nheads)
        needs = ctx.needs_input_grad
        return (dkv if needs[0] else None, dqg.to(qg.dtype) if needs[1] else None, None,
                dbias if needs[3] else None, None, None)


def _needs_graph(*tensors: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def fused_window_attention(qkv: torch.Tensor, scale: torch.Tensor,
                           bias: Optional[torch.Tensor], ws: int, nheads: int) -> torch.Tensor:
    """Fused plain window attention on the spatial layout.

    Args:
        qkv: (B, Hp, Wp, 3C) fused projection; Hp, Wp multiples of ``ws``.
        scale: (H,) per-head logit multipliers (typically head_dim**-0.5).
        bias: (H, L, L) additive bias (GCViT's learned relative position
            bias; its gradient flows), or None (DaViT).

    Returns:
        (B, Hp, Wp, C), same dtype as ``qkv``. Differentiable in ``qkv`` and
        ``bias``.
    """
    scale = scale.detach().float().contiguous()
    bias = None if bias is None else bias.float().contiguous()
    if _needs_graph(qkv, bias):
        return WindowAttentionFunction.apply(qkv, scale, bias, ws, nheads)
    # no graph to build (eval under inference_mode): nothing is saved
    return _forward(qkv, scale, bias, ws, nheads)


def fused_window_attention_global(kv: torch.Tensor, q_global: torch.Tensor,
                                  scale: torch.Tensor, bias: torch.Tensor, ws: int,
                                  nheads: int) -> torch.Tensor:
    """Fused GCViT global-query window attention on the spatial layout: every
    window of an image attends with that image's shared queries, which are
    never repeated per window in memory.

    Args:
        kv: (B, Hp, Wp, 2C) key/value projection; Hp, Wp multiples of ``ws``.
        q_global: (B, L, C) shared global queries per image (cast to kv's dtype).
        scale: (H,) per-head logit multipliers.
        bias: (H, L, L) learned relative position bias.

    Returns:
        (B, Hp, Wp, C), same dtype as ``kv``. Differentiable in ``kv``,
        ``q_global`` and ``bias``.
    """
    scale = scale.detach().float().contiguous()
    bias = bias.float().contiguous()
    qg = q_global.to(kv.dtype).contiguous()  # autograd casts its gradient back
    if _needs_graph(kv, qg, bias):
        return WindowAttentionGlobalFunction.apply(kv, qg, scale, bias, ws, nheads)
    return _forward_global(kv, qg, scale, bias, ws, nheads)


def window_attention_spatial(proj: torch.Tensor, scale: torch.Tensor,
                             bias: Optional[torch.Tensor], ws: int, nheads: int,
                             q_global: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain window attention on the (B, Hp, Wp, .) spatial layout, the one
    entry of DaViT spatial blocks and GCViT local and global blocks.

    ``proj`` is the fused qkv projection (3C channels) when ``q_global`` is
    None, else the kv projection (2C) with ``q_global`` the image's (B, L, C)
    shared queries."""
    refuse_in_export("K3a" if q_global is None else "K4")
    if q_global is not None:
        if bias is None:
            raise ValueError("global-query window attention needs its bias")
        return fused_window_attention_global(proj, q_global, scale, bias, ws, nheads)
    return fused_window_attention(proj, scale, bias, ws, nheads)
