"""One inference MBConv block fused into one op (port of ``_kernel``,
``pallas_block`` and ``xla_block`` of ``tools/probe_mbconv_fused.py``, the
probe of EfficientNet-B0's hottest block shapes).

``mbconv_fused(x, p)``: ``x (N, H, W, C)`` NHWC (a channels-last NCHW
activation permuted to NHWC is a view), ``p`` the block with its BatchNorms
folded into (scale, bias), under the probe's names::

    w_exp (C, mid)  s1, b1 (mid)   expand 1x1, affine, swish
    w_dw (k, k, mid) s2, b2 (mid)  depthwise k x k (zero padding), affine, swish
    w_se1 (mid, rd) b_se1 (rd)     SE: spatial mean, fc + bias, swish,
    w_se2 (rd, mid) b_se2 (mid)        fc + bias, sigmoid; the gate
    w_proj (mid, C) s3, b3 (C)     project 1x1, affine, + x

Per-channel vectors may be ``(C,)`` or the probe's ``(1, C)``. Everything is
computed in f32 from ``x`` as read and the widened parameters, with one
rounding to ``x.dtype`` at the output. The zero padding of the depthwise conv
applies to the *activated* expansion (the border is 0, not swish(b1)).

A CUDA tensor goes to the hand-written Hopper kernel
``csrc/mbconv_fused_fwd.cu`` (it launches or raises) by one of two routes that
:func:`route` picks from the shape before the launch: ``"cluster"`` (bf16
whose image fits a cluster of at most 8 blocks: one launch,
``csrc/mbconv_fused_cluster.cuh``, products on the tensor cores) or
``"three_launch"`` (f32, and bf16 images too large for a cluster). A CPU
tensor goes to :func:`mbconv_fused_plain`. Inference only, as in the JAX
package (no backward): an ``x`` that requires a gradient raises.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from torchok_tpu_torch.ops.common import DTYPE_CODE, LAUNCHES, check_tensor, refuse_in_export

KERNEL = "mbconv_fused_fwd"
PLAIN = "mbconv_fused_plain"
NAMES = ("w_exp", "s1", "b1", "w_dw", "s2", "b2", "w_se1", "b_se1", "w_se2", "b_se2",
         "w_proj", "s3", "b3")
VECTORS = ("s1", "b1", "s2", "b2", "b_se1", "b_se2", "s3", "b3")
THREADS = 256
SHARED_LIMIT = 232448  # bytes of shared memory one Hopper block may use
# x, y, partial, gate, the 13 parameters; dtype, N, H, W, C, mid, rd, k,
# rows, chunk; stream
_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
CLUSTER_SYMBOL = "mbconv_fused_cluster_fwd"
# x, y, the 13 parameters; N, H, W, C, mid, rd, k, strips, rows, chunk, kc,
# warps_m; stream
_CLUSTER_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
# blocks of a cluster, in the order tried: powers of two (they pack a GPC's SMs
# evenly: 56x56 in 8 strips of 7 kept more SMs busy than in 7 of 8 rows)
STRIPS = (1, 2, 4, 8)
CLUSTER_THREADS = 512  # threads of a block of the cluster route
CLUSTER_WARPS = CLUSTER_THREADS // 32
TILES_M, TILES_N = 4, 2  # m-tiles (16 pixels) and n-tiles (8 channels) of y a warp holds
W_EXP_QUADS = 6  # float4 of a chunk's w_exp a thread carries: C x chunk <= 6 x 4 x 512
PROJ_STAGES = 3  # tiles of w_proj rows in flight
# launches per route of the kernel (a launch of either adds one to
# LAUNCHES[KERNEL] as well)
ROUTE_LAUNCHES: collections.Counter = collections.Counter()


def block_shape(x: torch.Tensor, p: Mapping[str, torch.Tensor]) -> Tuple[int, ...]:
    """``(N, H, W, C, mid, rd, k)`` of a block, after checking what the op
    takes: NHWC ``x``, parameters of matching shapes, an odd ``k <= 7``, C
    and mid multiples of 8, and no gradient through ``x``."""
    if x.requires_grad:
        raise ValueError("mbconv_fused is inference only (the JAX package has no backward "
                         "for it): x requires grad")
    missing = [name for name in NAMES if name not in p]
    if missing:
        raise ValueError(f"mbconv_fused: missing parameters {missing}")
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    n, h, w, c = x.shape
    if p["w_exp"].dim() != 2 or p["w_exp"].shape[0] != c:
        raise ValueError(f"w_exp must be (C={c}, mid), got {tuple(p['w_exp'].shape)}")
    mid = p["w_exp"].shape[1]
    if p["w_dw"].dim() != 3 or p["w_dw"].shape[0] != p["w_dw"].shape[1]:
        raise ValueError(f"w_dw must be (k, k, mid), got {tuple(p['w_dw'].shape)}")
    k = p["w_dw"].shape[0]
    if k % 2 == 0 or k > 7:
        raise ValueError(f"mbconv_fused takes an odd depthwise kernel size up to 7, got {k}")
    if c % 8 or mid % 8 or not c or not mid:
        raise ValueError(f"mbconv_fused takes C and mid multiples of 8, got C={c}, mid={mid}")
    if p["w_se1"].dim() != 2 or p["w_se1"].shape[0] != mid:
        raise ValueError(f"w_se1 must be (mid={mid}, rd), got {tuple(p['w_se1'].shape)}")
    rd = p["w_se1"].shape[1]
    shapes = {"w_dw": (k, k, mid), "w_se2": (rd, mid), "w_proj": (mid, c),
              "s1": (mid,), "b1": (mid,), "s2": (mid,), "b2": (mid,), "b_se1": (rd,),
              "b_se2": (mid,), "s3": (c,), "b3": (c,)}
    for name, shape in shapes.items():
        got = tuple(p[name].shape)
        if got != shape and not (len(shape) == 1 and got == (1,) + shape):
            raise ValueError(f"{name} must be {shape}, got {got}")
    if n < 1 or h < 1 or w < 1 or rd < 1:
        raise ValueError(f"mbconv_fused needs a non-empty block, got x {tuple(x.shape)}, "
                         f"rd {rd}")
    return n, h, w, c, mid, rd, k


def _f32(p: Mapping[str, torch.Tensor], device: torch.device) -> Dict[str, torch.Tensor]:
    """Every parameter as f32 on ``device`` (widened, exact), vectors
    flattened, contiguous; converted only where it is not already (the host
    time of a kernel call)."""
    out = {}
    for name in NAMES:
        t = p[name].detach()
        if t.dtype != torch.float32 or t.device != device:
            t = t.to(device, torch.float32)
        if name in VECTORS and t.dim() != 1:
            t = t.reshape(-1)
        out[name] = t if t.is_contiguous() else t.contiguous()
    return out


def _swish(a: torch.Tensor) -> torch.Tensor:
    return a * torch.sigmoid(a)


def mbconv_fused_plain(x: torch.Tensor, p: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 throughout in the order of
    the Pallas ``_kernel``, one rounding to ``x.dtype`` at the output."""
    n, h, w, c, mid, rd, k = block_shape(x, p)
    q = _f32(p, x.device)
    pad = (k - 1) // 2
    with torch.autocast(x.device.type, enabled=False):
        xf = x.float()
        a = torch.matmul(xf.reshape(n * h * w, c), q["w_exp"])
        a = _swish(a * q["s1"] + q["b1"]).reshape(n, h, w, mid)
        apad = F.pad(a, (0, 0, pad, pad, pad, pad))  # zeros around the activation
        acc = torch.zeros_like(a)
        for dy in range(k):
            for dx in range(k):
                acc = acc + apad[:, dy:dy + h, dx:dx + w, :] * q["w_dw"][dy, dx]
        a = _swish(acc * q["s2"] + q["b2"])
        se = a.reshape(n, h * w, mid).mean(dim=1)  # (N, mid)
        r = _swish(torch.matmul(se, q["w_se1"]) + q["b_se1"])
        gate = torch.sigmoid(torch.matmul(r, q["w_se2"]) + q["b_se2"])
        a = a * gate[:, None, None, :]
        y = torch.matmul(a.reshape(n * h * w, mid), q["w_proj"]) * q["s3"] + q["b3"]
        return (y.reshape(n, h, w, c) + xf).to(x.dtype)


def shared_bytes(w: int, c: int, k: int, rows: int, chunk: int, itemsize: int) -> int:
    """Dynamic shared memory of the kernel's project pass (the larger of its
    two passes) for a strip of ``rows`` image rows and ``chunk`` expanded
    channels at a time: the sizes ``csrc/mbconv_fused_fwd.cu::SharedLayout``
    carves, each rounded up to 16 bytes."""
    pad = (k - 1) // 2

    def up4(v: int) -> int:
        return -(-v // 4) * 4

    halo = rows + 2 * pad
    lda = -(-halo * w // 8) * 8
    floats = (up4(c * lda * itemsize // 4)                # the strip's x with its halo rows
              + up4(halo * (w + 2 * pad) * (chunk + 1))  # the chunk's expansion, zero border
              + up4(c * chunk) + up4(chunk * (4 + k * k))  # expand weights, vectors, taps
              + THREADS                                  # SE partial sums
              + up4(up4(rows * w) * (chunk + 1))         # the chunk's gated activation
              + up4(chunk * c) + up4(chunk)              # projection rows, gate
              + up4(rows * w * c))                       # the strip's projection
    return 4 * floats


def plan(h: int, w: int, c: int, mid: int, k: int, itemsize: int) -> Tuple[int, int, int]:
    """``(rows, chunk, bytes)``: the widest chunk of expanded channels (32, 16
    or 8, dividing mid), then the tallest strip of rows (the strips of an
    image as even as they go) whose shared memory fits one block. Each chunk
    repeats the block's expand, depthwise and projection phases behind
    barriers, so fewer chunks pay more than a second block on the SM."""
    for chunk in (32, 16, 8):
        if mid % chunk:
            continue
        seen = set()
        for tall in range(h, 0, -1):
            rows = -(-h // -(-h // tall))
            if rows in seen:
                continue
            seen.add(rows)
            nbytes = shared_bytes(w, c, k, rows, chunk, itemsize)
            if nbytes <= SHARED_LIMIT:
                return rows, chunk, nbytes
    raise ValueError(f"{KERNEL}: no strip of W={w}, C={c}, k={k} fits a block's shared memory")


class ClusterPlan(NamedTuple):
    """How the cluster route cuts a block: ``strips`` blocks (a cluster) of
    ``rows`` image rows hold an image, ``chunk`` expanded channels at a time,
    ``kc`` rows of w_proj a stage, ``warps_m`` x (16 / warps_m) warps over y's
    tiles; ``bytes`` of shared memory a block."""
    strips: int
    rows: int
    chunk: int
    kc: int
    warps_m: int
    bytes: int


def _up16(v: int) -> int:
    return -(-v // 16) * 16


def cluster_shared_bytes(h: int, w: int, c: int, mid: int, k: int, rows: int, chunk: int,
                         kc: int) -> int:
    """Dynamic shared memory of a block of the cluster route: the sizes
    ``csrc/mbconv_fused_cluster.cuh::Layout`` carves, each rounded up to 16
    bytes."""
    pad = (k - 1) // 2
    halo = min(h, rows + 2 * pad)        # image rows of x a block holds at most
    cp = _up16(c)                        # the expand's depth
    xs = _up16(halo * w * (cp + 8) * 2)            # x rows, bf16
    act = _up16(rows * w * (mid + 8) * 2)          # the strip's activation, bf16
    e = _up16((rows + 2 * pad) * (w + 2 * pad) * (chunk + 1) * 4)  # a chunk's expansion
    # + the chunk's w_exp rows and two stages of its s1, b1, s2, b2 and taps
    expand = e + _up16(chunk * (cp + 8) * 2) + 2 * _up16(chunk * (4 + k * k) * 4)
    project = PROJ_STAGES * _up16(kc * (c + 4) * 4)  # the w_proj ring (the same space)
    total = xs + act + max(expand, project) + 2 * _up16(mid * 4) + CLUSTER_THREADS * 4
    # the last m-tile of xs or act reads up to 15 rows past its end, inside the block's
    # buffers
    return max(total, _up16(halo * w) * (cp + 8) * 2, xs + _up16(rows * w) * (mid + 8) * 2)


def _warps_m(rows: int, w: int, c: int) -> Optional[int]:
    """The split of the 16 warps over y's (rows * w / 16) x (c / 8) tiles that
    holds the fewest tiles a warp, at most TILES_M x TILES_N."""
    mt, nt = -(-rows * w // 16), c // 8
    best = None
    for wm in (1, 2, 4, 8, 16):
        a, b = -(-mt // wm), -(-nt // (CLUSTER_WARPS // wm))
        if a <= TILES_M and b <= TILES_N and (best is None or a * b < best[0]):
            best = (a * b, wm)
    return None if best is None else best[1]


@functools.lru_cache(maxsize=None)
def plan_cluster(h: int, w: int, c: int, mid: int, rd: int, k: int) -> Optional[ClusterPlan]:
    """The cluster route's cut of a block, or None where it takes none: the
    first count of strips in ``STRIPS`` whose block fits ``SHARED_LIMIT``,
    with the widest chunk (64, 32, 16) and then the deepest w_proj stage (64
    rows down to 16) that fit. It needs mid a multiple of 16, rd <= mid and
    <= 512, and y's tiles of a strip within 16 warps' registers."""
    if mid % 16 or c % 8 or rd > min(mid, CLUSTER_THREADS):
        return None
    for strips in STRIPS:
        rows = -(-h // strips)
        if -(-h // rows) != strips:
            continue  # no block of an image without rows
        wm = _warps_m(rows, w, c)
        if wm is None:
            continue
        for chunk in (64, 32, 16):
            if mid % chunk or c * chunk > W_EXP_QUADS * 4 * CLUSTER_THREADS:
                continue
            for kc in (64, 48, 32, 16):
                nbytes = cluster_shared_bytes(h, w, c, mid, k, rows, chunk, kc)
                if nbytes <= SHARED_LIMIT:
                    return ClusterPlan(strips, rows, chunk, kc, wm, nbytes)
    return None


def route(h: int, w: int, c: int, mid: int, rd: int, k: int, dtype: torch.dtype) -> str:
    """Which kernel a CUDA tensor of this block shape and dtype takes:
    ``"cluster"`` for bf16 that :func:`plan_cluster` fits, else
    ``"three_launch"``. Decided from the shape before the launch; no launch
    or build failure is ever routed elsewhere."""
    if dtype == torch.bfloat16 and plan_cluster(h, w, c, mid, rd, k) is not None:
        return "cluster"
    return "three_launch"


def _cluster_cuda(x: torch.Tensor, q: Dict[str, torch.Tensor], shape: Tuple[int, ...],
                  cut: ClusterPlan) -> torch.Tensor:
    """One launch of the cluster route (it rounds w_exp to bf16 itself)."""
    from torchok_tpu_torch.utils.cuda_build import load_function
    n, h, w, c, mid, rd, k = shape
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = load_function(KERNEL, _CLUSTER_ARGTYPES, CLUSTER_SYMBOL)(
        x.data_ptr(), y.data_ptr(), *[q[name].data_ptr() for name in NAMES], n, h, w, c, mid,
        rd, k, cut.strips, cut.rows, cut.chunk, cut.kc, cut.warps_m, stream)
    if err != 0:
        raise RuntimeError(f"{CLUSTER_SYMBOL} launch failed: CUDA error {err}")
    return y


def mbconv_fused_cuda(x: torch.Tensor, p: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Launch the Hopper kernel by the route :func:`route` picks (one
    cluster launch, or the statistics, gate and projection passes). Raises on
    what it does not take: f32 or bf16 ``x``, contiguous, on a CUDA device,
    and what :func:`block_shape` refuses."""
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"{KERNEL} takes float32 or bfloat16 x, got {x.dtype}")
    n, h, w, c, mid, rd, k = block_shape(x, p)
    check_tensor(x, "x", (n, h, w, c), x.dtype, x.device)
    q = _f32(p, x.device)
    if route(h, w, c, mid, rd, k, x.dtype) == "cluster":
        y = _cluster_cuda(x, q, (n, h, w, c, mid, rd, k), plan_cluster(h, w, c, mid, rd, k))
        LAUNCHES[KERNEL] += 1
        ROUTE_LAUNCHES["cluster"] += 1
        return y
    rows, chunk, _ = plan(h, w, c, mid, k, x.element_size())
    strips = -(-h // rows)
    from torchok_tpu_torch.utils.cuda_build import load_function
    y = torch.empty_like(x)
    partial = torch.empty((n, strips, mid), dtype=torch.float32, device=x.device)
    gate = torch.empty((n, mid), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = load_function(KERNEL, _ARGTYPES)(
        x.data_ptr(), y.data_ptr(), partial.data_ptr(), gate.data_ptr(),
        *[q[name].data_ptr() for name in NAMES], DTYPE_CODE[x.dtype], n, h, w, c, mid, rd, k,
        rows, chunk, stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err}")
    LAUNCHES[KERNEL] += 1
    ROUTE_LAUNCHES["three_launch"] += 1
    return y


def mbconv_fused(x: torch.Tensor, p: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """One inference MBConv block on NHWC ``x`` (see the module's docstring)."""
    refuse_in_export("K9")
    if x.device.type == "cuda":
        return mbconv_fused_cuda(x, p)
    if x.device.type != "cpu":
        raise ValueError(f"mbconv_fused runs on CUDA or the CPU, not {x.device}")
    y = mbconv_fused_plain(x, p)
    LAUNCHES[PLAIN] += 1
    return y
