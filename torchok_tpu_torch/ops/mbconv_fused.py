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
``csrc/mbconv_fused_fwd.cu`` (it launches or raises); a CPU tensor goes to
:func:`mbconv_fused_plain`. Inference only, as in the JAX package (no
backward): an ``x`` that requires a gradient raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from torchok_tpu_torch.ops.common import DTYPE_CODE, LAUNCHES, check_tensor

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
    """Every parameter widened to f32 (exact), vectors flattened, contiguous."""
    out = {name: p[name].detach().to(device, torch.float32) for name in NAMES}
    return {name: (t.reshape(-1) if name in VECTORS else t).contiguous()
            for name, t in out.items()}


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


def mbconv_fused_cuda(x: torch.Tensor, p: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Launch the Hopper kernel (statistics, gate and projection passes).
    Raises on what it does not take: f32 or bf16 ``x``, contiguous, on a CUDA
    device, and what :func:`block_shape` refuses."""
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"{KERNEL} takes float32 or bfloat16 x, got {x.dtype}")
    n, h, w, c, mid, rd, k = block_shape(x, p)
    check_tensor(x, "x", (n, h, w, c), x.dtype, x.device)
    rows, chunk, _ = plan(h, w, c, mid, k, x.element_size())
    strips = -(-h // rows)
    q = _f32(p, x.device)
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
    return y


def mbconv_fused(x: torch.Tensor, p: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """One inference MBConv block on NHWC ``x`` (see the module's docstring)."""
    if x.device.type == "cuda":
        return mbconv_fused_cuda(x, p)
    if x.device.type != "cpu":
        raise ValueError(f"mbconv_fused runs on CUDA or the CPU, not {x.device}")
    y = mbconv_fused_plain(x, p)
    LAUNCHES[PLAIN] += 1
    return y
