"""3x3 convolution as an implicit GEMM (port of ``pallas_conv`` of
``tools/probe_r50_conv_gemm.py``, the probe of ResNet-50's bottleneck 3x3
convs).

``conv3x3_gemm(x, w)``: ``x (N, H, W, Cin)`` NHWC, ``w (3, 3, Cin, Cout)``
HWIO (the probe's layouts), stride 1, zero padding 1, contraction over
``9 * Cin`` with f32 accumulation and one rounding to ``x.dtype``. A CUDA
tensor goes to the hand-written Hopper kernel ``csrc/conv3x3_gemm.cu`` (it
launches or raises); a CPU tensor goes to :func:`conv3x3_gemm_plain`, which
builds the im2col matrix the kernel never builds. Forward only, as the probe.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from torchok_tpu_torch.ops.common import DTYPE_CODE, LAUNCHES, check_tensor

KERNEL = "conv3x3_gemm"
PLAIN = "conv3x3_gemm_plain"
# x, w, y; dtype, N, H, W, Cin, Cout; stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def conv3x3_gemm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: zero-pad, gather the nine taps into the
    ``(N*H*W, 9*Cin)`` matrix, one product with f32 accumulation, one
    rounding to ``x.dtype``."""
    n, h, ww, cin = x.shape
    cout = w.shape[-1]
    with torch.autocast(x.device.type, enabled=False):
        xp = F.pad(x, (0, 0, 1, 1, 1, 1))  # zeros around H and W
        taps = [xp[:, dy:dy + h, dx:dx + ww, :] for dy in range(3) for dx in range(3)]
        col = torch.cat(taps, dim=-1).reshape(n * h * ww, 9 * cin)
        y = torch.matmul(col.float(), w.reshape(9 * cin, cout).float())
        return y.to(x.dtype).reshape(n, h, ww, cout)


def conv3x3_gemm_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel. Raises on what it does not take: f32 or bf16
    ``x`` and ``w`` of one type, Cin and Cout multiples of 8, both contiguous
    on one CUDA device."""
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"{KERNEL} takes float32 or bfloat16 x, got {x.dtype}")
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(f"x must be (N, H, W, Cin) and w (3, 3, Cin, Cout), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, h, ww, cin = x.shape
    cout = w.shape[3]
    if cin % 8 or cout % 8 or not cin or not cout or n * h * ww < 1:
        raise ValueError(f"{KERNEL} takes Cin and Cout multiples of 8; got Cin={cin}, "
                         f"Cout={cout}")
    check_tensor(x, "x", (n, h, ww, cin), x.dtype, x.device)
    check_tensor(w, "w", (3, 3, cin, cout), x.dtype, x.device)
    from torchok_tpu_torch.utils.cuda_build import load_function
    y = torch.empty((n, h, ww, cout), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = load_function(KERNEL, _ARGTYPES)(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), DTYPE_CODE[x.dtype], n, h, ww, cin, cout,
        stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err}")
    LAUNCHES[KERNEL] += 1
    return y


def conv3x3_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 / stride 1 / zero padding 1 conv on NHWC ``x`` with HWIO ``w``."""
    if x.device.type == "cuda":
        return conv3x3_gemm_cuda(x, w)
    if x.device.type != "cpu":
        raise ValueError(f"conv3x3_gemm runs on CUDA or the CPU, not {x.device}")
    LAUNCHES[PLAIN] += 1
    return conv3x3_gemm_plain(x, w)
