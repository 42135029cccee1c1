"""Fused 1x1-conv + BatchNorm pipeline op (port of ``torchok_tpu.ops.conv_bn``).

A bottleneck's 1x1 convs are plain matrix products over ``M = B*H*W`` rows,
so both sides of the BatchNorm between two of them fold into the product:

* **input prologue**: the *previous* BatchNorm's normalize (+ReLU) applied in
  registers to the raw conv output as it is read: the normalised tensor is
  never written;
* **statistics epilogue**: sum and sum of squares of the (rounded) output,
  gathered while the tile is still on the chip: the separate reduction pass
  over the output disappears. Flax's BatchNorm computes ``var = E[x^2] -
  E[x]^2`` in f32 from the activation, which is exactly ``s2/M - (s1/M)^2``.

:func:`matmul_bn` sends a CUDA tensor to the hand-written Hopper kernel
``csrc/matmul_bn_fwd.cu`` (it launches or raises) and a CPU tensor to
:func:`matmul_bn_plain`, the plain PyTorch version with the same rounding
points. The kernel routes by dtype (:func:`forward_route`, launches counted
per route in :data:`ROUTE_LAUNCHES`): bf16 takes ``csrc/matmul_bn_wgmma.cuh``
(wgmma with the prologue on A in registers, TMA stages, one persistent block
an SM, tiles and grid from :func:`forward_plan`), f32 the FMA tile loop of
``csrc/gemm_tile.cuh``. The backward is plain tensor code and
``torch.matmul`` (the JAX package leaves it to XLA), wired by
:class:`MatmulBnFunction`.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from torchok_tpu_torch.ops.common import DTYPE_CODE, LAUNCHES, check_tensor

KERNEL = "matmul_bn_fwd"
PLAIN = "matmul_bn_plain"
# the kernel's routes, as the entry's dtype code picks them, and the launches
# per route (the wrapper adds one per launch)
ROUTES = ("fma", "wgmma")
ROUTE_LAUNCHES: collections.Counter = collections.Counter()
TILE_M = 128               # rows of a tile on both routes
FMA_TILE_N = 64            # columns of a tile of csrc/gemm_tile.cuh
WGMMA_TILE_N = (64, 128, 256)  # the tile widths of csrc/matmul_bn_wgmma.cuh
# x, w, scale, bias, y, s1, s2, partial; dtype, M, K, N, relu_in, with_affine,
# tile_n, groups; stream
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _activate(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              relu_in: bool, with_affine: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pre-activation, activation) in f32."""
    pre = x.float()
    if with_affine:
        pre = pre * scale.float() + bias.float()
    return pre, (torch.relu(pre) if relu_in else pre)


def matmul_bn_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    relu_in: bool = False, with_affine: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the affine and ReLU in f32,
    rounded to ``x.dtype`` before the product; the product accumulated in f32
    and rounded to ``x.dtype``; ``s1``/``s2`` over the rounded ``y`` in f32."""
    with torch.autocast(x.device.type, enabled=False):
        _, a = _activate(x, scale, bias, relu_in, with_affine)
        y = torch.matmul(a.to(x.dtype).float(), w.float()).to(x.dtype)
        yf = y.float()
        return y, yf.sum(0), (yf * yf).sum(0)


def _check_shape(m: int, k: int, n: int) -> None:
    if m < 1 or k < 8 or n < 8 or k % 8 or n % 8:
        raise ValueError(f"{KERNEL} takes M >= 1 and K, N multiples of 8; got M={m}, K={k}, N={n}")


def forward_route(dtype: torch.dtype, m: int, k: int, n: int) -> str:
    """The route (one of :data:`ROUTES`) a launch takes: ``wgmma`` for bf16,
    ``fma`` for f32. Raises on what the kernel does not take."""
    if dtype not in DTYPE_CODE:
        raise TypeError(f"{KERNEL} takes float32 or bfloat16 x, got {dtype}")
    _check_shape(m, k, n)
    return ROUTES[int(dtype == torch.bfloat16)]


class ForwardPlan(NamedTuple):
    """Tiles and grid of one launch: ``tiles_n * groups`` blocks."""
    tile_n: int    # columns of a tile (its rows: TILE_M)
    tiles_n: int   # column tiles
    groups: int    # blocks that share the row tiles of one column tile


@functools.lru_cache(maxsize=None)
def forward_plan(m: int, k: int, n: int, sms: int, route: str = "wgmma") -> ForwardPlan:
    """The grid of a launch on a card of ``sms`` SMs. Group ``j`` of a column
    tile takes its row tiles ``j, j + groups, ...``.

    ``fma``: 128 x 64 tiles, at most two blocks an SM in all (rounded down:
    one block more than fits would run alone in a second wave).
    ``wgmma``: one persistent block an SM, each with one column tile. Up to N
    = 256 a tile spans all of N (the next of 64, 128, 256), so x is read and
    transformed once; above, column tiles of 256 or of 128, whichever leaves
    the busiest block the fewest columns to compute (ties: 256)."""
    _check_shape(m, k, n)
    m_tiles = -(-m // TILE_M)
    if route == "fma":
        tiles_n = -(-n // FMA_TILE_N)
        return ForwardPlan(FMA_TILE_N, tiles_n, max(1, min(m_tiles, 2 * sms // tiles_n)))
    if route != "wgmma":
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")

    def plan(tile_n: int) -> ForwardPlan:
        tiles_n = -(-n // tile_n)
        return ForwardPlan(tile_n, tiles_n, max(1, min(m_tiles, sms // tiles_n)))

    widths = [min(w for w in WGMMA_TILE_N if w >= n)] if n <= WGMMA_TILE_N[-1] else [256, 128]
    return min((plan(w) for w in widths),
               key=lambda p: (-(-m_tiles // p.groups) * p.tile_n, -p.tile_n))


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _function():
    from torchok_tpu_torch.utils.cuda_build import load_function
    return load_function(KERNEL, _ARGTYPES)


def matmul_bn_cuda(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   relu_in: bool = False, with_affine: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel and its reduction (same arguments and results
    as :func:`matmul_bn_plain`). Raises on what it does not take: f32 or bf16
    ``x`` and ``w`` of one type, K and N multiples of 8, f32 ``scale``/``bias``
    of length K, everything contiguous and on one CUDA device (and, in bf16,
    16-byte aligned: TMA reads it)."""
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"x must be (M, K) and w (K, N), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    route = forward_route(x.dtype, m, k, n)
    check_tensor(x, "x", (m, k), x.dtype, x.device)
    check_tensor(w, "w", (k, n), x.dtype, x.device)
    check_tensor(scale, "scale", (k,), torch.float32, x.device)
    check_tensor(bias, "bias", (k,), torch.float32, x.device)
    if route == "wgmma" and any(t.data_ptr() % 16 for t in (x, w, scale, bias)):
        raise ValueError(f"{KERNEL} in bf16 takes 16-byte aligned tensors")
    plan = forward_plan(m, k, n, _sm_count(x.device), route)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    s1 = torch.empty((n,), **f32)
    s2 = torch.empty((n,), **f32)
    partial = torch.empty((2, plan.groups, n), **f32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _function()(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        s1.data_ptr(), s2.data_ptr(), partial.data_ptr(), DTYPE_CODE[x.dtype], m, k, n,
        int(bool(relu_in)), int(bool(with_affine)), plan.tile_n, plan.groups, stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err}")
    LAUNCHES[KERNEL] += 1
    ROUTE_LAUNCHES[route] += 1
    return y, s1, s2


def _forward(x, w, scale, bias, relu_in: bool, with_affine: bool):
    if x.device.type == "cuda":
        return matmul_bn_cuda(x, w, scale, bias, relu_in, with_affine)
    if x.device.type != "cpu":
        raise ValueError(f"matmul_bn runs on CUDA or the CPU, not {x.device}")
    LAUNCHES[PLAIN] += 1
    return matmul_bn_plain(x, w, scale, bias, relu_in, with_affine)


def _product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for operands of one type with an f32 result (the reference's
    ``preferred_element_type``). On the card bf16 operands keep their type and
    the library accumulates and returns f32; elsewhere they are widened, which
    is exact."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


class MatmulBnFunction(torch.autograd.Function):
    """``(x, w, scale, bias, relu_in, with_affine) -> (y, s1, s2)`` with the
    backward of ``torchok_tpu.ops.conv_bn._matmul_bn_bwd``: the statistics'
    gradients broadcast over the rows, the rounding is straight-through, and
    the two products run in the forward's operand type with f32 accumulation."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, relu_in: bool, with_affine: bool):
        y, s1, s2 = _forward(x, w, scale, bias, relu_in, with_affine)
        ctx.save_for_backward(x, w, scale, bias, y)
        ctx.relu_in, ctx.with_affine = relu_in, with_affine
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        x, w, scale, bias, y = ctx.saved_tensors
        lp = x.dtype
        with torch.autocast(x.device.type, enabled=False):
            pre, a = _activate(x, scale, bias, ctx.relu_in, ctx.with_affine)
            dy_tot = (dy.float() + ds1.float()[None, :]
                      + 2.0 * y.float() * ds2.float()[None, :]).to(lp)
            # lp operands, f32 accumulation. da is used in f32 below, so its
            # product must not round it; dw is rounded to w's type anyway
            da = _product_f32(dy_tot, w.t())
            dw = torch.matmul(a.to(lp).t(), dy_tot).to(w.dtype)
            if ctx.relu_in:
                da = da * (pre > 0)
            if ctx.with_affine:
                dx = (da * scale.float()).to(lp)
                dscale = (da * x.float()).sum(0)
                dbias = da.sum(0)
            else:
                dx = da.to(lp)
                dscale = torch.zeros_like(scale)
                dbias = torch.zeros_like(bias)
        return dx, dw, dscale, dbias, None, None


def matmul_bn(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              relu_in: bool = False, with_affine: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``y = act(x*scale + bias) @ w`` with fused output statistics.

    ``x (M, K)`` bf16/f32, ``w (K, N)``; ``scale``/``bias (K,)`` f32 (ignored
    unless ``with_affine``); act = ReLU when ``relu_in``. Returns ``(y (M, N)
    x.dtype, s1 (N,) f32, s2 (N,) f32)`` where s1/s2 are the sum / sum of
    squares of the rounded y over M: feed them to :func:`bn_from_stats`.
    Differentiable in x, w, scale and bias."""
    scale = scale.float().contiguous()
    bias = bias.float().contiguous()
    return MatmulBnFunction.apply(x.contiguous(), w.contiguous(), scale, bias,
                                  bool(relu_in), bool(with_affine))


def bn_from_stats(s1: torch.Tensor, s2: torch.Tensor, m: int, gamma: torch.Tensor,
                  beta: torch.Tensor, eps: float = 1e-5
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold fused statistics into the BatchNorm affine.

    Returns (scale, bias, mean, var) with Flax semantics (``var = E[y^2] -
    E[y]^2`` in f32, the biased variance): ``y_hat = y * scale + bias`` equals
    ``gamma * (y - mean) / sqrt(var + eps) + beta``."""
    mean = s1 / m
    var = s2 / m - mean * mean
    inv = gamma * torch.rsqrt(var + eps)
    return inv, beta - mean * inv, mean, var
