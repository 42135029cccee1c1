"""Which SDPA backends take BEiT-B's attention (bs 128, 12 heads, L 197, d 64,
bf16) with its relative bias as a float mask, forward + backward, and in
how many ms (CUDA events, median of 10 after 3): the default dispatch (its
ATen ops from the profiler) and each backend forced. Mask layouts: the
(H, L, L) table broadcast over the batch, with and without a gradient,
materialised per image, padded to a multiple of 8 or 16 then sliced, and
the table's gather left permuted (a row stride of H: what BEiT passed
before its mask was padded).

    python tools/probe_torch_sdpa_bias.py    # on the card, about 20 s
"""
import warnings

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel


def timed(fn, iters=10, warm=3):
    for _ in range(warm):
        fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def main():
    torch.manual_seed(0)
    n, h, l, d = 128, 12, 197, 64
    q, k, v = (torch.randn(n, h, l, d, device="cuda", dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    table = torch.randn(h, l, l, device="cuda") * 0.1
    go = torch.randn(n, h, l, d, device="cuda", dtype=torch.bfloat16)

    def layouts():
        t = table.clone().requires_grad_(True)
        yield "(H,L,L) broadcast, grad", lambda: t.to(torch.bfloat16)[None].expand(n, -1, -1, -1)
        t2 = table.clone()
        yield "(H,L,L) broadcast, no grad", lambda: t2.to(torch.bfloat16)[None].expand(n, -1, -1, -1)
        t3 = table.clone().requires_grad_(True)
        yield "(N,H,L,L) per image, grad", lambda: t3.to(torch.bfloat16)[None].repeat(n, 1, 1, 1)
        t5 = table.clone().permute(1, 2, 0).contiguous().requires_grad_(True)
        yield "(H,L,L) permuted gather, grad", lambda: t5.to(torch.bfloat16).permute(2, 0, 1)[None] \
            .expand(n, -1, -1, -1)
        for pad in (200, 208):
            t4 = table.clone().requires_grad_(True)
            yield (f"(H,L,{pad}) padded then sliced, grad",
                   lambda t4=t4, pad=pad: F.pad(t4.to(torch.bfloat16), (0, pad - l))[..., :l][None]
                   .expand(n, -1, -1, -1))

    for name, make in layouts():
        for backend in (None, SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                        SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
            label = "default" if backend is None else backend.name

            def step():
                out = F.scaled_dot_product_attention(q, k, v, attn_mask=make())
                out.backward(go)

            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    if backend is None:
                        ms = timed(step)
                        with torch.profiler.profile(activities=[
                                torch.profiler.ProfilerActivity.CPU]) as prof:
                            step()
                            torch.cuda.synchronize()
                        ops = sorted({e.key for e in prof.key_averages()
                                      if "scaled_dot_product" in e.key})
                    else:
                        with sdpa_kernel(backend):
                            ms = timed(step)
                        ops = []
                print(f"{name:36s} {label:20s} ok {ms:8.3f} ms fwd+bwd {ops}", flush=True)
            except Exception as e:  # noqa: BLE001 — a backend that refuses is the reading
                why = " | ".join(str(w.message)[:160] for w in caught[-3:])
                print(f"{name:36s} {label:20s} refused: {str(e)[:120]} {why}", flush=True)
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"peak {peak:.1f} MiB", flush=True)


if __name__ == "__main__":
    main()
