"""``tools/profile_torch_slice.py`` files each kernel of a trace under its
kind: the window attention templates by their template flags (``<T, KC,
kHasBias, kGlobal, kCosine, kHasMask>``), demangled or mangled, and K2's
tensor-core passes under K2."""
import importlib.util
import os

import pytest

_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                     "profile_torch_slice.py")


def _tool():
    spec = importlib.util.spec_from_file_location("profile_torch_slice", _PATH)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name,kind", [
    # SwinV2's cosine forward, unmasked and masked (K1)
    ("void wattn::window_attention_fwd_kernel<__nv_bfloat16, 16, true, false, true, false>(x)",
     "K1 swin_attention_fwd"),
    ("void wattn::window_attention_fwd_kernel<__nv_bfloat16, 16, true, false, true, true>(x)",
     "K1 swin_attention_fwd"),
    ("void wattn::window_attention_fwd_tiled_kernel<__nv_bfloat16, true>(x)",
     "K1 swin_attention_fwd"),
    # GCViT's global and local blocks, DaViT's spatial blocks
    ("void wattn::window_attention_fwd_kernel<__nv_bfloat16, 4, true, true, false, false>(x)",
     "K4 window_attention_global_fwd"),
    ("void wattn::window_attention_fwd_kernel<__nv_bfloat16, 4, false, false, false, false>(x)",
     "K3a window_attention_fwd"),
    ("_ZN5wattn27window_attention_bwd_kernelI13__nv_bfloat16Li4ELb1ELb1ELb0ELb0EEEvPKT_",
     "K5 window_attention_global_bwd"),
    ("_ZN5wattn27window_attention_bwd_kernelI13__nv_bfloat16Li4ELb1ELb0ELb0ELb0EEEvPKT_",
     "K3b window_attention_bwd"),
    ("_ZN5wattn27window_attention_bwd_kernelIfLi16ELb1ELb0ELb1ELb1EEEvPKT_",
     "K2 swin_attention_bwd"),
    # K2's tensor-core passes, their set-up and the entry's reduce
    ("void swin_mma::swin_bwd_dkdv_kernel<false>(__nv_bfloat16 const*)", "K2 swin_attention_bwd"),
    ("void swin_mma::swin_bwd_dq_kernel<true>(__nv_bfloat16 const*)", "K2 swin_attention_bwd"),
    ("swin_mma::normalize_k(__nv_bfloat16 const*)", "K2 swin_attention_bwd"),
    ("swin_mma::combine_bias_mask(float const*)", "K2 swin_attention_bwd"),
    ("(anonymous namespace)::swin_attention_bwd_reduce(float const*)", "K2 swin_attention_bwd"),
    ("void wattn::window_attention_bwd_reduce(float const*)", "K3b/K5 dbias reduce"),
    ("void at::native::vectorized_layer_norm_kernel<float, float, false>(x)", "LayerNorm"),
])
def test_profile_files_each_kernel_under_its_kind(name, kind):
    assert _tool().kind_of(name) == kind
