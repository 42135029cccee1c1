"""``tools/profile_torch_slice.py`` files each kernel of a trace under its
kind: the window attention templates by their template flags (``<T, KC,
kHasBias, kGlobal, kCosine, kHasMask>``), demangled or mangled, the
tensor-core forward under K1, K3a or K4 and the passes of the tensor-core
backward under K2, K3b or K5 by their mode flags."""
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
    # K1's bf16 tensor-core kernel and its set-up
    ("void swin_fwd::swin_fwd_kernel<4, 2>(__nv_bfloat16 const*, __nv_bfloat16 const*, "
     "float const*, float const*, __nv_bfloat16*, wattn::Geometry, int)", "K1 swin_attention_fwd"),
    ("_ZN8swin_fwd15swin_fwd_kernelILi3ELi1EEEvPK13__nv_bfloat16S3_PKfS5_PS1_N5wattn8GeometryEi",
     "K1 swin_attention_fwd"),
    ("swin_fwd::normalize_k(__nv_bfloat16 const*, __nv_bfloat16*, unsigned long, int)",
     "K1 swin_attention_fwd"),
    ("swin_fwd::combine_bias_mask(float const*, float const*, float*, int, int, int)",
     "K1 swin_attention_fwd"),
    # the tensor-core forward's modes <tile rows / 16, images, kCosine,
    # kHasBias, kGlobal>: K1 (cosine), K3a (with and without a bias), K4
    # (global queries above L = 64) and K4's window walk, demangled and mangled
    ("void swin_fwd::swin_fwd_kernel<4, 2, true, true, false>(__nv_bfloat16 const*)",
     "K1 swin_attention_fwd"),
    ("_ZN8swin_fwd15swin_fwd_kernelILi3ELi1ELb1ELb1ELb0EEEvPK13__nv_bfloat16S3_PKfS5_PS1_"
     "N5wattn8GeometryEiS3_i", "K1 swin_attention_fwd"),
    ("void swin_fwd::swin_fwd_kernel<4, 2, false, true, false>(__nv_bfloat16 const*)",
     "K3a window_attention_fwd"),
    ("_ZN8swin_fwd15swin_fwd_kernelILi4ELi2ELb0ELb0ELb0EEEvPK13__nv_bfloat16S3_PKfS5_PS1_"
     "N5wattn8GeometryEiS3_i", "K3a window_attention_fwd"),
    ("void swin_fwd::swin_fwd_kernel<4, 2, false, true, true>(__nv_bfloat16 const*)",
     "K4 window_attention_global_fwd"),
    ("_ZN8swin_fwd15swin_fwd_kernelILi4ELi2ELb0ELb1ELb1EEEvPK13__nv_bfloat16S3_PKfS5_PS1_"
     "N5wattn8GeometryEiS3_i", "K4 window_attention_global_fwd"),
    ("void swin_fwd::global_fwd_kernel<4>(__nv_bfloat16 const*, __nv_bfloat16 const*)",
     "K4 window_attention_global_fwd"),
    ("_ZN8swin_fwd17global_fwd_kernelILi3EEEvPK13__nv_bfloat16S3_PKfS5_iPS1_N5wattn8GeometryEi",
     "K4 window_attention_global_fwd"),
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
    # the tensor-core backward's passes <kCosine, kShifted, kHasBias,
    # kGlobal>: K2 (cosine, unshifted and shifted), K3b (with and without a
    # bias), K5 (global queries), demangled and mangled; K2's set-up and its
    # entry's reduce
    ("void swin_mma::bwd_dkdv_kernel<true, false, true, false>(__nv_bfloat16 const*)",
     "K2 swin_attention_bwd"),
    ("void swin_mma::bwd_dq_kernel<true, true, true, false>(__nv_bfloat16 const*)",
     "K2 swin_attention_bwd"),
    ("_ZN8swin_mma13bwd_dq_kernelILb1ELb1ELb1ELb0EEEvPK13__nv_bfloat16S3_PKfS5_iS3_PS1_PfS7_"
     "N5wattn8GeometryE", "K2 swin_attention_bwd"),
    ("void swin_mma::bwd_dq_kernel<false, false, true, false>(__nv_bfloat16 const*)",
     "K3b window_attention_bwd"),
    ("void swin_mma::bwd_dkdv_kernel<false, false, false, false>(__nv_bfloat16 const*)",
     "K3b window_attention_bwd"),
    ("_ZN8swin_mma15bwd_dkdv_kernelILb0ELb0ELb1ELb0EEEvPK13__nv_bfloat16S3_PKfS5_S5_iS3_PS1_"
     "S5_PfS7_N5wattn8GeometryEi", "K3b window_attention_bwd"),
    ("void swin_mma::bwd_dq_kernel<false, false, true, true>(__nv_bfloat16 const*)",
     "K5 window_attention_global_bwd"),
    ("_ZN8swin_mma15bwd_dkdv_kernelILb0ELb0ELb1ELb1EEEvPK13__nv_bfloat16S3_PKfS5_S5_iS3_PS1_"
     "S5_PfS7_N5wattn8GeometryEi", "K5 window_attention_global_bwd"),
    ("swin_mma::pad_bias(float const*, float*, int, int, int)", "K3/K4/K5 bias pad"),
    ("swin_mma::normalize_k(__nv_bfloat16 const*)", "K2 swin_attention_bwd"),
    ("swin_mma::combine_bias_mask(float const*)", "K2 swin_attention_bwd"),
    ("(anonymous namespace)::swin_attention_bwd_reduce(float const*)", "K2 swin_attention_bwd"),
    ("void wattn::window_attention_bwd_reduce(float const*)", "K3b/K5 dbias reduce"),
    # K6: its FMA template (f32, bf16 at head dim 8) and its bf16 tensor-core
    # kernel mw_fwd_kernel<L, kHasMask>, demangled and mangled
    ("void (anonymous namespace)::window_attention_mw_fwd_kernel<float, 64, 32, true>(x)",
     "K6 window_attention_mw_fwd"),
    ("void mw_mma::mw_fwd_kernel<64, true>(__nv_bfloat16 const*, __nv_bfloat16 const*)",
     "K6 window_attention_mw_fwd"),
    ("_ZN6mw_mma13mw_fwd_kernelILi16ELb0EEEvPK13__nv_bfloat16S3_S3_PKfS5_S5_PS1_iiii",
     "K6 window_attention_mw_fwd"),
    ("void at::native::vectorized_layer_norm_kernel<float, float, false>(x)", "LayerNorm"),
])
def test_profile_files_each_kernel_under_its_kind(name, kind):
    assert _tool().kind_of(name) == kind
