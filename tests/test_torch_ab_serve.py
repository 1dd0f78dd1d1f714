"""``scripts/ab_serve.py``'s profile classes: the port's kernels are the
``__global__`` functions of its CUDA sources, matched by name as
torch.profiler names them, and no PyTorch kernel is counted among them."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import ab_serve  # noqa: E402

PORT = ab_serve.port_kernels(str(ROOT))


def test_port_kernels_name_every_global_function():
    sources = list((ROOT / "src/repro_torch/kernels").glob("*/csrc/*.cu"))
    assert len(sources) == 8  # the five forward kernels' and the three backward sources
    n_global = sum(p.read_text().count("__global__") for p in sources)
    assert len(PORT) == n_global
    assert {"wkv_mma_kernel", "wkv_kernel", "paged_mma_kernel", "flash_attention_mma_kernel",
            "mm_pu_splitk_reduce", "rmsnorm_vec_kernel", "dkdv_kernel", "dq_kernel",
            "bwd_vec_kernel", "dscale_sum_kernel", "wkv_bwd_kernel", "du_sum_kernel"} <= PORT


def test_port_kernels_of_some_sources():
    """Given sources, only their ``__global__`` functions: the RMSNorm
    backward's, which ``chip_smoke.py`` phase 31 sums in its profile."""
    bwd = ROOT / "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm_bwd.cu"
    names = ab_serve.port_kernels(str(ROOT), [bwd])
    assert names == {"bwd_vec_kernel", "bwd_scalar_kernel", "dscale_sum_kernel"} and names <= PORT
    assert ab_serve.is_port(
        "void (anonymous namespace)::bwd_vec_kernel<__nv_bfloat16, 32, 8, 1>(__nv_bfloat16", names)
    assert not ab_serve.is_port(
        "void (anonymous namespace)::rmsnorm_vec_kernel<__nv_bfloat16, 16, 1, 4>(__nv_bfl", names)


@pytest.mark.parametrize("name, cls", [
    ("void (anonymous namespace)::wkv_mma_kernel<64, 32>(__nv_bfloat16 const*, __nv_bf", "port"),
    ("void (anonymous namespace)::rmsnorm_vec_kernel<__nv_bfloat16, 16, 1, 4>(__nv_bfl", "port"),
    ("void (anonymous namespace)::tc::paged_mma_kernel<128>((anonymous namespace)::tc:", "port"),
    ("void (anonymous namespace)::tc::flash_attention_mma_kernel<128>(__nv_bfloat16 co", "port"),
    ("(anonymous namespace)::dscale_sum_kernel(float const*, float*, int, int)", "port"),
    ("void (anonymous namespace)::elementwise_kernel_with_index<int, at::native::arang",
     "elementwise"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy_vectorized<at::nativ", "copy"),
    ("nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN", "gemm"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::W",
     "reduce"),
])
def test_kernel_class(name, cls):
    assert ab_serve.kernel_class(name, PORT) == cls
