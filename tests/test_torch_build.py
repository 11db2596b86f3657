"""How the port's CUDA kernels are built and which variant serves a call,
on the CPU: no nvcc and no card are needed.

- ``build.library_path`` keys each kernel's library by its source, every
  shared header (``csrc/*.cuh``) and the nvcc flags, so an edited header
  never loads a stale library.
- ``kernel_variant`` of flash attention and of the MoE grouped matmul is a
  pure function of dtype and shape: the main path's bf16 shapes take the
  Hopper kernels (TMA and wgmma), float32 the SIMT kernels, and shapes the
  wgmma kernels do not serve the mma.sync ones.
"""

import shutil

import pytest

torch = pytest.importorskip("torch")

from repro_torch.config.registry import get_arch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.models.moe import capacity  # noqa: E402


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """``build.CSRC`` pointed at a private copy of the kernel sources."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


@pytest.mark.parametrize("name", build.KERNELS)
def test_library_path_follows_shared_headers(csrc_copy, name):
    before = build.library_path(name)
    assert build.library_path(name) == before  # stable for the same files
    header = csrc_copy / "hopper.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = build.library_path(name)
    assert after != before and after.parent == before.parent
    (csrc_copy / "extra.cuh").write_text("// a new header\n")
    assert build.library_path(name) not in (before, after)


def test_library_path_follows_the_source_alone(csrc_copy):
    paths = {n: build.library_path(n) for n in build.KERNELS}
    src = csrc_copy / "moe_gmm.cu"
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    for n in build.KERNELS:
        assert (build.library_path(n) != paths[n]) == (n == "moe_gmm")


def test_every_kernel_source_is_listed():
    assert sorted(p.stem for p in build.CSRC.glob("*.cu")) == sorted(
        build.KERNELS)
    assert [p.name for p in build.CSRC.glob("*.cuh")] == ["hopper.cuh"]


@pytest.mark.parametrize("dtype,B,S,H,KV,D,window,want", [
    # the main path: qwen3-1.7b's prefill, dbrx's attention, hymba's window
    (torch.bfloat16, 2, 4096, 16, 8, 128, None, "wgmma"),
    (torch.bfloat16, 2, 4096, 48, 8, 128, None, "wgmma"),
    (torch.bfloat16, 2, 4096, 25, 5, 64, 1024, "wgmma"),
    # ragged S, G = 16, MQA: still TMA-describable
    (torch.bfloat16, 1, 333, 32, 2, 128, None, "wgmma"),
    (torch.bfloat16, 1, 1, 8, 1, 64, None, "wgmma"),
    # other head dims keep mma.sync
    (torch.bfloat16, 2, 128, 4, 2, 16, None, "mma"),
    (torch.bfloat16, 2, 128, 4, 2, 32, 16, "mma"),
    (torch.bfloat16, 1, 1000, 8, 4, 256, None, "mma"),
    # float32 keeps the SIMT kernel at every head dim
    (torch.float32, 2, 4096, 16, 8, 128, None, "simt"),
    (torch.float32, 1, 300, 25, 5, 64, 100, "simt"),
    (torch.float32, 1, 64, 2, 2, 256, None, "simt"),
])
def test_flash_kernel_variant(dtype, B, S, H, KV, D, window, want):
    assert fa.kernel_variant(dtype, B, S, H, KV, D, window) == want
    assert want in fa.VARIANTS


def _moe_shapes():
    dbrx, kimi = get_arch("dbrx-132b"), get_arch("kimi-k2-1t-a32b")
    d, f = dbrx.d_model, dbrx.d_ff
    return dict(
        dbrx_up=(16, capacity(dbrx, 8192), d, f),
        dbrx_down=(16, capacity(dbrx, 8192), f, d),
        dbrx_decode=(16, capacity(dbrx, 16), d, f),
        kimi_up=(384, capacity(kimi, 8192), kimi.d_model, kimi.d_ff),
        kimi_decode=(384, capacity(kimi, 16), kimi.d_model, kimi.d_ff))


@pytest.mark.parametrize("dtype,shape,want", [
    # the main path: dbrx's prefill gate/up and down (16, 2560, 6144, 10752)
    (torch.bfloat16, "dbrx_up", "wgmma"),
    (torch.bfloat16, "dbrx_down", "wgmma"),
    (torch.bfloat16, "kimi_up", "wgmma"),
    # decode: a few rows of a 128-row tile, bound by the weights' bytes
    (torch.bfloat16, "dbrx_decode", "wgmma"),
    (torch.bfloat16, "kimi_decode", "wgmma"),
    (torch.float32, "dbrx_up", "simt"),
    (torch.float32, "dbrx_decode", "simt"),
])
def test_moe_kernel_variant_on_model_shapes(dtype, shape, want):
    E, C, din, dout = _moe_shapes()[shape]
    assert gmm.kernel_variant(dtype, E, C, din, dout) == want


def test_moe_main_path_shapes():
    s = _moe_shapes()
    assert s["dbrx_up"] == (16, 2560, 6144, 10752)
    assert s["dbrx_down"] == (16, 2560, 10752, 6144)
    assert s["dbrx_decode"][:3] == (16, 5, 6144)
    assert s["kimi_decode"][1] == 1


@pytest.mark.parametrize("dtype,E,C,din,dout,want", [
    (torch.bfloat16, 3, 70, 256, 384, "wgmma"),   # C not a multiple of 128
    (torch.bfloat16, 1, 256, 512, 128, "wgmma"),  # E = 1, dout < 256
    (torch.bfloat16, 2, 64, 136, 264, "wgmma"),   # C = 64, odd multiples of 8
    (torch.bfloat16, 2, 63, 512, 512, "wgmma"),   # C below one 64-row wgmma
    (torch.bfloat16, 3, 100, 130, 70, "mma"),     # din, dout not multiples of 8
    (torch.bfloat16, 4, 128, 132, 256, "mma"),    # din alone
    (torch.bfloat16, 4, 128, 256, 100, "mma"),    # dout alone
    (torch.bfloat16, 2, 128, 0, 64, "mma"),       # nothing to contract
    (torch.float32, 2, 128, 256, 256, "simt"),
])
def test_moe_kernel_variant_edges(dtype, E, C, din, dout, want):
    assert gmm.kernel_variant(dtype, E, C, din, dout) == want


def test_cpu_calls_launch_no_variant():
    """CPU tensors take the plain versions: no count moves."""
    before = (dict(fa.launches_by_variant), dict(gmm.launches_by_variant))
    q = torch.randn(1, 40, 4, 64, dtype=torch.bfloat16)
    kv = torch.randn(1, 40, 2, 64, dtype=torch.bfloat16)
    assert fa.flash_attention(q, kv, kv).shape == q.shape
    x = torch.randn(2, 70, 64, dtype=torch.bfloat16)
    w = torch.randn(2, 64, 128, dtype=torch.bfloat16)
    assert gmm.moe_gmm(x, w).shape == (2, 70, 128)
    assert (fa.launches_by_variant, gmm.launches_by_variant) == before
    assert set(fa.launches_by_variant) == set(fa.VARIANTS)
    assert set(gmm.launches_by_variant) == set(gmm.VARIANTS)
