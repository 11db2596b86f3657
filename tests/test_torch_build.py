"""How the port's CUDA kernels are built and which variant serves a call,
on the CPU: no nvcc and no card are needed.

- ``build.library_path`` keys each kernel's library by its source, every
  shared header (``csrc/*.cuh``) and the nvcc flags, so an edited header
  never loads a stale library.
- ``kernel_variant`` of flash attention, decode attention, the MoE grouped
  matmul and the linear scan is a pure function of dtype and shape: the
  main path's bf16 shapes take the Hopper kernels (TMA and wgmma for flash
  and the grouped matmul, a bulk-copy ring for decode, the chunk-parallel
  tensor-core scan), float32 the SIMT kernels, and shapes the Hopper
  kernels do not serve the older ones.
- ``kernel_variant`` of the compressed-FedAvg scatter-add names ``tile``
  for VGG16's biases and first conv and ``atomic`` for its other leaves,
  and only a variant that ``serves`` the shape; RMSNorm's names
  ``resident`` for rows that split into at most 2048 16-byte vectors and
  ``warp`` for the rest.
"""

import math
import shutil

import pytest

torch = pytest.importorskip("torch")

from repro_torch.config.registry import get_arch  # noqa: E402
from repro_torch.config.shapes import SHAPES  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import scatter_add as sa  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.configs.paper_models import lenet5  # noqa: E402
from repro_torch.models.cnn_zoo import cnn_init  # noqa: E402
from repro_torch.models.moe import capacity  # noqa: E402
from repro_torch.optim.compression import topk_count  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from repro_torch.models.ssm import _ssd_dims, _xlstm_dims  # noqa: E402


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
    # kimi-k2's 64/8 heads of 112: wgmma at D = 128, zero-padded (the
    # entry refuses mma there), ragged S and windows alike
    (torch.bfloat16, 1, 4096, 64, 8, 112, None, "wgmma"),
    (torch.bfloat16, 1, 333, 64, 8, 112, 100, "wgmma"),
    (torch.float32, 1, 4096, 64, 8, 112, None, "simt"),
])
def test_flash_kernel_variant(dtype, B, S, H, KV, D, window, want):
    assert fa.kernel_variant(dtype, B, S, H, KV, D, window) == want
    assert want in fa.VARIANTS


def _attn(arch):
    c = get_arch(arch)
    return c.num_heads, c.num_kv_heads, c.head_dim


@pytest.mark.parametrize("dtype,B,arch,T,want", [
    # every model's decode step: 16 slots (decode_32k: its batch) in bf16
    (torch.bfloat16, 16, "qwen3-1.7b", 4096, "tma"),
    (torch.bfloat16, 16, "dbrx-132b", 4096, "tma"),
    (torch.bfloat16, 16, "hymba-1.5b", 1024, "tma"),
    (torch.bfloat16, 16, "kimi-k2-1t-a32b", 4096, "tma"),
    (torch.bfloat16, 16, "glm4-9b", 4096, "tma"),          # G = 16
    (torch.bfloat16, SHAPES["decode_32k"].global_batch, "qwen3-1.7b",
     SHAPES["decode_32k"].seq_len, "tma"),
    (torch.float32, 16, "qwen3-1.7b", 4096, "simt"),
    (torch.float32, 16, "kimi-k2-1t-a32b", 4096, "simt"),
])
def test_decode_kernel_variant_on_model_shapes(dtype, B, arch, T, want):
    H, KV, D = _attn(arch)
    assert D in da.HEAD_DIMS
    assert da.kernel_variant(dtype, B, H, KV, D, T) == want
    assert want in da.VARIANTS


@pytest.mark.parametrize("dtype,B,H,KV,D,T,want", [
    (torch.bfloat16, 3, 8, 1, 128, 1000, "tma"),    # MQA
    (torch.bfloat16, 3, 8, 8, 128, 777, "tma"),     # MHA, T not a tile multiple
    (torch.bfloat16, 3, 8, 4, 256, 900, "tma"),
    (torch.bfloat16, 1, 8, 4, 112, 1, "tma"),       # one cache row
    (torch.bfloat16, 5, 16, 16, 16, 100, "simt"),   # D < 64: no whole box
    (torch.bfloat16, 3, 8, 2, 32, 300, "simt"),
    (torch.bfloat16, 2, 32, 1, 64, 100, "simt"),    # G = 32: past one mma tile
    (torch.bfloat16, 2, 34, 2, 128, 64, "simt"),    # G = 17
    (torch.float32, 3, 8, 1, 128, 1000, "simt"),
])
def test_decode_kernel_variant_edges(dtype, B, H, KV, D, T, want):
    assert da.kernel_variant(dtype, B, H, KV, D, T) == want


def _scan_shapes():
    hymba, xlstm = get_arch("hymba-1.5b"), get_arch("xlstm-350m")
    H, dk, _, dv = _ssd_dims(hymba)
    Hx, _, dh = _xlstm_dims(xlstm)
    return dict(hymba=(2, 4096, H, dk, dv), xlstm=(1, 1024, Hx, dh, dh),
                xlstm_long=(2, 4096, Hx, dh, dh))


@pytest.mark.parametrize("dtype,shape,want", [
    (torch.bfloat16, "hymba", "mma"),
    (torch.bfloat16, "xlstm", "mma"),
    (torch.bfloat16, "xlstm_long", "mma"),
    (torch.float32, "hymba", "simt"),
    (torch.float32, "xlstm", "simt"),
])
def test_scan_kernel_variant_on_model_shapes(dtype, shape, want):
    assert ss.kernel_variant(dtype, *_scan_shapes()[shape]) == want
    assert want in ss.VARIANTS


@pytest.mark.parametrize("dtype,shape,want", [
    (torch.bfloat16, (1, 333, 3, 16, 128), "mma"),   # S not a chunk multiple
    (torch.bfloat16, (2, 200, 2, 8, 16), "mma"),     # Dk, Dv under one tile
    (torch.bfloat16, (2, 64, 4, 64, 40), "mma"),     # Dv not a multiple of 16
    (torch.bfloat16, (1, 1, 1, 1024, 8), "mma"),
    (torch.float32, (2, 200, 2, 8, 16), "simt"),
])
def test_scan_kernel_variant_edges(dtype, shape, want):
    assert ss.kernel_variant(dtype, *shape) == want


def test_model_shapes_of_the_new_designs():
    s = _scan_shapes()
    assert s["hymba"] == (2, 4096, 25, 16, 128)
    assert s["xlstm"][2:] == (4, 512, 512)
    assert _attn("kimi-k2-1t-a32b") == (64, 8, 112)
    assert _attn("glm4-9b")[0] // _attn("glm4-9b")[1] == da.TMA_MAX_GROUP


def test_cpu_calls_launch_no_decode_or_scan_variant():
    """CPU tensors take the plain versions: no count moves."""
    before = (da.launches, dict(da.launches_by_variant), ss.launches,
              dict(ss.launches_by_variant))
    q = torch.randn(2, 8, 112, dtype=torch.bfloat16)
    kv = torch.randn(2, 40, 2, 112, dtype=torch.bfloat16)
    length = torch.tensor([0, 17], dtype=torch.int32)
    assert da.decode_attention(q, kv, kv, length).shape == q.shape
    x = torch.randn(1, 70, 2, 16, dtype=torch.bfloat16)
    y, _ = ss.linear_scan(x, x, x, torch.rand(1, 70, 2))
    assert y.shape == x.shape
    assert (da.launches, da.launches_by_variant, ss.launches,
            ss.launches_by_variant) == before
    assert set(da.launches_by_variant) == set(da.VARIANTS)
    assert set(ss.launches_by_variant) == set(ss.VARIANTS)


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


@pytest.mark.parametrize("name", ["scatter_add", "rmsnorm"])
def test_library_path_follows_each_redesigned_source(csrc_copy, name):
    paths = {n: build.library_path(n) for n in build.KERNELS}
    src = csrc_copy / f"{name}.cu"
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    for n in build.KERNELS:
        assert (build.library_path(n) != paths[n]) == (n == name)


# ---- the compressed-FedAvg scatter-add --------------------------------------

@pytest.fixture(scope="module")
def vgg16_leaves():
    return [tuple(leaf.shape) for leaf in
            tree_leaves(cnn_init(get_arch("paper-vgg16"), device="cpu"))]


@pytest.mark.parametrize("j", range(32))
def test_scatter_kernel_variant_on_vgg16_leaves(vgg16_leaves, j):
    """A cohort of 10 at ratio 0.01, as ``fedavg_compressed`` sends it:
    the biases and the first conv (3 x 3 x 3 x 64 = 1728 floats, 170
    entries) fit one tile; the other convs and the fc weights, fc2 (4096 x
    4096) among them, take the atomics."""
    assert len(vgg16_leaves) == 32
    shape = vgg16_leaves[j]
    size = math.prod(shape)
    want = "tile" if len(shape) == 1 or shape == (3, 3, 3, 64) else "atomic"
    assert sa.kernel_variant(10, topk_count(0.01, size), size) == want
    assert want in sa.VARIANTS


def test_vgg16_leaves_by_variant(vgg16_leaves):
    sizes = [math.prod(s) for s in vgg16_leaves]
    got = [sa.kernel_variant(10, topk_count(0.01, n), n) for n in sizes]
    by_shape = dict(zip(vgg16_leaves, got))
    assert by_shape[(4096, 4096)] == "atomic"           # fc2
    assert by_shape[(512, 4096)] == "atomic"            # fc1
    assert by_shape[(3, 3, 512, 512)] == "atomic"
    assert {v for s, v in zip(vgg16_leaves, got) if len(s) == 1} == {"tile"}
    assert (got.count("tile"), got.count("atomic")) == (17, 15)


LENET5_VARIANTS = ["tile", "tile", "tile", "tile", "tile", "atomic", "tile",
                   "tile", "tile", "tile"]


@pytest.mark.parametrize("j", range(10))
def test_scatter_kernel_variant_on_lenet5_leaves(j):
    """Phase 4's LeNet-5 leaves at n = 5, ratio 0.01: fc1 (784 x 120) is
    past one tile, every other leaf fits one tile."""
    leaves = tree_leaves(cnn_init(lenet5(), device="cpu"))
    assert len(leaves) == len(LENET5_VARIANTS)
    size = leaves[j].numel()
    assert (sa.kernel_variant(5, topk_count(0.01, size), size)
            == LENET5_VARIANTS[j])


@pytest.mark.parametrize("n,k,size,want", [
    (10, 40, sa.TILE, "tile"),                      # exactly one tile
    (10, 40, sa.TILE - 1, "tile"),
    (10, 40, sa.TILE + 1, "atomic"),                # one float past it
    (1, sa.TILE_MAX_ENTRIES, 1000, "tile"),
    (2, 513, 1000, "atomic"),                       # a long stream, one tile
    (3, 7, 1, "tile"),
    (1, sa.TILE_MAX_ENTRIES + 1, 10, "atomic"),    # a long stream, size 10
    (10, 1, 4096 * 4096, "atomic"),                # VGG16's fc2, 10 entries
    (10, 167_772, 4096 * 4096, "atomic"),          # fc2 at ratio 0.01
    (0, 5, 10 ** 6, "atomic"),
    (0, 5, 10, "tile"),
])
def test_scatter_kernel_variant_edges(n, k, size, want):
    assert sa.kernel_variant(n, k, size) == want
    assert sa.serves(want, n, k, size)


@pytest.mark.parametrize("variant,n,k,size,want", [
    ("atomic", 10, 167_772, 4096 * 4096, True),
    ("atomic", 1, 1, 1, True),
    ("tile", 10, 41, 4096, True),
    ("tile", 2, 513, 1000, True),       # any stream length
    ("tile", 1, 1, sa.TILE, True),
    ("tile", 1, 1, sa.TILE + 1, False),  # past one tile
    ("tile", 10, 167_772, 4096 * 4096, False),
])
def test_scatter_serves(variant, n, k, size, want):
    """The shapes the C entry takes, stated once on the Python side."""
    assert sa.serves(variant, n, k, size) is want


def test_scatter_serves_names_only_its_variants():
    with pytest.raises(ValueError, match="nonesuch"):
        sa.serves("nonesuch", 1, 1, 1)


@pytest.mark.parametrize("size", [1, 100, sa.TILE - 1, sa.TILE, sa.TILE + 1,
                                  2 ** 23, 2 ** 24 + 3])
@pytest.mark.parametrize("nk", [(1, 1), (10, 102), (10, 103), (3, 5000)])
def test_scatter_kernel_variant_serves_its_shape(size, nk):
    """The rule names a variant the entry takes, and ``tile`` wherever it
    serves a stream of at most ``TILE_MAX_ENTRIES`` entries."""
    n, k = nk
    got = sa.kernel_variant(n, k, size)
    assert sa.serves(got, n, k, size)
    assert (got == "tile") == (size <= sa.TILE
                               and n * k <= sa.TILE_MAX_ENTRIES)


# ---- RMSNorm ----------------------------------------------------------------

@pytest.mark.parametrize("dtype,shape", [
    # chip_smoke.py's phase-8 shapes
    (torch.float32, (8192, 2048)), (torch.bfloat16, (8192, 2048)),
    (torch.bfloat16, (8192, 6144)), (torch.bfloat16, (16, 6144)),
    (torch.float32, (4097, 1600)), (torch.bfloat16, (4097, 1600)),
    (torch.bfloat16, (1, 6144)), (torch.float32, (1, 6144)),
    # the widest rows served: 2048 vectors
    (torch.bfloat16, (300, 16384)), (torch.float16, (16, 16384)),
    (torch.float32, (300, 8192)),
    # d = 100 is 25 float32 vectors
    (torch.float32, (33, 100)),
])
def test_rmsnorm_kernel_variant_resident(dtype, shape):
    assert rn.kernel_variant(dtype, *shape) == "resident"


@pytest.mark.parametrize("dtype,shape", [
    (torch.bfloat16, (33, 100)), (torch.float16, (33, 100)),  # 12.5 vectors
    (torch.bfloat16, (300, 16392)), (torch.float16, (2, 16392)),
    (torch.float32, (300, 8196)), (torch.float32, (2, 16384)),
    (torch.bfloat16, (4, 6)),
])
def test_rmsnorm_kernel_variant_warp(dtype, shape):
    assert rn.kernel_variant(dtype, *shape) == "warp"
    assert set(rn.VARIANTS) == {"warp", "resident"}


def test_rmsnorm_max_resident_d():
    """2048 16-byte vectors: 16384 bf16 or f16 elements, 8192 float32."""
    assert rn.max_resident_d(torch.bfloat16) == 16384
    assert rn.max_resident_d(torch.float16) == 16384
    assert rn.max_resident_d(torch.float32) == 8192


def test_cpu_calls_launch_no_scatter_or_rmsnorm_variant():
    """CPU tensors take the plain versions: no count moves."""
    before = (sa.launches, dict(sa.launches_by_variant), rn.launches,
              dict(rn.launches_by_variant))
    vals = torch.randn(3, 40)
    idx = torch.randint(-1, sa.TILE + 2, (3, 40))
    out = sa.scatter_add(vals, idx, torch.rand(3), sa.TILE + 1)
    assert out.shape == (sa.TILE + 1,)
    x = torch.randn(5, 6144, dtype=torch.bfloat16)
    assert rn.rmsnorm(x, torch.ones(6144)).shape == x.shape
    assert (sa.launches, sa.launches_by_variant, rn.launches,
            rn.launches_by_variant) == before
    assert set(sa.launches_by_variant) == set(sa.VARIANTS)
    assert set(rn.launches_by_variant) == set(rn.VARIANTS)
