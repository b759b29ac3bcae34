"""The port's CUDA sources, run on the CPU, against their plain versions.

``dynmm_tpu_torch.kernels.emulate`` compiles each ``csrc/*.cu`` with the
host's C++ compiler against a small CUDA emulation, so the kernels'
indexing, tiling, masks and arithmetic are exercised here, where there is
no card and no ``nvcc``. Shapes are chosen to reach every code path: both
tiles of the pair's implicit-GEMM kernel (its ``mma.sync`` fragments
exchanged inside each emulated warp) with ragged pixel and channel edges;
the one-launch block's tiles cut by the image's last row and column, its
partial chunks and groups of channels, its passes of items and its
``cp.async`` staging; odd pooled sizes; the upsample's strips of rows at
both vector widths and C = 40; the SE cell's last-block finalize over
several squeeze blocks, and its counters reset between calls; the 16-byte
accesses of the sums and of the SE cell (8 bf16 channels a thread) and the
narrower ones a shape or an offset forces; the sums' last-block finalize;
the SE MLPs' own launch from C = 1024 up (its item queue, passes of 8
samples, ragged slices and tiles). The whole
small model is served through the emulated kernels, densely and through the
routed strategies, with the launch counts of its forward. On the card,
``chip_smoke.py`` holds the same sources, built by ``nvcc``, against the
same plain versions.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from dynmm_tpu_torch.kernels import LAUNCHES, emulate, reset_launches
from dynmm_tpu_torch.kernels import nbt1d, se, stem_fuse, upsample
from dynmm_tpu_torch.models.esanet import ESANetConfig
from dynmm_tpu_torch.models.skip_gate import SkipGateESANet
from dynmm_tpu_torch.serve import init_weights, serve
from tests.test_torch_port_routed import FixedGate


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler to emulate the CUDA sources with")
    return emulate.build(tmp_path_factory.mktemp("emulated_kernels"))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _randn(g, *shape, scale=1.0):
    return torch.randn(shape, generator=g) * scale


def _both(libs, fn, *args, **kwargs):
    """(emulated kernel, plain version) on the same CPU tensors."""
    reset_launches()
    with emulate.emulated(libs):
        out = fn(*args, **kwargs)
    assert sum(LAUNCHES.values()) >= 1
    return out, fn(*args, **kwargs)


def _close(out, ref):
    for o, r in zip(*((out, ref) if isinstance(out, tuple) else ((out,), (ref,)))):
        assert o.shape == r.shape
        torch.testing.assert_close(o, r, rtol=1e-5,
                                   atol=1e-5 * float(r.abs().max()))


@pytest.mark.parametrize("n,h,w,c", [
    # 32 x 32 tiles (64 x 64 tiles would give fewer than 264 blocks)
    (2, 5, 16, 32),   # one chunk of input channels per tap, 160 pixels
    (1, 2, 40, 64),   # two full chunks, two full tiles of output channels
    (2, 3, 8, 40),    # a partial chunk; output channels past C not stored
    (2, 5, 12, 32),   # ragged last tile of pixels (120 = 3·32 + 24)
    (1, 4, 3, 33),    # narrower than a tile, odd C: scalar loads
    (2, 3, 5, 100),   # four tiles of output channels, the last partial
    (1, 1, 7, 40),    # one image row: both row taps read padding
    (1, 9, 1, 33),    # one image column: both column taps read padding
    # 64 x 64 tiles: 265 blocks; ragged last tile (16,951 = 264·64 + 55)
    (1, 67, 253, 32),
])
@pytest.mark.parametrize("with_identity", [False, True])
def test_nbt1d_pair(libs, n, h, w, c, with_identity):
    """Pair 1 and pair 2 through both launches of the implicit-GEMM kernel.
    The 1e-5 relative tolerance holds only with 3xTF32's correction terms:
    the hi·hi products alone miss it by an order of magnitude."""
    g = _gen(h * w + c)
    x = _randn(g, n, h, w, c)
    p = [_randn(g, 3, c, c, scale=0.2), _randn(g, c), _randn(g, 3, c, c, scale=0.2),
         _randn(g, c), torch.rand(c, generator=g) + 0.5, _randn(g, c)]
    idn = _randn(g, n, h, w, c) if with_identity else None
    _close(*_both(libs, nbt1d.nbt1d_pair, x, *p, identity=idn))
    assert dict(LAUNCHES) == {"nbt1d_pair": 1}  # the plain call counts none


def _tf32_reference(v: np.ndarray) -> np.ndarray:
    """fp32 → tf32 bits by arithmetic in float64: the significand rounded
    to 11 bits, ties away from zero."""
    m, e = np.frexp(np.abs(v.astype(np.float64)))  # |v| = m·2^e, m in [0.5, 1)
    r = np.floor(m * 2.0 ** 11 + 0.5) * 2.0 ** (e - 11)
    return np.copysign(r, v).astype(np.float32).view(np.uint32)


_ONE = 1.0 + 2.0 ** -11  # halfway between two tf32 neighbours of 1
_TF32_CASES = {
    "ties": [_ONE, 1.0 + 3 * 2.0 ** -11, 3.0 * _ONE, 2.0 ** -20 * _ONE],
    "negatives": [-_ONE, -1.0 - 3 * 2.0 ** -11, -0.1, -7.3e-12, -0.0],
    "carry into the exponent": [np.nextafter(np.float32(2), np.float32(0)),
                                -np.nextafter(np.float32(1), np.float32(0)),
                                2.0 - 2.0 ** -11, 1.5e30 * (2 - 2.0 ** -11)],
    "near ties": [1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0 + 2.0 ** -11 + 2.0 ** -23,
                  0.0, 1.0, 3.14159265, 1e-30],
}


@pytest.mark.parametrize("case", list(_TF32_CASES) + ["random"])
def test_emulated_tf32_split(libs, case):
    """The emulated ``cvt.rna.tf32.f32`` against a bit-level reference,
    and the 3xTF32 split v = hi + lo that the pair kernel multiplies with:
    lo is v − hi rounded the same way, and hi + lo is within 2^-22 of v."""
    if case == "random":
        rng = np.random.default_rng(0)
        v = (rng.standard_normal(4096)
             * 2.0 ** rng.integers(-60, 60, 4096)).astype(np.float32)
    else:
        v = np.array(_TF32_CASES[case], dtype=np.float32)
    hi, lo = np.zeros(v.shape, np.uint32), np.zeros(v.shape, np.uint32)
    fn = libs["nbt1d"].dynmm_emu_tf32_split
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    fn.restype = None
    fn(v.ctypes.data, hi.ctypes.data, lo.ctypes.data, v.size)
    np.testing.assert_array_equal(hi, _tf32_reference(v))
    assert not (hi & 0x1FFF).any() and not (lo & 0x1FFF).any()
    rest = v - hi.view(np.float32)  # exact in fp32
    np.testing.assert_array_equal(lo, _tf32_reference(rest))
    total = hi.view(np.float32).astype(np.float64) + lo.view(np.float32)
    assert (np.abs(total - v) <= 2.0 ** -22 * np.abs(v)).all()


def _block_params(g, c):
    """Taps, non-zero biases and a folded BN away from identity, so a wrong
    boundary mask (relu(bias) instead of 0) changes the output."""
    p = []
    for _ in range(2):
        p += [_randn(g, 3, c, c, scale=0.3), _randn(g, c, scale=0.5),
              _randn(g, 3, c, c, scale=0.3), _randn(g, c, scale=0.5),
              torch.rand(c, generator=g) + 0.5, _randn(g, c, scale=0.3)]
    return p


@pytest.mark.parametrize("n,h,w,c", [
    (2, 5, 16, 8),    # one column tile of 16; the last tile cut by the image
    (1, 6, 20, 16),   # a ragged second column tile
    (2, 9, 12, 16),   # narrower than a tile (W not a multiple of 16)
    (1, 3, 8, 4),     # one tile taller than the image; C % 8 != 0
    (2, 4, 6, 13),    # C % 4 != 0: 4-byte copies, zero channels to 16
    (1, 7, 40, 12),   # three column tiles; channels not a multiple of 32
    (1, 2, 5, 16),    # narrower than a tile, two rows
    (1, 13, 37, 8),   # H, W multiples of no tile's rows or columns
    (1, 1, 20, 8),    # one image row: both row taps of a and g read padding
    (2, 6, 1, 12),    # one image column: the column taps read padding
    (1, 5, 18, 40),   # a partial 32-channel chunk; output channels past
                      # the second group's first fragment
    (1, 9, 20, 64),   # the flagship's C = 64, with 8 x 16 and 4 x 16 tiles
    (1, 3, 5, 200),   # chunks of 8 input channels (C > 192), 7 groups
])
@pytest.mark.parametrize("band_rows", [0, 3, 8, 4])  # 0: the kernel's choice
def test_nbt1d_fused(libs, n, h, w, c, band_rows):
    """The one-launch block on the tensor cores (3xTF32 fragments
    exchanged inside each emulated warp) against the plain version: tiles
    of ``band_rows`` output rows (0: the kernel's rule, which takes 2 rows
    on grids this small), ragged tiles, one-pixel-wide images, partial
    chunks and groups of channels."""
    g = _gen(h * w + c)
    x = _randn(g, n, h, w, c)
    _close(*_both(libs, nbt1d.nbt1d_fused, x, *_block_params(g, c),
                  band_rows=band_rows))
    assert dict(LAUNCHES) == {"nbt1d_fused": 1}  # the plain call counts none


@pytest.mark.parametrize("band_rows", [0, 6])
def test_nbt1d_fused_tile_rule(libs, band_rows):
    """C = 128: the rule takes 4 x 16 tiles, the tallest whose first step
    has at most one item per warp; 6 rows need two passes of items."""
    g = _gen(band_rows)
    x = _randn(g, 1, 9, 17, 128)
    _close(*_both(libs, nbt1d.nbt1d_fused, x, *_block_params(g, 128),
                  band_rows=band_rows))
    assert dict(LAUNCHES) == {"nbt1d_fused": 1}


@pytest.mark.parametrize("max_c,launches", [(16, {"nbt1d_fused": 1}),
                                            (8, {"nbt1d_pair": 2})])
def test_nbt1d_block_dispatch(libs, monkeypatch, max_c, launches):
    """Either side of the one-launch kernel's channel limit, the same
    block: one ``nbt1d_fused`` launch at or under it, two ``nbt1d_pair``
    launches over it."""
    monkeypatch.setattr(nbt1d, "NBT1D_FUSED_MAX_C", max_c)
    g = _gen(5)
    x = _randn(g, 2, 6, 10, 16)
    p = _block_params(g, 16)
    _close(*_both(libs, nbt1d.nbt1d_block, x, *p))
    assert dict(LAUNCHES) == launches
    _close(nbt1d.nbt1d_block(x, *p), nbt1d.nbt1d_fused_plain(x, *p))


@pytest.mark.parametrize("b,h,w,c", [(2, 5, 7, 12), (2, 3, 4, 40),
                                     (1, 6, 6, 300)])
def test_channel_sums(libs, b, h, w, c):
    g = _gen(c)
    _close(*_both(libs, se.channel_sums, _randn(g, b, h, w, c),
                  _randn(g, b, h, w, c)))


@pytest.mark.parametrize("b,h,w,c,cr", [
    (2, 5, 6, 32, 2), (3, 4, 4, 64, 4),
    # above C = 1024 each thread owns two float4 groups: ResNet50's stage-4
    # cell (C = 2048, C/16 = 128) and C = 1536 (the second group of the
    # last 64 threads past C/4), at ragged pixel counts
    (2, 3, 5, 2048, 128), (1, 7, 3, 1536, 96)])
def test_se_fuse_mixed_and_fused_se(libs, b, h, w, c, cr):
    g = _gen(c)
    ws = [_randn(g, c, cr, scale=0.3), _randn(g, cr), _randn(g, cr, c, scale=0.3),
          _randn(g, c)]
    wd = [_randn(g, c, cr, scale=0.3), _randn(g, cr), _randn(g, cr, c, scale=0.3),
          _randn(g, c)]
    rgb, depth = _randn(g, b, h, w, c), _randn(g, b, h, w, c)
    w_rgb = torch.rand(b, generator=g)
    _close(*_both(libs, se.se_fuse_mixed, rgb, depth, w_rgb, *ws, *wd))
    _close(*_both(libs, se.fused_se, _randn(g, b, h * w, c), *ws))
    _close(*_both(libs, se.fused_se, _randn(g, h * w, c), *ws))


def _se_weights(g, c, cr):
    return [_randn(g, c, cr, scale=0.3), _randn(g, cr), _randn(g, cr, c, scale=0.3),
            _randn(g, c)]


@pytest.fixture
def several_squeeze_blocks(monkeypatch):
    """Grids of several squeeze blocks per sample at the tests' small
    shapes, so the last block's finalize adds more than one partial."""
    monkeypatch.setattr(se, "BLOCKS_PER_SM", 8)
    monkeypatch.setattr(se, "MIN_ITEMS", 1)


@pytest.mark.parametrize("b,h,w,c,cr,w_rgb", [
    (2, 3, 5, 40, 2, [0.0, 1.0]),       # C = 40; w exactly 0 and exactly 1
    (1, 2, 3, 512, 32, [0.3]),          # the C = 512 level's C/16 = 32
    (3, 4, 4, 64, 4, [1.0, 0.25, 0.0]),
    (2, 3, 5, 2048, 128, [0.0, 0.6]),   # two float4 groups a thread
    (1, 5, 3, 1536, 96, [0.4]),
])
def test_se_cell_several_squeeze_blocks(libs, several_squeeze_blocks,
                                        b, h, w, c, cr, w_rgb):
    """The two-launch SE cell with 6-8 squeeze blocks per sample: the
    sample's last block adds their partials, runs both MLPs and folds in
    w; single-map ``fused_se`` through the same kernels (w = 0)."""
    assert se._se_splits(b, h * w, c, emulate.SMS) >= 6
    g = _gen(c + b)
    ws, wd = _se_weights(g, c, cr), _se_weights(g, c, cr)
    rgb, depth = _randn(g, b, h, w, c), _randn(g, b, h, w, c)
    _close(*_both(libs, se.se_fuse_mixed, rgb, depth, torch.tensor(w_rgb),
                  *ws, *wd))
    assert dict(LAUNCHES) == {"se_fuse_mixed": 1}
    _close(*_both(libs, se.fused_se, _randn(g, b, h * w, c), *ws))
    assert dict(LAUNCHES) == {"fused_se": 1}
    assert not se._COUNTERS[torch.device("cpu")].any()


def test_se_cell_repeats_bit_identical(libs, several_squeeze_blocks):
    """Two calls in a row, and two batch sizes in a row, give bit-identical
    results: the finalize leaves every per-sample counter at 0."""
    g = _gen(11)
    c, cr = 32, 2
    ws, wd = _se_weights(g, c, cr), _se_weights(g, c, cr)
    rgb, depth = _randn(g, 3, 5, 4, c), _randn(g, 3, 5, 4, c)
    w_rgb = torch.rand(3, generator=g)

    def cell(n):
        out = se.se_fuse_mixed(rgb[:n], depth[:n], w_rgb[:n], *ws, *wd)
        assert not se._COUNTERS[torch.device("cpu")].any()
        return out

    with emulate.emulated(libs):
        outs = [cell(3), cell(3), cell(1), cell(1), cell(3)]
    for a, b in ((0, 1), (2, 3), (0, 4)):
        assert torch.equal(outs[a], outs[b])
    _close(outs[0], se.se_fuse_mixed_plain(rgb, depth, w_rgb, *ws, *wd))
    _close(outs[2], se.se_fuse_mixed_plain(rgb[:1], depth[:1], w_rgb[:1],
                                           *ws, *wd))


@pytest.mark.parametrize("b,h,w,c", [(2, 9, 10, 8), (1, 8, 12, 4)])
@pytest.mark.parametrize("negative", [False, True])
def test_stem_fuse_pool(libs, b, h, w, c, negative):
    g = _gen(h * w)
    rgb, depth = _randn(g, b, h, w, c), _randn(g, b, h, w, c)
    if negative:  # padding must never win the max
        rgb, depth = -rgb.abs() - 1, -depth.abs() - 1
    _close(*_both(libs, stem_fuse.stem_fuse_pool, rgb, depth,
                  torch.rand(b, c, generator=g), torch.rand(b, c, generator=g)))


@pytest.mark.parametrize("shape", [(2, 3, 5, 6), (1, 4, 4, 40), (5, 3, 8)])
def test_learned_upsample(libs, shape):
    g = _gen(sum(shape))
    c = shape[-1]
    _close(*_both(libs, upsample.learned_upsample, _randn(g, *shape),
                  _randn(g, 3, 3, c), _randn(g, c)))


@pytest.mark.parametrize("shape,sms,strips", [
    ((3, 5, 4, 4), 2, 2),    # float4s; strips of 3 rows, the first ends
                             # mid-image, steps of 4 rows cut by the strip
    ((1, 11, 3, 4), 1, 3),   # strips of 5 rows: a full step, then one row
    ((1, 7, 5, 6), 2, 7),    # C % 4 != 0: one channel a thread, 1-row strips
    ((1, 1, 6, 40), 2, 1),   # one source row: both window rows are padding
    ((3, 4, 1, 40), 2, 2),   # one source column; a last strip of one row
    ((2, 6, 3, 40), 1, 1),   # one strip of 6 rows: a step of 4, then 2
    ((1, 3, 1, 6), 2, 3),    # one column, one channel a thread
])
def test_learned_upsample_strips(libs, monkeypatch, shape, sms, strips):
    """The sliding window across steps and strip boundaries (the kernel's
    strip rule, for ``sms`` SMs, cuts the image into ``strips``), at the
    image's edges, in both vector widths, at B = 1 and 3."""
    monkeypatch.setattr(emulate, "SMS", sms)
    n, h, w, c = shape
    cols = 2 * w * (c // 4 if c % 4 == 0 else c)
    rows = min(16, max(1, n * h * -(-cols // 256) // (2 * sms)))
    assert -(-h // rows) == strips
    g = _gen(sum(shape) + sms)
    _close(*_both(libs, upsample.learned_upsample, _randn(g, *shape),
                  _randn(g, 3, 3, c), _randn(g, c)))
    assert dict(LAUNCHES) == {"learned_upsample": 1}


def test_learned_upsample_unaligned_takes_scalar_path(libs):
    """C % 4 == 0 but a map that is not 16-byte aligned: one channel a
    thread, the same result."""
    g = _gen(3)
    x = torch.empty(2 * 3 * 5 * 8 + 1)[1:].view(2, 3, 5, 8)
    x.copy_(_randn(g, 2, 3, 5, 8))
    assert x.data_ptr() % 16
    _close(*_both(libs, upsample.learned_upsample, x, _randn(g, 3, 3, 8),
                  _randn(g, 8)))


# ------------------------------------------------------------ bf16 forms
BF = torch.bfloat16


def _bf16_close(out, ref, tol):
    """Max abs err ≤ ``tol`` of max |ref| (0: bit-identical), dtypes equal."""
    for o, r in zip(*((out, ref) if isinstance(out, tuple) else ((out,), (ref,)))):
        assert o.dtype == r.dtype and o.shape == r.shape
        err = float((o.float() - r.float()).abs().max())
        assert err <= tol * float(r.float().abs().max()), err


@pytest.mark.parametrize("b,h,w,c", [(2, 5, 7, 12), (1, 6, 6, 300)])
def test_channel_sums_bf16(libs, b, h, w, c):
    """bf16 maps, fp32 sums: within 1e-5 (the summation order)."""
    g = _gen(c + 1)
    rgb, depth = _randn(g, b, h, w, c).to(BF), _randn(g, b, h, w, c).to(BF)
    out, ref = _both(libs, se.channel_sums, rgb, depth)
    assert dict(LAUNCHES) == {"channel_sums.bf16": 1}
    assert out[0].dtype == torch.float32
    _bf16_close(out, ref, 1e-5)


@pytest.mark.parametrize("b,h,w,c", [(2, 9, 10, 8), (1, 8, 12, 4)])
@pytest.mark.parametrize("negative", [False, True])
def test_stem_fuse_pool_bf16_bit_identical(libs, b, h, w, c, negative):
    """The per-op bf16 roundings of the kernel are the plain version's."""
    g = _gen(h * w + 1)
    rgb, depth = _randn(g, b, h, w, c), _randn(g, b, h, w, c)
    if negative:
        rgb, depth = -rgb.abs() - 1, -depth.abs() - 1
    s_r, s_d = (torch.rand(b, c, generator=g).to(BF) for _ in range(2))
    out, ref = _both(libs, stem_fuse.stem_fuse_pool, rgb.to(BF),
                     depth.to(BF), s_r, s_d)
    assert dict(LAUNCHES) == {"stem_fuse_pool.bf16": 1}
    _bf16_close(out, ref, 0.0)


@pytest.mark.parametrize("b,h,w,c,cr,w_rgb", [
    (2, 3, 5, 40, 2, [0.0, 1.0]),
    (3, 4, 4, 64, 4, [1.0, 0.25, 0.0]),
    (2, 3, 5, 2048, 128, [0.0, 0.6]),   # two float4 groups a thread
])
def test_se_cell_bf16(libs, several_squeeze_blocks, b, h, w, c, cr, w_rgb):
    """bf16 maps, fp32 MLP weights: within 8e-3 of max |plain| (the fp32
    means' summation order can move a rounding to bf16 by one step), and
    two calls bit-identical; the single-map cell through the same
    kernels."""
    g = _gen(c + b + 1)
    ws, wd = _se_weights(g, c, cr), _se_weights(g, c, cr)
    rgb, depth = _randn(g, b, h, w, c).to(BF), _randn(g, b, h, w, c).to(BF)
    args = (rgb, depth, torch.tensor(w_rgb), *ws, *wd)
    out, ref = _both(libs, se.se_fuse_mixed, *args)
    assert dict(LAUNCHES) == {"se_fuse_mixed.bf16": 1}
    _bf16_close(out, ref, 8e-3)
    with emulate.emulated(libs):
        assert torch.equal(se.se_fuse_mixed(*args), out)
    x = _randn(g, b, h * w, c).to(BF)
    out, ref = _both(libs, se.fused_se, x, *ws)
    assert dict(LAUNCHES) == {"fused_se.bf16": 1}
    _bf16_close(out, ref, 8e-3)


@pytest.mark.parametrize("shape", [(2, 3, 5, 6), (1, 4, 4, 40), (3, 5, 4, 4)])
def test_learned_upsample_bf16(libs, shape):
    """bf16 map, taps and bias; fp32 arithmetic rounded once at the store:
    within 8e-3 of max |plain| (another summation order), both widths."""
    g = _gen(sum(shape) + 1)
    c = shape[-1]
    x, k, bias = (_randn(g, *shape).to(BF), _randn(g, 3, 3, c).to(BF),
                  _randn(g, c).to(BF))
    out, ref = _both(libs, upsample.learned_upsample, x, k, bias)
    assert dict(LAUNCHES) == {"learned_upsample.bf16": 1}
    _bf16_close(out, ref, 8e-3)
    # a map that is not 8-byte aligned takes one channel a thread
    xu = torch.empty(x.numel() + 1, dtype=BF)[1:].view(x.shape)
    xu.copy_(x)
    assert xu.data_ptr() % 8
    with emulate.emulated(libs):
        _bf16_close(upsample.learned_upsample(xu, k, bias), ref, 8e-3)


# ------------------------- 16-byte accesses, narrower ones, the MLP launch
DTYPES = {"fp32": torch.float32, "bf16": BF}


def _suffix(dtype):
    return ".bf16" if dtype == BF else ""


def _offset(x, nbytes):
    """x's values in a tensor that starts ``nbytes`` past an allocation."""
    k = nbytes // x.element_size()
    y = torch.empty(x.numel() + k, dtype=x.dtype)[k:].view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16 == nbytes % 16
    return y


@pytest.fixture
def several_sums_blocks(monkeypatch):
    """More ``channel_sums`` blocks per (sample, map) than the emulation's
    two SMs give, so the last block adds several partials."""
    monkeypatch.setattr(se, "SUMS_BLOCKS_PER_SM", 16)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,h,w,c", [
    (1, 37, 71, 8),    # splits of 526 (fp32) / 1314 (bf16) pixels: full
                       # unrolled steps of every lane, then a ragged tail
    (2, 9, 31, 64),    # 279 pixels: 4 (fp32) / 2 (bf16) splits, ragged
    (2, 5, 7, 1024),   # one or two pixel lanes, 8 / 4 splits of 35 pixels
    (1, 9, 30, 1024),  # 16 splits: the last block's loads in two passes
])
def test_channel_sums_several_blocks(libs, several_sums_blocks, dtype, b, h,
                                     w, c):
    """16-byte accesses (4 fp32 or 8 bf16 channels a thread), several
    blocks per (sample, map) whose partials the last block adds (in lanes
    of a channel up to C = 64, one thread a channel at 1024), HW a multiple
    of neither the unroll nor the split. Two calls are bit-identical and
    leave every ticket at 0."""
    g = _gen(c + h)
    rgb = _randn(g, b, h, w, c).to(DTYPES[dtype])
    depth = _randn(g, b, h, w, c).to(DTYPES[dtype])
    width = se._access_width(c, (rgb, depth))
    assert width == 16 // rgb.element_size()
    splits = se._sums_splits(b, h * w, c, width, emulate.SMS)
    assert splits >= 2 and (h * w) % splits and (h * w) % se.SUMS_UNROLL
    out, ref = _both(libs, se.channel_sums, rgb, depth)
    assert dict(LAUNCHES) == {"channel_sums" + _suffix(rgb.dtype): 1}
    assert out[0].dtype == torch.float32
    _bf16_close(out, ref, 1e-5)
    assert not se._SUMS_COUNTERS[torch.device("cpu")].any()
    with emulate.emulated(libs):
        again = se.channel_sums(rgb, depth)
    assert all(torch.equal(a, o) for a, o in zip(again, out))


@pytest.mark.parametrize("dtype,c,offset,width", [
    ("fp32", 12, 0, 4), ("fp32", 13, 0, 1), ("fp32", 64, 8, 2),
    ("fp32", 64, 4, 1), ("bf16", 12, 0, 4), ("bf16", 300, 0, 4),
    ("bf16", 6, 0, 2), ("bf16", 7, 0, 1), ("bf16", 64, 8, 4),
])
def test_channel_sums_narrow_accesses(libs, several_sums_blocks, dtype, c,
                                      offset, width):
    """Where C or the maps' alignment does not allow 16 bytes, the same
    kernel takes a narrower access (a bf16 map with C % 8 != 0, maps that
    start 8 or 4 bytes past a 16-byte boundary); it never falls back to the
    plain version."""
    g = _gen(c + offset)
    rgb, depth = (_offset(_randn(g, 2, 7, 9, c).to(DTYPES[dtype]), offset)
                  for _ in range(2))
    assert se._access_width(c, (rgb, depth)) == width
    out, ref = _both(libs, se.channel_sums, rgb, depth)
    assert dict(LAUNCHES) == {"channel_sums" + _suffix(rgb.dtype): 1}
    _bf16_close(out, ref, 1e-5)


@pytest.mark.parametrize("b,h,w,c,cr", [(3, 4, 6, 64, 4), (2, 3, 5, 512, 32)])
def test_se_cell_bf16_16_byte_accesses(libs, several_squeeze_blocks, b, h,
                                       w, c, cr):
    """bf16 maps at C ≤ 512 in 16-byte accesses (8 channels a thread):
    bit-identical to the plain version, the rounding points unchanged, in
    both SE forms."""
    g = _gen(c + 3)
    ws, wd = _se_weights(g, c, cr), _se_weights(g, c, cr)
    rgb, depth = _randn(g, b, h, w, c).to(BF), _randn(g, b, h, w, c).to(BF)
    assert se._access_width(c, (rgb, depth)) == 8
    out, ref = _both(libs, se.se_fuse_mixed, rgb, depth,
                     torch.rand(b, generator=g), *ws, *wd)
    assert dict(LAUNCHES) == {"se_fuse_mixed.bf16": 1}
    _bf16_close(out, ref, 0.0)
    out, ref = _both(libs, se.fused_se, _randn(g, b, h * w, c).to(BF), *ws)
    assert dict(LAUNCHES) == {"fused_se.bf16": 1}
    _bf16_close(out, ref, 0.0)


@pytest.mark.parametrize("c,offset", [(44, 0), (12, 0), (64, 8)])
def test_se_cell_bf16_narrow_accesses(libs, several_squeeze_blocks, c,
                                      offset):
    """A bf16 map with C % 8 != 0, or 8 bytes past a 16-byte boundary,
    takes the 8-byte access (4 channels a thread) in the same kernels."""
    g = _gen(c + offset + 5)
    cr = max(1, c // 16)
    ws, wd = _se_weights(g, c, cr), _se_weights(g, c, cr)
    rgb, depth = (_offset(_randn(g, 2, 3, 5, c).to(BF), offset)
                  for _ in range(2))
    assert se._access_width(c, (rgb, depth)) == 4
    args = (rgb, depth, torch.rand(2, generator=g), *ws, *wd)
    out, ref = _both(libs, se.se_fuse_mixed, *args)
    assert dict(LAUNCHES) == {"se_fuse_mixed.bf16": 1}
    _bf16_close(out, ref, 8e-3)
    x = _offset(_randn(g, 2, 15, c).to(BF), offset)
    out, ref = _both(libs, se.fused_se, x, *ws)
    assert dict(LAUNCHES) == {"fused_se.bf16": 1}
    _bf16_close(out, ref, 8e-3)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,h,w,c,cr", [
    (10, 1, 2, 1024, 64),   # two passes of 8 samples in the MLP launch
    (2, 2, 3, 1536, 96),    # three ranges of 32 hidden units
    (3, 1, 3, 2048, 128),   # ResNet50's stage-4 cell
    (2, 2, 2, 1040, 65),    # a ragged last slice, unit range and tile
])
def test_se_cell_mlp_launch(libs, several_squeeze_blocks, dtype, b, h, w, c,
                            cr):
    """From C = SE_SPLIT_C up the MLPs of every sample run in their own
    launch (layer-1 items, then layer-2 items that wait for them): fp32
    within the file's limits, bf16 within 8e-3 of max |plain| (another
    summation order of the MLP may move a scale by one bf16 step), two
    calls bit-identical, every queue counter left at 0; both SE forms."""
    assert c >= se.SE_SPLIT_C
    g = _gen(c + b)
    ws, wd = _se_weights(g, c, cr), _se_weights(g, c, cr)
    rgb = _randn(g, b, h, w, c).to(DTYPES[dtype])
    depth = _randn(g, b, h, w, c).to(DTYPES[dtype])
    args = (rgb, depth, torch.rand(b, generator=g), *ws, *wd)

    def check(fn, *a):
        out, ref = _both(libs, fn, *a)
        assert dict(LAUNCHES) == {fn.__name__ + _suffix(rgb.dtype): 1}
        if rgb.dtype == BF:
            _bf16_close(out, ref, 8e-3)
        else:
            _close(out, ref)
        assert not se._COUNTERS[torch.device("cpu")].any()
        with emulate.emulated(libs):
            assert torch.equal(fn(*a), out)

    check(se.se_fuse_mixed, *args)
    check(se.fused_se, _randn(g, b, h * w, c).to(rgb.dtype), *ws)


SMALL_CFG = ESANetConfig(height=64, width=64, num_classes=5,
                         encoder_rgb="resnet18", encoder_depth="resnet18",
                         channels_decoder=(32, 32, 32),
                         nr_decoder_blocks=(1, 1, 1))


def _small_model(cls=SkipGateESANet):
    model = cls(SMALL_CFG)
    init_weights(model, _gen(0))
    return model.to(memory_format=torch.channels_last).eval()


def _small_launches(ran):
    """Launches of one small-model forward whose depth stages 1-4 ran as
    ``ran`` says. resnet18 has 2, 1, 1 and 1 stride-1 NBt1D blocks in its
    stages at C = 64, 128, 256 and 512, the decoder 3 at C = 32; a block
    is one ``nbt1d_fused`` launch up to ``NBT1D_FUSED_MAX_C`` channels and
    two ``nbt1d_pair`` launches above. Every stage that ran adds its depth
    blocks and one fusion cell (``se_fuse_mixed``); ``channel_sums`` runs
    in the stem cell only."""
    counts = {"nbt1d_fused": 0, "nbt1d_pair": 0, "channel_sums": 1,
              "stem_fuse_pool": 1, "se_fuse_mixed": 0, "learned_upsample": 5}

    def blocks(c, n):
        if c <= nbt1d.NBT1D_FUSED_MAX_C:
            counts["nbt1d_fused"] += n
        else:
            counts["nbt1d_pair"] += 2 * n

    for (c, n), r in zip(((64, 2), (128, 1), (256, 1), (512, 1)), ran):
        blocks(c, n * (1 + int(r)))
        counts["se_fuse_mixed"] += int(r)
    blocks(32, 3)
    return {k: v for k, v in counts.items() if v}


def test_small_model_serves_through_emulated_kernels(libs):
    """Every kernel site of the dense forward, with the launch counts of
    the small config: 13 stride-1 blocks, 7 of them at C ≤ 64."""
    model = _small_model()
    g = _gen(1)
    rgb, depth = _randn(g, 1, 64, 64, 3), _randn(g, 1, 64, 64, 1)
    reset_launches()
    with emulate.emulated(libs):
        class_map, weight = serve(model, rgb, depth, mode="dense")
    assert dict(LAUNCHES) == _small_launches([True] * 4)
    with torch.inference_mode():
        with emulate.emulated(libs):
            logits = model(rgb, depth, hard=True)
        ref, ref_w = model(rgb, depth, hard=True, return_weight=True,
                           use_kernels=False)
    torch.testing.assert_close(weight, ref_w, rtol=0, atol=0)
    torch.testing.assert_close(logits, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
    assert (class_map == ref.argmax(-1)).float().mean() >= 0.999


def test_small_bf16_model_serves_through_emulated_kernels(libs):
    """The bf16 small model through the emulated bf16 forms: no NBt1D
    launch (its blocks run PyTorch convs), the other sites' bf16 forms, and
    the logits of the bf16 plain versions within 2e-2 of max |plain|."""
    import dataclasses

    model = SkipGateESANet(dataclasses.replace(SMALL_CFG, dtype=BF))
    init_weights(model, _gen(0))
    model = model.to(memory_format=torch.channels_last).eval()
    g = _gen(1)
    rgb, depth = _randn(g, 1, 64, 64, 3), _randn(g, 1, 64, 64, 1)
    reset_launches()
    with emulate.emulated(libs):
        class_map, weight = serve(model, rgb, depth, mode="dense")
    assert dict(LAUNCHES) == {
        f"{k}.bf16": v for k, v in _small_launches([True] * 4).items()
        if not k.startswith("nbt1d")}
    with torch.inference_mode():
        with emulate.emulated(libs):
            logits = model(rgb, depth, hard=True)
        ref, ref_w = model(rgb, depth, hard=True, return_weight=True,
                           use_kernels=False)
    assert logits.dtype == BF
    torch.testing.assert_close(weight, ref_w, rtol=0, atol=0)
    _bf16_close(logits, ref, 2e-2)


@pytest.mark.parametrize("mode,paths,ran", [
    ("compact", [0, 3], [True, True, True, False]),
    ("batchmax", [0, 2], [True, True, False, False]),
    ("switch", [4], [True] * 4),
])
def test_small_model_routed_through_emulated_kernels(libs, mode, paths, ran):
    """A routed strategy through the emulated kernels: a depth stage that
    no sample takes launches nothing, and the result is the dense one."""
    model = _small_model(FixedGate)
    model.paths = paths
    g = _gen(2)
    rgb = _randn(g, len(paths), 64, 64, 3)
    depth = _randn(g, len(paths), 64, 64, 1)
    reset_launches()
    with emulate.emulated(libs):
        class_map, weight = serve(model, rgb, depth, mode=mode)
    assert dict(LAUNCHES) == _small_launches(ran)
    with torch.inference_mode():
        with emulate.emulated(libs):
            logits, _ = getattr(model, {
                "compact": "forward_routed_compact",
                "batchmax": "forward_switch_batched",
                "switch": "forward_switch"}[mode])(rgb, depth,
                                                   return_weight=True)
        ref = model(rgb, depth, hard=True, use_kernels=False)
    torch.testing.assert_close(logits, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
    assert (class_map == ref.argmax(-1)).float().mean() >= 0.999


def _variant_launches(kind):
    """Launches of one eval forward of a small variant: both encoders'
    stride-1 blocks (one for the one-modality net), the decoder's, the
    upsamples; the static SE-add net's stem and fusion cells, the plain-add
    nets' stem through ``stem_fuse_pool`` (unit scales), one
    ``channel_sums`` a local gate, five single-map SE cells."""
    if kind == "static-se":
        return _small_launches([True] * 4)
    counts = _small_launches([True] * 4)
    for k in ("channel_sums", "se_fuse_mixed"):
        counts.pop(k)
    if kind == "local":
        counts["channel_sums"] = 4
    if kind == "rgb-se":
        one = _small_launches([False] * 4)
        counts = {k: one[k] for k in ("nbt1d_fused", "nbt1d_pair",
                                      "learned_upsample")}
        counts["fused_se"] = 5
    return counts


@pytest.mark.parametrize("kind", ["static-se", "static-add", "local",
                                  "rgb-se"])
def test_variants_serve_through_emulated_kernels(libs, kind):
    """The static ESANet (SE-add and add), the local-gate SkipESANet and
    the one-modality net with SE through the emulated kernels: the launches
    of their kernel sites, logits equal to the plain path's within 1e-5."""
    from dynmm_tpu_torch.models.esanet import ESANet
    from dynmm_tpu_torch.models.one_modality import ESANetOneModality
    from dynmm_tpu_torch.models.skip_local import SkipESANet

    import dataclasses

    cfg = dataclasses.replace(SMALL_CFG, fuse_depth_in_rgb_encoder=(
        "SE-add" if kind in ("static-se", "rgb-se") else "add"))
    model = {"static-se": ESANet, "static-add": ESANet,
             "local": lambda c: SkipESANet(c, block_rule=(1, 1, 2, 2)),
             "rgb-se": lambda c: ESANetOneModality(c, 3, "SE-add")}[kind](cfg)
    init_weights(model, _gen(3))
    model = model.to(memory_format=torch.channels_last).eval()
    g = _gen(4)
    rgb, depth = _randn(g, 1, 64, 64, 3), _randn(g, 1, 64, 64, 1)
    kw = {"test": True, "return_weights": True} if kind == "local" else {}

    def run(use_kernels):
        args = ((rgb,) if kind == "rgb-se" else (rgb, depth)) + (
            (torch.Generator().manual_seed(0),) if kind == "local" else ())
        with torch.inference_mode():
            return model(*args, use_kernels=use_kernels, **kw)

    reset_launches()
    with emulate.emulated(libs):
        out = run(True)
    assert dict(LAUNCHES) == _variant_launches(kind)
    ref = run(False)
    if kind == "local":
        (out, ws), (ref, ws_ref) = out, ref
        for w, w_ref in zip(ws, ws_ref):
            torch.testing.assert_close(w, w_ref, rtol=0, atol=0)
    _close(out, ref)
