"""Each kernel module of the port against its JAX counterpart.

On the CPU a wrapper takes its plain PyTorch version (the CUDA kernels are
held against those plain versions on the card by ``chip_smoke.py``). Here
the plain versions meet the JAX Pallas kernels, run in interpret mode as the
JAX package's own tests run them, and the JAX oracles, on the same numpy
inputs, at rtol/atol 1e-5 in fp32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynmm_tpu.kernels import nbt1d as jnbt
from dynmm_tpu.kernels import se as jse
from dynmm_tpu.kernels import stem_fuse as jstem
from dynmm_tpu.kernels import upsample as jup
from dynmm_tpu_torch.kernels import LAUNCHES, _build, reset_launches
from dynmm_tpu_torch.kernels import nbt1d, se, stem_fuse, upsample

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **(tol or TOL))


# ---------------------------------------------------------------- nbt1d
def _nbt1d_params(rng, c):
    """Taps, biases and a folded BN with non-trivial statistics, so the
    boundary masks (relu(bias) vs 0 outside the image) matter."""
    out = []
    for _ in range(2):
        w_row, b_row = _np(rng, 3, c, c, scale=0.2), _np(rng, c, scale=0.5)
        w_col, b_col = _np(rng, 3, c, c, scale=0.2), _np(rng, c, scale=0.5)
        gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
        beta, mean = _np(rng, c, scale=0.2), _np(rng, c, scale=0.2)
        var = rng.uniform(0.5, 1.5, c).astype(np.float32)
        s, t = jnbt.fold_bn(gamma, beta, mean, var)
        out += [w_row, b_row, w_col, b_col, np.array(s), np.array(t)]
    return out


@pytest.mark.parametrize("n,h,w,c", [(2, 12, 10, 8), (1, 8, 6, 16)])
def test_nbt1d_block_matches_pallas_and_oracle(n, h, w, c):
    rng = np.random.default_rng(h * w + c)
    x = _np(rng, n, h, w, c)
    params = _nbt1d_params(rng, c)
    port = nbt1d.nbt1d_block(torch.from_numpy(x),
                             *map(torch.from_numpy, params))
    jp = [jnp.asarray(p) for p in params]
    _close(port, jnbt.fused_nbt1d_twopass(jnp.asarray(x), *jp,
                                          interpret=True))
    _close(port, jnbt.reference_nbt1d(jnp.asarray(x), *jp))


@pytest.mark.parametrize("shape", [(2, 12, 10, 8), (2, 30, 40, 16),
                                   (2, 8, 6, 4), (1, 6, 18, 8), (5, 7, 4)])
def test_nbt1d_fused_matches_pallas_and_oracle(shape):
    """The one-launch block (W = 18: not a multiple of 16; (H, W, C): the
    unbatched form) against the mono Pallas kernel and the oracle."""
    rng = np.random.default_rng(sum(shape))
    x = _np(rng, *shape)
    params = _nbt1d_params(rng, shape[-1])
    port = nbt1d.nbt1d_fused(torch.from_numpy(x),
                             *map(torch.from_numpy, params))
    assert port.shape == x.shape
    jp = [jnp.asarray(p) for p in params]
    _close(port, jnbt.fused_nbt1d(jnp.asarray(x), *jp, interpret=True))
    _close(port, jnbt.reference_nbt1d(jnp.asarray(x), *jp))


@pytest.mark.parametrize("max_c", [16, 8])
def test_nbt1d_block_dispatch_either_side(monkeypatch, max_c):
    """``nbt1d_block`` gives the oracle's block whether its channel count
    is at the one-launch limit (fused) or over it (two pairs)."""
    monkeypatch.setattr(nbt1d, "NBT1D_FUSED_MAX_C", max_c)
    rng = np.random.default_rng(max_c)
    x = _np(rng, 2, 6, 9, 16)
    params = _nbt1d_params(rng, 16)
    reset_launches()
    port = nbt1d.nbt1d_block(torch.from_numpy(x),
                             *map(torch.from_numpy, params))
    assert sum(LAUNCHES.values()) == 0  # CPU tensors: plain versions
    _close(port, jnbt.reference_nbt1d(jnp.asarray(x),
                                      *map(jnp.asarray, params)))


def test_nbt1d_pair_forms():
    """Pair 1 (relu after the affine) and pair 2 (+identity, relu) against
    the JAX pair kernel's two flag combinations."""
    rng = np.random.default_rng(3)
    x, idn = _np(rng, 2, 6, 9, 8), _np(rng, 2, 6, 9, 8)
    p = _nbt1d_params(rng, 8)[:6]
    tp = list(map(torch.from_numpy, p))
    jp = [jnp.asarray(a) for a in p]
    _close(nbt1d.nbt1d_pair(torch.from_numpy(x), *tp),
           jnbt._run_pair(jnp.asarray(x), None, *jp, add_identity=False,
                          final_relu=False, relu_after_affine=True,
                          interpret=True))
    _close(nbt1d.nbt1d_pair(torch.from_numpy(x), *tp,
                            identity=torch.from_numpy(idn)),
           jnbt._run_pair(jnp.asarray(x), jnp.asarray(idn), *jp,
                          add_identity=True, final_relu=True,
                          relu_after_affine=False, interpret=True))


def test_fold_bn_matches_jax():
    rng = np.random.default_rng(4)
    gamma, beta, mean = (_np(rng, 16) for _ in range(3))
    var = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    s, t = nbt1d.fold_bn(*map(torch.from_numpy, (gamma, beta, mean, var)))
    js, jt = jnbt.fold_bn(gamma, beta, mean, var)
    _close(s, js, rtol=1e-6, atol=1e-7)
    _close(t, jt, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ stem cell
def _stem_inputs(seed, b=2, h=16, w=24, c=64):
    rng = np.random.default_rng(seed)
    rgb, depth = _np(rng, b, h, w, c), _np(rng, b, h, w, c)
    ws = []
    for _ in range(2):
        ws += [_np(rng, c, c // 16, scale=0.2), _np(rng, c // 16),
               _np(rng, c // 16, c, scale=0.2), _np(rng, c)]
    return rgb, depth, ws


def test_channel_sums_matches_pallas():
    rgb, depth, _ = _stem_inputs(0)
    sr, sd = se.channel_sums(torch.from_numpy(rgb), torch.from_numpy(depth))
    jr, jd = jstem.channel_sums(jnp.asarray(rgb), jnp.asarray(depth),
                                tile_rows=4, interpret=True)
    _close(sr, jr)
    _close(sd, jd)


@pytest.mark.parametrize("negative", [False, True])
def test_stem_cell_matches_pallas_and_oracle(negative):
    rgb, depth, ws = _stem_inputs(5 if negative else 1)
    if negative:  # max-pool padding must never win: −inf, not 0
        rgb, depth = -np.abs(rgb) - 1.0, -np.abs(depth) - 1.0
    port = stem_fuse.stem_se_fusion_pool(
        torch.from_numpy(rgb), torch.from_numpy(depth),
        *map(torch.from_numpy, ws))
    jargs = [jnp.asarray(a) for a in (rgb, depth, *ws)]
    pallas = jstem.stem_se_fusion_pool(*jargs, interpret=True)
    oracle = jstem.reference_stem_fusion(*jargs)
    for p, a, o in zip(port, pallas, oracle):
        assert p.shape == (2, 8, 12, 64)
        _close(p, a)
        _close(p, o)


def test_stem_fuse_pool_matches_pallas_pass():
    rgb, depth, _ = _stem_inputs(2, h=20, w=16)
    rng = np.random.default_rng(9)
    s_r = rng.uniform(0, 1, (2, 64)).astype(np.float32)
    s_d = rng.uniform(0, 1, (2, 64)).astype(np.float32)
    port = stem_fuse.stem_fuse_pool(*map(torch.from_numpy,
                                         (rgb, depth, s_r, s_d)))
    pallas = jstem.fused_stem_fusion(*map(jnp.asarray, (rgb, depth, s_r, s_d)),
                                     interpret=True)
    for p, a in zip(port, pallas):
        _close(p, a)


def test_se_gate_from_sums_matches_jax():
    rgb, _, ws = _stem_inputs(3)
    sums = rgb.sum(axis=(1, 2))
    port = stem_fuse.se_gate_from_sums(torch.from_numpy(sums), 16 * 24,
                                       *map(torch.from_numpy, ws[:4]))
    _close(port, jstem.se_gate_from_sums(jnp.asarray(sums), 16 * 24,
                                         *map(jnp.asarray, ws[:4])))


# ------------------------------------------------------------- upsample
@pytest.mark.parametrize("shape", [(15, 20, 8), (2, 6, 8, 40), (2, 5, 3, 4)])
def test_learned_upsample_matches_pallas_and_oracle(shape):
    rng = np.random.default_rng(len(shape) + shape[-1])
    c = shape[-1]
    x, k, b = _np(rng, *shape), _np(rng, 3, 3, c), _np(rng, c)
    port = upsample.learned_upsample(*map(torch.from_numpy, (x, k, b)))
    assert port.shape[-3:] == (2 * shape[-3], 2 * shape[-2], c)
    jx, jk, jb = map(jnp.asarray, (x, k, b))
    _close(port, jup.fused_learned_upsample(jx, jk, jb, interpret=True))
    _close(port, jup.reference_learned_upsample(jx, jk, jb))


# -------------------------------------------------------------------- se
def _se_weights(rng, c, cr):
    return [_np(rng, c, cr, scale=0.3), _np(rng, cr), _np(rng, cr, c, scale=0.3),
            _np(rng, c)]


@pytest.mark.parametrize("shape", [(128, 64), (3, 64, 32)])
def test_fused_se_matches_pallas_and_oracle(shape):
    rng = np.random.default_rng(shape[-1])
    x = _np(rng, *shape)
    ws = _se_weights(rng, shape[-1], 4)
    port = se.fused_se(torch.from_numpy(x), *map(torch.from_numpy, ws))
    jargs = list(map(jnp.asarray, (x, *ws)))
    _close(port, jse.fused_se(*jargs, interpret=True))
    _close(port, jse.se_reference(*jargs))


def test_se_fuse_mixed_matches_jax_fusion_cell():
    """The two-map mixed form against the JAX fusion cell's algebra:
    ``w·rgb + (1−w)·(se(rgb) + se(depth))`` through ``se_reference``."""
    rng = np.random.default_rng(7)
    b, h, w, c = 3, 6, 5, 32
    rgb, depth = _np(rng, b, h, w, c), _np(rng, b, h, w, c)
    wr, wd = _se_weights(rng, c, 2), _se_weights(rng, c, 2)
    w_rgb = np.array([0.0, 0.3, 1.0], np.float32)
    port = se.se_fuse_mixed(*map(torch.from_numpy, (rgb, depth, w_rgb)),
                            *map(torch.from_numpy, wr + wd))
    flat = lambda a: jnp.asarray(a.reshape(b, h * w, c))
    fused = (jse.se_reference(flat(rgb), *map(jnp.asarray, wr))
             + jse.se_reference(flat(depth), *map(jnp.asarray, wd)))
    wv = w_rgb[:, None, None]
    ref = wv * flat(rgb) + (1.0 - wv) * fused
    _close(port, np.asarray(ref).reshape(b, h, w, c))


# ------------------------------------------------------------- wrappers
def test_cpu_path_counts_no_launch():
    reset_launches()
    x = torch.randn(1, 4, 4, 8)
    upsample.learned_upsample(x, torch.randn(3, 3, 8), torch.randn(8))
    se.channel_sums(x, x)
    assert sum(LAUNCHES.values()) == 0


def test_wrapper_never_falls_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on the card raises instead of
    taking the plain version."""
    x = torch.empty(1, 4, 4, 8, device="meta")
    with pytest.raises(ValueError):
        upsample.learned_upsample(x, torch.empty(3, 3, 8, device="meta"),
                                  torch.empty(8, device="meta"))
    taps, vec = torch.empty(3, 8, 8, device="meta"), torch.empty(8, device="meta")
    with pytest.raises(ValueError):
        nbt1d.nbt1d_fused(x, *([taps, vec, taps, vec, vec, vec] * 2))
    with pytest.raises(ValueError):
        nbt1d.nbt1d_block(x, *([taps, vec, taps, vec, vec, vec] * 2))
    with pytest.raises(ValueError):
        _build.on_card(torch.empty(2), x)


def test_build_dir_is_keyed_by_sources():
    d = _build.build_dir()
    assert d.parent == _build.BUILD_ROOT and len(d.name) == 16
    assert d == _build.build_dir()
    assert {f.stem for f in _build.CSRC.glob("*.cu")} == set(_build.SOURCES)
