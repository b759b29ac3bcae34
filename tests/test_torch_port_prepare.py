"""The port's dataset converters (``dynmm_tpu_torch/data/prepare_*.py``)
against the JAX package's (``dynmm_tpu/data/prepare_*.py``).

* On the synthetic raw trees of the JAX package's own tests
  (``tests/test_prepare_converters.py``, ``tests/test_datasets.py``), both
  converters write the same files: every PNG's array (read by OpenCV), every
  ``.npy`` array and every list equal.
* On the committed fixtures (``tests/fixtures_torch_prepare/``: a MATLAB
  v7.3 NYUv2 file at 640x480 with a user block and chunked, deflated
  datasets; SUN RGB-D's ``SUNRGBD2Dseg.mat`` references and its JPEGs), the
  port's files equal what the JAX converter wrote there (``expected.npz``),
  as ``chip_smoke.py`` phase 21 checks them on the card.
* The CLIs run as ``python -m dynmm_tpu_torch.data.prepare_*``.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
pytest.importorskip("h5py")

import _torch_prepare_raw as raw  # noqa: E402
from dynmm_tpu.data import prepare_cityscapes as jcity  # noqa: E402
from dynmm_tpu.data import prepare_nyuv2 as jnyu  # noqa: E402
from dynmm_tpu.data import prepare_scenenet as jscene  # noqa: E402
from dynmm_tpu.data import prepare_sunrgbd as jsun  # noqa: E402
from dynmm_tpu_torch.data import png  # noqa: E402
from dynmm_tpu_torch.data import prepare_cityscapes as pcity  # noqa: E402
from dynmm_tpu_torch.data import prepare_nyuv2 as pnyu  # noqa: E402
from dynmm_tpu_torch.data import prepare_scenenet as pscene  # noqa: E402
from dynmm_tpu_torch.data import prepare_sunrgbd as psun  # noqa: E402
from tests.test_datasets import make_fake_nyu_mat  # noqa: E402
from tests.test_prepare_converters import (_make_cityscapes_raw,  # noqa: E402
                                           _make_scenenet_raw,
                                           _make_sunrgbd_raw)

REPO = Path(__file__).resolve().parents[1]
PORTS = {"nyuv2": pnyu, "sunrgbd": psun, "cityscapes": pcity,
         "scenenet": pscene}


def cv2_read(path: str) -> np.ndarray:
    """The PNG's array as OpenCV reads it, colour in RGB order."""
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return img[..., ::-1].copy() if img.ndim == 3 else img


def both(tmp_path, jax_convert, port_convert, *args, **kw):
    """Run both converters on the same inputs; assert equal outputs and
    return the written map."""
    jax_convert(str(tmp_path / "jax"), *args, **kw)
    port_convert(str(tmp_path / "port"), *args, **kw)
    want = raw.written(tmp_path / "jax", cv2_read)
    got = raw.written(tmp_path / "port", cv2_read)
    assert want and raw.differences(got, want) == []
    return got


def test_nyuv2_matches_jax(tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    make_fake_nyu_mat(src)
    got = both(tmp_path, jnyu.convert, pnyu.convert,
               str(src / "nyu_depth_v2_labeled.mat"), str(src / "splits.mat"),
               str(src / "classMapping40.mat"))
    assert str(got["train.txt"]) == "0000\n0002\n"
    assert got["train/rgb/0000.png"].shape == (24, 32, 3)
    np.testing.assert_array_equal(pnyu.MAP_40_TO_13, jnyu.MAP_40_TO_13)


def test_nyuv2_class13_mat_matches_jax(tmp_path):
    from scipy.io import savemat

    src = tmp_path / "in"
    src.mkdir()
    make_fake_nyu_mat(src, n=3, h=8, w=12)
    table = (np.arange(40) * 7 % 13 + 1).astype(np.uint8)
    savemat(src / "class13.mat",
            {"classMapping13": {"classMapping": table[None, :]}})
    both(tmp_path, jnyu.convert, pnyu.convert,
         str(src / "nyu_depth_v2_labeled.mat"), str(src / "splits.mat"),
         str(src / "classMapping40.mat"), str(src / "class13.mat"))


def test_sunrgbd_matches_jax(tmp_path):
    toolbox, data, _ = _make_sunrgbd_raw(tmp_path / "in")
    got = both(tmp_path, jsun.convert, psun.convert, str(toolbox), str(data))
    assert str(got["train_cameras.txt"]) == "kv1\nkv2\n"
    assert got["test/rgb/00002.png"].shape == (12, 16, 3)


def test_cityscapes_matches_jax(tmp_path):
    root, _ = _make_cityscapes_raw(tmp_path / "in")
    got = both(tmp_path, jcity.convert, pcity.convert, str(root))
    assert got["train/depth_raw/city_000000_000019.npy"].dtype == np.float16
    assert set(k.split("/")[0] for k in got) >= {"train", "valid", "test"}
    np.testing.assert_array_equal(pcity.CLASS_MAPPING_REDUCED,
                                  jcity.CLASS_MAPPING_REDUCED)


@pytest.mark.parametrize("n_views,min_classes", [(2, -1), (1, -1), (2, 4)])
def test_scenenet_matches_jax(tmp_path, n_views, min_classes):
    root, _ = _make_scenenet_raw(tmp_path / "in")
    kw = dict(n_views_train=n_views, n_views_test=n_views,
              min_classes_in_view=min_classes)
    counts = jscene.convert(str(tmp_path / "jax"), str(root), **kw)
    assert pscene.convert(str(tmp_path / "port"), str(root), **kw) == counts
    want = raw.written(tmp_path / "jax", cv2_read)
    assert raw.differences(raw.written(tmp_path / "port", cv2_read),
                           want) == []
    assert pscene.WNID_TO_NYU13 == jscene.WNID_TO_NYU13
    payload = (root / "scenenet_rgbd_train_0.pb").read_bytes()
    assert pscene.parse_trajectories(payload) == [
        pscene.Trajectory(t.render_path,
                          [pscene.Instance(**vars(i)) for i in t.instances],
                          [pscene.View(**vars(v)) for v in t.views])
        for t in jscene.parse_trajectories(payload)]


def test_missing_raw_png_raises_naming_it(tmp_path):
    root, _ = _make_cityscapes_raw(tmp_path / "in")
    victim = next((root / "disparity").rglob("*.png"))
    victim.unlink()
    victim.mkdir()  # exists, but is no PNG
    with pytest.raises((IsADirectoryError, ValueError), match=victim.name):
        pcity.convert(str(tmp_path / "port"), str(root))


@pytest.mark.parametrize("kind", sorted(raw.BUILDERS))
def test_fixture_outputs_equal_jax(tmp_path, kind):
    """The port's converter on the fixture's raw tree writes what the JAX
    converter wrote there, read by the port's PNG codec (as on the card)
    and by OpenCV."""
    kw = raw.BUILDERS[kind](tmp_path / "in")
    PORTS[kind].convert(str(tmp_path / "out"), **kw)
    want = raw.expected(kind)
    for read in (png.read, cv2_read):
        got = raw.written(tmp_path / "out", read)
        assert raw.differences(got, want) == []
    if kind == "nyuv2":
        assert want["train/rgb/0000.png"].shape == (480, 640, 3)


def test_fixtures_are_small():
    size = sum(p.stat().st_size for p in raw.FIXTURES.rglob("*")
               if p.is_file())
    assert size < 1_000_000


@pytest.mark.parametrize("kind", sorted(raw.BUILDERS))
def test_cli_runs_as_module(tmp_path, kind):
    kw = raw.BUILDERS[kind](tmp_path / "in")
    out = str(tmp_path / "out")
    argv = {"nyuv2": [out, "--mat", kw.get("mat_path", ""),
                      "--splits", kw.get("splits_path", ""),
                      "--class-mapping", kw.get("mapping_path", "")],
            "sunrgbd": [out, "--toolbox-dir", kw.get("toolbox_dir", ""),
                        "--data-dir", kw.get("data_dir", "")],
            "cityscapes": [out, kw.get("cityscapes_dir", "")],
            "scenenet": [out, "--scenenet-dir", kw.get("scenenet_dir", ""),
                         "--n-random-views-to-include-train", "2",
                         "--n-random-views-to-include-valid", "2"]}[kind]
    proc = subprocess.run(
        [sys.executable, "-m", f"dynmm_tpu_torch.data.prepare_{kind}", *argv],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = raw.written(tmp_path / "out", png.read)
    assert raw.differences(got, raw.expected(kind)) == []
