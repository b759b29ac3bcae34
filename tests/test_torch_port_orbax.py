"""The port's orbax checkpoints (``dynmm_tpu_torch/utils/orbax.py``, the zstd
decoder of ``native/zstd.cpp``) against the JAX package's ``save_orbax`` /
``load_orbax`` (orbax 0.11, tensorstore) on the CPU.

* JAX ``save_orbax`` → port ``load_orbax``, leaf by leaf bit-equal, dtypes
  kept: the plain tree of ``test_aux_subsystems.py``; a small
  SkipGateESANet trainer state (fp32 params and statistics, a bf16 momentum
  trace, int32 counters); the fp32 trainer state sharded over a (4, 2)
  mesh of 8 CPU devices (arrays in several chunks). The weights load into
  the port model with ``load_state_dict(strict=True)``, and its logits lie
  within the port's fp32 tolerance of JAX's (1e-4 of max |JAX|), gate
  weights equal.
* Port ``save_orbax`` → JAX ``load_orbax``, without a target and onto a
  target sharded over the mesh (shardings kept): bit-equal.
* A port round trip, and a restore onto the port's (1, 2) mesh that reads
  on each rank only the chunks of its 'model' slices, from JAX's mesh save
  and from the port's own mesh save (one chunk per slice).
* The zstd decoder against ``zstandard`` (hypothesis-drawn inputs at
  several levels, with and without checksums) and against every frame
  tensorstore wrote; corrupt frames raise.
* The committed fixture ``tests/fixtures_torch_orbax/`` (what
  ``chip_smoke.py`` decodes on the card) decodes to its expected values,
  and its generator reproduces them.
"""

import pathlib
import struct

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import zstandard
from hypothesis import given, settings, strategies as st
from jax.sharding import NamedSharding

import _make_torch_orbax_fixture as fixture_gen
import _port_mesh_setup as ms
from _port_train_setup import (SMALL, batches, compile_fast, jax_model,
                               random_variables)
from _port_train_setup import one_torch_thread  # noqa: F401 (autouse)
from dynmm_tpu.parallel import make_mesh, replicate, shard_params
from dynmm_tpu.train.seg import SegTrainConfig as JaxTrainConfig
from dynmm_tpu.train.seg import make_seg_optimizer as jax_optimizer
from dynmm_tpu.utils import checkpoint as jax_ckpt
from dynmm_tpu_torch import native
from dynmm_tpu_torch.models.esanet import ESANetConfig
from dynmm_tpu_torch.models.skip_gate import SkipGateESANet
from dynmm_tpu_torch.parallel.launch import run_ranks
from dynmm_tpu_torch.train.seg import SegTrainConfig, SegTrainer
from dynmm_tpu_torch.utils.checkpoint import load_orbax, save_orbax
from dynmm_tpu_torch.utils.msgpack import msgpack_restore
from dynmm_tpu_torch.utils.orbax import OrbaxArray, OrbaxCheckpoint, zstd_frame
from dynmm_tpu_torch.utils.weights import flax_leaf, load_flax_variables

FP32_TOL = 1e-4  # of max |JAX logits| (tests/_port_export_setup.py)
MIN_OUT = 256  # both packages' default 'model' split rule


def flat(tree, path=()) -> dict:
    """{path: leaf} of a restored tree: dicts and sequences by key (flax's
    state dict), empty nodes (optax's EmptyState, None, {}) as {}."""
    if tree is None or (isinstance(tree, (dict, tuple, list)) and not tree):
        return {path: {}}
    if hasattr(tree, "_fields"):  # a NamedTuple
        tree = tree._asdict() if tree._fields else {}
        return flat(tree, path) if tree else {path: {}}
    if isinstance(tree, (tuple, list)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, path + (str(k),)))
        return out
    return {path: tree}


def bits(leaf) -> np.ndarray:
    """A leaf's values as numpy, bfloat16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        return leaf.view(torch.int16).numpy().view(np.uint16)
    arr = np.asarray(leaf)
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr


def assert_same_leaves(got, want) -> None:
    """Bit-equal leaves, the same dtypes and shapes, the same paths."""
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        if isinstance(w, dict):
            assert g == {}, path
            continue
        w_dtype = np.asarray(w).dtype.name if not isinstance(
            w, torch.Tensor) else str(w.dtype).split(".")[-1]
        g_dtype = (str(g.dtype).split(".")[-1] if isinstance(g, torch.Tensor)
                   else np.asarray(g).dtype.name)
        assert g_dtype == w_dtype, (path, g_dtype, w_dtype)
        np.testing.assert_array_equal(bits(g), bits(w), err_msg=str(path))


@pytest.fixture(scope="module")
def variables():
    return random_variables(0)


def jax_trainer_state(variables, bf16_trace=False) -> dict:
    """The JAX trainer's state (``SegTrainer.init_state``'s layout) over
    ``variables``: SGD (nesterov momentum, optax's trace), its trace in
    bfloat16 under ``bf16_trace``."""
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    cfg = JaxTrainConfig(epochs=1, lr=0.01)
    if bf16_trace:
        tx = optax.inject_hyperparams(lambda learning_rate: optax.chain(
            optax.add_decayed_weights(cfg.weight_decay),
            optax.sgd(learning_rate, momentum=cfg.momentum, nesterov=True,
                      accumulator_dtype=jnp.bfloat16)))(learning_rate=cfg.lr)
    else:
        tx = jax_optimizer(cfg, params)
    opt = tx.init(params)
    # a moved trace (init's is zeros) and count
    opt = jax.tree_util.tree_map(
        lambda a: (a + 0.5 * jnp.ones_like(a) if jnp.issubdtype(
            a.dtype, jnp.floating) else a + 3), opt)
    return {"params": params,
            "model_state": {"batch_stats": variables["batch_stats"]},
            "opt_state": opt}


def jax_mesh_state(state: dict, mesh) -> dict:
    """``state`` placed as the JAX trainer places it on ``mesh``."""
    return {"params": shard_params(state["params"], mesh, MIN_OUT),
            "model_state": replicate(state["model_state"], mesh),
            "opt_state": shard_params(state["opt_state"], mesh, MIN_OUT)}


@pytest.fixture(scope="module")
def saved(variables, tmp_path_factory):
    """JAX orbax saves: {case: (path, the JAX state saved, epoch)}."""
    root = tmp_path_factory.mktemp("orbax")
    mesh = make_mesh(4, 2)
    states = {
        "plain": ({"params": {"w": jnp.arange(6.0).reshape(2, 3)}}, 7),
        "trainer": (jax_trainer_state(variables, bf16_trace=True), 3),
        "mesh": (jax_mesh_state(jax_trainer_state(variables), mesh), 4),
    }
    return {case: (jax_ckpt.save_orbax(str(root / case), state, epoch=epoch),
                   state, epoch)
            for case, (state, epoch) in states.items()}


@pytest.fixture(scope="module")
def logits(variables):
    """The JAX model's eval logits and gate weights on a test batch, and
    the batch."""
    batch = batches(1, "test")[0]
    apply = jax.jit(lambda v, r, d: jax_model().apply(
        v, r, d, train=False, hard=True, return_weight=True))
    call = (variables, jnp.asarray(batch["image"]), jnp.asarray(batch["depth"]))
    out, w = compile_fast(apply, *call)(*call)
    return np.asarray(out), np.asarray(w), batch


def port_logits(params, batch_stats, batch):
    model = SkipGateESANet(ESANetConfig(**SMALL))
    load_flax_variables(model, {"params": params, "batch_stats": batch_stats})
    model.eval()
    with torch.no_grad():
        out, w = model(torch.from_numpy(batch["image"]),
                       torch.from_numpy(batch["depth"]), hard=True,
                       return_weight=True)
    return out.numpy(), w.numpy()


@pytest.mark.parametrize("case", ["plain", "trainer", "mesh"])
def test_jax_save_loads_exactly(saved, logits, case):
    path, state, epoch = saved[case]
    got = load_orbax(path)
    assert got["epoch"] == epoch and isinstance(got["epoch"], int)
    assert_same_leaves(got["state"], state)
    if case == "mesh":  # a shard a chunk
        assert max(len(a.chunk_keys()) for a in _arrays(path).values()) > 1
    if case == "plain":
        return
    s = got["state"]
    assert s["opt_state"]["count"].dtype == np.int32
    trace = s["opt_state"]["inner_state"]["1"]["0"]["trace"]
    leaf = trace["decoder"]["conv_out"]["kernel"]
    assert (leaf.dtype == torch.bfloat16) == (case == "trainer")
    ref, ref_w, batch = logits
    out, w = port_logits(s["params"], s["model_state"]["batch_stats"], batch)
    np.testing.assert_array_equal(w, ref_w)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=FP32_TOL * np.abs(ref).max())


def _arrays(path) -> dict:
    ckpt = OrbaxCheckpoint(path)
    return {".".join(p): a for p, a in flat(ckpt.tree()).items()
            if isinstance(a, OrbaxArray)}


def port_state(variables):
    model = SkipGateESANet(ESANetConfig(**SMALL))
    load_flax_variables(model, variables)
    trainer = SegTrainer(model, SegTrainConfig(epochs=1, lr=0.01),
                         np.ones(5, np.float32), device="cpu")
    return trainer.init_state()


@pytest.mark.parametrize("target", ["none", "sharded"])
def test_port_save_loads_in_jax(saved, variables, tmp_path, target):
    """The JAX mesh save restored into the port's trainer state, which
    ``save_orbax`` writes; JAX restores it equal to the state JAX saved."""
    path, state, epoch = saved["mesh"]
    port = port_state(random_variables(1))
    assert load_orbax(path, target=port)["state"] is port
    out = save_orbax(str(tmp_path / "port"), port, epoch=epoch)
    if target == "none":
        got = jax_ckpt.load_orbax(out)
    else:
        got = jax_ckpt.load_orbax(out, target=state)
        for (p, g), (_, w) in zip(
                jax.tree_util.tree_leaves_with_path(got["state"]),
                jax.tree_util.tree_leaves_with_path(state)):
            assert isinstance(g, jax.Array) and isinstance(
                g.sharding, NamedSharding), p
            assert g.sharding.is_equivalent_to(w.sharding, w.ndim), p
    assert int(got["epoch"]) == epoch
    assert_same_leaves(got["state"], state)


def test_port_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    state = {"w": rng.standard_normal((3, 5)).astype(np.float32),
             "b": torch.randn(7, generator=torch.Generator().manual_seed(0)
                              ).to(torch.bfloat16),
             "big": rng.standard_normal((64, 300)),
             "n": np.asarray(4, np.int32), "k": np.arange(5, dtype=np.int64),
             "u": rng.integers(0, 255, (4, 4), dtype=np.uint8),
             "mask": rng.random(9) > 0.5, "empty": {},
             "seq": {"0": {}, "1": {"0": np.float32(2.0) * np.ones(2)}}}
    path = save_orbax(str(tmp_path / "ck"), state, epoch=2)
    got = load_orbax(path)
    assert got["epoch"] == 2
    assert_same_leaves(got["state"], state)
    assert _arrays(path)["state.big"].chunks == (64, 300)  # one chunk


def test_restore_on_port_mesh_reads_own_chunks(saved, variables, tmp_path):
    """Two ranks on a (1, 2) mesh restore JAX's mesh save: each reads of a
    split weight and its trace only the chunks of its 'model' slice (and
    every chunk of the rest), and holds that slice. ``save_orbax`` under
    the mesh writes one chunk per slice along the split axis, which the
    ranks restore reading their own chunks again; JAX reads it equal."""
    path, state, epoch = saved["mesh"]
    out = str(tmp_path / "port_mesh")
    ranks = run_ranks(ms.orbax_on_mesh, 2, (SMALL, random_variables(1), path,
                                            out, (1, 2), MIN_OUT),
                      device="cpu", timeout=300)
    n_model, split = ranks[0]["shards"]
    assert n_model == 2 and len(split) > 10
    want = flat(jax.tree_util.tree_map(np.asarray, state))
    for src, i in ((path, 0), (out, 1)):
        arrays = _arrays(src)
        for r in ranks:
            m = r["model_index"]
            expect = {"epoch/0"}  # a scalar, read with the tree
            every = {k for a in arrays.values() for k in a.chunk_keys()}
            for name, a in arrays.items():
                if any(name.endswith(".".join(p)) for p in split):
                    k = a.shape[-1] // 2
                    expect.update(a.chunk_keys(
                        (..., slice(m * k, (m + 1) * k))))
                else:
                    expect.update(a.chunk_keys())
            assert set(r["reads"][i]["read"]) == expect
            assert len(every - expect) > 10  # the other slices' chunks
            if src == out:  # one chunk per slice of a split leaf
                assert all(a.chunks[-1] == a.shape[-1] // 2
                           for name, a in arrays.items()
                           if any(name.endswith(".".join(p)) for p in split))
            got = r["reads"][i]
            assert len(got["slices"]) == len(split)
            for name, local in got["slices"].items():
                p = flax_leaf(name, local.ndim)[0]
                for tree, have in ((("params",), local), (
                        ("opt_state", "inner_state", "1", "0", "trace"),
                        got["momenta"][name])):
                    full = want[tree + p]
                    k = full.shape[-1] // 2
                    np.testing.assert_array_equal(
                        _flax_layout(have), full[..., m * k:(m + 1) * k])
    assert_same_leaves(jax_ckpt.load_orbax(out)["state"], state)


def _flax_layout(t: np.ndarray) -> np.ndarray:
    """A torch weight in flax's layout (OIHW → HWIO, (out, in) → (in,
    out))."""
    return t.transpose(2, 3, 1, 0) if t.ndim == 4 else t.T


# ------------------------------------------------------------------- zstd
@settings(max_examples=150, deadline=None)
@given(data=st.one_of(
    st.binary(max_size=3000),
    st.lists(st.sampled_from([b"ab", b"orbax", b"\0" * 9, b"xyz" * 40]),
             max_size=400).map(b"".join),
    st.integers(0, 2 ** 32 - 1).map(lambda s: np.random.default_rng(
        s).standard_normal(3000).astype(np.float32).tobytes())),
    level=st.sampled_from([-5, 1, 3, 9, 19]), checksum=st.booleans(),
    content_size=st.booleans())
def test_zstd_matches_zstandard(data, level, checksum, content_size):
    frame = zstandard.ZstdCompressor(
        level=level, write_checksum=checksum,
        write_content_size=content_size).compress(data)
    assert native.zstd_decompress(frame).tobytes() == data
    assert native.zstd_decompress(frame, len(data)).tobytes() == data
    assert native.zstd_decompress(zstd_frame(data)).tobytes() == data


def test_zstd_tensorstore_frames(saved):
    """Every zarr chunk and OCDBT file tensorstore wrote decodes as
    ``zstandard`` decodes it."""
    n = 0
    for case in ("trainer", "mesh"):
        ckpt = OrbaxCheckpoint(saved[case][0])
        for key in ckpt.store.values:
            if key.endswith(b".zarray"):
                continue
            frame = ckpt.store.get(key.decode())
            want = zstandard.ZstdDecompressor().decompressobj().decompress(
                frame)
            assert native.zstd_decompress(frame).tobytes() == want, key
            n += 1
        for f in pathlib.Path(ckpt.path).rglob("manifest.ocdbt"):
            frame = f.read_bytes()[14:-4]
            want = zstandard.ZstdDecompressor().decompressobj().decompress(
                frame)
            assert native.zstd_decompress(frame).tobytes() == want, f
    assert n > 1000


def _corrupt(kind: str) -> bytes:
    data = np.random.default_rng(0).standard_normal(20000).astype(
        np.float32).tobytes()
    frame = bytearray(zstandard.ZstdCompressor(
        level=3, write_checksum=True).compress(data))
    if kind == "truncated":
        return bytes(frame[:len(frame) // 2])
    if kind == "magic":
        frame[0] ^= 1
    elif kind == "checksum":
        frame[-1] ^= 0xFF
    elif kind == "stream":
        frame[len(frame) // 2] ^= 0x5A
    elif kind == "dictionary":  # the descriptor names dictionary 7
        frame = bytearray(zstd_frame(data))
        frame[4:5] = bytes([frame[4] | 1, 7])
    return bytes(frame)


@pytest.mark.parametrize("kind", ["truncated", "magic", "checksum", "stream",
                                  "dictionary"])
def test_zstd_corrupt_frame_raises(kind):
    with pytest.raises(ValueError):
        native.zstd_decompress(_corrupt(kind), 80000)


def test_crc32c_and_ocdbt_checksums(saved):
    assert native.crc32c(b"123456789") == 0xE3069283  # RFC 3720's check
    path = saved["mesh"][0]
    files = [f for f in pathlib.Path(path).rglob("*")
             if f.name == "manifest.ocdbt"]
    assert len(files) == 2  # the root and the process's sub-database
    for f in files:
        blob = f.read_bytes()
        assert native.crc32c(blob[:-4]) == struct.unpack("<I", blob[-4:])[0]


# ---------------------------------------------------------------- fixture
def test_fixture_decodes_to_expected():
    root = fixture_gen.ROOT
    want = msgpack_restore((root / "expected.msgpack").read_bytes())
    got = load_orbax(str(root / "ckpt"))
    assert got["epoch"] == want["epoch"] == fixture_gen.EPOCH
    state = flat(got["state"], ("state",))
    expect = flat(want["state"], ("state",))
    assert sorted(state) == sorted(expect)
    bf16 = set(want["bfloat16"])
    for path, w in expect.items():
        g = state[path]
        if ".".join(path) in bf16:
            assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(bits(g), w, err_msg=str(path))
        if not isinstance(w, dict) and ".".join(path) not in bf16:
            assert g.dtype == w.dtype, path


def test_fixture_generator_reproduces_expected():
    want = msgpack_restore((fixture_gen.ROOT / "expected.msgpack")
                           .read_bytes())
    got = fixture_gen.expected(fixture_gen.make_state())
    assert got["bfloat16"] == list(want["bfloat16"])
    assert_same_leaves(got["state"], want["state"])
