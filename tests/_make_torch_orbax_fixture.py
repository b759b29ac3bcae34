"""Write ``tests/fixtures_torch_orbax/``: an orbax checkpoint that the JAX
package's ``save_orbax`` writes, for the port to read where there is no
JAX (``chip_smoke.py``), and ``expected.msgpack``, what it holds.

* ``ckpt/``: ``save_orbax`` of ``make_state()`` at epoch 7. Float32,
  float64, bfloat16, int32, int64, uint8 and bool leaves, 0-d ones, an
  empty dict and a tuple; jax.Array and numpy leaves; two arrays sharded
  over a (data 4, model 2) mesh of 8 CPU devices, so they are written in
  several chunks; ramps and repeats that tensorstore's zstd compresses
  with Huffman literals and FSE sequences. The folder stays under 64 KB.
* ``expected.msgpack``: flax msgpack of ``{"epoch", "state"}``, the state
  as flax's state dict (the tuple keyed "0", "1"), bfloat16 leaves as
  their uint16 bits and named in ``"bfloat16"``.

Tensorstore names data files at random, so a second run writes other
bytes for the same values. Run from the repository root:

    JAX_PLATFORMS=cpu python tests/_make_torch_orbax_fixture.py
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent / "fixtures_torch_orbax"
EPOCH = 7


def make_state() -> dict:
    """The saved state: numpy leaves (bfloat16 through ml_dtypes)."""
    import ml_dtypes

    rng = np.random.default_rng(21)
    return {
        "params": {
            "conv": {"kernel": rng.standard_normal((3, 3, 4, 16)).astype(
                np.float32),
                     "bias": np.linspace(-1, 1, 16, dtype=np.float32)},
            "wide": np.tile(np.arange(32, dtype=np.float32) / 8, (8, 1)),
        },
        "moments": {"bf16": rng.standard_normal((8, 24)).astype(
            ml_dtypes.bfloat16),
                    "f64": rng.standard_normal((16, 24))},
        "count": np.asarray(3, np.int32),
        "scale": np.asarray(0.25, np.float32),
        "steps": np.arange(600, dtype=np.int64) // 7,
        "pixels": rng.integers(0, 4, (16, 16, 3), dtype=np.uint8),
        "mask": np.arange(30).reshape(6, 5) % 3 == 0,
        "empty": {},
        "pair": (np.arange(12, dtype=np.int32).reshape(3, 4),
                 np.asarray(-2.5, np.float64)),
    }


def jax_state(state: dict):
    """``state`` as the JAX package holds it: ``params`` and ``pair[0]`` as
    jax.Arrays (``conv.kernel`` split over 'model', ``wide`` over 'data'
    and 'model'), the rest numpy."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dynmm_tpu.parallel import make_mesh

    mesh = make_mesh(4, 2)
    put = lambda x, *spec: jax.device_put(x, NamedSharding(mesh, P(*spec)))
    out = dict(state)
    out["params"] = {
        "conv": {"kernel": put(state["params"]["conv"]["kernel"], None, None,
                               None, "model"),
                 "bias": put(state["params"]["conv"]["bias"])},
        "wide": put(state["params"]["wide"], "data", "model"),
    }
    out["pair"] = (put(state["pair"][0]), state["pair"][1])
    return out


def expected(state: dict) -> dict:
    """``{"epoch", "state", "bfloat16"}`` as ``expected.msgpack`` holds it."""
    import flax.serialization

    bf16 = []

    def host(tree, path):
        if isinstance(tree, dict):
            return {k: host(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return {str(i): host(v, path + (str(i),))
                    for i, v in enumerate(tree)}
        arr = np.asarray(tree)
        if arr.dtype.name == "bfloat16":
            bf16.append(".".join(path))
            return arr.view(np.uint16)
        return arr

    tree = host(state, ("state",))
    return {"epoch": EPOCH, "state": flax.serialization.to_state_dict(tree),
            "bfloat16": bf16}


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    import flax.serialization

    sys.path.insert(0, str(ROOT.parents[1]))
    from dynmm_tpu.utils.checkpoint import save_orbax

    state = make_state()
    shutil.rmtree(ROOT, ignore_errors=True)
    ROOT.mkdir(parents=True)
    save_orbax(str(ROOT / "ckpt"), jax_state(state), epoch=EPOCH)
    (ROOT / "expected.msgpack").write_bytes(
        flax.serialization.msgpack_serialize(expected(state)))
    size = sum(f.stat().st_size for f in ROOT.rglob("*") if f.is_file())
    print(f"wrote {ROOT} ({size} bytes)")


if __name__ == "__main__":
    main()
