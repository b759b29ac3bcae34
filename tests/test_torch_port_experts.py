"""The modality half's expert stack of the port against the JAX package:
the masked GRU, the fusions, MulT, the expert CLIs and ``--robust``.

* ``GRU``/``GRUWithLinear`` at the text expert's width (hidden 512, T = 50,
  B = 4) on ragged lengths (50, 17, 1, 5): the last valid state, the full
  sequence (states frozen past each end) and the flattened sequence.
* Dropout in training: the GRU's two masks (last state, sequence) are
  independent and keep ~90 % at rate 0.1, scaled by 1/0.9; the attention
  keeps one (query, key) mask for the batch and every head; nothing drops
  in eval; a MulT fusion inside ``MMDL`` drops nothing while the model
  trains (JAX's ``MMDL`` calls its fusion without ``train``).
* ``ConcatEarly``, ``LowRankTensorFusion``, ``MultiplicativeInteractions2Modal``
  and MulT (``affect_mm --fusion 4``'s config at T = 50, with lengths).
* Every expert the CLIs build (``imdb_mm --fuse 0-3``, ``affect_mm
  --fusion 0-5`` against the examples' own ``build_expert``, loaded by
  path, and ``affect_uni --enc gru``): the init tree's structure, shapes
  and dtypes, and the forward at B = 3. MulT inside ``MMDL`` runs without
  lengths there.
* flax's initialisers: the GRU's orthogonal hidden kernels, the fusions'
  normal factors and zeros (by distribution: each package draws its own).
* Three AdamW steps in float64 through ``mmdl_adapter`` and
  ``unimodal_adapter`` for GRU, early-fusion GRU, LRTF, MIM and MulT
  experts at reduced widths with dropout 0: every leaf within 1e-8 of the
  JAX trainer's (max abs error over max |JAX|).
* Expert files: the port's ``save_expert`` writes JAX's bytes for those
  trees, and each package grafts the other's file.
* The two steps on the CPU: the port's expert CLIs write the files its
  routers graft (the graft lines print; the router checkpoint's grafted
  leaves equal the files under ``--freeze``), and JAX grafts every file
  the port wrote. ``affect_dyn --enc gru`` raises where JAX does.
* ``--robust``: ``robustness_sweep`` over ``SupervisedTrainer.evaluate``
  against JAX's on the same variables and seed.

Tolerance: max abs error over max |JAX| ≤ 1e-5 in fp32.
"""

import functools
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynmm_tpu.data import affect as jaffect
from dynmm_tpu.data import imdb as jimdb
from dynmm_tpu.data.loader import ArrayLoader as JArrayLoader
from dynmm_tpu.models import mult as jmult
from dynmm_tpu.models.modality import mmdl as jmmdl
from dynmm_tpu.nn import fusions as jfus
from dynmm_tpu.nn import mlp as jmlp
from dynmm_tpu.nn import sequence as jseq
from dynmm_tpu.train import adapters as jadapters
from dynmm_tpu.train import experts as jexperts
from dynmm_tpu.train import robustness as jrob
from dynmm_tpu.train import supervised as jsup
from dynmm_tpu_torch.cli import (affect_dyn, affect_mm, affect_uni, imdb_dyn,
                                 imdb_mm, imdb_uni)
from dynmm_tpu_torch.data.loader import ArrayLoader
from dynmm_tpu_torch.models.modality import MMDL, EncoderHead
from dynmm_tpu_torch.models.mult import MULTModel
from dynmm_tpu_torch.nn import fusions, mlp, sequence
from dynmm_tpu_torch.train import adapters, experts, robustness
from dynmm_tpu_torch.train.supervised import SupervisedConfig, SupervisedTrainer
from dynmm_tpu_torch.utils.checkpoint import load_checkpoint
from dynmm_tpu_torch.utils.init import flax_default_init
from dynmm_tpu_torch.utils.weights import flax_variables, load_flax_variables
from tests._port_modality_setup import (ROUTERS, jax_variables, port_router,
                                        rel_err)
from tests._port_train_setup import compile_fast, leaf_errors
from tests._port_train_setup import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
DIMS = (35, 74, 300)
T = 50


class JSeqIdentity(jmlp.Identity):
    """The JAX example's ``SeqIdentity`` (local to its ``build_expert``)."""

    def __call__(self, x, lengths=None, train=False):
        return x


def seeded(shapes, rng):
    """Numpy float32 values for a flax variable tree of shapes, scaled to
    keep activations O(1): dense kernels normal with variance 1/fan_in,
    LRTF factors 1/(d+1), rank weights 1/R, MIM ``W`` 1/(d1·d2) and
    ``U``/``V`` 1/d, biases and BN means small normals, scales and BN
    variances uniform in [0.5, 1.5]."""

    def leaf(path, s):
        name, shape = path[-1].key, tuple(s.shape)
        if name == "kernel":
            qkv = path[-2].key in ("query", "key", "value")
            fan = shape[0] if qkv else int(np.prod(shape[:-1]))
        elif name.startswith("factor") or name == "rank_weights":
            fan = shape[1]
        elif name == "W":
            fan = shape[0] * shape[1]
        elif name in ("U", "V"):
            fan = shape[0]
        elif name in ("bias", "mean", "b"):
            fan = 100.0
        else:  # scale, var
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.standard_normal(shape, dtype=np.float32) / np.float32(
            np.sqrt(fan))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def mosei_inputs(b: int, t: int = T, seed: int = 0):
    """Three streams (B, t, d) zero past ragged lengths (the first full),
    and the lengths."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, t + 1, size=b).astype(np.int32)
    lengths[0] = t
    xs = []
    for d in DIMS:
        x = rng.standard_normal((b, t, d)).astype(np.float32)
        x[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
        xs.append(x)
    return xs, [lengths] * 3


def imdb_inputs(b: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, d)).astype(np.float32)
            for d in (300, 4096)]


def to_torch(xs, dtype=torch.float32):
    return [torch.from_numpy(np.asarray(x)).to(dtype) for x in xs]


def lengths_torch(ls):
    return [torch.from_numpy(np.asarray(l)).long() for l in ls]


def generator():
    return torch.Generator().manual_seed(0)


# ------------------------------------------------------------------- GRU
GRU_MODES = {"last_only": {}, "sequence": {"last_only": False},
             "flatten": {"last_only": False, "flatten": True}}


@pytest.mark.parametrize("linear", [False, True], ids=["GRU", "GRUWithLinear"])
@pytest.mark.parametrize("mode", list(GRU_MODES))
def test_gru_matches_jax(mode, linear):
    kw = GRU_MODES[mode]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, T, 300)).astype(np.float32)
    lengths = np.array([T, 17, 1, 5], np.int32)
    if linear:
        jm = jseq.GRUWithLinear(512, 32, **kw)
        tm = sequence.GRUWithLinear(300, 512, 32, time=T, **kw)
    else:
        jm, tm = jseq.GRU(512, **kw), sequence.GRU(300, 512, **kw)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lengths)))
    variables = seeded(shapes, rng)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x),
                                        jnp.asarray(lengths)))
    load_flax_variables(tm, variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(lengths).long())
    assert got.shape == want.shape
    assert rel_err(got, want) <= TOL
    back = flax_variables(tm)["params"]
    assert max(leaf_errors(back, variables["params"]).values()) == 0
    if mode == "sequence" and not linear:  # frozen past each end
        for b, n in enumerate(lengths):
            assert torch.equal(got[b, n:], got[b, n - 1:n].expand(T - n, -1))


# --------------------------------------------------------------- dropout
def test_gru_dropout_masks():
    gru = sequence.GRU(8, 256, dropout=True, dropout_rate=0.1)
    flax_default_init(gru, generator())
    x = torch.randn(64, 6, 8, generator=generator())
    with torch.no_grad():
        clean_last, clean_seq = gru.eval().states(x)
        assert torch.equal(clean_last, clean_seq[:, -1])
        mlp.set_dropout_generator(gru, generator())
        last, seq = gru.train().states(x)
    keep_last, keep_seq = last != 0, seq[:, -1] != 0
    for keep in (keep_last, keep_seq, seq != 0):
        assert abs(keep.float().mean().item() - 0.9) < 0.015
    torch.testing.assert_close(last[keep_last], clean_last[keep_last] / 0.9)
    torch.testing.assert_close(seq[seq != 0], clean_seq[seq != 0] / 0.9)
    agree = (keep_last == keep_seq).float().mean().item()
    assert abs(agree - (0.9 ** 2 + 0.1 ** 2)) < 0.03  # independent masks


def test_attention_dropout_is_one_mask():
    attn = sequence.MultiHeadDotProductAttention(16, 4, dropout_rate=0.1)
    flax_default_init(attn, generator())
    mlp.set_dropout_generator(attn, generator())
    seen = []
    attn.drop.register_forward_hook(lambda m, i, o: seen.append((i[0], o)))
    x = torch.randn(3, 64, 16, generator=generator())
    with torch.no_grad():
        attn.train()(x)
        weights, dropped = seen[-1]
        keep = dropped != 0
        assert keep.shape == (3, 4, 64, 64)
        assert torch.equal(keep, keep[:1, :1].expand_as(keep))
        assert abs(keep[0, 0].float().mean().item() - 0.9) < 0.02
        torch.testing.assert_close(dropped[keep], weights[keep] / 0.9)
        attn.eval()(x)
        assert torch.equal(seen[-1][0], seen[-1][1])


def test_mult_in_mmdl_drops_nothing_in_training():
    fusion = MULTModel(DIMS, embed_dim=8, num_heads=2, layers=2)
    model = MMDL([affect_mm.SeqIdentity() for _ in DIMS], fusion,
                 affect_mm.SeqIdentity(), has_padding=True)
    flax_default_init(model, generator())
    mlp.set_dropout_generator(model, generator())
    xs, ls = mosei_inputs(4, t=10)
    xs, ls = to_torch(xs), lengths_torch(ls)
    with torch.no_grad():
        want = model.eval()(xs, ls)
        assert torch.equal(model.train()(xs, ls), want)
        assert model.training and not fusion.training
        fusion.train()  # alone, the fusion's dropout is live
        assert not torch.equal(fusion(xs), want)


# --------------------------------------------------------------- fusions
def _fusion_case(name):
    rng = np.random.default_rng(2)
    if name == "concat_early":
        xs = [rng.standard_normal((3, 7, d)).astype(np.float32)
              for d in (5, 6, 4)]
        return jfus.ConcatEarly(), fusions.ConcatEarly(), xs
    if name == "lrtf":
        xs = [rng.standard_normal((3, d)).astype(np.float32)
              for d in (32, 32, 128)]
        return (jfus.LowRankTensorFusion(128, rank=32),
                fusions.LowRankTensorFusion((32, 32, 128), 128, rank=32), xs)
    xs = [rng.standard_normal((3, d)).astype(np.float32) for d in (64, 48)]
    return (jfus.MultiplicativeInteractions2Modal(40),
            fusions.MultiplicativeInteractions2Modal((64, 48), 40), xs)


@pytest.mark.parametrize("name", ["concat_early", "lrtf", "mim"])
def test_fusions_match_jax(name):
    jm, tm, xs = _fusion_case(name)
    jx = [jnp.asarray(x) for x in xs]
    variables = seeded(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jx)), np.random.default_rng(3))
    want = np.asarray(jm.apply(variables, jx))
    if variables:
        load_flax_variables(tm, variables)
        back = flax_variables(tm)["params"]
        assert max(leaf_errors(back, variables["params"]).values()) == 0
    with torch.no_grad():
        got = tm(to_torch(xs))
    assert got.shape == want.shape and rel_err(got, want) <= TOL


def test_mult_with_lengths_matches_jax():
    """``affect_mm --fusion 4``'s MulT called directly with lengths:
    masked cross and self attention, the last valid step as summary."""
    xs, ls = mosei_inputs(3)
    jm = jmult.MULTModel(embed_dim=40, num_heads=10, layers=4, output_dim=1)
    jx, jl = [jnp.asarray(x) for x in xs], [jnp.asarray(l) for l in ls]
    variables = seeded(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jx, jl)),
        np.random.default_rng(4))
    want = np.asarray(jax.jit(jm.apply)(variables, jx, jl))
    tm = MULTModel(DIMS, embed_dim=40, num_heads=10, layers=4,
                   output_dim=1).eval()
    load_flax_variables(tm, variables)
    with torch.no_grad():
        got = tm(to_torch(xs), lengths_torch(ls))
    assert rel_err(got, want) <= TOL
    with torch.no_grad():  # the lengths matter: unmasked is another answer
        assert rel_err(tm(to_torch(xs)), want) > 1e-3


# --------------------------------------------------- every expert, vs JAX
def _example(rel: str):
    spec = importlib.util.spec_from_file_location(
        f"_example_{Path(rel).stem}", REPO / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


EXPERTS = ([f"imdb_mm-{f}" for f in range(4)]
           + [f"affect_mm-{f}" for f in range(6)] + ["affect_uni-gru"])


def _expert_models(name: str):
    """(JAX model, port model, kind) of one CLI expert at the CLI's
    widths."""
    cli, _, arg = name.partition("-")
    if cli == "imdb_mm":
        jm, jname = _example("examples/multimedia/imdb_mm.py").build_expert(
            int(arg))
        tm, tname = imdb_mm.build_expert(int(arg))
        assert tname == jname
        return jm, tm, "imdb"
    if cli == "affect_mm":
        jm = _example("examples/affect/affect_mm.py").build_expert(int(arg))
        return jm, affect_mm.build_expert(int(arg)), "mosei"
    jm = jmmdl.EncoderHead(jseq.GRU(hidden_dim=512, dropout=True),
                           jmlp.MLP(256, 1), sequence=True)
    return jm, affect_uni.build_expert(2, "gru", 512, 256, 1), "stream"


@functools.lru_cache(maxsize=None)
def _jax_expert(name: str):
    """(JAX model, port model, kind, init tree of shapes, seeded variables,
    inputs, JAX's eval forward) of one expert, once per module run."""
    jm, tm, kind = _expert_models(name)
    if kind == "imdb":
        xs, ls = imdb_inputs(3), None
        args = ([jnp.asarray(x) for x in xs],)
    else:
        xs, ls = mosei_inputs(3)
        if kind == "stream":
            xs, ls = xs[2:], ls[2:]
        args = ([jnp.asarray(x) for x in xs], [jnp.asarray(l) for l in ls])
        if kind == "stream":
            args = (args[0][0], args[1][0])
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))
    variables = seeded(shapes, np.random.default_rng(5))
    want = np.asarray(jax.jit(jm.apply)(variables, *args))
    return tm, kind, shapes, variables, xs, ls, want


def _structure(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_structure(v, path + (k,)))
        else:
            out["/".join(path + (k,))] = (tuple(v.shape), np.dtype(v.dtype))
    return out


@pytest.mark.parametrize("name", EXPERTS)
def test_expert_matches_jax_build_expert(name):
    tm, kind, shapes, variables, xs, ls, want = _jax_expert(name)
    ours = flax_variables(tm)
    for coll in ("params", "batch_stats"):
        assert _structure(ours[coll]) == _structure(shapes.get(coll, {})), coll
    load_flax_variables(tm, variables)
    tm.eval()
    with torch.no_grad():
        if kind == "imdb":
            got = tm(to_torch(xs))
        elif kind == "stream":
            got = tm(to_torch(xs)[0], lengths_torch(ls)[0])
        else:
            got = tm(to_torch(xs), lengths_torch(ls))
    assert got.shape == want.shape and rel_err(got, want) <= TOL


def test_flax_initialisers():
    """The GRU's hidden kernels orthogonal (its input kernels lecun), the
    LRTF factors and rank weights normal(0.02) with a zero bias, the MIM's
    ``W``/``V`` normal(0.01) with ``U``/``b`` zero: per leaf, the port's
    standard deviation within 5 % of JAX's own init of the same shapes."""
    port = torch.nn.ModuleDict({
        "gru": sequence.GRU(64, 128),
        "lrtf": fusions.LowRankTensorFusion((32, 32), 64, rank=16),
        "mim": fusions.MultiplicativeInteractions2Modal((32, 48), 64)})
    flax_default_init(port, generator())
    ours = flax_variables(port)["params"]
    key = jax.random.PRNGKey(0)
    a, b = jnp.ones((2, 32)), jnp.ones((2, 48))
    theirs = jax.jit(lambda key: {  # one compile for the three inits
        "gru": jseq.GRU(128).init(key, jnp.ones((2, 3, 64)))["params"],
        "lrtf": jfus.LowRankTensorFusion(64, rank=16).init(
            key, [a, a])["params"],
        "mim": jfus.MultiplicativeInteractions2Modal(64).init(
            key, [a, b])["params"]})(key)
    got, want = _leaves(ours), _leaves(jax.device_get(theirs))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        if not w.any():
            assert not g.any(), path
        elif w.size >= 1000:
            assert abs(g.std() / w.std() - 1) < 0.05, path
        if path.split("/")[-2] in ("hr", "hz", "hn") and path.endswith(
                "kernel"):
            for m in (g, w):
                np.testing.assert_allclose(m @ m.T, np.eye(len(m)),
                                           atol=1e-5)


def _leaves(tree, path=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_leaves(v, path + (k,)))
        else:
            out["/".join(path + (k,))] = np.asarray(v, np.float64)
    return out


# ----------------------------------------- three float64 steps vs JAX
def _small_experts(name: str):
    """(JAX model, port model, modality index or None, kind) of a reduced
    expert with dropout 0."""
    gru = dict(dropout=True, dropout_rate=0.0)
    seq_ids = [JSeqIdentity() for _ in DIMS]
    ids = [affect_mm.SeqIdentity() for _ in DIMS]
    if name == "gru":
        return (jmmdl.EncoderHead(jseq.GRU(16, **gru), jmlp.MLP(8, 1),
                                  sequence=True),
                EncoderHead(sequence.GRU(300, 16, **gru), mlp.MLP(16, 8, 1),
                            sequence=True), 2, "mosei")
    if name == "ef_gru":
        return (jmmdl.MMDL(seq_ids, jfus.ConcatEarly(), jmmdl.EncoderHead(
                    jseq.GRU(16, **gru), jmlp.MLP(8, 1), sequence=True),
                    has_padding=True),
                MMDL(ids, fusions.ConcatEarly(), EncoderHead(
                    sequence.GRU(sum(DIMS), 16, **gru), mlp.MLP(16, 8, 1),
                    sequence=True), has_padding=True), None, "mosei")
    if name == "lrtf":
        hid, out = (8, 8, 12), (4, 4, 6)
        return (jmmdl.MMDL([jseq.GRUWithLinear(h, o, **gru)
                            for h, o in zip(hid, out)],
                           jfus.LowRankTensorFusion(8, rank=4),
                           jmlp.MLP(16, 1), has_padding=True),
                MMDL([sequence.GRUWithLinear(d, h, o, **gru)
                      for d, h, o in zip(DIMS, hid, out)],
                     fusions.LowRankTensorFusion(out, 8, rank=4),
                     mlp.MLP(8, 16, 1), has_padding=True), None, "mosei")
    if name == "mim":
        drop = dict(linear_layer=False, dropout_rate=0.0)
        return (jmmdl.MMDL([jmlp.MaxOut_MLP(16, first_hidden=16, **drop),
                            jmlp.MaxOut_MLP(16, first_hidden=8,
                                            second_hidden=16, **drop)],
                           jfus.MultiplicativeInteractions2Modal(12),
                           jmlp.LinearHead(23)),
                MMDL([mlp.MaxOut_MLP(16, 16, 300, **drop),
                      mlp.MaxOut_MLP(16, 8, 4096, 16, **drop)],
                     fusions.MultiplicativeInteractions2Modal((16, 16), 12),
                     mlp.LinearHead(12, 23)), None, "imdb")
    return (jmmdl.MMDL(seq_ids, jmult.MULTModel(8, 2, 1, 1, dropout_rate=0.0),
                       JSeqIdentity(), has_padding=True),
            MMDL(ids, MULTModel(DIMS, 8, 2, 1, 1, dropout_rate=0.0),
                 affect_mm.SeqIdentity(), has_padding=True), None, "mosei")


def _loader(kind: str, n: int, batch_size: int, **kw) -> ArrayLoader:
    if kind == "imdb":
        t, i, y = jimdb.synthetic_imdb(n, seed=1)
        return ArrayLoader([t, i], y, batch_size=batch_size, **kw)
    mods, y, lens = jaffect.synthetic_mosei(n, seq_len=12, seed=1)
    return ArrayLoader(mods, y, lengths=lens, batch_size=batch_size, **kw)


def _cfg(kind: str) -> dict:
    task = ({"task": "multilabel", "objective": "bce_with_logits"}
            if kind == "imdb" else
            {"task": "posneg-classification", "objective": "l1"})
    return {**task, "lr": 1e-3, "weight_decay": 0.05, "clip_val": 0.5}


def _jax_batch(batch, dtype):
    return {"inputs": [jnp.asarray(x, dtype) for x in batch.inputs],
            "label": jnp.asarray(batch.label, dtype),
            "lengths": ([jnp.asarray(l) for l in batch.lengths]
                        if batch.lengths else None)}


@functools.lru_cache(maxsize=None)
def _small_variables(name: str):
    jm, tm, mod, kind = _small_experts(name)
    b0 = next(iter(_loader(kind, 8, 8)))
    if mod is not None:
        args = (jnp.asarray(b0.inputs[mod]), jnp.asarray(b0.lengths[mod]))
    elif kind == "mosei":
        args = ([jnp.asarray(x) for x in b0.inputs],
                [jnp.asarray(l) for l in b0.lengths])
    else:
        args = ([jnp.asarray(x) for x in b0.inputs],)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))
    return seeded(shapes, np.random.default_rng(9))


SMALL = ["gru", "ef_gru", "lrtf", "mim", "mult"]


@pytest.mark.parametrize("name", SMALL)
def test_expert_three_steps_match_jax_float64(name):
    jm, tm, mod, kind = _small_experts(name)
    variables = _small_variables(name)
    batches = list(_loader(kind, 24, 8))
    cfg = _cfg(kind)
    jadapt = (jadapters.unimodal_adapter(jm, mod) if mod is not None
              else jadapters.mmdl_adapter(jm))
    with jax.enable_x64():
        jt = jsup.SupervisedTrainer(jadapt, jsup.SupervisedConfig(**cfg))
        state = jt.init_state(jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), variables))
        jb = [_jax_batch(b, jnp.float64) for b in batches]
        rng = jax.random.PRNGKey(0)
        step = compile_fast(jt._build_train_step(), state, jb[0], rng)
        for b in jb:
            state, _, _ = step(state, b, rng)
        j_state = jax.tree_util.tree_map(np.asarray, state)
    load_flax_variables(tm, variables)
    tm = tm.double()
    adapt = (adapters.unimodal_adapter(tm, mod) if mod is not None
             else adapters.mmdl_adapter(tm))
    trainer = SupervisedTrainer(adapt, SupervisedConfig(**cfg), device="cpu")
    pstate = trainer.init_state()
    trainer.train_epoch(pstate, batches)
    ours = flax_variables(tm)
    errs = leaf_errors(ours["params"], j_state["params"])
    errs.update(leaf_errors(ours["batch_stats"],
                            j_state["model_state"].get("batch_stats", {})))
    assert max(errs.values()) < 1e-8, max(errs.items(), key=lambda kv: kv[1])
    assert min(leaf_errors(ours["params"], variables["params"]).values()) > 0


@pytest.mark.parametrize("name", ["gru", "lrtf", "mim", "mult"])
def test_expert_files_both_ways(tmp_path, name):
    """Byte-identical files of the same tree; each package grafts the
    other's into a router-like tree (``{"params": {"expert": ...}}``) and
    the port's model loads the result."""
    src = _small_variables(name)
    tree_p, tree_s = src["params"], src.get("batch_stats")
    ours = experts.save_expert(str(tmp_path / "port.msgpack"), tree_p, tree_s)
    theirs = jexperts.save_expert(str(tmp_path / "jax.msgpack"), tree_p,
                                  tree_s)
    assert open(ours, "rb").read() == open(theirs, "rb").read()

    _, tm, _, _ = _small_experts(name)
    flax_default_init(tm, generator())
    start = flax_variables(tm)
    wrap = {c: {"expert": start[c]} for c in start if start[c]}
    ported = experts.inject_expert(wrap, "expert",
                                   experts.load_expert(theirs))
    load_flax_variables(tm, {c: v["expert"] for c, v in ported.items()})
    by_jax = jexperts.inject_expert(wrap, "expert",
                                    jexperts.load_expert(ours))
    back = flax_variables(tm)
    for coll in wrap:
        want = jax.device_get(by_jax[coll]["expert"])
        assert max(leaf_errors(back[coll], want).values()) == 0
        assert max(leaf_errors(back[coll], src[coll]).values()) == 0


# --------------------------------------------------- the two steps, CPU
TWO_STEPS = {
    "imdb": ([(imdb_uni, ["--mod", "0"]), (imdb_mm, ["--fuse", "1"])],
             imdb_dyn, ["--reg", "0.1"], "imdb/DynMMNet_freezeTrue_reg_0.1",
             {"text_encoder": "imdb/encoder_text", "text_head":
              "imdb/head_text", "branch3": "imdb/best_lf"}),
    "mosei": ([(affect_uni, ["--mod", "2"]), (affect_mm, ["--fusion", "3"])],
              affect_dyn, ["--reg", "0.01"],
              "mosei/dyn_enc_transformer_reg_0.01freezeTrue",
              {"text_encoder": "mosei/reg_transformer_encoder_text",
               "text_head": "mosei/reg_transformer_head_text",
               "branch2": "mosei/lf_tran"}),
}


@pytest.mark.parametrize("kind", list(TWO_STEPS))
def test_two_steps_on_cpu(tmp_path, monkeypatch, capsys, kind):
    """The port's expert CLIs write the files its router grafts (one line
    each); under ``--freeze`` the router checkpoint's grafted parameters
    equal the files bit for bit; JAX grafts every file the port wrote."""
    steps, router, extra, ckpt, grafts = TWO_STEPS[kind]
    monkeypatch.chdir(tmp_path)
    common = ["--synthetic", "--n-epochs", "1", "--device", "cpu"]
    for cli, argv in steps:
        cli.main(common + argv)
        out = capsys.readouterr().out
        assert re.search(r"^run 0: \{'loss': ", out, re.M), out
    router.main(common + ["--freeze"] + extra)
    out = capsys.readouterr().out
    for path in grafts.values():
        line = ("loaded expert" if kind == "imdb" else "Loading model")
        assert f"{line} ./log/{path}.msgpack" in out.splitlines(), out
    saved = load_checkpoint(str(tmp_path / "log" / f"{ckpt}.msgpack"))
    params = saved["state"]["params"]
    target = jax_variables(kind)
    for sub, path in grafts.items():
        file = experts.load_expert(str(tmp_path / "log" / f"{path}.msgpack"))
        assert max(leaf_errors(params[sub], file["params"]).values()) == 0
        grafted = jexperts.inject_expert(target, sub, jexperts.load_expert(
            str(tmp_path / "log" / f"{path}.msgpack")))
        errs = leaf_errors(jax.device_get(grafted["params"][sub]),
                           file["params"])
        assert max(errs.values()) == 0


def test_affect_dyn_enc_gru_raises_as_jax(tmp_path, monkeypatch):
    """``affect_dyn --enc gru`` grafts ``reg_gru_encoder_text.msgpack``
    into the text transformer: the JAX CLI's ``inject_expert`` raises
    ``ValueError`` on that tree, and so does the port's CLI."""
    gru = affect_uni.build_expert(2, "gru", 512, 256, 1)
    flax_default_init(gru, generator())
    v = flax_variables(gru)
    path = tmp_path / "log" / "mosei" / "reg_gru_encoder_text.msgpack"
    experts.save_expert(str(path), v["params"]["encoder"])
    with pytest.raises(ValueError):
        jexperts.inject_expert(jax_variables("mosei"), "text_encoder",
                               jexperts.load_expert(str(path)))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="lacks"):
        affect_dyn.main(["--synthetic", "--enc", "gru", "--n-epochs", "1",
                         "--device", "cpu"])


# ------------------------------------------------------------- --robust
def test_robustness_sweep_matches_jax():
    """The noisy loaders are JAX's arrays; the sweep's losses agree within
    1e-5 relative and its f1 curves are equal."""
    variables = jax_variables("imdb", seed=3)
    loader = _loader("imdb", 20, 8, pad_tail=True)
    groups = {"text": [0], "image": [1], "both": [0, 1]}
    jloader = JArrayLoader(loader.inputs, loader.label, batch_size=8,
                           pad_tail=True)
    for level in (0.0, 0.5):
        a = robustness.noisy_loader(loader, level, [0, 1], seed=0)
        b = jrob.noisy_loader(jloader, level, [0, 1], seed=0)
        for x, y in zip(a.inputs, b.inputs):
            np.testing.assert_array_equal(x, y)
    cfg = {"task": "multilabel", "objective": "bce_with_logits"}
    jm = ROUTERS["imdb"][0]()
    jt = jsup.SupervisedTrainer(jadapters.dynmm_adapter(jm, hard=True),
                                jsup.SupervisedConfig(**cfg))
    jstate = jt.init_state(variables)
    want = jrob.robustness_sweep(lambda l: jt.evaluate(jstate, l), jloader,
                                 groups)
    model = port_router("imdb", variables)
    trainer = SupervisedTrainer(adapters.dynmm_adapter(model, hard=True),
                                SupervisedConfig(**cfg), device="cpu")
    state = trainer.init_state()
    got = robustness.robustness_sweep(lambda l: trainer.evaluate(state, l),
                                      loader, groups)
    assert got.keys() == want.keys()
    for g in want:
        assert got[g].keys() == want[g].keys()
        np.testing.assert_allclose(got[g]["loss"], want[g]["loss"],
                                   rtol=1e-5)
        for m in ("f1_micro", "f1_macro"):
            assert got[g][m] == want[g][m], (g, m)
        assert (robustness.relative_robustness(got[g]["f1_macro"])
                == jrob.relative_robustness(want[g]["f1_macro"]))
    assert len(set(map(tuple, (c["loss"] for c in got.values())))) == 3
