"""The port's supervised training stack against the JAX package's: data,
objectives, metrics, ``SupervisedTrainer``, experts, checkpoints and the
``imdb_dyn`` / ``affect_dyn`` CLIs.

* Three trainer steps in float64 (the JAX side under ``jax.enable_x64``,
  compiled at XLA level 1): AdamW with weight decay, a clip that binds,
  the λ resource loss, with and without ``--freeze``; every parameter and
  BN statistic within 1e-8 of the JAX trainer's (max abs error over max
  |JAX| per leaf). Dropout is 0 (the routers' ``dropout_rate`` field).
* ``evaluate`` (padded tail batches, gate statistics) and the numpy copies
  (loaders, metrics) against the JAX package's; ``fit`` returns the best
  epoch's copy.
* Experts and checkpoints written by either package load into the other.
* Both CLIs end to end on the CPU on the synthetic data; ``--robust``
  prints the JAX sweep's curves; the flags not ported yet raise; without a
  card the entry points (the expert CLIs too) raise.
"""

import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dynmm_tpu.data import affect as jaffect
from dynmm_tpu.data import imdb as jimdb
from dynmm_tpu.train import adapters as jadapters
from dynmm_tpu.train import experts as jexperts
from dynmm_tpu.train import metrics as jmetrics
from dynmm_tpu.train import objectives as jobjectives
from dynmm_tpu.train import supervised as jsup
from dynmm_tpu.utils import checkpoint as jckpt
from dynmm_tpu_torch.cli import (affect_dyn, affect_mm, affect_uni, imdb_dyn,
                                 imdb_mm, imdb_uni)
from dynmm_tpu_torch.data import affect, imdb
from dynmm_tpu_torch.data.loader import ArrayLoader
from dynmm_tpu_torch.train import adapters, experts, metrics, objectives
from dynmm_tpu_torch.train.supervised import (SupervisedConfig,
                                              SupervisedOptimizer,
                                              SupervisedTrainer)
from dynmm_tpu_torch.utils.checkpoint import save_checkpoint
from dynmm_tpu_torch.utils.init import flax_default_init
from dynmm_tpu_torch.utils.weights import (flax_variables,
                                           load_checkpoint_into,
                                           load_flax_variables)
from tests._port_modality_setup import (ROUTERS, jax_variables,
                                        port_router, random_tree)
from tests._port_train_setup import compile_fast, leaf_errors
from tests._port_train_setup import one_torch_thread  # noqa: F401 (autouse)


def _loader(kind: str, n: int, batch_size: int, **kw) -> ArrayLoader:
    """Port loader over the JAX package's synthetic data (IMDB at its
    widths; MOSEI at T = 12)."""
    if kind == "imdb":
        t, i, y = jimdb.synthetic_imdb(n, seed=1)
        return ArrayLoader([t, i], y, batch_size=batch_size, **kw)
    mods, y, lens = jaffect.synthetic_mosei(n, seq_len=12, seed=1)
    return ArrayLoader(mods, y, lengths=lens, batch_size=batch_size, **kw)


def _cfg(kind: str, **kw) -> dict:
    task = ({"task": "multilabel", "objective": "bce_with_logits"}
            if kind == "imdb" else
            {"task": "posneg-classification", "objective": "l1"})
    return {**task, "lr": 1e-3, "weight_decay": 0.05, "clip_val": 0.5,
            "additional_loss": True, "lossw": 0.1, **kw}


def _gate_only(path) -> bool:
    return "gate" in path


def _jax_batch(batch, dtype):
    return {"inputs": [jnp.asarray(x, dtype) for x in batch.inputs],
            "label": jnp.asarray(batch.label, dtype),
            "lengths": ([jnp.asarray(l) for l in batch.lengths]
                        if batch.lengths else None)}


# ------------------------------------------------------------- train steps
STEPS = [("imdb", False), ("imdb", True), ("mosei", False), ("mosei", True)]


def _steps(kind, freeze, n_steps, **cfg):
    """``n_steps`` train steps of the router in float64 in both packages
    from the same variables: (the port's losses, JAX's, the port's
    variables, JAX's state, the initial variables)."""
    variables = jax_variables(kind, seed=2)
    loader = _loader(kind, n_steps * (16 if kind == "imdb" else 8),
                     16 if kind == "imdb" else 8)
    batches = list(loader)
    pred = _gate_only if freeze else None
    with jax.enable_x64():
        jm = ROUTERS[kind][0]()
        jt = jsup.SupervisedTrainer(
            jadapters.dynmm_adapter(jm, temp=1.0, hard=False),
            jsup.SupervisedConfig(**_cfg(kind, **cfg)), trainable_pred=pred)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     variables)
        state = jt.init_state(v64)
        rng = jax.random.PRNGKey(0)
        jb = [_jax_batch(b, jnp.float64) for b in batches]
        step = compile_fast(jt._build_train_step(), state, jb[0], rng)
        j_losses = []
        for b in jb:
            state, loss, _ = step(state, b, rng)
            j_losses.append(float(loss))
        j_state = jax.tree_util.tree_map(np.asarray, state)

    model = port_router(kind, variables, torch.float64).train()
    trainer = SupervisedTrainer(
        adapters.dynmm_adapter(model, temp=1.0, hard=False),
        SupervisedConfig(**_cfg(kind, **cfg)), trainable_pred=pred,
        device="cpu")
    pstate = trainer.init_state()
    losses = [float(trainer.train_step(pstate, trainer.to_device_batch(b))[0])
              for b in batches]
    return losses, j_losses, flax_variables(model), j_state, variables


@pytest.mark.parametrize("kind,freeze", STEPS,
                         ids=[f"{k}-{'freeze' if f else 'all'}" for k, f in STEPS])
def test_three_steps_match_jax_float64(kind, freeze):
    losses, j_losses, ours, j_state, variables = _steps(kind, freeze, 3)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-10)
    worst = {}
    for coll, want in (("params", j_state["params"]),
                       ("batch_stats",
                        j_state["model_state"].get("batch_stats", {}))):
        errs = leaf_errors(ours[coll], want)
        if errs:
            worst[coll] = max(errs.items(), key=lambda kv: kv[1])
    assert all(e < 1e-8 for _, e in worst.values()), worst
    moved = leaf_errors(ours["params"], variables["params"])
    if freeze:
        assert {k for k, e in moved.items() if e > 0} == {
            k for k in moved if k.startswith("/gate")}
    else:  # weight decay moves every leaf, the unreached image branch too
        assert min(moved.values()) > 0


@pytest.mark.parametrize("kind", ["imdb", "mosei"])
def test_rmsprop_steps_match_optax_float64(kind):
    """``optimizer="rmsprop"`` (``optax.rmsprop(lr)``, inside the global-norm
    clip) for five steps: the losses within 1e-6 relative, every parameter
    within 1e-5 of its leaf's largest entry (the float64 step bounds of
    ``tests/test_torch_port_train_steps.py``)."""
    losses, j_losses, ours, j_state, variables = _steps(
        kind, False, 5, optimizer="rmsprop")
    np.testing.assert_allclose(losses, j_losses, rtol=1e-6)
    errs = leaf_errors(ours["params"], j_state["params"])
    worst = max(errs.items(), key=lambda kv: kv[1])
    print(f"{kind} rmsprop, five steps: worst leaf {worst}")
    assert worst[1] < 1e-5, worst
    moved = leaf_errors(ours["params"], variables["params"])
    assert max(moved.values()) > 1e-3  # the steps moved the weights


def _experts(name: str):
    """(JAX model, port model, adapters' extra args, kind) of one expert
    training set-up: a text MLP expert, the MOSEI text transformer expert
    (a sequence encoder) and the IMDB late-fusion MMDL."""
    from dynmm_tpu.models.modality import mmdl as jmmdl
    from dynmm_tpu.nn import fusions as jfus
    from dynmm_tpu.nn import mlp as jmlp
    from dynmm_tpu.nn import sequence as jseq
    from dynmm_tpu_torch.models.modality import mmdl
    from dynmm_tpu_torch.nn import fusions, mlp, sequence

    if name == "unimodal-mlp":
        return (jmmdl.EncoderHead(jmlp.MLP(64, 32), jmlp.MLP(32, 23)),
                mmdl.EncoderHead(mlp.MLP(300, 64, 32), mlp.MLP(32, 32, 23)),
                (0,), "imdb")
    if name == "unimodal-transformer":
        return (jmmdl.EncoderHead(jseq.Transformer(dim=10), jmlp.MLP(16, 1),
                                  sequence=True),
                mmdl.EncoderHead(sequence.Transformer(300, 10),
                                 mlp.MLP(10, 16, 1), sequence=True),
                (2,), "mosei")
    return (jmmdl.MMDL([jmlp.MaxOut_MLP(32, first_hidden=32,
                                        linear_layer=False, dropout_rate=0.0),
                        jmlp.MaxOut_MLP(32, first_hidden=16, second_hidden=32,
                                        linear_layer=False, dropout_rate=0.0)],
                       jfus.Concat(), jmlp.LinearHead(23)),
            mmdl.MMDL([mlp.MaxOut_MLP(32, 32, 300, linear_layer=False,
                                      dropout_rate=0.0),
                       mlp.MaxOut_MLP(32, 16, 4096, 32, linear_layer=False,
                                      dropout_rate=0.0)],
                      fusions.Concat(), mlp.LinearHead(64, 23)),
            (), "imdb")


@pytest.mark.parametrize("name", ["unimodal-mlp", "unimodal-transformer",
                                  "mmdl"])
def test_expert_adapters_three_steps_match_jax_float64(name):
    """``unimodal_adapter`` and ``mmdl_adapter`` (the expert branches'
    training), three AdamW steps in float64 against the JAX trainer."""
    jm, tm, extra, kind = _experts(name)
    batches = list(_loader(kind, 24, 8))
    b0 = batches[0]
    if extra:  # one stream (and its lengths)
        args = [jnp.asarray(b0.inputs[extra[0]])] + (
            [jnp.asarray(b0.lengths[extra[0]])] if b0.lengths else [])
    else:
        args = [[jnp.asarray(x) for x in b0.inputs]]
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))
    variables = random_tree(shapes, np.random.default_rng(9))
    cfg = _cfg(kind, additional_loss=False)
    jadapt = (jadapters.unimodal_adapter(jm, *extra) if extra
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
    adapt = (adapters.unimodal_adapter(tm, *extra) if extra
             else adapters.mmdl_adapter(tm))
    trainer = SupervisedTrainer(adapt, SupervisedConfig(**cfg), device="cpu")
    pstate = trainer.init_state()
    for b in batches:
        trainer.train_step(pstate, trainer.to_device_batch(b))
    ours = flax_variables(tm)
    errs = leaf_errors(ours["params"], j_state["params"])
    errs.update(leaf_errors(ours["batch_stats"],
                            j_state["model_state"].get("batch_stats", {})))
    assert max(errs.values()) < 1e-8, max(errs.items(), key=lambda kv: kv[1])


def test_clip_is_optax_global_norm():
    """``g / ‖g‖ · max`` where ‖g‖ ≥ max, untouched below (torch's
    ``clip_grad_norm_`` divides by ‖g‖ + 1e-6)."""
    rng = np.random.default_rng(0)
    for scale in (0.01, 10.0):
        grads = [rng.standard_normal(s) * scale for s in ((3, 4), (5,))]
        with jax.enable_x64():
            want, _ = optax.clip_by_global_norm(1.0).update(
                [jnp.asarray(g) for g in grads], optax.EmptyState())
            want = [np.asarray(w) for w in want]
        params = {f"p{i}": torch.nn.Parameter(torch.zeros(g.shape,
                                                          dtype=torch.float64))
                  for i, g in enumerate(grads)}
        opt = SupervisedOptimizer(SupervisedConfig(optimizer="sgd", lr=1.0,
                                                   clip_val=1.0), params)
        for p, g in zip(params.values(), grads):
            p.grad = torch.from_numpy(g)
        opt.step()  # SGD's first step with momentum 0.9, Nesterov: −1.9 g
        for p, w in zip(params.values(), want):
            np.testing.assert_allclose(p.detach().numpy(), -1.9 * np.asarray(w),
                                       rtol=1e-12)


# ---------------------------------------------------------- numpy copies
@pytest.mark.parametrize("kind", ["imdb", "mosei"])
def test_synthetic_loaders_match_jax(kind):
    """Same batches, shuffle order, padded tails and ``valid`` masks."""
    if kind == "imdb":
        ours = imdb.synthetic_imdb_loaders(n_train=40, n_valid=24,
                                           batch_size=16, seed=3)
        ref = jimdb.synthetic_imdb_loaders(n_train=40, n_valid=24,
                                           batch_size=16, seed=3)
    else:
        ours = affect.synthetic_mosei_loaders(n_train=20, n_valid=12,
                                              batch_size=8, seed=3)
        ref = jaffect.synthetic_mosei_loaders(n_train=20, n_valid=12,
                                              batch_size=8, seed=3)
    for a, b in zip(ours, ref):
        for _ in range(2):  # two epochs: the shuffle stream continues
            got, want = list(a), list(b)
            assert len(got) == len(want) > 0
            for x, y in zip(got, want):
                for u, v in zip(x.inputs + [x.label] + (x.lengths or []),
                                y.inputs + [y.label] + (y.lengths or [])):
                    np.testing.assert_array_equal(u, v)
                if y.valid is None:
                    assert x.valid is None
                else:
                    np.testing.assert_array_equal(x.valid, y.valid)


def test_imdb_hdf5_without_h5py_raises(monkeypatch, tmp_path):
    """Without h5py the port reads the MultiBench file (its own HDF5
    reader) as the JAX loader reads it with h5py; a missing file raises."""
    h5py = pytest.importorskip("h5py")
    path = str(tmp_path / "multimodal_imdb.hdf5")
    rng = np.random.default_rng(0)
    with h5py.File(path, "w") as f:
        f["features"] = rng.standard_normal((12, 1, 300)).astype(np.float32)
        f.create_dataset("vgg_features", data=rng.standard_normal(
            (12, 4096)).astype(np.float32), chunks=(5, 512),
            compression="gzip")
        f["genres"] = (rng.random((12, 23)) > 0.7).astype(np.int64)
    want = {"train": jimdb.load_imdb_hdf5(path, "train")}
    monkeypatch.setitem(sys.modules, "h5py", None)
    for split, arrays in want.items():
        got = imdb.load_imdb_hdf5(path, split)
        for g, w in zip(got, arrays):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    with pytest.raises(FileNotFoundError, match="missing.hdf5"):
        imdb.load_imdb_hdf5(str(tmp_path / "missing.hdf5"), "train")


@pytest.mark.parametrize("name", list(objectives.OBJECTIVES))
def test_objectives_match_jax(name):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((6, 5))
    if name == "cross_entropy":
        labels = rng.integers(0, 5, (6, 1))
    elif name == "bce_with_logits":
        labels = (rng.random((6, 5)) > 0.5).astype(np.float64)
    else:
        labels = rng.standard_normal((6, 5))
    got = objectives.get_objective(name)(torch.from_numpy(logits),
                                         torch.from_numpy(labels))
    with jax.enable_x64():
        want = jobjectives.get_objective(name)(jnp.asarray(logits),
                                               jnp.asarray(labels))
    assert float(got) == pytest.approx(float(want), rel=1e-12)


def test_metrics_match_jax():
    rng = np.random.default_rng(5)
    true = (rng.random((40, 6)) > 0.6).astype(np.int64)
    pred = (rng.random((40, 6)) > 0.5).astype(np.int64)
    for avg in ("micro", "macro"):
        assert metrics.f1_score(true, pred, avg) == jmetrics.f1_score(
            true, pred, avg)
    assert metrics.accuracy(true, pred) == jmetrics.accuracy(true, pred)
    x, y = rng.standard_normal(40), rng.standard_normal(40)
    assert metrics.pearson_corr(x, y) == jmetrics.pearson_corr(x, y)
    assert metrics.posneg_accuracy_corr(x, y) == jmetrics.posneg_accuracy_corr(
        x, y)
    labels = rng.integers(0, 2, 40)
    assert metrics.auprc(x, labels) == jmetrics.auprc(x, labels)


# ----------------------------------------------------------------- evaluate
@pytest.mark.parametrize("kind", ["imdb", "mosei"])
def test_evaluate_matches_jax(kind):
    """Hard-gate evaluation over a padded tail batch: metrics as the JAX
    trainer's, gate statistics of the valid rows only."""
    variables = jax_variables(kind, seed=3)
    loader = _loader(kind, 20, 8, pad_tail=True)
    cfg = _cfg(kind)
    jm = ROUTERS[kind][0]()
    jt = jsup.SupervisedTrainer(jadapters.dynmm_adapter(jm, hard=True),
                                jsup.SupervisedConfig(**cfg))
    want = jt.evaluate(jt.init_state(variables), loader, collect_weights=True)
    model = port_router(kind, variables)
    trainer = SupervisedTrainer(adapters.dynmm_adapter(model, hard=True),
                                SupervisedConfig(**cfg), device="cpu")
    got = trainer.evaluate(trainer.init_state(), loader, collect_weights=True)
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "gate_stats":
            assert got[k].weights.shape == (20, 2)
            np.testing.assert_array_equal(got[k].weights, v.weights)
        else:
            assert got[k] == pytest.approx(v, rel=1e-5, abs=1e-7), k


def test_fit_returns_a_copy_of_the_best_epoch(monkeypatch):
    """Selection metric 1.0, 0.5, 0.2: epoch 0 is best and patience 1 stops
    after epoch 2; the returned weights are those after epoch 0, not a
    reference to the tensors later steps changed in place."""
    variables = jax_variables("mosei", seed=4)
    model = port_router("mosei", variables)
    trainer = SupervisedTrainer(
        adapters.dynmm_adapter(model, hard=False),
        SupervisedConfig(**_cfg("mosei", epochs=5, patience=1, lr=1e-2)),
        device="cpu")
    scores = iter([1.0, 0.5, 0.2, 0.1])
    monkeypatch.setattr(trainer, "_selection_metric", lambda m: next(scores))
    seen = []
    state, logs = trainer.fit(
        trainer.init_state(), _loader("mosei", 16, 8), _loader("mosei", 8, 8),
        log_fn=lambda msg: seen.append(
            {k: v.clone() for k, v in model.state_dict().items()}))
    assert len(logs) == 3 and len(seen) == 3
    final = model.state_dict()
    for k, v in final.items():
        torch.testing.assert_close(v, seen[0][k], rtol=0, atol=0)
    assert any(not torch.equal(v, seen[2][k]) for k, v in final.items())


# ----------------------------------------------------- experts, checkpoints
@pytest.mark.parametrize("kind,sub", [("imdb", "branch3"),
                                      ("mosei", "text_encoder")])
def test_experts_both_ways(tmp_path, kind, sub):
    """An expert the port writes is byte-identical to the JAX package's
    file of the same tree; each package grafts the other's file."""
    src = jax_variables(kind, seed=5)
    tree_p = src["params"][sub]
    tree_s = src.get("batch_stats", {}).get(sub)
    ours = experts.save_expert(str(tmp_path / "port.msgpack"), tree_p, tree_s)
    theirs = jexperts.save_expert(str(tmp_path / "jax.msgpack"), tree_p, tree_s)
    assert open(ours, "rb").read() == open(theirs, "rb").read()

    target = jax_variables(kind, seed=6)
    model = port_router(kind, target)
    v = experts.inject_expert(flax_variables(model), sub,
                              experts.load_expert(theirs))
    load_flax_variables(model, v)
    want = jexperts.inject_expert(target, sub, jexperts.load_expert(ours))
    back = flax_variables(model)
    for coll in ("params", "batch_stats"):
        if coll in want:
            errs = leaf_errors(back[coll], jax.device_get(want[coll]))
            assert max(errs.values()) == 0
    assert leaf_errors(back["params"][sub], tree_p) == {
        k: 0.0 for k in leaf_errors(tree_p, tree_p)}
    with pytest.raises(ValueError, match="lacks"):
        experts.inject_expert(v, sub, {"params": {}})


@pytest.mark.parametrize("kind", ["imdb", "mosei"])
def test_checkpoints_both_ways(tmp_path, kind):
    variables = jax_variables(kind, seed=7)
    model = port_router(kind, variables)
    trainer = SupervisedTrainer(adapters.dynmm_adapter(model),
                                SupervisedConfig(**_cfg(kind)), device="cpu")
    state = trainer.init_state()
    save_checkpoint(str(tmp_path / "port.msgpack"), state.variables(), epoch=0)
    target = {"params": variables["params"],
              "model_state": {k: v for k, v in variables.items()
                              if k != "params"}}
    payload = jckpt.load_checkpoint(str(tmp_path / "port.msgpack"), target)
    for coll in ("params", "model_state"):
        errs = leaf_errors(payload["state"][coll], target[coll])
        assert not errs or max(errs.values()) == 0

    other = jax_variables(kind, seed=8)
    jckpt.save_checkpoint(str(tmp_path / "jax.msgpack"), {
        "params": other["params"],
        "model_state": {k: v for k, v in other.items() if k != "params"}},
        epoch=0)
    load_checkpoint_into(model, str(tmp_path / "jax.msgpack"))
    back = flax_variables(model)
    assert max(leaf_errors(back["params"], other["params"]).values()) == 0


# ---------------------------------------------------------------------- CLIs
RESULT = {"imdb": r"f1_micro: [\d.]+ \| f1_macro: [\d.]+ \| Total Flops "
                  r"[\d.]+M \| branch ratio [\d.]+",
          "affect": r"Accuracy [\d.]+ \| Loss [\d.]+ \| Corr [-\d.]+ \| "
                    r"Total Flops [\d.]+M \| ratio [\d.]+"}
CLIS = {"imdb": (imdb_dyn, "imdb/DynMMNet_freezeTrue_reg_0.1.msgpack",
                 ROUTERS["imdb"][1]),
        "affect": (affect_dyn,
                   "mosei/dyn_enc_transformer_reg_0.01freezeTrue.msgpack",
                   ROUTERS["mosei"][1])}


@pytest.mark.parametrize("name", list(CLIS))
def test_cli_end_to_end_on_cpu(tmp_path, monkeypatch, capsys, name):
    """``--synthetic --freeze --n-epochs 1 --device cpu``: the result line,
    a checkpoint in which only the gate moved (BN statistics follow the
    train-mode forwards, as in the JAX trainer), which JAX reads and
    ``--eval-only`` evaluates to the same line."""
    cli, ckpt, make = CLIS[name]
    monkeypatch.chdir(tmp_path)
    argv = ["--synthetic", "--n-epochs", "1", "--freeze", "--reg", "0.1"
            if name == "imdb" else "0.01", "--no-pretrain", "--device", "cpu"]
    cli.main(argv)
    out = capsys.readouterr().out
    lines = re.findall(RESULT[name], out)
    assert len(lines) == 1, out
    path = tmp_path / "log" / ckpt
    payload = jckpt.load_checkpoint(str(path))
    init = make()
    flax_default_init(init, torch.Generator().manual_seed(0))
    start = flax_variables(init)["params"]
    moved = leaf_errors(payload["state"]["params"], start)
    assert {k for k, e in moved.items() if e > 0} == {
        k for k in moved if k.startswith("/gate")}
    cli.main(argv + ["--eval-only"])
    assert re.findall(RESULT[name], capsys.readouterr().out) == lines


ROBUST = {"imdb": ("imdb", "f1_macro", {"text": [0], "image": [1],
                                         "both": [0, 1]}),
          "affect": ("mosei", "accuracy", {"visual": [0], "audio": [1],
                                           "text": [2]})}


def _jax_robust_lines(name: str) -> list:
    """The JAX CLI's ``--robust`` lines on the port CLI's start weights
    (``build_router(seed=0)``): ``robustness_sweep`` over the JAX
    trainer's hard-gate ``evaluate`` on the synthetic test split."""
    from dynmm_tpu.train import robustness as jrob
    from dynmm_tpu_torch.models.modality import build_router

    kind, metric, groups = ROBUST[name]
    variables = {k: v for k, v in flax_variables(
        build_router(kind, seed=0, device="cpu")).items() if v}
    test = (jimdb.synthetic_imdb_loaders(batch_size=128)[2] if kind == "imdb"
            else jaffect.synthetic_mosei_loaders(batch_size=32)[2])
    jt = jsup.SupervisedTrainer(
        jadapters.dynmm_adapter(ROUTERS[kind][0](), temp=1.0, hard=True,
                                infer_mode=0),
        jsup.SupervisedConfig(**_cfg(kind)))
    state = jt.init_state(variables)
    curves = jrob.robustness_sweep(lambda l: jt.evaluate(state, l), test,
                                   groups)
    return [f"robustness ({mod}): {metric} curve "
            f"{[round(v, 3) for v in curve[metric]]} | relative robustness "
            f"{jrob.relative_robustness(curve[metric]):.3f}"
            for mod, curve in curves.items()]


@pytest.mark.parametrize("name", list(CLIS))
@pytest.mark.parametrize("flag", ["--robust", "--measure", "--routed"])
def test_cli_unported_flags_raise(tmp_path, monkeypatch, capsys, name, flag):
    """The flags that raised before they were ported, each now held to the
    JAX CLI: ``--robust --eval-only`` prints the JAX CLI's robustness
    lines, computed by the JAX package's sweep on the same start weights;
    ``--measure`` (and ``--measure --routed``) prints the JAX CLI's timing
    line (``examples/*_dyn.py``: ``Time measured over 10 reps: %.4f ±
    %.4fs per pass``) after the test line, once."""
    monkeypatch.chdir(tmp_path)
    if flag != "--robust":
        flags = ["--measure"] + (["--routed"] if flag == "--routed" else [])
        CLIS[name][0].main(["--synthetic", "--eval-only", "--device", "cpu",
                            *flags])
        out = capsys.readouterr().out.splitlines()
        timed = [i for i, ln in enumerate(out) if ln.startswith("Time ")]
        assert len(timed) == 1, out
        assert re.fullmatch(r"Time measured over 10 reps: \d+\.\d{4} ± "
                            r"\d+\.\d{4}s per pass", out[timed[0]])
        assert re.match(RESULT[name], out[timed[0] - 1])
        return
    CLIS[name][0].main(["--synthetic", "--robust", "--eval-only", "--device",
                        "cpu"])
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("robustness (")]
    assert got == _jax_robust_lines(name)


def test_entry_points_raise_without_a_card(monkeypatch):
    from dynmm_tpu_torch.models.modality import build_router

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_router("mosei")
    model = build_router("imdb", device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SupervisedTrainer(adapters.dynmm_adapter(model), SupervisedConfig())
    for cli in (imdb_dyn, affect_dyn, imdb_uni, imdb_mm, affect_uni,
                affect_mm):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["--synthetic", "--n-epochs", "1"])
