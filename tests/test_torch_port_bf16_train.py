"""bf16 training of the port (``ESANetConfig(dtype=torch.bfloat16)``, fp32
parameters) against the JAX package's bf16 training.

The port rounds a train step where the JAX model at ``dtype=bfloat16``
rounds it: convs on a per-call bf16 cast of their parameters (the cast's
backward gives fp32 gradients), the conv's sum rounded before its bias,
BN with fp32 statistics and a bf16 output, the SE MLP on bf16 weights, the
gate in fp32, the learned upsample on bf16 taps, ``log_softmax`` on the
bf16 logits and the class weighting and sums in fp32.

The module tests show it. Each train-mode cell runs forward and backward
(a seeded cotangent) in the port at bf16, in the JAX module at bf16 and in
the JAX module at fp32, on the same bf16 inputs and parameters: the output,
the input gradient, the parameter gradients (together) and the new BN
statistics of the port lie closer to JAX's bf16 ones than half the
distance of JAX's fp32 ones (relative L2): err(port, JAX bf16) ≤ ½ ×
err(JAX fp32, JAX bf16). A cell that computed in fp32 would sit at the
fp32 distance.

The whole steps (the global-gate flagship with SGD and the soft gate; the
local-gate SkipESANet on JAX's Gumbel draws) take one step at B = 8 (the
PPM's 1×1 bin normalises over the batch, degenerate at 2) against the JAX
``SegTrainer``'s step compiled with ``xla_allow_excess_precision`` off:
XLA:CPU otherwise keeps bf16 intermediates of the fused step in fp32,
which moves its BN statistics as far as fp32 does. The loss and the new
BN statistics are held by the ½ rule, and the port's fp32 step must miss
that bound (the control). The updates cannot be: at random init a bf16
step's gradients are mostly rounding noise, and JAX's own bf16 step moves
its updates further than ½ × its fp32 distance when one input pixel moves
by one bf16 step (asserted, the witness). They are held closer to JAX's
bf16 updates than the port's fp32 updates are, at a norm within a factor
2 of JAX's (a zero update fails). The local-gate net's loss is as noisy:
JAX's own bf16 step moves it further than the ½ rule allows under the
same nudge (asserted), so it is held within twice that move. The eval after the step reads the
trained weights (its stale copies differ) and agrees with JAX's eval of
them by ``tests/test_torch_port_bf16.py``'s net bound, 5e-2 of max |JAX
fp32 logits|, with the same gate choices.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _port_train_setup import one_torch_thread  # noqa: F401 (autouse)
from _port_train_setup import (FAST_COMPILE, SMALL, batches, class_weights,
                               compile_fast, random_variables)
from _port_variants_setup import H as VH
from _port_variants_setup import W as VW
from _port_variants_setup import (GumbelFromJax, configs, jax_gumbel_draws)
from _port_variants_setup import random_variables as seeded_variables
from dynmm_tpu.core.gates import sample_gumbel as jax_sample_gumbel
from dynmm_tpu.models import skip_local as jlocal
from dynmm_tpu.models.esanet import ESANetConfig as JaxConfig
from dynmm_tpu.models.resnet import NonBottleneck1D as JaxNBt1D
from dynmm_tpu.models.skip_gate import SkipGateESANet as JaxSkipGate
from dynmm_tpu.nn import layers as jl
from dynmm_tpu.train import seg as jax_seg
from dynmm_tpu.train.seg_losses import weighted_ce_2d as jax_ce
from dynmm_tpu_torch.models import skip_local
from dynmm_tpu_torch.models.esanet import ESANetConfig
from dynmm_tpu_torch.models.resnet import NonBottleneck1D
from dynmm_tpu_torch.models.skip_gate import SkipGateESANet
from dynmm_tpu_torch.nn import layers
from dynmm_tpu_torch.nn.layers import pack_weights
from dynmm_tpu_torch.train.seg import SegTrainConfig, SegTrainer
from dynmm_tpu_torch.train.seg_losses import weighted_ce_2d
from dynmm_tpu_torch.utils.weights import (flax_from_state_dict,
                                           load_flax_variables)
from tests.test_torch_port_layers import _flax, _port

BF = torch.bfloat16


def _round16(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bf16 values, as float32."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(a, np.float64).ravel()
                           for a in jax.tree_util.tree_leaves(tree)])


def _rel(a, b) -> float:
    a, b = _flat(a), _flat(b)
    assert a.shape == b.shape
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_step(jm, variables, inputs, cot, method=None, **kw):
    """A JAX module's forward and backward: (output, input gradients,
    parameter gradients, new BN statistics), as numpy."""
    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}
    mutable = "batch_stats" in variables

    def fn(p, *xs):
        out = jm.apply({"params": p, **rest}, *xs, method=method,
                       **({"train": True, "mutable": ["batch_stats"]}
                          if mutable else {}), **kw)
        return out if mutable else (out, {})

    out, vjp, stats = jax.vjp(fn, params, *inputs, has_aux=True)
    grads = vjp(jnp.asarray(cot, out.dtype))
    host = lambda t: jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.float32)), t)
    return host(out), host(list(grads[1:])), host(grads[0]), host(
        stats.get("batch_stats", {}))


def _nchw_leaf(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).to(BF).requires_grad_()


def _port_step(tm, inputs, cot, call):
    """The port's module in train mode at bf16: (output NHWC, input
    gradients NHWC, parameter gradients and BN statistics as flax
    trees)."""
    layers.set_compute_dtype(tm, BF)
    tm.train()
    xs = [_nchw_leaf(x) for x in inputs]
    out = call(tm, *[x.permute(0, 3, 1, 2) if x.dim() == 4 else x
                     for x in xs])
    nhwc = out.dim() == 4
    out_nhwc = out.permute(0, 2, 3, 1) if nhwc else out
    out_nhwc.backward(torch.from_numpy(cot).to(out.dtype))
    wrap = torch.nn.ModuleDict({"m": tm})
    grads = flax_from_state_dict({n: p.grad for n, p in
                                  wrap.named_parameters()})["params"]["m"]
    stats = flax_from_state_dict(wrap.state_dict())["batch_stats"]
    f32 = lambda t: t.detach().float().numpy()
    return (f32(out_nhwc), [f32(x.grad) for x in xs], grads,
            stats.get("m", {}))


PARTS = ("output", "input grads", "param grads", "BN statistics")


def _hold(name, ours, j16, j32, accuracy=()):
    """err(port bf16, JAX bf16) ≤ ½ err(JAX fp32, JAX bf16) for every part
    of (output, input grads, param grads, BN statistics) present; the
    parts in ``accuracy`` instead: err(port bf16, JAX fp32) ≤ err(JAX bf16,
    JAX fp32)."""
    rows = {}
    for part, p, a, b in zip(PARTS, ours, j16, j32):
        if jax.tree_util.tree_leaves(a):
            rows[part] = ((_rel(p, b), _rel(a, b)) if part in accuracy
                          else (_rel(p, a), 0.5 * _rel(b, a)))
    print(name, {k: f"{e:.3g} (bound {f:.3g})" for k, (e, f) in rows.items()})
    bad = {part: v for part, v in rows.items() if v[0] > v[1]}
    assert not bad, (name, bad)


def _check_module(name, make_jax, port, variables, inputs, call,
                  method=None, accuracy=(), **kw):
    """``_hold`` on a train-mode module: the JAX module at bf16 and at
    fp32, the port's at bf16, on the same bf16 inputs, parameters and
    seeded cotangent."""
    x16 = [_round16(x) for x in inputs]
    jm16, jm32 = make_jax(jnp.bfloat16), make_jax(None)
    shape = jax.eval_shape(
        lambda *xs: jm16.apply(variables, *xs, method=method, **(
            {"train": True, "mutable": ["batch_stats"]}
            if "batch_stats" in variables else {}), **kw),
        *[jnp.asarray(x, jnp.bfloat16) for x in x16])
    shape = shape[0] if "batch_stats" in variables else shape
    rng = np.random.default_rng(7)
    cot = _round16(rng.standard_normal(shape.shape).astype(np.float32))
    j16 = _jax_step(jm16, variables, [jnp.asarray(x, jnp.bfloat16)
                                      for x in x16], cot, method, **kw)
    j32 = _jax_step(jm32, variables, [jnp.asarray(x) for x in x16], cot,
                    method, **kw)
    _hold(name, _port_step(port, x16, cot, call), j16, j32, accuracy)


def test_conv_bn_act_train_bf16():
    rng = np.random.default_rng(31)
    x = rng.standard_normal((2, 12, 16, 16)).astype(np.float32)
    jm = jl.ConvBNAct(24, 3)
    v = _flax(jm, rng, x)
    _check_module("ConvBNAct", lambda dt: jl.ConvBNAct(24, 3, dtype=dt),
                  _port(layers.ConvBNAct(16, 24, 3), v), v, [x],
                  lambda m, x: m(x))


def test_nonbottleneck1d_train_bf16():
    rng = np.random.default_rng(32)
    x = rng.standard_normal((2, 12, 16, 16)).astype(np.float32)
    jm = JaxNBt1D(16)
    v = _flax(jm, rng, x)
    _check_module("NonBottleneck1D", lambda dt: JaxNBt1D(16, dtype=dt),
                  _port(NonBottleneck1D(16, 16), v), v, [x],
                  lambda m, x: m(x))


def test_se_fusion_cell_train_bf16():
    rng = np.random.default_rng(33)
    rgb, depth = (rng.standard_normal((3, 6, 8, 32)).astype(np.float32)
                  for _ in range(2))
    jm = jl.SqueezeAndExciteFusionAdd(32)
    v = _flax(jm, rng, rgb, depth)
    w = np.array([0.0, 0.375, 1.0], np.float32)
    _check_module(
        "SE fusion", lambda dt: jl.SqueezeAndExciteFusionAdd(32, dtype=dt),
        _port(layers.SqueezeAndExciteFusionAdd(32), v), v, [rgb, depth],
        lambda m, r, d: m.fuse_mixed(r, d, torch.from_numpy(w),
                                     use_kernels=False),
        method="fuse_mixed", accuracy=("param grads",), w_rgb=jnp.asarray(w))


def test_stem_cell_train_bf16():
    rng = np.random.default_rng(34)
    rgb, depth = (rng.standard_normal((2, 12, 16, 16)).astype(np.float32)
                  for _ in range(2))
    jm = jl.SqueezeAndExciteFusionAdd(16)
    v = _flax(jm, rng, rgb, depth)
    _check_module(
        "stem cell", lambda dt: jl.SqueezeAndExciteFusionAdd(16, dtype=dt),
        _port(layers.SqueezeAndExciteFusionAdd(16), v), v, [rgb, depth],
        lambda m, r, d: m.fuse_and_pool(r, d, use_kernels=False)[0],
        method=lambda m, r, d: m.fuse_and_pool(r, d)[0])


def test_batchnorm_train_bf16_is_the_fp32_cast():
    """Train-mode BN of a bf16 map (``_WideBatchNorm``) against
    ``F.batch_norm`` on the map cast to fp32 with the output cast back, the
    JAX BN's order: output, gradients and running statistics bit-equal on
    the CPU, with the incoming gradient channels-last or contiguous.
    ``F.batch_norm`` on the bf16 map itself rounds otherwise (the share of
    its input gradient that differs is printed)."""
    rng = np.random.default_rng(38)
    c, shape = 16, (2, 16, 9, 10)
    x = torch.from_numpy(_round16(3 * rng.standard_normal(shape).astype(
        np.float32) + 1)).to(BF).contiguous(memory_format=torch.channels_last)
    cot = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        BF)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(c).astype(np.float32))

    def run(fn, g):
        xi = x.detach().requires_grad_()
        wi, bi = (torch.nn.Parameter(t.clone()) for t in (w, b))
        stats = (torch.zeros(c), torch.ones(c))
        y = fn(xi, wi, bi, stats)
        y.backward(g)
        return y.detach(), xi.grad, wi.grad, bi.grad, *stats

    def port(t, wi, bi, st):
        bn = layers.BatchNorm2d(c).train()
        bn.weight, bn.bias = wi, bi
        bn.running_mean, bn.running_var = st
        return bn(t)

    for layout in (torch.channels_last, torch.contiguous_format):
        g = cot.contiguous(memory_format=layout)
        ref = run(lambda t, wi, bi, st: F.batch_norm(
            t.float(), *st, wi, bi, True, 0.1, 1e-5).to(BF), g)
        for got, want in zip(run(port, g), ref):
            assert got.dtype == want.dtype and torch.equal(got, want)
        mixed = run(lambda t, wi, bi, st: F.batch_norm(
            t, *st, wi, bi, True, 0.1, 1e-5), g)
        print(f"F.batch_norm on the bf16 map, gradient {layout}: its input "
              "gradient differs from the fp32 cast's on "
              f"{(mixed[1] != ref[1]).float().mean().item():.3g} of the map")


def test_upsample_train_bf16():
    rng = np.random.default_rng(35)
    x = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
    jm = jl.Upsample(mode="learned-3x3-zeropad", channels=8)
    v = _flax(jm, rng, x)
    _check_module(
        "Upsample",
        lambda dt: jl.Upsample(mode="learned-3x3-zeropad", channels=8,
                               dtype=dt),
        _port(layers.Upsample("learned-3x3-zeropad", 8), v), v, [x],
        lambda m, x: m(x, use_kernels=False),
        accuracy=("output", "input grads", "param grads"))


def test_se_weight_train_bf16():
    """The local gate's SE weight (``SqueezeAndExcitationWeight``) from the
    map's channel means, as the port's gate computes it."""
    rng = np.random.default_rng(36)
    x = rng.standard_normal((3, 6, 8, 32)).astype(np.float32)
    jm = jl.SqueezeAndExcitationWeight(32)
    v = _flax(jm, rng, x)
    _check_module(
        "SE weight", lambda dt: jl.SqueezeAndExcitationWeight(32, dtype=dt),
        _port(layers.SqueezeAndExcitationWeight(32), v), v, [x],
        lambda m, x: m.from_means(x.float().mean(dim=(2, 3)), x.dtype),
        accuracy=("input grads", "param grads"))


def test_local_gate_train_bf16(monkeypatch):
    """The local gate (``SqueezeAndExciteReweigh``, soft, temperature 0.7)
    on the JAX gate's Gumbel draws: its SE weight, the outer sigmoid, the
    logits ``[w, 1 − w]`` over the temperature and the Gumbel softmax. Its
    parameter gradients are the SE weight's, held as in
    ``test_se_weight_train_bf16``."""
    rng = np.random.default_rng(39)
    rgb, depth = (rng.standard_normal((3, 6, 8, 16)).astype(np.float32)
                  for _ in range(2))
    key = jax.random.PRNGKey(5)
    jm = jl.SqueezeAndExciteReweigh(16)
    v = _flax(jm, rng, key, rgb, depth)
    GumbelFromJax(monkeypatch, [np.asarray(
        jax_sample_gumbel(key, (3, 2), jnp.float32))])
    _check_module(
        "local gate",
        lambda dt: jl.SqueezeAndExciteReweigh(16, dtype=dt),
        _port(layers.SqueezeAndExciteReweigh(16), v), v, [rgb, depth],
        lambda m, r, d: m(r, d, torch.Generator(), temp=0.7,
                          use_kernels=False),
        method=lambda m, r, d: m(key, r, d, temp=0.7),
        accuracy=("param grads",))


def test_loss_train_bf16():
    """``weighted_ce_2d`` on bf16 logits (void pixels included), its
    gradient with respect to the logits."""
    rng = np.random.default_rng(37)
    logits = _round16(3 * rng.standard_normal((2, 12, 16, 5)).astype(
        np.float32))
    labels = rng.integers(0, 6, (2, 12, 16)).astype(np.uint8)
    cw = rng.uniform(0.5, 2.0, 5).astype(np.float32)

    def jax_side(dtype):
        f = lambda lg: jax_ce(lg, jnp.asarray(labels), jnp.asarray(cw))
        loss, vjp = jax.vjp(f, jnp.asarray(logits, dtype))
        (g,) = vjp(jnp.ones((), loss.dtype))
        return (np.asarray(loss), [np.asarray(jnp.asarray(g, jnp.float32))],
                {}, {})

    x = torch.from_numpy(logits).to(BF).requires_grad_()
    loss = weighted_ce_2d(x, torch.from_numpy(labels), torch.from_numpy(cw))
    assert loss.dtype == torch.float32
    loss.backward()
    ours = (loss.detach().numpy(), [x.grad.float().numpy()], {}, {})
    _hold("loss", ours, jax_side(jnp.bfloat16), jax_side(jnp.float32))


# ---------------------------------------------------------- whole steps
LR, TEMP = 3e-4, 0.7
STEP_B = 8  # the PPM's 1×1 bin normalises over the batch: 2 is degenerate
NET_TOL = 5e-2
# XLA:CPU keeps bf16 intermediates of a fused step in fp32 by default; the
# reference step rounds every op to the module's dtype, as the port does
STRICT = {**FAST_COMPILE, "xla_allow_excess_precision": False}


def _jax_steps(jmodel, variables, batches_, cw, kw, options):
    """The first step of the JAX ``SegTrainer`` from ``variables`` on each
    of ``batches_``, compiled once with ``options``: [(state, logs)],
    numpy."""
    cfg = jax_seg.SegTrainConfig(epochs=1, lr=LR, **kw)
    trainer = jax_seg.SegTrainer(jmodel, cfg, cw)
    trainer.tx = jax_seg.make_seg_optimizer(cfg, variables["params"])
    out = []
    for batch in batches_:
        state = {"params": variables["params"],
                 "model_state": {"batch_stats": variables["batch_stats"]},
                 "opt_state": trainer.tx.init(variables["params"])}
        key = (False, False, False)
        if key not in trainer._train_steps:
            targets = [jnp.asarray(batch["label"])] + [
                jnp.asarray(batch["label_down"][r]) for r in (8, 16, 32)]
            trainer._train_steps[key] = trainer._get_train_step(key).lower(
                state, jnp.asarray(batch["image"]),
                jnp.asarray(batch["depth"]), targets, LR, TEMP,
                jax.random.PRNGKey(0)).compile(compiler_options=options)
        state, logs = trainer.train_one_epoch(state, [batch], 0, LR, TEMP)
        out.append((jax.tree_util.tree_map(np.asarray, state), logs))
    return out


def _port_train(model, variables, batch, cw, kw):
    """One step of the port's ``SegTrainer`` on the CPU: (state, logs)."""
    load_flax_variables(model, variables)
    trainer = SegTrainer(model, SegTrainConfig(epochs=1, lr=LR, **kw), cw,
                         device="cpu")
    return trainer.train_one_epoch(trainer.init_state(), [batch], 0, LR,
                                   TEMP)


def _moves(tree, variables) -> dict:
    """The step's loss, parameter updates and BN statistic changes."""
    tree, logs = tree
    sub = lambda a, b: jax.tree_util.tree_map(
        lambda x, y: np.asarray(x, np.float64) - np.asarray(y, np.float64),
        a, b)
    if not isinstance(tree, dict):
        tree = flax_from_state_dict(tree.model.state_dict())
        tree = {"params": tree["params"],
                "model_state": {"batch_stats": tree["batch_stats"]}}
    return {"loss": np.float64(logs["loss_train_total"]),
            "updates": sub(tree["params"], variables["params"]),
            "BN statistics": sub(tree["model_state"]["batch_stats"],
                                 variables["batch_stats"])}


def _nudged(batch: dict) -> dict:
    """``batch`` with its first image value one bf16 step larger (in the
    bf16 map the stem makes of it)."""
    image = batch["image"].copy()
    image[0, 0, 0, 0] = _round16(_round16(image[0, 0, 0, 0])
                                 * np.float32(1 + 2 ** -7))
    return dict(batch, image=image)


def _whole_step(name, runs, variables, noisy_loss=False):
    """One bf16 train step of the port against the JAX package's (module
    docstring). ``runs``: (state, logs) of the port at bf16 and fp32, of
    JAX at bf16 (strict rounding), at fp32, and at bf16 on the nudged
    batch. ``noisy_loss``: the net's bf16 loss moves further than the ½
    rule allows when one input pixel moves by one bf16 step (asserted on
    JAX's own step, the witness), so the loss is held within twice that
    move, and the BN statistics alone take the ½ rule and its control."""
    m = {k: _moves(v, variables) for k, v in runs.items()}
    err = lambda part, a: _rel(m[a][part], m["jax16"][part])
    for part in ("loss", "BN statistics"):
        ours, bound = err(part, "port16"), 0.5 * err(part, "jax32")
        control = err(part, "port32")
        print(f"{name}: {part} err(port bf16, JAX bf16) {ours:.3g}, bound "
              f"½ err(JAX fp32, JAX bf16) {bound:.3g}; the port's fp32 step "
              f"{control:.3g}")
        if noisy_loss and part == "loss":
            jax_noise = err(part, "nudged")
            print(f"{name}: loss of JAX's bf16 step on the nudged batch "
                  f"{jax_noise:.3g}")
            assert jax_noise > bound, (name, "the loss is not noisy")
            assert np.isfinite(ours) and ours <= 2 * jax_noise, (name, part)
            continue
        assert np.isfinite(ours) and ours <= bound, (name, part)
        assert control > bound, (name, part, "the control passes")
    ours, fp32 = err("updates", "port16"), err("updates", "port32")
    jax32, jax_noise = err("updates", "jax32"), err("updates", "nudged")
    norm = lambda a: np.linalg.norm(_flat(m[a]["updates"]))
    size = norm("port16") / norm("jax16")
    print(f"{name}: updates err(port bf16, JAX bf16) {ours:.3g}, the "
          f"port's fp32 step {fp32:.3g}; JAX's fp32 step {jax32:.3g} (the ½ "
          f"rule would be {0.5 * jax32:.3g}), JAX's bf16 step on the nudged "
          f"batch {jax_noise:.3g}; |port bf16 update| / |JAX bf16 update| "
          f"{size:.3g}")
    # JAX's own bf16 updates move further than the ½ rule allows when one
    # input pixel moves by one bf16 step: the rule cannot hold here
    assert jax_noise > 0.5 * jax32, name
    assert ours < fp32 and 0.5 <= size <= 2.0, name


def _runs(make_jax, make_port, variables, batch, cw, kw, monkeypatch=None,
          draws=None) -> dict:
    """The five steps ``_whole_step`` holds; with ``draws`` the port's
    gates take those Gumbel draws."""
    j16, nudged = _jax_steps(make_jax(jnp.bfloat16), variables,
                             [batch, _nudged(batch)], cw, kw, STRICT)
    (j32,) = _jax_steps(make_jax(None), variables, [batch], cw, kw,
                        FAST_COMPILE)
    out = {"jax16": j16, "nudged": nudged, "jax32": j32}
    for key, dtype in (("port16", BF), ("port32", None)):
        if draws is not None:
            GumbelFromJax(monkeypatch, draws)
        out[key] = _port_train(make_port(dtype), variables, batch, cw, kw)
    return out


@pytest.fixture(scope="module")
def flagship():
    """One SGD step (soft gate, FLOP hinge) of the training harness's
    flagship at B = 8, in both packages at bf16 and fp32, and JAX's bf16
    step again with one input pixel moved by one bf16 step."""
    variables, cw = random_variables(1), class_weights()
    batch = batches(1, b=STEP_B)[0]
    kw = dict(optimizer="SGD", loss_ratio=0.1)
    runs = _runs(
        lambda dtype: JaxSkipGate(JaxConfig(dtype=dtype, **SMALL)),
        lambda dtype: SkipGateESANet(ESANetConfig(dtype=dtype, **SMALL)),
        variables, batch, cw, kw)
    return {"variables": variables, "runs": runs}


def test_flagship_bf16_step_matches_jax(flagship):
    _whole_step("flagship", flagship["runs"], flagship["variables"])


def test_bf16_eval_after_the_step_reads_the_trained_weights(flagship):
    """The port's bf16 eval forward after its step (``pack_weights``, as
    ``validate`` calls it) against the JAX net's eval of the same trained
    weights (the port's, carried across: the two packages' bf16 updates
    part, above), by ``tests/test_torch_port_bf16.py``'s net bounds:
    logits within 5e-2 of max |JAX fp32 logits|, the gate choices JAX's
    (the gate computes in fp32). Before ``pack_weights`` the bf16 copies
    still hold the weights from before the step, and miss that bound."""
    model = flagship["runs"]["port16"][0].model.eval()
    trained = flax_from_state_dict(model.state_dict())
    test = batches(1, phase="test", seed=3)[0]
    jm = JaxSkipGate(JaxConfig(**SMALL))
    apply = jax.jit(lambda v, r, d: jm.apply(v, r, d, train=False, hard=True,
                                             return_weight=True))
    args = (trained, jnp.asarray(test["image"]), jnp.asarray(test["depth"]))
    ref, ref_w = (np.asarray(a) for a in compile_fast(apply, *args)(*args))
    rgb, depth = (torch.from_numpy(test[k]) for k in ("image", "depth"))
    with torch.no_grad():
        stale = model(rgb, depth, hard=True)
        pack_weights(model)
        out, w = model(rgb, depth, hard=True, return_weight=True)
    assert out.dtype == BF
    scale = np.abs(ref).max()
    err = np.abs(out.float().numpy() - ref).max() / scale
    stale_err = np.abs(stale.float().numpy() - ref).max() / scale
    print(f"bf16 eval after the step vs the JAX fp32 eval of the trained "
          f"weights: {err:.3g} of max |logits| (bound {NET_TOL}); with the "
          f"stale copies {stale_err:.3g}")
    assert err <= NET_TOL
    np.testing.assert_array_equal(w.float().numpy(), ref_w)
    assert stale_err > NET_TOL


def test_local_gate_bf16_step_matches_jax(monkeypatch):
    """One SGD step of the local-gate SkipESANet (block rule 1122) at bf16,
    the port's gates on the JAX Gumbel draws of the step's key."""
    jcfg, pcfg = configs(fuse_depth_in_rgb_encoder="add")
    rule = (1, 1, 2, 2)
    b = batches(1, h=VH, w=VW, b=STEP_B)[0]
    variables = seeded_variables(lambda: jlocal.SkipESANet(
        jcfg, block_rule=rule).init(
        jax.random.PRNGKey(0), jnp.asarray(b["image"][:1]),
        jnp.asarray(b["depth"][:1]), jax.random.PRNGKey(1)), 2)
    kw = dict(optimizer="SGD", dynamic=True, global_gate=False)
    sub = jax.random.split(jax.random.PRNGKey(0))[1]
    runs = _runs(
        lambda dtype: jlocal.SkipESANet(dataclasses.replace(jcfg, dtype=dtype),
                                        block_rule=rule),
        lambda dtype: skip_local.SkipESANet(
            dataclasses.replace(pcfg, dtype=dtype), block_rule=rule),
        variables, b, class_weights(), kw, monkeypatch,
        jax_gumbel_draws(sub, STEP_B))
    _whole_step("local gate", runs, variables, noisy_loss=True)
