"""The port's modality-level modules against the JAX package's, on the same
variables (the JAX modules' trees with seeded values) and seeded inputs
(``_port_modality_setup.py``).

* Building blocks: ``MLP``, ``MaxOut_MLP`` (eval, BN statistics randomised),
  ``Transformer`` over ragged lengths (and a sequence with no valid step:
  uniform attention, never NaN), ``Concat``, ``sinusoidal_positions``.
* The three routers in every dense mode (soft, hard, ``infer_mode`` 1, 2,
  −1, and 3 for the three-branch net), ``forward_branch``, the bucket-
  compacted routed forward under several ladders and forced branch mixes,
  and ``forward_switch`` at B=1.
* The weight bridge both ways: the port's state back as the flax tree
  equals the JAX variables leaf for leaf.

Tolerance: max abs error over max |JAX| ≤ 1e-5 in fp32 (the same sums in
another order); gate weights, and so hard-gate choices, identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynmm_tpu.core import routing as jrouting
from dynmm_tpu.nn import fusions as jfusions
from dynmm_tpu.nn import mlp as jmlp
from dynmm_tpu.nn import sequence as jseq
from dynmm_tpu_torch.core import routing
from dynmm_tpu_torch.nn import fusions, mlp, sequence
from dynmm_tpu_torch.utils.weights import flax_variables, load_flax_variables
from tests._port_modality_setup import (ROUTERS, T, as_torch, inputs,
                                        jax_variables, port_router,
                                        random_tree, rel_err)
from tests._port_train_setup import one_torch_thread  # noqa: F401

TOL = 1e-5


@pytest.fixture(scope="module")
def routers():
    """{kind: (jax model, variables, port model)}."""
    out = {}
    for kind in ROUTERS:
        v = jax_variables(kind)
        out[kind] = (ROUTERS[kind][0](), v, port_router(kind, v))
    return out


def _data(kind, b=8, seed=3):
    return inputs("mosei" if kind == "tribranch" else kind, b=b, seed=seed)


def _jax_args(kind, xs, ls):
    xs = [jnp.asarray(x) for x in xs]
    return (xs,) if kind == "imdb" else (xs, [jnp.asarray(l) for l in ls])


def _port_args(kind, xs, ls):
    txs, tls = as_torch(xs, ls)
    return (txs,) if kind == "imdb" else (txs, tls)


def _init(jmodule, *args):
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), *args))
    return random_tree(shapes, np.random.default_rng(5))


# ------------------------------------------------------------ building blocks
def test_mlp_matches_jax():
    x = np.random.default_rng(0).standard_normal((6, 40)).astype(np.float32)
    jm = jmlp.MLP(32, 7)
    v = _init(jm, jnp.asarray(x))
    tm = mlp.MLP(40, 32, 7)
    load_flax_variables(tm, v)
    want = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("linear_layer", [True, False])
def test_maxout_mlp_eval_matches_jax(linear_layer):
    x = np.random.default_rng(1).standard_normal((6, 40)).astype(np.float32)
    jm = jmlp.MaxOut_MLP(5, first_hidden=24, second_hidden=16,
                         linear_layer=linear_layer, dropout_rate=0.0)
    v = _init(jm, jnp.asarray(x))
    assert set(v["batch_stats"]) == {"bn0", "bn1", "bn2"}
    tm = mlp.MaxOut_MLP(5, 24, 40, 16, linear_layer=linear_layer).eval()
    load_flax_variables(tm, v)
    want = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == want.shape
    assert rel_err(got, want) <= TOL


def test_maxout_pairs_pieces_fastest():
    """Maxout takes the max over adjacent columns of its one dense layer
    (piece index fastest): the flax kernel layout pairs the same rows."""
    m = mlp.Maxout(3, 2, num_pieces=2)
    with torch.no_grad():
        m.lin.weight.zero_()
        m.lin.bias.copy_(torch.tensor([1.0, 5.0, 7.0, 2.0]))
        assert m(torch.zeros(1, 3)).tolist() == [[5.0, 7.0]]


@pytest.mark.parametrize("lengths", [[12, 5, 1, 9], [0, 3, 12, 7]])
def test_transformer_ragged_lengths_match_jax(lengths):
    """Ragged lengths, and a sequence with no valid step (length 0): flax
    masks with finfo.min, so its attention is uniform, not NaN."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, T, 35)).astype(np.float32)
    lens = np.array(lengths, np.int32)
    jm = jseq.Transformer(dim=10)
    v = _init(jm, jnp.asarray(x), jnp.asarray(lens))
    tm = sequence.Transformer(35, 10)
    load_flax_variables(tm, v)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(lens))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(lens).long())
    assert bool(torch.isfinite(got).all())
    assert rel_err(got, want) <= TOL


def test_sequence_helpers_and_concat_match_jax():
    lens = np.array([3, 0, 7], np.int32)
    np.testing.assert_array_equal(
        sequence.length_mask(torch.from_numpy(lens), 7).numpy(),
        np.asarray(jseq.length_mask(jnp.asarray(lens), 7)))
    x = np.random.default_rng(3).standard_normal((3, 7, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        sequence.last_valid(torch.from_numpy(x), torch.from_numpy(lens)).numpy(),
        np.asarray(jseq.last_valid(jnp.asarray(x), jnp.asarray(lens))))
    for dim in (10, 11):
        np.testing.assert_allclose(
            sequence.sinusoidal_positions(50, dim).numpy(),
            np.asarray(jseq.sinusoidal_positions(50, dim)), rtol=1e-6,
            atol=1e-6)
    a = np.ones((3, 2, 2), np.float32)
    np.testing.assert_array_equal(
        fusions.Concat()([torch.from_numpy(x), torch.from_numpy(a)]).numpy(),
        np.asarray(jfusions.Concat().apply({}, [jnp.asarray(x),
                                                jnp.asarray(a)])))


# ------------------------------------------------------------------- routers
MODES = [dict(hard=False), dict(hard=True), dict(infer_mode=1),
         dict(infer_mode=2), dict(infer_mode=-1)]


@pytest.mark.parametrize("kind", list(ROUTERS))
@pytest.mark.parametrize("mode", MODES, ids=lambda m: "-".join(
    f"{k}{v}" for k, v in m.items()))
def test_router_dense_forward_matches_jax(routers, kind, mode):
    jm, v, tm = routers[kind]
    xs, ls = _data(kind)
    want_out, want_res, want_w = jm.apply(v, *_jax_args(kind, xs, ls), **mode)
    with torch.no_grad():
        out, res, w = tm(*_port_args(kind, xs, ls), **mode)
    assert out.shape == want_out.shape
    assert rel_err(out, want_out) <= TOL
    assert abs(float(res) - float(want_res)) <= TOL
    if mode.get("hard"):
        np.testing.assert_array_equal(w.numpy(), np.asarray(want_w))
    else:
        assert rel_err(w, want_w) <= TOL


def test_tribranch_third_branch_matches_jax(routers):
    jm, v, tm = routers["tribranch"]
    xs, ls = _data("tribranch")
    want, _, _ = jm.apply(v, *_jax_args("mosei", xs, ls), infer_mode=3)
    with torch.no_grad():
        got, _, _ = tm(*_port_args("mosei", xs, ls), infer_mode=3)
    assert rel_err(got, want) <= TOL


@pytest.mark.parametrize("path", [1, 2, 3])
def test_imdb_forward_branch_matches_jax(routers, path):
    """Path 2 is the image-only branch, off the routing path."""
    jm, v, tm = routers["imdb"]
    xs, _ = _data("imdb")
    want = jm.apply(v, [jnp.asarray(x) for x in xs], path,
                    method=jm.forward_branch)
    with torch.no_grad():
        got = tm.forward_branch(as_torch(xs, None)[0], path)
    assert rel_err(got, want) <= TOL


# ------------------------------------------------------------------- routing
ROUTED = [("imdb", None, None), ("imdb", (0, 16), None),
          ("imdb", (0, 4, 8, 12, 16), [1, 0] * 8),
          ("imdb", None, [0] * 16), ("imdb", (0, 16), [1] * 16),
          ("mosei", None, None), ("mosei", (0, 8, 16), [0, 1, 1] * 5 + [0]),
          ("mosei", (4, 12), [0] * 16), ("mosei", None, [1] * 16),
          ("mosei", (0, 3, 16), [1, 1, 0] + [0] * 13)]


@pytest.mark.parametrize("kind,caps,force_k", ROUTED)
def test_compact_matches_dense_hard(routers, kind, caps, force_k):
    """Each row of the compacted forward equals its branch run densely
    (``infer_mode``, held against JAX above), for the live gate and forced
    mixes, all-cheap and all-expensive ones included; gate weights equal
    dense hard eval's."""
    _, _, tm = routers[kind]
    xs, ls = _data(kind, b=16, seed=4)
    args = _port_args(kind, xs, ls)
    with torch.no_grad():
        got, w = tm.forward_routed_compact(*args, caps=caps, force_k=force_k)
        dense = [tm(*args, infer_mode=i)[0] for i in (1, 2)]
        _, _, w_hard = tm(*args, hard=True)
    np.testing.assert_array_equal(w.numpy(), w_hard.numpy())
    k = w.argmax(1) if force_k is None else torch.tensor(force_k)
    ref = torch.where(k[:, None] == 1, dense[1], dense[0])
    assert rel_err(got, ref) <= TOL


@pytest.mark.parametrize("kind", ["imdb", "mosei"])
def test_compact_matches_jax_routed(routers, kind):
    """A mixed batch through both packages' routed forwards."""
    jm, v, tm = routers[kind]
    xs, ls = _data(kind)
    force_k = np.array([1, 0, 0, 1, 1, 0, 1, 0], np.int32)
    want, want_w = jm.apply(v, *_jax_args(kind, xs, ls), caps=(0, 4, 8),
                            force_k=force_k, method=jm.forward_routed_compact)
    with torch.no_grad():
        got, w = tm.forward_routed_compact(*_port_args(kind, xs, ls),
                                           caps=(0, 4, 8), force_k=force_k)
    np.testing.assert_array_equal(w.numpy(), np.asarray(want_w))
    assert rel_err(got, want) <= TOL


def test_compact_two_branch_ladder_and_stable_order():
    """The rung is the smallest ≥ the participants; equal keys keep their
    order (a stable sort, as ``jnp.argsort``); caps outside [0, B] raise
    as in the JAX package."""
    x = torch.arange(8.0)[:, None]
    k = torch.tensor([1, 0, 1, 0, 0, 1, 0, 0])
    seen = {}

    def branch(tag):
        def fn(ins):
            seen[tag] = ins[0][:, 0].tolist()
            return ins[0] * (10 if tag == "exp" else -1)
        return fn

    out = routing.compact_two_branch(k, (x,), branch("cheap"), branch("exp"),
                                     caps=(0, 4, 8))
    # 3 expensive rows → rung 4, 5 cheap rows → rung 8 (the whole batch)
    assert seen == {"exp": [0.0, 2.0, 5.0, 1.0],
                    "cheap": [0.0, 2.0, 5.0, 1.0, 3.0, 4.0, 6.0, 7.0]}
    want = torch.where(k[:, None] == 1, x * 10, -x)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    jout = jrouting.compact_two_branch(
        jnp.asarray(k.numpy()), (jnp.asarray(x.numpy()),),
        lambda ins: -ins[0], lambda ins: ins[0] * 10, out_shape=(1,),
        caps=(0, 4, 8))
    np.testing.assert_array_equal(np.asarray(jout), out.numpy())
    for bad in ((0, 9), (-1, 8)):
        with pytest.raises(ValueError, match="outside"):
            routing.compact_two_branch(k, (x,), branch("c"), branch("e"),
                                       caps=bad)


@pytest.mark.parametrize("kind", ["imdb", "mosei"])
@pytest.mark.parametrize("branch", [0, 1])
def test_switch_matches_dense_hard(routers, kind, branch):
    """B=1: only the branch the gate picks runs; its output equals dense
    hard eval of the port and of JAX on that sample. A gate bias forces
    each branch."""
    jm, v, tm = routers[kind]
    gate_fc = ("gate", "fc2") if kind == "imdb" else ("gate", "fc")
    v = jax.tree_util.tree_map(np.array, v)
    fc = v["params"][gate_fc[0]][gate_fc[1]]
    fc["kernel"][:] = 0.0
    fc["bias"][:] = [20.0, 0.0] if branch == 0 else [0.0, 20.0]
    load_flax_variables(tm, v)
    xs, ls = _data(kind)
    want, _, want_w = jm.apply(v, *_jax_args(kind, xs, ls), hard=True)
    one = _port_args(kind, [x[:1] for x in xs],
                     None if ls is None else [l[:1] for l in ls])
    with torch.no_grad():
        got, w = tm.forward_switch(*one)
        dense, _, w_d = tm(*one, hard=True)
    load_flax_variables(tm, routers[kind][1])
    assert int(w.argmax()) == branch
    np.testing.assert_array_equal(w.numpy(), np.asarray(want_w)[:1])
    np.testing.assert_array_equal(w.numpy(), w_d.numpy())
    assert rel_err(got, dense) <= TOL
    assert rel_err(got, np.asarray(want)[:1]) <= TOL


# -------------------------------------------------------------------- bridge
@pytest.mark.parametrize("kind", list(ROUTERS))
def test_bridge_round_trip_is_the_jax_tree(routers, kind):
    """The port's state back in the flax layout equals the JAX variables
    (same keys, shapes and values), and loads strictly again."""
    _, v, tm = routers[kind]
    back = flax_variables(tm)
    want = {k: v[k] for k in ("params", "batch_stats") if k in v}
    got = {k: back[k] for k in want}
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (p, a), (_, b) in zip(flat_g, flat_w):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(p))
    if "batch_stats" not in v:
        assert back["batch_stats"] == {}
    load_flax_variables(tm, back)
