"""SkipGateESANet — fusion-level DynMM with a global 5-way gate (port of
``dynmm_tpu/models/skip_gate.py``).

One gate, computed after the stem from both modality maps, weights 5 paths
("fuse depth for the first k stages", k ∈ {0..4}). The dense forward
computes every branch and mixes with cumulative gate weights: block i's
unfused rgb branch gets ``Σ_{j<i} w_j`` for i = 1..3, and block 4 takes
``1 − w_4`` (the reference's quirk, kept as it is). With the hard gate the
one-hot weights make the mix exact.

Execution strategies, all hard-gate eval and all equal to the dense forward
(``forward_routed_compact`` in ``strict_caps`` mode only where no rung
overflows):

* ``forward`` — dense: every depth stage on every sample.
* ``forward_switch_batched`` — depth stages 1..max(k) over the batch.
* ``forward_routed_compact`` — depth sorted into descending-path order,
  stage i run on a prefix sized from a capacity ladder, its output
  scattered back to caller order before the fusion.
* ``forward_switch`` — batch 1: depth stages 1..k, unmixed fusion.

The JAX package picks the executed branch inside the compiled graph with
``lax.cond``/``lax.switch``. Eager PyTorch uses Python ``if``s on values
read to the host once per request: one ``.tolist()``/``int()`` of the gate's
choices right after the gate, which waits for the stems and the gate to
finish on the card. A skipped depth stage launches nothing. While
``torch.export`` traces (``torch.compiler.is_exporting()``), the choices
stay on the device and each stage is a ``torch.cond``, as in JAX
(``_depth_stage``, ``_ladder``); a Python-int ``force_path`` stays a
static path.

Kernel sites: the stem cell (``channel_sums`` + ``stem_fuse_pool``; with
plain ``add`` fusion ``stem_fuse_pool`` alone, unit scales), every
stride-1 NonBottleneck1D block (one ``nbt1d_fused`` up to 64 channels, two
``nbt1d_pair`` above; BasicBlock and Bottleneck encoders are cuDNN), each
SE-add fusion cell that runs (``se_fuse_mixed``, in the unmixed form with
w = 0; C ≤ 2048, so ResNet50's too; plain ``add`` fusion mixes as
``rgb + (1−w)·depth`` in PyTorch ops) and the learned upsamples
(``learned_upsample``; three with ``low_res``). ``use_kernels=False`` runs
the plain PyTorch version of each instead, on the same weights.

Training (``model.train()``): ``forward`` is the dense soft- or hard-gated
forward of the JAX ``__call__(train=True)``, with BN on batch statistics,
every cell on its plain PyTorch version reading the parameters themselves
(no kernel has a backward, as in JAX), and it returns
``((out, down_8, down_16, down_32), expected_cost_loss(weight, table))``.
``ini_stage`` (train or eval) draws uniform random one-hot paths from the
``torch.Generator`` the caller passes. ``FLOP_TABLES`` and
``capacity_ladders`` are kept here as numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from dynmm_tpu_torch.core.gates import diff_softmax
from dynmm_tpu_torch.core.resource import expected_cost_loss
from dynmm_tpu_torch.core.routing import permute_rows, scatter_rows
from dynmm_tpu_torch.models.esanet import ESANetConfig, _DualEncoderParts
from dynmm_tpu_torch.nn.layers import BatchNorm2d, nchw, nhwc

# Analytic per-path GFLOP tables (reference model_skip_mod_globalgate.py
# :217-223). depth_enc: cost of the depth encoder under hard path k;
# total: whole-network cost per hard path.
FLOP_TABLES = {
    "resnet34": {
        "gate": np.array([0.0, 3.27, 7.27, 13.15, 16.02]),
        "depth_enc": np.array([0.2506752, 3.1113216, 6.9470208, 12.66432,
                               15.538944]),
        "total": np.array([22.37101509, 25.23166149, 29.06736069,
                           34.78465989, 37.65928389]),
    },
    "resnet50": {
        "depth_enc": np.array([0.2506752, 4.39420573, 10.72382115,
                               19.71582947, 24.679084]),
        "total": np.array([32.5854654, 36.728995928, 43.058611352,
                           52.050619672, 57.0138742]),
    },
}


def flop_table(encoder_rgb: str, key: str = "depth_enc") -> np.ndarray:
    name = "resnet34" if encoder_rgb == "resnet34" else "resnet50"
    return FLOP_TABLES[name][key]


def capacity_ladders(branch_ratios, bs: int,
                     capacity_factor: Optional[float] = None) -> tuple:
    """Per-stage capacity schedule for ``forward_routed_compact`` from a
    gate's branch ratios (5,).

    Stage i's expected participant count is ``bs · P(k ≥ i)``: its ladder
    is that count rounded up plus the ``bs`` rung that keeps any batch
    exact, ``(bs,)`` for an always-on stage. With ``capacity_factor`` it is
    a strict single-rung schedule (pass ``strict_caps=True``): rung i is
    ``ceil(bs · P(k ≥ i) · factor)`` clipped to ``bs`` and made
    non-increasing across stages, so a row dropped at one stage never
    re-enters a later one; a live stage keeps a rung ≥ 1."""
    r = np.asarray(branch_ratios, dtype=np.float64)
    assert r.shape == (5,)
    if capacity_factor is not None:
        rungs = []
        for i in range(1, 5):
            p = float(r[i:].sum())
            c = 0 if p <= 0 else min(
                bs, int(np.ceil(p * bs * capacity_factor - 1e-9)))
            if rungs:
                c = min(c, rungs[-1])
            rungs.append(c)
        return tuple((c,) for c in rungs)
    out = []
    for i in range(1, 5):
        exp = int(np.ceil(float(r[i:].sum()) * bs - 1e-9))
        out.append((bs,) if exp >= bs else (exp, bs))
    return tuple(out)


def _stage_ladders(caps, bs: int, strict_caps: bool) -> list[list[int]]:
    """Four sorted ladders (one per depth stage) from a shared ladder, four
    ladders or ``None`` (``(0, bs//2, bs)``); raises where the JAX model
    asserts."""
    if caps is None:
        caps = (0, bs // 2, bs)
    if isinstance(caps[0], (tuple, list)):
        if len(caps) != 4:
            raise ValueError("per-stage caps need 4 ladders (stages 1-4)")
        ladders = [sorted(set(c)) for c in caps]
    else:
        ladders = [sorted(set(caps))] * 4
    for lad in ladders:
        if lad[0] < 0 or lad[-1] > bs:
            raise ValueError(f"capacity ladder {lad} outside [0, {bs}]")
        if not strict_caps and lad[-1] != bs:
            raise ValueError(
                "exact mode needs the bs fallback rung; pass "
                "strict_caps=True for capacity-factor drop semantics")
    return ladders


class GlobalGate(nn.Module):
    """concat(rgb, depth) at 1/4 res → 2 × (5×5/2 conv → BN → tanh) → global
    average pool → 1×1 conv to ``branch_num`` logits → DiffSoftmax. Runs in
    fp32; one conv on the concatenation equals the JAX split sum."""

    def __init__(self, in_channels: int = 64, branch_num: int = 5,
                 hidden_dim: int = 8):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(2 * in_channels, hidden_dim, 5, stride=2),
            BatchNorm2d(hidden_dim), nn.Tanh(),
            nn.Conv2d(hidden_dim, hidden_dim, 5, stride=2),
            BatchNorm2d(hidden_dim), nn.Tanh())
        self.fc = nn.Conv2d(hidden_dim, branch_num, 1, bias=False)

    def logits(self, rgb, depth):
        # at least fp32, wider where the parameters are (float64 tests)
        dt = torch.promote_types(torch.float32, self.fc.weight.dtype)
        x = self.conv(torch.cat([rgb.to(dt), depth.to(dt)], dim=1))
        return self.fc(x.mean(dim=(2, 3), keepdim=True))[:, :, 0, 0]

    def forward(self, rgb, depth, temp: float = 1.0, hard: bool = False):
        return diff_softmax(self.logits(rgb, depth), tau=temp, hard=hard,
                            dim=-1)


class SkipGateESANet(_DualEncoderParts):
    """Fusion-level DynMM segmentation net. Public layout is NHWC:
    ``forward(rgb (B,H,W,3), depth (B,H,W,1))`` → logits (B,H,W,classes)."""

    def __init__(self, cfg: ESANetConfig):
        super().__init__(cfg)
        self.gate_layer = GlobalGate(branch_num=5)

    def _stems(self, rgb, depth, use_kernels: bool = True):
        """NHWC images → the two pooled stem maps (NCHW)."""
        rgb = self.encoder_rgb.stem(nchw(rgb))
        depth = self.encoder_depth.stem(nchw(depth))
        return self.stem_pool(rgb, depth, use_kernels)

    @staticmethod
    def _rgb_weight(weight, i: int):
        """Block i's unfused-rgb weight (B,): the cumulative probability
        that the gate stopped fusing before i, ``Σ_{j<i} w_j``, for i = 1..3;
        ``1 − w_4`` for block 4 (the reference's quirk)."""
        return weight[:, :i].sum(dim=1) if i < 4 else 1.0 - weight[:, 4]

    def _fuse_mixed_scatter(self, i: int, rgb, d_p, w_rgb, order,
                            use_kernels: bool = True):
        """``fuse_mixed`` for the compacted depth layout: ``rgb`` is the
        whole batch in caller order, ``d_p`` the depth stage's output on the
        sorted prefix (original samples ``order[:cap]``), ``w_rgb`` the
        caller-order weights. ``d_p`` is scattered into a zero batch and the
        fusion cell runs as in the dense forward: rows outside the prefix
        have depth 0, and rows inside it that do not fuse (prefix padding)
        have w = 1, so neither adds a depth term — the JAX
        ``rgb·s_r' + scatter(d_p·s_d')`` exactly. An overflowed participant
        (strict caps) keeps ``rgb·s_r`` and loses only its depth term."""
        depth = nchw(scatter_rows(nhwc(d_p), order, rgb.shape[0]))
        return self.fuse_mixed(i, rgb, depth, w_rgb, use_kernels)

    def _zero_depth(self, i: int, like: torch.Tensor) -> torch.Tensor:
        """Zero depth map of stage ``i``'s output shape (batch and size of
        ``like``), channels_last."""
        c = self.encoder_depth.down_channels[4 * 2 ** (i - 1)]
        b, _, h, w = like.shape
        return torch.zeros((b, c, h, w), device=like.device, dtype=like.dtype
                           ).to(memory_format=torch.channels_last)

    @staticmethod
    def random_paths(bs: int, generator: torch.Generator) -> torch.Tensor:
        """``ini_stage``'s uniform random paths in 0..4, (bs,) int64, drawn
        on the generator's device."""
        return torch.randint(0, 5, (bs,), generator=generator,
                             device=generator.device)

    def gate_weights(self, rgb, depth, temp: float = 1.0, hard: bool = False,
                     baseline: bool = False, ini_stage: bool = False,
                     generator: Optional[torch.Generator] = None):
        """(B, 5) path weights from the pooled stem maps; ``baseline``
        forces path 4 (static ESANet); ``ini_stage`` draws uniform random
        one-hot paths from ``generator`` (warm-up exploration)."""
        bs = rgb.shape[0]
        if baseline:
            w = torch.zeros((bs, 5), device=rgb.device, dtype=rgb.dtype)
            w[:, 4] = 1.0
            return w
        if ini_stage:
            if generator is None:
                raise ValueError("ini_stage draws its paths from a "
                                 "torch.Generator; pass generator=")
            idx = self.random_paths(bs, generator).to(rgb.device)
            return nn.functional.one_hot(idx, 5).to(rgb.dtype)
        return self.gate_layer(rgb, depth, temp=temp, hard=hard)

    def gate_only(self, rgb, depth, temp: float = 1.0,
                  use_kernels: bool = True):
        """Stems + hard gate: (B, 5) one-hot path weights."""
        r, d = self._stems(rgb, depth, use_kernels)
        return self.gate_weights(r, d, temp=temp, hard=True)

    def forward(self, rgb, depth, temp: float = 1.0, hard: bool = False,
                baseline: bool = False, return_weight: bool = False,
                low_res: bool = False, use_kernels: bool = True,
                ini_stage: bool = False,
                generator: Optional[torch.Generator] = None):
        """Dense forward. In eval: NHWC logits (H/4 with ``low_res``), or
        ``(logits, weight)``. In training: ``(preds, loss_flop)``, preds the
        NHWC ``(out, down_8, down_16, down_32)``, on the plain versions."""
        use_kernels = use_kernels and not self.training
        rgb, depth = self._stems(rgb, depth, use_kernels)
        ini = {"ini_stage": True, "generator": generator} if ini_stage else {}
        weight = self.gate_weights(rgb, depth, temp=temp, hard=hard,
                                   baseline=baseline, **ini)
        skips = []
        fused = rgb
        for i in (1, 2, 3, 4):
            rgb = getattr(self.encoder_rgb, f"layer{i}")(fused, use_kernels)
            depth = getattr(self.encoder_depth, f"layer{i}")(depth, use_kernels)
            fused = self.fuse_mixed(i, rgb, depth,
                                    self._rgb_weight(weight, i), use_kernels)
            if i < 4:
                skips.append(self.skip(i, fused))
        return self._out(fused, skips, weight, return_weight, low_res,
                         use_kernels)

    def _out(self, fused, skips, weight, return_weight, low_res, use_kernels):
        out = self._nhwc(self.head(fused, skips, use_kernels, low_res))
        if self.training:
            table = flop_table(self.cfg.encoder_rgb)
            return out, expected_cost_loss(weight, table)
        return (out, weight) if return_weight else out

    # ------------------------------------------------ batched adaptive skips
    def forward_switch_batched(self, rgb, depth, temp: float = 1.0,
                               baseline: bool = False,
                               return_weight: bool = False,
                               force_path: Optional[int] = None,
                               low_res: bool = False,
                               use_kernels: bool = True):
        """Hard-gate batched inference that runs depth stages 1..K only,
        K = the batch's largest path (``force_path`` sets every sample's
        path to it). Per-sample mixing is the dense forward's, so results
        are equal to it; stages beyond K, where every sample's depth weight
        is 0, are skipped. K is read to the host once, after the gate."""
        rgb, depth = self._stems(rgb, depth, use_kernels)
        weight = self.gate_weights(rgb, depth, temp=temp, hard=True,
                                   baseline=baseline)
        if force_path is not None:
            weight = torch.zeros_like(weight)
            weight[:, force_path] = 1.0
            k_max = int(force_path)
        elif torch.compiler.is_exporting():
            k_max = weight.argmax(dim=-1).max()
        else:
            k_max = int(weight.argmax(dim=-1).max())

        def mixed(i):
            def fuse(r, d):
                d = getattr(self.encoder_depth, f"layer{i}")(d, use_kernels)
                return self.fuse_mixed(i, r, d, self._rgb_weight(weight, i),
                                       use_kernels), d
            return fuse

        fused = rgb
        skips = []
        for i in (1, 2, 3, 4):
            r = getattr(self.encoder_rgb, f"layer{i}")(fused, use_kernels)
            # no later stage reads the depth of a skipped one (K is monotone)
            fused, depth = self._depth_stage(k_max >= i, i, r, depth,
                                             mixed(i))
            if i < 4:
                skips.append(self.skip(i, fused))
        return self._out(fused, skips, weight, return_weight, low_res,
                         use_kernels)

    def _depth_stage(self, run, i: int, r, depth, fuse):
        """(fused, depth) after depth stage ``i``: ``fuse(r, depth)`` where
        ``run`` holds, else ``r`` unfused. ``run`` is a Python bool (read
        on the host once a request) or, while ``torch.export`` traces, a
        0-dim bool tensor: then a ``torch.cond`` whose skipped branch
        threads a zero depth map of the stage's output shape, as the JAX
        package's ``lax.cond``s do."""
        if not torch.is_tensor(run):
            return fuse(r, depth) if run else (r, depth)
        # a branch returns no operand as it is (dynamo refuses the alias)
        return torch.cond(run, fuse,
                          lambda r, d: (r.clone(), self._zero_depth(i, r)),
                          (r, depth))

    # ------------------------------- per-sample bucket-compacted routing
    def forward_routed_compact(self, rgb, depth, temp: float = 1.0,
                               baseline: bool = False,
                               return_weight: bool = False, caps=None,
                               low_res: bool = False,
                               strict_caps: bool = False,
                               use_kernels: bool = True):
        """Hard-gate batched inference with per-sample depth skipping.

        Only the depth stream is permuted into descending-path order (a
        stable sort, as ``jnp.argsort``), so stage i's participants
        (k ≥ i) are a prefix of it. Stage i runs on ``cap`` rows, the
        smallest rung of its ladder that holds the n_i participants (the
        last rung when none does), and its output is scattered back to
        caller order for the fusion (``_fuse_mixed_scatter``); rgb, skips,
        decoder and logits stay in caller order. The depth buffer is padded
        back to the batch with zero rows after each stage; a cap-0 stage
        returns rgb unfused, launches nothing, and threads a zero buffer.

        ``caps``: one ladder for every stage (default ``(0, bs//2, bs)``)
        or four, one per stage (``capacity_ladders``). Any ladder that ends
        at ``bs`` is exact. ``strict_caps``: ladders may end below ``bs``;
        participants beyond the last rung lose that stage's depth term
        (MoE capacity-factor drop semantics). The participant counts are
        read to the host once, after the gate."""
        rgb, depth = self._stems(rgb, depth, use_kernels)
        weight = self.gate_weights(rgb, depth, temp=temp, hard=True,
                                   baseline=baseline)
        bs = rgb.shape[0]
        k = weight.argmax(dim=-1)
        if torch.compiler.is_exporting():
            counts = (k[:, None] >= torch.arange(1, 5, device=k.device)
                      ).sum(dim=0)
        else:
            paths = k.tolist()
            counts = [sum(p >= i for p in paths) for i in range(1, 5)]
        order = torch.argsort(-k, stable=True)  # participants first
        depth_buf = nchw(permute_rows(nhwc(depth), order))
        ladders = _stage_ladders(caps, bs, strict_caps)

        def stage(i):
            """Depth stage ``i`` on a prefix of ``cap`` rows, its output
            padded back to the batch with zero rows."""
            def at_cap(cap):
                def run(r, d):
                    if cap == 0:  # n_i == 0 (or a strict 0 rung): rgb unfused
                        # a cond branch returns no operand as it is
                        out = r.clone() if torch.compiler.is_exporting() else r
                        return out, self._zero_depth(i, r)
                    d_p = getattr(self.encoder_depth, f"layer{i}")(
                        d[:cap], use_kernels)
                    fused = self._fuse_mixed_scatter(
                        i, r, d_p, self._rgb_weight(weight, i), order,
                        use_kernels)
                    if cap < bs:
                        d_p = torch.cat([d_p, self._zero_depth(i, r[cap:])])
                    return fused, d_p
                return run
            return at_cap

        fused = rgb
        skips = []
        for i in (1, 2, 3, 4):
            r = getattr(self.encoder_rgb, f"layer{i}")(fused, use_kernels)
            fused, depth_buf = self._ladder(counts[i - 1], ladders[i - 1],
                                            stage(i), r, depth_buf)
            if i < 4:
                skips.append(self.skip(i, fused))
        return self._out(fused, skips, weight, return_weight, low_res,
                         use_kernels)

    @staticmethod
    def _ladder(n, ladder: list[int], at_cap, r, depth):
        """``at_cap(cap)(r, depth)`` at the smallest rung ``cap`` of
        ``ladder`` that holds ``n`` participants (the last rung when none
        does). ``n`` is a Python int, or while ``torch.export`` traces a
        0-dim tensor: then a chain of 2-way ``torch.cond``s picks the rung,
        as the JAX package's ``lax.cond`` ladder does."""
        if not torch.is_tensor(n):
            return at_cap(next((c for c in ladder if n <= c), ladder[-1]))(
                r, depth)
        if len(ladder) == 1:
            return at_cap(ladder[0])(r, depth)
        return torch.cond(
            n <= ladder[0], at_cap(ladder[0]),
            lambda r, d: SkipGateESANet._ladder(n, ladder[1:], at_cap, r, d),
            (r, depth))

    # ------------------------------------------------------ hard, real skips
    def forward_switch(self, rgb, depth, temp: float = 1.0,
                       baseline: bool = False, return_weight: bool = False,
                       force_path: Optional[int] = None,
                       low_res: bool = False, use_kernels: bool = True):
        """Hard-gate inference that runs depth stages 1..k only and fuses
        them unmixed (``fuse``), k = sample 0's path or ``force_path``
        (which does not change the returned weights). Meant for batch 1:
        a larger batch raises unless ``force_path`` is given."""
        if force_path is None and rgb.shape[0] != 1:
            raise ValueError(
                "forward_switch routes the WHOLE batch by sample 0's gate "
                f"decision; got batch={rgb.shape[0]}. Use batch=1, pass "
                "force_path, or use forward_switch_batched / "
                "forward_routed_compact for per-sample batched routing.")
        rgb, depth = self._stems(rgb, depth, use_kernels)
        weight = self.gate_weights(rgb, depth, temp=temp, hard=True,
                                   baseline=baseline)
        if force_path is not None:
            k = int(force_path)
        elif torch.compiler.is_exporting():
            k = weight[0].argmax()
        else:
            k = int(weight[0].argmax())

        def unmixed(i):
            def fuse(r, d):
                d = getattr(self.encoder_depth, f"layer{i}")(d, use_kernels)
                return self.fuse(i, r, d, use_kernels), d
            return fuse

        fused = rgb
        skips = []
        for i in (1, 2, 3, 4):
            r = getattr(self.encoder_rgb, f"layer{i}")(fused, use_kernels)
            fused, depth = self._depth_stage(k >= i, i, r, depth, unmixed(i))
            if i < 4:
                skips.append(self.skip(i, fused))
        return self._out(fused, skips, weight, return_weight, low_res,
                         use_kernels)
