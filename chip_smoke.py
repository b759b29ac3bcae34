#!/usr/bin/env python3
"""Card check of the PyTorch/H100 port (``dynmm_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

1. Device and build: prints the card's name and power limit, builds every
   CUDA source of the port with ``nvcc`` (sm_90a) and prints the seconds.
2. Kernels: calls each kernel's wrapper at the shapes the flagship's forward
   gives it at B=8, 480×640 (the NBt1D kernels at B=1 too), and holds the
   result against its plain PyTorch version on the same seeded inputs: max
   abs error and max abs error over max |plain| (≤ 1e-4 in fp32: the
   summation orders differ). Times the kernel, the plain version and, where
   one PyTorch call computes the same function, that call on the device:
   10 calls captured in a CUDA graph, its replays timed with CUDA events, so
   the host's cost of issuing a short call is left out (``device_ms``); the
   one-launch block also beside two ``nbt1d_pair`` calls
   on the same inputs, at all four block levels (those it does not serve
   count 0 calls a forward). Both NBt1D kernels (3xTF32 on the tensor
   cores) get two bounds, fp32 on CUDA cores and three TF32 products per
   fp32 product on the tensor cores, and their fp32-equivalent TFLOP/s.
   ``learned_upsample`` and ``se_fuse_mixed`` run at B=1 too, and at every
   shape make 20 back-to-back calls whose outputs must be bit-identical
   (the SE squeeze's last-block tickets and fences race only on the card).
   The SE cell also runs at the R50 net's four stage shapes (C = 256 to
   2048), the single-map ``fused_se`` at the R34 one-modality net's five
   shapes and at C = 2048. The time of each kernel per dense forward is
   printed for B=8 and B=1, of the flagship and of the R50 net. The bf16
   forms (``channel_sums``, ``stem_fuse_pool``, ``se_fuse_mixed``,
   ``fused_se``, ``learned_upsample``, named "<name>.bf16") run at the same
   shapes on bf16 maps against their bf16 plain versions (``BF16_TOL``: the
   stem bit-identical, the sums ≤ 1e-5, the SE cells and the upsample
   ≤ 8e-3 of max |plain| with 20-call bit-identical repeats, the
   single-map SE cell at B=8 and B=1), their bounds from bf16 bytes, beside
   two bf16→fp32 ``torch.sum`` and a bf16 ``conv_transpose2d``; the sums,
   fp32 and bf16, also at the local-gate net's four gate shapes and at
   R50's widest gate (1024 channels), beside two ``torch.sum``.
3. Serve, dense: builds the 480×640 flagship with seeded random weights,
   serves 3 batches of 8 and 3 of 1 through ``dynmm_tpu_torch.serve.serve``
   (``mode="dense"``) with every launch count at 0 before, checks the
   counts of each forward, then runs the same requests with
   ``use_kernels=False`` (plain versions, same weights): identical gate
   choices, logits within 1e-3 relative, class maps identical on ≥ 99.9 %
   of pixels.
4. Serve, routed: the same model with a gate override that hands out fixed
   per-sample paths serves B=8 through ``batchmax`` and ``compact`` (the
   default ladder, ``capacity_schedule``'s per-stage ladders, a strict
   schedule that covers the batch), B=1 through ``switch`` for every path
   and with the live gate, and B=8 at ``low_res``. Counts at 0 before; each
   forward's launches must equal the counts its paths give (a skipped depth
   stage launches nothing), and each request must agree with the dense
   forward on the same paths as in phase 3.
5. Recipe gate: reads ``bench_assets/gate_recipe.msgpack`` with the port's
   own msgpack reader (it prints whether ``msgpack`` and ``flax`` could be
   imported; it needs neither), merges it into a seeded 480×640 flagship and
   serves ``make_recipe_eval_batch(8, 480, 640)`` (half depth-needed
   samples) through ``dense``, ``batchmax`` and ``compact`` and its samples
   one at a time through ``switch``. Prints the path mix beside the
   asset's branch ratios and each mode's request time; as in phases 3-4,
   each routed request must agree with the dense forward on the same input
   (its max abs error printed), every request launch the counts its paths
   give, and the kernels agree with the plain versions.
6. Train: ``SegTrainer.fit`` on the 480×640 flagship (seeded weights,
   SGD, lr 0.01, loss ratio 1e-4, temperature 1.0 → 0.001 over 60 epochs,
   so the gate stays soft) for 2 epochs of 2 steps of batch 8 on
   ``SyntheticSegDataset(mixed_modality_frac=0.5)``, validating each epoch.
   Requires finite losses, no kernel launch during a train step and the
   ``EXPECTED`` launches for each validation forward; then, on the trained
   weights, the kernel eval path against the plain one (gate choices
   identical, logits within 1e-3 relative), the rolling checkpoint loaded
   into a fresh model giving equal eval logits (error 0), and one step
   resumed from that checkpoint against one more step of the trained state
   (every parameter and BN statistic within 1e-5 relative). Prints the ms
   per train step (median after the first) and the peak memory, and keeps
   the rolling checkpoint's payload for phase 17.
7. Modality-level DynMM (no kernel of the port runs here; the six launch
   counters must not move). Serves the MM-IMDB router at B=4096 (text 300,
   image 4096) and the CMU-MOSEI router at B=1024, T=50, lengths full (the
   JAX bench's serving batches; seeded weights): dense soft, dense hard,
   ``infer_mode=2`` (the static late-fusion baseline), the compacted routed
   forward with ``force_k`` at 0/25/50 % on the expensive branch and with
   the live gate, and ``forward_switch`` at B=1 for each branch (a gate
   bias forces it). Each request is timed on the host clock ending in
   ``torch.cuda.synchronize()`` (median of 5 after a warm-up), and one more
   is traced with ``torch.profiler`` for its device time and the device's
   busy share of its window; every
   compact and switch request must equal dense eval of the same branches
   (max abs error over max |dense| ≤ 1e-5, the same branch per sample), and
   the card's dense forward the CPU's on the same weights (≤ 1e-4
   relative; MOSEI on its first 128 rows). Then runs each CLI's
   ``main(argv)`` (``imdb_dyn``, ``affect_dyn``: ``--synthetic --freeze
   --no-pretrain --n-epochs 3 --device cuda``) from a temporary working
   directory: finite losses, the result line, the frozen parameters
   bit-identical to the CLI's seeded start and the gate's changed (the
   IMDB fusion branch's BN statistics follow its train-mode forwards, as in
   the JAX trainer), and the checkpoint in a fresh router giving the CLI
   model's hard-eval outputs exactly (error 0). Prints ms per request and
   per train step (median after the first).
8. The eval and predict CLIs on prepared data: writes a NYUv2-layout test
   split of 16 samples at 480×640 (``SyntheticSegDataset``, half
   depth-needed) with the port's PNG codec, and the flagship with seeded
   weights and the recipe gate merged as ``.msgpack`` and ``.pth``. Runs
   ``cli.eval.main`` at B=8 (hard from each checkpoint: equal mIoU; two
   noise runs; quarter resolution; capacity factor 8.0, which must score
   the exact chain's mIoU; the packed stem) and ``cli.predict.main`` in
   every serve mode (batchmax, dense, compact, compact with capacity
   factor 1.25, switch and switch_host at B=1 on 4 samples, quarter
   resolution, packed stem). Counts at 0 before each run: the launches
   must be those the samples' paths give (the strict capacity runs add
   their ``gate_only`` calibration). Predict's PNGs, read back, must equal
   ``serve()``'s class maps of the same batches through the palette
   (error 0); the kernels' class maps of one batch must agree with the
   plain versions' on ≥ 99.9 % of pixels, raw and packed, and the packed
   stem's logits lie within 1e-4 relative of the raw stem's. Prints each
   eval run's seconds a batch, predict's frames/s, the path mix and the
   host's share of a batch (PNG decode, preprocessing, packing) beside the
   forward. It also serves the R50 net (recipe gate merged) through
   ``cli.predict --encoder resnet50``: launches of the samples' paths,
   PNGs equal to ``serve()``'s maps. Deletes its files.
9. R50: builds the 480×640 SkipGateESANet on Bottleneck ResNet50 encoders
   with seeded weights, merges ``bench_assets/gate_recipe_resnet50.msgpack``
   and serves ``make_recipe_eval_batch(8, 480, 640)`` in every mode the JAX
   bench runs it: dense, ``baseline``, ``batchmax`` (live and forced to
   paths 0, 2, 4), ``compact`` on ``capacity_ladders`` of the asset's
   ratios, strict ``compact`` at capacity factor 1.25, dense and
   ``batchmax`` at B=1 and ``switch`` for each sample at B=1. Counts at 0
   before; each request's launches must be those of its paths, its logits
   equal the dense forward's on the same paths (error 0; a strict rung
   that drops participants is reported instead), and the plain path's
   (gate choices identical, logits within 1e-3 relative, class maps on
   ≥ 99.9 % of pixels). Prints each request's ms and the path mix beside
   the asset's ratios.
10. Trains the R50 net through ``cli.train.main``: 2 steps of B=8 at
   480×640 on synthetic data, then its validation; finite losses, no
   kernel launch in a step, the validation forward's launches; prints the
   step times and the peak memory.
11. For the static ESANet, the local-gate SkipESANet (block rule 1122) and
   the one-modality net on rgb with SE, R34-NBt1D at 480×640:
   ``cli.train`` for 1 epoch of 2 steps of B=8, then ``cli.eval`` on the
   rolling checkpoint in fp32, ``--dtype bfloat16`` and, for the static
   net, ``--quant int8 --dtype bfloat16``; each run's launches those of the
   net's kernel sites (the local gates' ``channel_sums``, the single-map
   ``fused_se``; in bf16 their bf16 forms and no NBt1D launch), and the
   trained weights' kernel eval path against the plain one. On the same
   weights in bf16: the kernel path against the bf16 plain path (gate
   choices identical, logits within 2e-2 of max |plain|, class maps equal
   wherever the plain top-two margin exceeds twice the logit error). The
   bf16 net against the fp32 net on the variant's seeded weights
   (``serve.init_weights``, seed 0: the same in every run): drift < 5e-2
   of max |fp32|, the local gates' choices that differ from fp32's counted
   and their samples left out of the drift; the same drifts of the
   kernels and of the bf16 plain path on the trained weights, which
   cuDNN's nondeterministic backward makes differ from run to run, are
   printed and stored, not bounded. Request ms of fp32 and bf16 in turns
   (median of 5) at B=8 and B=1, with one traced request's device time and
   busy share.
12. The bf16 flagship: the 480×640 flagship at ``dtype=torch.bfloat16``
   (fp32 parameters, bf16 maps, the gate in fp32) with the recipe gate
   serves ``make_recipe_eval_batch(8, 480, 640)`` through ``dense``,
   ``batchmax``, ``compact`` (the default ladder and
   ``capacity_schedule``'s) and each sample through ``switch``. Counts at
   0 before; each request's launches those of its paths (no NBt1D launch,
   the bf16 forms otherwise). Each request against the dense bf16 forward
   on the same paths (≤ 8e-3 of max |dense|; 0 expected), against the same
   requests on the bf16 plain versions (gate choices identical, logits
   within 2e-2 of max |plain|, class maps equal wherever the plain top-two
   margin exceeds twice the max logit error) and against the fp32 flagship
   on the same inputs (gate choices identical, drift < 5e-2 of max |fp32|,
   class-map agreement printed). Request ms of fp32 and bf16 in turns per
   mode at B=8 and B=1; then ``cli.eval`` and ``cli.predict --dtype
   bfloat16`` on phase 8's layout (their launches those of the samples'
   paths), eval's mIoU beside fp32's.
13. The int8 flagship: the 480×640 flagship with the recipe gate at
   ``quant="int8"``, fp32 and bf16 compute, calibrated (absmax, fp32) on two
   batches of ``make_recipe_eval_batch(8, 480, 640, seed=4321+i)`` (the JAX
   bench's feed): ``quant_sanity`` must count its 177 quantized convs, and
   its packed forward equal the in-graph one (error 0). One conv of each
   shape class (3×1, 1×3, their stride-2 forms, 1×1, 1×1/2, 3×3,
   ``conv_out``, and BasicBlock's 3×3/2 stand-alone) on its input of a dense
   B=8 forward: ``conv_int8``'s int32 sums equal a float64 conv of the same
   int8 operands; its time beside the fp32 cuDNN conv's. Serves ``dense``,
   ``batchmax``, ``compact``, ``low_res``, the packed stem at B=8 and
   ``switch`` for each sample at B=1, counts at 0 before: each request's
   launches those of its paths with no NBt1D launch (``int8_launches``) and
   its int8 convs (``nn/quant.py::INT8_CONVS``) those of its paths. Each
   request against the dense int8 forward on the same paths (≤ 1e-3 of max
   |dense| at fp32, 8e-3 at bf16; 0 expected), the int8 plain path with
   each quantized conv fed the input it got in the kernel forward (gate
   choices identical, logits within 1e-5 of max |plain| at fp32 and 1e-2 at
   bf16, class maps equal wherever the plain top-two margin exceeds twice
   the max logit error; without the replay, rounding flips at quantization
   boundaries cascade: printed, not held) and the fp32 net (the JAX
   package's bounds: gate choices identical, relative L2 < 0.12, class-map
   agreement > 0.85). Request ms of fp32, bf16, int8 and int8-bf16 in turns
   at B=8 and B=1; then ``cli.eval --quant int8`` (absmax, percentile 99.9;
   mIoU beside fp32's) and ``cli.predict --quant int8`` (and ``--dtype
   bfloat16 --output_res quarter --packed_stem``) on phase 8's layout, their
   launches those of the samples' paths plus the calibration forwards, the
   PNGs equal to ``serve()``'s maps of a net calibrated on the same batches.
14. Export: the 480×640 recipe flagship's serving forward as
   ``torch.export`` artifacts (``utils/serve_export.py``): ``dense``,
   ``batchmax``, ``compact`` (the default ladder and
   ``capacity_schedule``'s) and ``low_res`` at B=8, ``switch`` at B=1 (one
   artifact, the live gate, replayed for each sample of
   ``make_recipe_eval_batch(8, 480, 640)``), the bf16 and the int8 net
   dense at B=8. ``cli.predict --export_path`` on a layout of phase 8's
   exports the fp32 ``batchmax`` and the ``--quant int8 --serve_mode
   dense`` forms (the module it exports is held for the eager side), and
   their reloaded artifacts' PNGs of the first batch are byte-equal to
   ``cli.predict``'s own; the other forms are exported in process. Each
   is exported, saved, reloaded from the file and
   replayed with the counts at 0: logits and gate weights equal to the
   eager forward's with error 0, the replay's launches per kernel equal
   to the eager forward's, which are those its paths give (the int8
   program's ``aten._int_mm`` nodes equal the eager forward's int8
   convs). Prints export seconds, artifact bytes and request ms of eager
   and artifact in turns (median of 5; B=8, and B=1 for ``switch``). One
   ``cuda,cpu`` artifact (dense, B=1) replays on the CPU through the
   plain versions: class maps equal to the card's wherever the CPU's
   top-two margin exceeds twice the max logit error.
15. Swish and hswish: the 480×640 flagship with ``activation="swish"``
   and ``"hswish"`` (the recipe gate, seeded weights), and the swish net in
   bf16 and int8 (calibrated as in phase 13: ``quant_sanity`` counts the
   relu net's 177 convs). The TPU kernels of the SE cell and the NBt1D
   block fuse relu, so these nets run those cells in PyTorch ops: every
   forward launches ``channel_sums`` 1, ``stem_fuse_pool`` 1 and
   ``learned_upsample`` 5 (3 at ``low_res``) and nothing else
   (``act_launches``). Serves the swish net ``dense`` at B=8 and B=1,
   ``batchmax``, ``compact`` and ``low_res`` at B=8 and ``switch`` at B=1
   for each path, the hswish net ``dense`` and ``batchmax`` at B=8 (a gate
   override hands out fixed per-sample paths), counts at 0 before, each
   forward's launches those of the rule; each routed request against the
   dense forward on the same paths with error 0. Kernel path against
   ``use_kernels=False`` (live gate): gate choices identical, logits within
   1e-3 relative, class maps equal on ≥ 99.9 %. The bf16 swish net against
   its plain path (phase 12's bounds) and the fp32 swish net (drift
   < 5e-2); the int8 swish net against the fp32 swish net (the JAX
   bounds). ``cli.train --activation swish`` for 2 steps of B=8 (step ms
   and peak memory beside fp32 relu's), then ``cli.eval`` and
   ``cli.predict`` on its checkpoint on phase 8's layout (the PNGs equal to
   ``serve()``'s maps); one dense B=8 export of the swish net replayed with
   error 0 and the same launches; request ms of the relu, swish and hswish
   flagships in turns at B=8 and B=1. Prints its seconds by part.
17. (Runs after phase 15, before phase 16's lines.) bf16 training: train-mode
   BN of bf16 maps at the flagship's BN shapes, forward and backward: the
   port's ``BatchNorm2d`` (``F.batch_norm`` on a channels-last bf16 map)
   bit-equal to ``_WideBatchNorm`` (the JAX BN's order, the port's form on
   the CPU and for contiguous maps) in output, gradients and running
   statistics, both layouts. Then phase 6 at ``dtype=torch.bfloat16``: ``SegTrainer.fit`` on the
   480×640 flagship (seeded weights, SGD, lr 0.01, loss ratio 1e-4, soft
   gate) for 2 epochs of 2 steps of B=8, validating each epoch: finite
   losses, no kernel launch in a train step, ``EXPECTED_BF16`` in each
   validation forward; on the trained weights the bf16 kernel eval path
   against the bf16 plain one (phase 12's limits); the rolling checkpoint
   in a fresh bf16 trainer bit-equal to the file (weights, BN statistics,
   optimizer state), then one step against one more step of the trained
   state (max rel err ≤ 1e-3, and below the same step from a fresh
   optimizer). Phase 6's fp32 checkpoint, written again by the port's
   writer, loads its optax-layout ``opt_state`` into an fp32 trainer on
   the card (momentum buffers on the card, bit-equal to the file) and
   takes a finite step. Prints ms per bf16 train step (median after the
   first, and of 5 more steps back to back on one batch after the resume)
   and peak memory beside phase 6's fp32 figures, and its seconds.
18. (Runs after phase 17.) The modality experts' two steps, in one
   temporary working directory, no kernel launch counter moving. Step 1:
   the 14 expert CLIs (``imdb_uni --mod 0|1``, ``imdb_mm --fuse 0-3``,
   ``affect_uni --mod 2 --enc transformer|gru``, ``affect_mm --fusion
   0-5``; ``--synthetic --n-epochs 2 --device cuda``): finite losses, the
   result lines, ms a train step (median after the first), each written
   file holding the trained tree bit for bit; each trained expert's
   forward at the JAX bench's serving batches (MM-IMDB B=4096, CMU-MOSEI
   B=1024, T=50, ragged lengths) timed as phase 7's requests (ms, device
   ms, kernels, busy share; only the device events between two
   ``torch.cuda._sleep`` marks around the traced call counted, with tiny
   launches before and after them to take the events a trace loses at its
   edges late in a long run) and held to the CPU's forward on the same
   weights (≤ 1e-4 relative, first 256 / 128 rows). Step 2: ``imdb_dyn``
   and ``affect_dyn --synthetic --freeze --n-epochs 2`` without
   ``--no-pretrain``: a graft line for each of the five and three files,
   every leaf outside the gate bit-identical to the files after training,
   every gate leaf moved, as phase 7 checks them. Step 3: ``imdb_dyn
   --robust --eval-only`` on step 2's router: three curves of six finite
   values. Prints its seconds by step.
19. (Runs after phase 18.) FLOP counting and the latency harness, no
   kernel launch counter moving: ``cli.imdb_count_flop`` and
   ``cli.affect_count_flop`` on the card print the same lines as on the
   CPU (MACs a branch and the gate, parameters); ``imdb_dyn`` and
   ``affect_dyn --synthetic --eval-only --measure`` on the card, then with
   ``--routed``, each print the JAX CLI's timing line (``utils/
   profiling.py::test_time``: ten passes over the test split after a
   warm-up, each ended by a device synchronisation); the routed forward
   they time (``forward_routed_compact``) against the dense hard eval on
   a synthetic test batch of each router (≤ 1e-5 of max |dense|, gate
   choices identical). Prints its seconds.
20. Mesh training and sharded routing over ``torch.distributed``: four
   ranks on this card (``parallel/launch.py::run_ranks``; gloo with CUDA
   tensors, since NCCL refuses two ranks on one device; the backend and
   world printed). On a 2×2 mesh, one train step of the 480×640 flagship
   (phase 6's trainer and seeded weights, the first two samples of its
   first batch, one a data rank, weights of ≥ 256 output channels split
   over 'model'), in float64; then the one-process step on the card from
   the same weights and batch: the loss within 1e-6 relative, every
   parameter and BN statistic within 1e-5 of its leaf's largest entry and
   the update within 1e-3 of its largest entry (in fp32 this net's B=2
   step is rounding noise in places), each rank holding fewer parameter
   entries than the net, no kernel launch in the step. Then ranks 0-1 (a
   data-only mesh, D = 2) serve the flagship (seeded weights, a gate
   override that sends blank samples down path 0 and the others down path
   4) through both sharded routed forwards (``forward_switch_batched``,
   ``forward_routed_compact`` with caps (0, 2)) on 4 samples, the first two
   blank: each rank's gathered logits equal the one-process routed runs of
   each shard (≤ ``KERNEL_TOL`` of max; 0 expected), the blank shard's
   rank launched no depth stage's kernel and the other every one
   (``path_launches``). The ranks' launches join phase 16's counts.
   Prints its seconds.
21. The dataset converters, which import no h5py, OpenCV or PIL (this
   machine has no h5py): every fixture JPEG of ``tests/fixtures_torch_prepare/jpeg``
   decoded (``data/jpeg.py``) under IMREAD_COLOR and IMREAD_UNCHANGED
   against its stored ``cv2.imread`` pixels (error 0; the progressive one
   raises); the four converters (``python -m dynmm_tpu_torch.data.
   prepare_*``'s ``convert``) on the raw trees ``tests/_torch_prepare_raw.py``
   builds from the fixtures (MATLAB v7.3 files read by ``data/hdf5.py``,
   the v5 ones written by ``scipy.io.savemat``), every written PNG, ``.npy``
   and list equal to what the JAX converter wrote (``expected.npz``);
   then ``cli.eval`` on the converted NYUv2 layout (its test split: one
   sample at 480x640) with the recipe-gate flagship, fp32, relu, its
   launches those of a dense batch. Prints each converter's seconds a
   sample, eval's seconds a batch, the card line and its seconds.
22. Orbax checkpoints (``utils/orbax.py``; no orbax, tensorstore or zstd
   package): phase 6's trained fp32 state of the flagship (params, BN
   statistics, the optax SGD ``opt_state``) in a trainer state,
   ``save_orbax``, then ``load_orbax`` without a target (every leaf
   bit-equal to the source tree) and into a fresh trainer state (its tree
   bit-equal). A dense B=8 ``serve()`` from the restored weights: launches
   those of a dense batch, class map and gate choices equal to the source
   weights', and the logits of both models equal (error 0). Then the
   JAX-written ``tests/fixtures_torch_orbax/ckpt`` (several chunks a
   sharded array, tensorstore's zstd frames) decoded equal to its
   ``expected.msgpack``. Prints the state's bytes and the save and restore
   seconds beside the card line.
16. Prints the kernels' JSON line (launches summed over phases 3-6, 8-15,
   17 and 20-22; phase 14's are its replays'), the card line, and last
   ``{"ok": true, "device": {...}}``.

TF32 is switched off for cuDNN convolutions and matmuls here, so the kernels
and their plain versions compare in fp32 (bf16 convolutions are unaffected). Any failure exits non-zero before
the last line; without a card, or outside a checkout, it fails at once.
Details go to ``chiprun_out/chip_smoke.json`` beside this script.
"""

from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple

import torch

ROOT = Path(__file__).resolve().parent
BATCH = 8
HEIGHT, WIDTH, CLASSES = 480, 640, 40
# H100 SXM data-sheet peaks: HBM3 bytes/s, fp32 (non-tensor) FLOP/s and
# dense TF32 tensor-core FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
# fp32 FLOP/s of fp32-accurate work on the tensor cores in 3xTF32: three
# TF32 products per fp32 product
PEAK_TF32X3_FLOPS = PEAK_TF32_FLOPS / 3
KERNEL_TOL = 1e-4
# the bf16 forms against their bf16 plain versions, max abs err over
# max |plain|: the sums (fp32 out) differ by summation order; the stem's
# per-op bf16 arithmetic is the plain version's; the SE cell's and the
# upsample's fp32 sums in another order move a rounding to bf16 by one step
# (2^-7 of the top binade)
BF16_TOL = {"channel_sums": 1e-5, "stem_fuse_pool": 0.0,
            "se_fuse_mixed": 8e-3, "learned_upsample": 8e-3}
REPEATS = 20  # back-to-back calls that must give bit-identical outputs
# launches of one dense hard-gate forward of the flagship: its stride-1
# NBt1D blocks up to NBT1D_FUSED_MAX_C channels (6 at C = 64) take one
# launch each, the wider ones (29) two; channel_sums runs in the stem cell
EXPECTED = {"nbt1d_fused": 6, "nbt1d_pair": 58, "channel_sums": 1,
            "stem_fuse_pool": 1, "se_fuse_mixed": 4, "learned_upsample": 5}
# the same in bf16: the NBt1D blocks run cuDNN convs (no bf16 form), the
# other kernels their bf16 forms, counted under "<name>.bf16"
EXPECTED_BF16 = {"channel_sums.bf16": 1, "stem_fuse_pool.bf16": 1,
                 "se_fuse_mixed.bf16": 4, "learned_upsample.bf16": 5}
# the flagship's stride-1 NBt1D blocks by channel count: in each encoder
# stage (stage i at 64·2^(i-1) channels) and in the decoder
ENCODER_BLOCKS = ((64, 3), (128, 3), (256, 5), (512, 2))
DECODER_BLOCKS = ((512, 3), (256, 3), (128, 3))
SOURCES = {
    "nbt1d_fused": ("nbt1d_block.cu", "dynmm_tpu/kernels/nbt1d.py:154"),
    "nbt1d_pair": ("nbt1d.cu", "dynmm_tpu/kernels/nbt1d.py:246"),
    "channel_sums": ("se.cu", "dynmm_tpu/kernels/stem_fuse.py:85"),
    "stem_fuse_pool": ("stem_fuse.cu", "dynmm_tpu/kernels/stem_fuse.py:198"),
    "learned_upsample": ("upsample.cu", "dynmm_tpu/kernels/upsample.py:130"),
    "se_fuse_mixed": ("se.cu", "dynmm_tpu/kernels/se.py:66"),
    "fused_se": ("se.cu", "dynmm_tpu/kernels/se.py:66"),
}
# the net whose forward each kernel's totals in the kernels line count:
# the flagship, or for the single-map SE cell the R34-NBt1D one-modality
# net with SE (five calls a forward)
TOTALS_NET = {"fused_se": "R34 one-modality",
              "fused_se.bf16": "R34 one-modality"}
# the single-map SE cell's shapes: the R34 one-modality net's five cells,
# and the R50 one-modality net's last one
ONE_MODALITY_SE = ((64, 240, 320, "R34 one-modality"),
                   (64, 120, 160, "R34 one-modality"),
                   (128, 60, 80, "R34 one-modality"),
                   (256, 30, 40, "R34 one-modality"),
                   (512, 15, 20, "R34 one-modality"),
                   (2048, 15, 20, "R50 one-modality"))
# the local gates' channel sums: the R34 local-gate net's four gates and the
# R50 one's widest (C = 1024)
LOCAL_GATE_SUMS = ((64, 240, 320, "R34 local-gate"),
                   (64, 120, 160, "R34 local-gate"),
                   (128, 60, 80, "R34 local-gate"),
                   (256, 30, 40, "R34 local-gate"),
                   (1024, 30, 40, "R50 local-gate"))
# ResNet50 encoders: Bottleneck blocks (cuDNN), no stride-1 NBt1D block
R50_ENCODER_BLOCKS = ()


def bound(n_bytes: float, n_flops: float,
          peak_flops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Case(NamedTuple):
    """One kernel at one shape of the main path: ``calls`` per forward at
    ``batch``; ``peak`` is the FLOP/s its bound counts operations at;
    ``alt`` another way to compute the same output, timed beside it;
    ``repeat``: check that REPEATS calls give bit-identical outputs."""
    name: str
    label: str
    calls: int
    kern: Callable
    plain: Callable
    lib: Callable | None
    n_bytes: float
    n_flops: float
    alt: Callable | None = None
    batch: int = BATCH
    peak: float = PEAK_FP32_FLOPS
    repeat: bool = False
    net: str = "R34"
    r50_calls: int = 0  # calls per dense forward of the R50 net
    tol: float = KERNEL_TOL  # max abs err over max |plain|


class Inputs:
    """Seeded inputs on the card."""

    def __init__(self, seed: int):
        self.g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(self, *shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=self.g, device="cuda") * scale + shift

    def rand(self, *shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=self.g,
                                           device="cuda")


def upsample_library_weight(taps: torch.Tensor) -> torch.Tensor:
    """Nearest ×2 + zero-padded depthwise 3×3 as one depthwise transposed
    conv (stride 2, padding 1): the 3×3 taps phase-merged into a 4×4 kernel
    (the JAX package's ``_UPSAMPLE_PHASE_MERGE``), flipped."""
    a = torch.tensor([[1.0, 0, 0], [1, 1, 0], [0, 1, 1], [0, 0, 1]],
                     device=taps.device)
    kt = torch.einsum("us,stc,vt->cuv", a, taps, a)  # (C, 4, 4)
    return kt.flip(1, 2).unsqueeze(1).contiguous()


def se_weight_bytes(c: int, maps: int) -> int:
    """Bytes of ``maps`` SE MLPs (C/16 hidden units), each read once."""
    cr = c // 16
    return maps * (2 * c * cr + cr + c) * 4


def kernel_cases(inp: Inputs) -> list[Case]:
    """Every shape of the main path."""
    from dynmm_tpu_torch.kernels import nbt1d, se, stem_fuse, upsample

    b = BATCH
    cases = []
    # K1: 13 stride-1 blocks per encoder, 9 in the decoder: one launch each
    # up to NBT1D_FUSED_MAX_C channels, two pairs each above
    per_level = {c: 2 * n for c, n in ENCODER_BLOCKS}
    for c, n in DECODER_BLOCKS:
        per_level[c] += n
    for c, h, w in ((64, 120, 160), (128, 60, 80), (256, 30, 40),
                    (512, 15, 20)):
        blocks = per_level[c]
        std = math.sqrt(2.0 / (3 * c))
        params = []
        for _ in range(2):
            params += [inp.randn(3, c, c, scale=std), inp.randn(c, scale=0.05),
                       inp.randn(3, c, c, scale=std), inp.randn(c, scale=0.05),
                       inp.rand(c, lo=0.5, hi=1.0), inp.randn(c, scale=0.1)]
        fused = c <= nbt1d.NBT1D_FUSED_MAX_C
        x, idn = inp.randn(b, h, w, c), inp.randn(b, h, w, c)
        for bb in (b, 1):
            xb, idb = x[:bb].contiguous(), idn[:bb].contiguous()
            vol = bb * h * w * c * 4
            for form, extra in (("pair1", {}), ("pair2", {"identity": idb})):
                args = (xb, *params[:6])
                n_bytes = (vol * (3 if extra else 2) + 2 * 3 * c * c * 4
                           + 4 * c * 4)
                cases.append(Case(
                    "nbt1d_pair", f"{form} {bb}x{h}x{w}x{c}",
                    0 if fused else blocks,
                    lambda a=args, e=extra: nbt1d.nbt1d_pair(*a, **e),
                    lambda a=args, e=extra: nbt1d.nbt1d_pair_plain(*a, **e),
                    None, n_bytes, 12.0 * c * c * bb * h * w, batch=bb,
                    peak=PEAK_TF32X3_FLOPS,
                    r50_calls=0 if fused else dict(DECODER_BLOCKS).get(c, 0)))
            # the one-launch block at every level, served or not
            args = (xb, *params)
            cases.append(Case(
                "nbt1d_fused", f"{bb}x{h}x{w}x{c}", blocks if fused else 0,
                lambda a=args: nbt1d.nbt1d_fused(*a),
                lambda a=args: nbt1d.nbt1d_fused_plain(*a),
                None, 2 * bb * h * w * c * 4 + 4 * 3 * c * c * 4 + 8 * c * 4,
                24.0 * c * c * bb * h * w,
                lambda a=args: nbt1d.nbt1d_pair(
                    nbt1d.nbt1d_pair(*a[:7]), *a[7:], identity=a[0]),
                batch=bb, peak=PEAK_TF32X3_FLOPS))
    # channel sums: the stem cell
    c, h, w = 64, 240, 320
    r, d = inp.randn(b, h, w, c), inp.randn(b, h, w, c)
    n = b * h * w * c
    cases.append(Case("channel_sums", f"{b}x{h}x{w}x{c}", 1,
                  lambda r=r, d=d: se.channel_sums(r, d),
                  lambda r=r, d=d: se.channel_sums_plain(r, d),
                  lambda r=r, d=d: (torch.sum(r, dim=(1, 2)),
                                    torch.sum(d, dim=(1, 2))),
                  2 * n * 4 + 2 * b * c * 4, 2.0 * n, None, r50_calls=1))
    # K2: stem scale-add + dual max-pool
    r, d = inp.randn(b, h, w, c), inp.randn(b, h, w, c)
    s_r, s_d = inp.rand(b, c), inp.rand(b, c)
    n = b * h * w * c
    args = (r, d, s_r, s_d)
    cases.append(Case("stem_fuse_pool", f"{b}x{h}x{w}x{c}", 1,
                  lambda a=args: stem_fuse.stem_fuse_pool(*a),
                  lambda a=args: stem_fuse.stem_fuse_pool_plain(*a),
                  None, (2 * n + 2 * n // 4) * 4, 3.0 * n + 18.0 * n / 4, None,
                  r50_calls=1))
    # the local gates' channel sums of the fp32 local-gate SkipESANet: R34's
    # four gates and R50's widest (1024 channels at 30×40); after the stem's
    # two cases, whose c, h, w this loop rebinds
    for c, h, w, net in LOCAL_GATE_SUMS:
        n = b * h * w * c
        r, d = inp.randn(b, h, w, c), inp.randn(b, h, w, c)
        cases.append(Case(
            "channel_sums", f"{b}x{h}x{w}x{c}", 1,
            lambda r=r, d=d: se.channel_sums(r, d),
            lambda r=r, d=d: se.channel_sums_plain(r, d),
            lambda r=r, d=d: (torch.sum(r, dim=(1, 2)),
                              torch.sum(d, dim=(1, 2))),
            2 * n * 4 + 2 * b * c * 4, 2.0 * n, net=net))
    # K3: three decoder-module upsamples and the two logits upsamples
    for c, h, w in ((512, 15, 20), (256, 30, 40), (128, 60, 80),
                    (40, 120, 160), (40, 240, 320)):
        x = inp.randn(b, h, w, c)
        taps, bias = inp.randn(3, 3, c, scale=0.3), inp.randn(c, scale=0.1)
        wt = upsample_library_weight(taps)
        for bb in (b, 1):
            xb = x[:bb].contiguous()
            n = bb * h * w * c
            cases.append(Case(
                "learned_upsample", f"{bb}x{h}x{w}x{c}", 1,
                lambda x=xb, k=taps, bb=bias: upsample.learned_upsample(x, k, bb),
                lambda x=xb, k=taps, bb=bias: upsample.learned_upsample_plain(
                    x, k, bb),
                lambda x=xb, wt=wt, bb=bias, c=c: (
                    torch.nn.functional.conv_transpose2d(
                        x.permute(0, 3, 1, 2), wt, bb, stride=2, padding=1,
                        groups=c).permute(0, 2, 3, 1)),
                (n + 4 * n) * 4 + 10 * c * 4, 8.0 * 4 * n, None, batch=bb,
                repeat=True, r50_calls=1))
    # K4: the four gate-mixed SE fusion cells (squeeze + mix)
    for c, h, w in ((64, 120, 160), (128, 60, 80), (256, 30, 40),
                    (512, 15, 20)):
        r, d = inp.randn(b, h, w, c), inp.randn(b, h, w, c)
        cr = c // 16
        wts = []
        for _ in range(2):
            wts += [inp.randn(c, cr, scale=1 / math.sqrt(c)),
                    inp.randn(cr, scale=0.1),
                    inp.randn(cr, c, scale=1 / math.sqrt(cr)),
                    inp.randn(c, scale=0.1)]
        w_rgb = inp.rand(b)
        for bb in (b, 1):
            rb, db, wb = r[:bb].contiguous(), d[:bb].contiguous(), w_rgb[:bb]
            n = bb * h * w * c
            cases.append(Case(
                "se_fuse_mixed", f"{bb}x{h}x{w}x{c}", 1,
                lambda r=rb, d=db, wr=wb, ws=wts: se.se_fuse_mixed(r, d, wr, *ws),
                lambda r=rb, d=db, wr=wb, ws=wts: se.se_fuse_mixed_plain(
                    r, d, wr, *ws),
                None, 3 * n * 4 + se_weight_bytes(c, 2), 5.0 * n, None,
                batch=bb, repeat=True))
    # the SE cell at the R50 net's four stage shapes (above C = 1024 a
    # thread owns two float4 groups), and the single-map cell: the R34
    # one-modality net's five SE calls and C = 2048
    # (the 1×1 map at C = 2048 reads almost nothing: its time is the
    # finalize's serial tail, the cell's share of which it gives)
    for c, h, w in ((256, 120, 160), (512, 60, 80), (1024, 30, 40),
                    (2048, 15, 20), (2048, 1, 1)):
        cr = c // 16
        wts = []
        for _ in range(2):
            wts += [inp.randn(c, cr, scale=1 / math.sqrt(c)),
                    inp.randn(cr, scale=0.1),
                    inp.randn(cr, c, scale=1 / math.sqrt(cr)),
                    inp.randn(c, scale=0.1)]
        r, d, w_rgb = inp.randn(b, h, w, c), inp.randn(b, h, w, c), inp.rand(b)
        for bb in (b, 1):
            rb, db, wb = r[:bb].contiguous(), d[:bb].contiguous(), w_rgb[:bb]
            n = bb * h * w * c
            cases.append(Case(
                "se_fuse_mixed", f"{bb}x{h}x{w}x{c}", 0,
                lambda r=rb, d=db, wr=wb, ws=wts: se.se_fuse_mixed(r, d, wr, *ws),
                lambda r=rb, d=db, wr=wb, ws=wts: se.se_fuse_mixed_plain(
                    r, d, wr, *ws),
                None, 3 * n * 4 + se_weight_bytes(c, 2), 5.0 * n, None,
                batch=bb, repeat=True, r50_calls=int(h > 1)))
    for c, h, w, net in ONE_MODALITY_SE:
        cr = c // 16
        wts = [inp.randn(c, cr, scale=1 / math.sqrt(c)), inp.randn(cr, scale=0.1),
               inp.randn(cr, c, scale=1 / math.sqrt(cr)), inp.randn(c, scale=0.1)]
        x = inp.randn(b, h * w, c)
        n = b * h * w * c
        cases.append(Case(
            "fused_se", f"{b}x{h}x{w}x{c}", 1,
            lambda x=x, ws=wts: se.fused_se(x, *ws),
            lambda x=x, ws=wts: se.se_reference(x, *ws),
            None, 2 * n * 4 + se_weight_bytes(c, 1), 3.0 * n, None,
            repeat=True, net=net))
    return cases + bf16_cases(inp)


def bf16_cases(inp: Inputs) -> list[Case]:
    """The bf16 forms at the bf16 flagship's shapes (the SE cell at R50's
    too), the single-map SE cell at the one-modality nets' and the sums at
    the local gates', against their bf16 plain versions with ``BF16_TOL``;
    bounds count bf16 map bytes (2 a value) and fp32 sums, scales and SE
    weights."""
    from dynmm_tpu_torch.kernels import se, stem_fuse, upsample

    bf = torch.bfloat16
    b = BATCH
    cases = []
    c, h, w = 64, 240, 320
    n = b * h * w * c
    r, d = inp.randn(b, h, w, c).to(bf), inp.randn(b, h, w, c).to(bf)
    cases.append(Case(
        "channel_sums.bf16", f"{b}x{h}x{w}x{c}", 1,
        lambda r=r, d=d: se.channel_sums(r, d),
        lambda r=r, d=d: se.channel_sums_plain(r, d),
        lambda r=r, d=d: (torch.sum(r, dim=(1, 2), dtype=torch.float32),
                          torch.sum(d, dim=(1, 2), dtype=torch.float32)),
        2 * n * 2 + 2 * b * c * 4, 2.0 * n, tol=BF16_TOL["channel_sums"]))
    s_r, s_d = inp.rand(b, c).to(bf), inp.rand(b, c).to(bf)
    args = (r, d, s_r, s_d)
    cases.append(Case(
        "stem_fuse_pool.bf16", f"{b}x{h}x{w}x{c}", 1,
        lambda a=args: stem_fuse.stem_fuse_pool(*a),
        lambda a=args: stem_fuse.stem_fuse_pool_plain(*a), None,
        (2 * n + 2 * n // 4) * 2 + 2 * b * c * 2, 3.0 * n + 18.0 * n / 4,
        tol=BF16_TOL["stem_fuse_pool"]))
    for c, h, w in ((512, 15, 20), (256, 30, 40), (128, 60, 80),
                    (40, 120, 160), (40, 240, 320)):
        x = inp.randn(b, h, w, c).to(bf)
        taps = inp.randn(3, 3, c, scale=0.3).to(bf)
        bias = inp.randn(c, scale=0.1).to(bf)
        wt = upsample_library_weight(taps.float()).to(bf)
        for bb in (b, 1):
            xb = x[:bb].contiguous()
            n = bb * h * w * c
            cases.append(Case(
                "learned_upsample.bf16", f"{bb}x{h}x{w}x{c}", 1,
                lambda x=xb, k=taps, bb=bias: upsample.learned_upsample(x, k, bb),
                lambda x=xb, k=taps, bb=bias: upsample.learned_upsample_plain(
                    x, k, bb),
                lambda x=xb, wt=wt, bb=bias, c=c: (
                    torch.nn.functional.conv_transpose2d(
                        x.permute(0, 3, 1, 2), wt, bb, stride=2, padding=1,
                        groups=c).permute(0, 2, 3, 1)),
                (n + 4 * n) * 2 + 10 * c * 2, 8.0 * 4 * n, batch=bb,
                repeat=True, tol=BF16_TOL["learned_upsample"]))
    for c, h, w, calls in ((64, 120, 160, 1), (128, 60, 80, 1),
                           (256, 30, 40, 1), (512, 15, 20, 1),
                           (256, 120, 160, 0), (512, 60, 80, 0),
                           (1024, 30, 40, 0), (2048, 15, 20, 0)):
        r, d = inp.randn(b, h, w, c).to(bf), inp.randn(b, h, w, c).to(bf)
        cr = c // 16
        wts = []
        for _ in range(2):
            wts += [inp.randn(c, cr, scale=1 / math.sqrt(c)),
                    inp.randn(cr, scale=0.1),
                    inp.randn(cr, c, scale=1 / math.sqrt(cr)),
                    inp.randn(c, scale=0.1)]
        w_rgb = inp.rand(b)
        for bb in (b, 1):
            rb, db, wb = r[:bb].contiguous(), d[:bb].contiguous(), w_rgb[:bb]
            n = bb * h * w * c
            cases.append(Case(
                "se_fuse_mixed.bf16", f"{bb}x{h}x{w}x{c}", calls,
                lambda r=rb, d=db, wr=wb, ws=wts: se.se_fuse_mixed(r, d, wr, *ws),
                lambda r=rb, d=db, wr=wb, ws=wts: se.se_fuse_mixed_plain(
                    r, d, wr, *ws),
                None, 3 * n * 2 + se_weight_bytes(c, 2), 5.0 * n, batch=bb,
                repeat=True, r50_calls=1 - calls,
                tol=BF16_TOL["se_fuse_mixed"]))
    # the single-map SE cell on bf16 maps: the bf16 R34 one-modality net's
    # five cells and the R50 one-modality net's last one (C = 2048)
    for c, h, w, net in ONE_MODALITY_SE:
        cr = c // 16
        wts = [inp.randn(c, cr, scale=1 / math.sqrt(c)), inp.randn(cr, scale=0.1),
               inp.randn(cr, c, scale=1 / math.sqrt(cr)), inp.randn(c, scale=0.1)]
        x = inp.randn(b, h * w, c).to(bf)
        for bb in (b, 1):
            xb = x[:bb].contiguous()
            n = bb * h * w * c
            cases.append(Case(
                "fused_se.bf16", f"{bb}x{h}x{w}x{c}", 1,
                lambda x=xb, ws=wts: se.fused_se(x, *ws),
                lambda x=xb, ws=wts: se.se_reference(x, *ws),
                None, 2 * n * 2 + se_weight_bytes(c, 1), 3.0 * n, batch=bb,
                repeat=True, net=net, tol=BF16_TOL["se_fuse_mixed"]))
    # the local gates' channel sums of the bf16 local-gate SkipESANet: R34's
    # four gates and R50's widest (1024 channels at 30×40)
    for c, h, w, net in LOCAL_GATE_SUMS:
        n = b * h * w * c
        r, d = inp.randn(b, h, w, c).to(bf), inp.randn(b, h, w, c).to(bf)
        cases.append(Case(
            "channel_sums.bf16", f"{b}x{h}x{w}x{c}", 1,
            lambda r=r, d=d: se.channel_sums(r, d),
            lambda r=r, d=d: se.channel_sums_plain(r, d),
            lambda r=r, d=d: (torch.sum(r, dim=(1, 2), dtype=torch.float32),
                              torch.sum(d, dim=(1, 2), dtype=torch.float32)),
            2 * n * 2 + 2 * b * c * 4, 2.0 * n, net=net,
            tol=BF16_TOL["channel_sums"]))
    return cases


def second_opinion(case: Case, outs_k: tuple, outs_p: tuple) -> None:
    """After a kernel/plain mismatch, and before the check fails: the kernel
    and the plain version once more on the same inputs, the plain version
    with and without cuDNN, each held against the first outputs, so that the
    failure says which side changed its answer."""
    def as_tuple(o):
        return o if isinstance(o, tuple) else (o,)

    with torch.inference_mode():
        runs = {"kernel": outs_k, "plain": outs_p,
                "kernel again": as_tuple(case.kern()),
                "plain again": as_tuple(case.plain())}
        with torch.backends.cudnn.flags(enabled=False):
            runs["plain without cuDNN"] = as_tuple(case.plain())
        torch.cuda.synchronize()
    for label, outs in runs.items():
        finite = all(bool(torch.isfinite(o).all()) for o in outs)
        print(f"  second opinion, {case.name} {case.label}: {label}: max |out| "
              f"{max(o.abs().max().item() for o in outs):.6g}, finite "
              f"{finite}", file=sys.stderr, flush=True)
    names = list(runs)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            err = max((x - y).abs().max().item()
                      for x, y in zip(runs[a], runs[b]))
            print(f"  second opinion: max |{a} - {b}| = {err:.6g}",
                  file=sys.stderr, flush=True)


def check_kernels(report: dict) -> list[dict]:
    from dynmm_tpu_torch.utils.device import device_ms

    per_kernel: dict[str, dict] = {}
    # per kernel and batch: ms, bound ms, fp32 CUDA-core bound ms, plain ms
    # a forward
    per_forward: dict[tuple[str, int], list[float]] = {}
    inp = Inputs(seed=0)
    for case in kernel_cases(inp):
        name, label, calls = case.name, case.label, case.calls
        with torch.inference_mode():
            out_k, out_p = case.kern(), case.plain()
            torch.cuda.synchronize()
            outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
            outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
            err = max((a - p).abs().max().item() for a, p in zip(outs_k, outs_p))
            scale = max(p.abs().max().item() for p in outs_p)
            rel = err / scale
            if not all(torch.isfinite(a).all() for a in outs_k):
                raise RuntimeError(f"{name} {label}: non-finite output")
            if rel > case.tol:
                second_opinion(case, outs_k, outs_p)
                raise RuntimeError(f"{name} {label}: max abs err {err:.3g} is "
                                   f"{rel:.3g} of max |plain| > {case.tol}")
            if case.repeat:
                for _ in range(REPEATS):
                    again = case.kern()
                    again = again if isinstance(again, tuple) else (again,)
                    if not all(torch.equal(a, o) for a, o in zip(again, outs_k)):
                        raise RuntimeError(f"{name} {label}: {REPEATS} calls "
                                           "on the same inputs differ")
            lib_ms = None
            if case.lib is not None:
                out_l = case.lib()
                outs_l = out_l if isinstance(out_l, tuple) else (out_l,)
                lib_err = max((a - p).abs().max().item()
                              for a, p in zip(outs_l, outs_p)) / scale
                # (a bf16 library call rounds at its own points)
                if lib_err > max(2 * case.tol, KERNEL_TOL):
                    raise RuntimeError(f"{name} {label}: library call differs "
                                       f"({lib_err:.3g})")
                lib_ms = device_ms(case.lib)
            ms, plain_ms = device_ms(case.kern), device_ms(case.plain)
            alt_ms = None if case.alt is None else device_ms(case.alt)
        b_ms, b_by = bound(case.n_bytes, case.n_flops, case.peak)
        fp32_ms, _ = bound(case.n_bytes, case.n_flops)
        tflops = case.n_flops / ms / 1e9
        row = {"kernel": name, "shape": label, "batch": case.batch,
               "calls_per_forward": calls, "r50_calls_per_forward":
               case.r50_calls, "max_abs_err": err,
               "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
               "fp32_bound_ms": fp32_ms, "tflops": tflops,
               "repeats_identical": REPEATS if case.repeat else None}
        if case.alt is not None:
            row["two_pair_ms"] = alt_ms
        report["kernel_cases"].append(row)
        bounds = (f"bound {b_ms:.4f} ms ({b_by})" if case.peak == PEAK_FP32_FLOPS
                  else f"bound 3xTF32 {b_ms:.4f} ms ({b_by}), fp32 "
                       f"{fp32_ms:.4f} ms")
        print(f"  {name:21s} {label:22s} x{calls:<2d} R50 x{case.r50_calls} "
              f"err {err:.3g} "
              f"(rel {rel:.3g})  kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s)  "
              f"plain {plain_ms:.4f} ms  "
              f"library {'-' if lib_ms is None else f'{lib_ms:.4f} ms'}  "
              + bounds
              + ("" if case.alt is None else f"  two nbt1d_pair {alt_ms:.4f} ms"),
              flush=True)
        for net, n_calls in ((case.net, calls), ("R50", case.r50_calls)):
            if not n_calls:
                continue
            tot = per_forward.setdefault((name, net, case.batch), [0.0] * 4)
            tot[0] += ms * n_calls
            tot[1] += b_ms * n_calls
            tot[2] += fp32_ms * n_calls
            tot[3] += plain_ms * n_calls
        agg = per_kernel.setdefault(name, {
            "name": name, "route": "cuda",
            "source": "dynmm_tpu_torch/kernels/csrc/"
                      + SOURCES[name.split(".")[0]][0],
            "replaces": SOURCES[name.split(".")[0]][1], "launches": 0,
            "max_abs_err": 0.0,
            "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": b_by,
            "library_ms": 0.0 if lib_ms is not None else None})
        agg["max_abs_err"] = max(agg["max_abs_err"], err)
        if case.batch != BATCH or case.net != TOTALS_NET.get(name, "R34"):
            continue
        # per-forward totals at B=8: each shape's time times its calls
        agg["ms"] += ms * calls
        agg["plain_ms"] += plain_ms * calls
        agg["bound_ms"] += b_ms * calls
        if lib_ms is not None:
            agg["library_ms"] += lib_ms * calls
    report["per_forward"] = []
    for (name, net, b), (ms, b_ms, fp32_ms, plain_ms) in per_forward.items():
        report["per_forward"].append({
            "kernel": name, "net": net, "batch": b, "ms": ms,
            "bound_ms": b_ms, "fp32_bound_ms": fp32_ms, "plain_ms": plain_ms})
        print(f"  {name} per dense {net} B={b} forward: {ms:.4f} ms; bound "
              f"{b_ms:.4f} ms" + (f", on fp32 CUDA cores {fp32_ms:.4f} ms"
                                  if fp32_ms != b_ms else "")
              + f"; plain {plain_ms:.4f} ms", flush=True)
    return list(per_kernel.values())


def check_serve(report: dict):
    from dynmm_tpu_torch.kernels import LAUNCHES, reset_launches
    from dynmm_tpu_torch.nn.layers import first_argmax
    from dynmm_tpu_torch.serve import build_flagship, serve

    t0 = time.perf_counter()
    model = build_flagship(HEIGHT, WIDTH, CLASSES, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  flagship built in {time.perf_counter() - t0:.2f} s "
          f"({n_params} parameters)", flush=True)
    inp = Inputs(seed=1)
    requests = [(inp.randn(b, HEIGHT, WIDTH, 3), inp.randn(b, HEIGHT, WIDTH, 1))
                for b in (BATCH,) * 3 + (1,) * 3]
    # warm-up of both paths (cuDNN picks its algorithms), not counted
    for i, use_kernels in ((0, True), (3, True), (0, False), (3, False)):
        serve(model, *requests[i], mode="dense", use_kernels=use_kernels)
    torch.cuda.synchronize()

    if path_launches([True] * 4, low_res=False) != EXPECTED:
        raise RuntimeError("EXPECTED disagrees with the block tables and "
                           "NBT1D_FUSED_MAX_C")
    # the main path's run: counts at 0 just before, read just after
    reset_launches()
    served = []
    for rgb, depth in requests:
        before = dict(LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        class_map, weight = serve(model, rgb, depth, mode="dense")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        delta = {k: LAUNCHES[k] - before.get(k, 0) for k in LAUNCHES}
        if delta != EXPECTED:
            raise RuntimeError(f"launches of one forward {delta} != {EXPECTED}")
        served.append((class_map, weight, ms))
        print(f"  request B={rgb.shape[0]}: {ms:.2f} ms, paths "
              f"{weight.argmax(1).tolist()}", flush=True)
    launches = dict(LAUNCHES)
    for name, n in EXPECTED.items():
        if launches.get(name, 0) != n * len(requests):
            raise RuntimeError(f"{name}: {launches.get(name, 0)} launches in "
                               f"the served run, expected {n * len(requests)}")

    # the same requests through the plain versions, same weights
    for (rgb, depth), (class_map, weight, ms) in zip(requests, served):
        with torch.inference_mode():
            logits_k = model(rgb, depth, hard=True, use_kernels=True)
            logits_p, weight_p = model(rgb, depth, hard=True,
                                       return_weight=True, use_kernels=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serve(model, rgb, depth, mode="dense", use_kernels=False)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
        b = rgb.shape[0]
        if logits_k.shape != (b, HEIGHT, WIDTH, CLASSES) or not bool(
                torch.isfinite(logits_k).all()):
            raise RuntimeError("served logits are not finite or mis-shaped")
        if class_map.shape != (b, HEIGHT, WIDTH) or class_map.dtype != torch.int32:
            raise RuntimeError("class map is mis-shaped")
        rel = ((logits_k - logits_p).abs().max()
               / logits_p.abs().max()).item()
        agree = (class_map == first_argmax(logits_p)).float().mean().item()
        same_gate = bool(torch.equal(weight, weight_p))
        row = {"batch": b, "ms": ms, "plain_ms": plain_ms,
               "paths": weight.argmax(1).tolist(), "logits_rel_err": rel,
               "class_map_agreement": agree, "same_gate": same_gate}
        report["serve"].append(row)
        print(f"  B={b}: kernels {ms:.2f} ms vs plain {plain_ms:.2f} ms; "
              f"logits rel err {rel:.3g}, class maps agree on "
              f"{agree * 100:.4f} %, gate choices identical: {same_gate}",
              flush=True)
        if not same_gate or rel > 1e-3 or agree < 0.999:
            raise RuntimeError("kernel path disagrees with the plain path")
    return model, launches


class PathGate:
    """Gate override of one model (the JAX tests' ``FixedGateNet``): hands
    out the fixed per-sample ``paths`` as one-hot weights, or runs the live
    gate while ``paths`` is None."""

    def __init__(self, model):
        self.live = model.gate_weights
        self.paths = None
        model.gate_weights = self

    def __call__(self, rgb, depth, temp=1.0, hard=False, baseline=False):
        if self.paths is None:
            return self.live(rgb, depth, temp=temp, hard=hard,
                             baseline=baseline)
        idx = torch.tensor(self.paths[:rgb.shape[0]], device=rgb.device)
        return torch.nn.functional.one_hot(idx, 5).to(rgb.dtype)


def path_launches(ran: list[bool], low_res: bool,
                  encoder_blocks=ENCODER_BLOCKS, bf16: bool = False) -> dict:
    """Launches of one flagship forward whose depth stages 1-4 ran as
    ``ran`` says. Always: the rgb encoder's and the decoder's stride-1
    blocks (one ``nbt1d_fused`` each up to ``NBT1D_FUSED_MAX_C`` channels,
    two ``nbt1d_pair`` above), the stem cell (``stem_fuse_pool`` and its
    ``channel_sums``), 5 upsamples (3 at ``low_res``). A depth stage that
    ran adds its blocks and one fusion cell (``se_fuse_mixed``).
    ``encoder_blocks``: the encoders' stride-1 NBt1D blocks per stage
    (none for ResNet50's Bottleneck encoders, whose stages still fuse).
    ``bf16``: the bf16 net, whose NBt1D blocks launch nothing (cuDNN
    convs) and whose other kernels count as "<name>.bf16"."""
    from dynmm_tpu_torch.kernels.nbt1d import NBT1D_FUSED_MAX_C

    if bf16:
        counts = path_launches(ran, low_res, ())
        return {f"{k}.bf16": v for k, v in counts.items()
                if not k.startswith("nbt1d")}

    counts = {"nbt1d_fused": 0, "nbt1d_pair": 0, "channel_sums": 1,
              "stem_fuse_pool": 1, "se_fuse_mixed": 0,
              "learned_upsample": 3 if low_res else 5}

    def blocks(c, n):
        if c <= NBT1D_FUSED_MAX_C:
            counts["nbt1d_fused"] += n
        else:
            counts["nbt1d_pair"] += 2 * n

    for i, r in enumerate(ran):
        if encoder_blocks:
            c, n = encoder_blocks[i]
            blocks(c, n * (1 + int(r)))
        counts["se_fuse_mixed"] += int(r)
    for c, n in DECODER_BLOCKS:
        blocks(c, n)
    return {k: v for k, v in counts.items() if v}


def stages_run(mode: str, paths: list[int], kw: dict) -> list[bool]:
    """Which depth stages a routed forward runs: stages 1..K (K the largest
    path, or ``force_path``) for batchmax and switch; for compact, the
    stages whose ladder rung for the n_i participants is above 0."""
    if mode != "compact":
        k = kw.get("force_path", max(paths))
        return [k >= i for i in range(1, 5)]
    from dynmm_tpu_torch.models.skip_gate import _stage_ladders

    ladders = _stage_ladders(kw.get("caps"), len(paths),
                             kw.get("strict_caps", False))
    ran = []
    for i, ladder in enumerate(ladders, start=1):
        n = sum(p >= i for p in paths)
        ran.append(next((c for c in ladder if n <= c), ladder[-1]) > 0)
    return ran


def check_routed(model, report: dict) -> dict:
    from dynmm_tpu_torch.kernels import LAUNCHES, reset_launches
    from dynmm_tpu_torch.nn.layers import first_argmax
    from dynmm_tpu_torch.serve import capacity_schedule, serve

    gate = PathGate(model)
    inp = Inputs(seed=2)
    big = (inp.randn(BATCH, HEIGHT, WIDTH, 3), inp.randn(BATCH, HEIGHT, WIDTH, 1))
    one = (big[0][:1].contiguous(), big[1][:1].contiguous())
    mixed = [0, 4, 2, 1, 3, 0, 1, 2]
    gate.paths = mixed
    per_stage = capacity_schedule(model, [big], BATCH)
    strict = capacity_schedule(model, [big], BATCH, capacity_factor=1.25)
    print(f"  capacity_schedule over paths {mixed}: per-stage {per_stage}, "
          f"strict x1.25 {strict}", flush=True)
    # (label, mode, paths (None: the live gate), images, serve kwargs)
    requests = [
        ("batchmax", "batchmax", mixed, big, {}),
        ("batchmax K=2", "batchmax", [2, 0, 1, 2, 0, 0, 1, 2], big, {}),
        ("compact", "compact", mixed, big, {}),
        ("compact per-stage", "compact", mixed, big, {"caps": per_stage}),
        ("compact strict", "compact", mixed, big,
         {"caps": strict, "strict_caps": True}),
        ("compact cheap", "compact", [0, 1, 0, 1, 0, 0, 1, 0], big, {}),
        *((f"switch k={k}", "switch", [k], one, {"force_path": k})
          for k in range(5)),
        ("switch live gate", "switch", None, one, {}),
        ("compact low_res", "compact", mixed, big, {"low_res": True}),
    ]

    def run(req, mode=None, use_kernels=True):
        label, m, paths, images, kw = req
        gate.paths = paths
        if mode == "dense":
            kw = {"low_res": kw.get("low_res", False)}
        return serve(model, *images, mode=mode or m, use_kernels=use_kernels,
                     **kw)

    # warm-up (cuDNN picks algorithms per batch size and capacity), not counted
    for req in requests:
        run(req)
        run(req, "dense")
    torch.cuda.synchronize()

    # the routed path's run: counts at 0 just before, read just after
    reset_launches()
    served = []
    for req in requests:
        label, mode, paths, images, kw = req
        before = dict(LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        class_map, weight = run(req)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        delta = {k: LAUNCHES[k] - before.get(k, 0) for k in LAUNCHES}
        delta = {k: v for k, v in delta.items() if v}
        chosen = weight.argmax(1).tolist()
        ran = stages_run(mode, chosen if paths is None else paths, kw)
        expected = path_launches(ran, kw.get("low_res", False))
        if delta != expected:
            raise RuntimeError(f"{label}: launches {delta} != {expected} "
                               f"(depth stages run {ran})")
        served.append((class_map, weight, ms, ran))
    launches = dict(LAUNCHES)

    # each request against the dense forward on the same paths
    methods = {"batchmax": "forward_switch_batched",
               "compact": "forward_routed_compact", "switch": "forward_switch"}
    for req, (class_map, weight, ms, ran) in zip(requests, served):
        label, mode, paths, (rgb, depth), kw = req
        low_res = kw.get("low_res", False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dense_map, dense_w = run(req, "dense")
        torch.cuda.synchronize()
        dense_ms = (time.perf_counter() - t0) * 1e3
        with torch.inference_mode():
            logits = getattr(model, methods[mode])(
                rgb, depth, **kw)
            logits_d = model(rgb, depth, hard=True, low_res=low_res)
        rel = ((logits - logits_d).abs().max() / logits_d.abs().max()).item()
        agree = (class_map == dense_map).float().mean().item()
        agree_logits = (first_argmax(logits_d) == first_argmax(logits)
                        ).float().mean().item()
        same_gate = bool(torch.equal(weight, dense_w))
        finite = bool(torch.isfinite(logits).all())
        b = rgb.shape[0]
        shape_ok = (class_map.shape == (b, HEIGHT, WIDTH) and logits.shape
                    == (b, HEIGHT // (4 if low_res else 1),
                        WIDTH // (4 if low_res else 1), CLASSES))
        row = {"request": label, "mode": mode, "batch": b,
               "paths": weight.argmax(1).tolist(), "depth_stages_run": ran,
               "serve_kwargs": dict(kw), "ms": ms,
               "dense_ms": dense_ms, "logits_rel_err": rel,
               "class_map_agreement": agree, "same_gate": same_gate,
               "launches": path_launches(ran, low_res)}
        report["routed"].append(row)
        print(f"  {label:18s} B={b} paths {row['paths']} stages run "
              f"{[int(r) for r in ran]}: {ms:.2f} ms vs dense {dense_ms:.2f} "
              f"ms; logits rel err {rel:.3g}, class maps agree on "
              f"{agree * 100:.4f} %, gate choices identical: {same_gate}",
              flush=True)
        if (not same_gate or not finite or not shape_ok or rel > 1e-3
                or agree < 0.999 or agree_logits < 0.999):
            raise RuntimeError(f"{label}: routed serving disagrees with the "
                               "dense forward")
    return launches


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def check_recipe_gate(report: dict) -> dict:
    import importlib.util

    from dynmm_tpu_torch.data.nyuv2 import make_recipe_eval_batch
    from dynmm_tpu_torch.kernels import LAUNCHES, reset_launches
    from dynmm_tpu_torch.nn.layers import first_argmax
    from dynmm_tpu_torch.serve import build_flagship, serve
    from dynmm_tpu_torch.utils.weights import load_recipe_gate

    found = {m: importlib.util.find_spec(m) is not None
             for m in ("msgpack", "flax")}
    print(f"  importable on this machine: msgpack {found['msgpack']}, flax "
          f"{found['flax']} (the asset is read with the port's own reader)",
          flush=True)
    model = build_flagship(HEIGHT, WIDTH, CLASSES, seed=0)
    ratios, provenance = load_recipe_gate(model)
    if ratios is None:
        raise RuntimeError("bench_assets/gate_recipe.msgpack is missing")
    rgb, depth = (torch.from_numpy(a).cuda()
                  for a in make_recipe_eval_batch(BATCH, HEIGHT, WIDTH))
    singles = [(rgb[i:i + 1].contiguous(), depth[i:i + 1].contiguous())
               for i in range(BATCH)]
    requests = [("dense", "dense", (rgb, depth)),
                ("batchmax", "batchmax", (rgb, depth)),
                ("compact", "compact", (rgb, depth)),
                *((f"switch #{i}", "switch", one)
                  for i, one in enumerate(singles))]
    for _, mode, images in requests:  # warm-up, not counted
        serve(model, *images, mode=mode)
        serve(model, *images, mode="dense")
    torch.cuda.synchronize()

    reset_launches()
    served = []
    for label, mode, images in requests:
        before = dict(LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        class_map, weight = serve(model, *images, mode=mode)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        delta = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                 if v - before.get(k, 0)}
        paths = weight.argmax(1).tolist()
        expected = path_launches(
            [True] * 4 if mode == "dense" else stages_run(mode, paths, {}),
            False)
        if delta != expected:
            raise RuntimeError(f"recipe {label}: launches {delta} != {expected}")
        served.append((class_map, weight, ms))
    launches = dict(LAUNCHES)

    methods = {"dense": "forward", "batchmax": "forward_switch_batched",
               "compact": "forward_routed_compact", "switch": "forward_switch"}
    rows = []
    for (label, mode, (r, d)), (class_map, weight, ms) in zip(requests, served):
        with torch.inference_mode():
            kw = {"hard": True} if mode == "dense" else {}
            logits = getattr(model, methods[mode])(r, d, **kw)
            logits_d, weight_d = model(r, d, hard=True, return_weight=True)
            logits_p, weight_p = model(r, d, hard=True, return_weight=True,
                                       use_kernels=False)
        routed_err = (logits - logits_d).abs().max().item()
        routed_rel = _rel(logits, logits_d)
        plain_rel = _rel(logits_d, logits_p)
        agree = (class_map == first_argmax(logits_p)).float().mean().item()
        same_gate = (torch.equal(weight, weight_d)
                     and torch.equal(weight_d, weight_p))
        row = {"request": label, "mode": mode, "batch": r.shape[0],
               "paths": weight.argmax(1).tolist(), "ms": ms,
               "routed_vs_dense_max_abs_err": routed_err,
               "kernels_vs_plain_rel_err": plain_rel,
               "class_map_agreement": agree, "same_gate": same_gate}
        rows.append(row)
        print(f"  {label:11s} B={r.shape[0]} paths {row['paths']}: {ms:.2f} ms;"
              f" routed vs dense max abs err {routed_err:.3g}; kernels vs "
              f"plain rel err {plain_rel:.3g}, class maps agree on "
              f"{agree * 100:.4f} %, gate choices identical: {same_gate}",
              flush=True)
        if (routed_rel > 1e-3 or not same_gate or plain_rel > 1e-3
                or agree < 0.999 or not bool(torch.isfinite(logits).all())):
            raise RuntimeError(f"recipe {label}: disagreement")
    paths = served[0][1].argmax(1)
    mix = torch.nn.functional.one_hot(paths, 5).double().mean(0).tolist()
    print(f"  path mix of the batch {mix} (paths {paths.tolist()}); the "
          f"asset's branch ratios {ratios.tolist()}", flush=True)
    report["recipe_gate"] = {"asset_branch_ratios": ratios.tolist(),
                             "provenance": provenance, "path_mix": mix,
                             "importable": found, "requests": rows}
    return launches


def check_r50(report: dict) -> dict:
    """Phase 9: the R50 SkipGateESANet (Bottleneck ResNet50 encoders, SE
    cells at 64/256/512/1024/2048 channels) with its recipe gate, served in
    every mode the JAX bench serves it."""
    from dynmm_tpu_torch.data.nyuv2 import make_recipe_eval_batch
    from dynmm_tpu_torch.kernels import LAUNCHES, reset_launches
    from dynmm_tpu_torch.models.skip_gate import capacity_ladders
    from dynmm_tpu_torch.nn.layers import first_argmax
    from dynmm_tpu_torch.serve import build_flagship, serve
    from dynmm_tpu_torch.utils.device import card_line
    from dynmm_tpu_torch.utils.weights import load_recipe_gate

    card = card_line()
    t0 = time.perf_counter()
    model = build_flagship(HEIGHT, WIDTH, CLASSES, seed=0, encoder="resnet50")
    ratios, _ = load_recipe_gate(model, "resnet50")
    if ratios is None:
        raise RuntimeError("bench_assets/gate_recipe_resnet50.msgpack is "
                           "missing")
    torch.cuda.synchronize()
    print(f"  R50 net built with its recipe gate in "
          f"{time.perf_counter() - t0:.2f} s "
          f"({sum(p.numel() for p in model.parameters())} parameters)",
          flush=True)
    gate = PathGate(model)
    big = tuple(torch.from_numpy(a).cuda()
                for a in make_recipe_eval_batch(BATCH, HEIGHT, WIDTH))
    one = tuple(x[:1].contiguous() for x in big)
    ladders = capacity_ladders(ratios, BATCH)
    strict = capacity_ladders(ratios, BATCH, capacity_factor=1.25)
    # (label, mode, images, serve kwargs); mode "baseline" is the dense
    # forward with path 4 forced (the static ESANet's compute)
    requests = [
        ("dense", "dense", big, {}),
        ("baseline", "baseline", big, {}),
        ("batchmax", "batchmax", big, {}),
        *((f"batchmax k={k}", "batchmax", big, {"force_path": k})
          for k in (0, 2, 4)),
        ("compact ladders", "compact", big, {"caps": ladders}),
        ("compact x1.25", "compact", big,
         {"caps": strict, "strict_caps": True}),
        ("dense B=1", "dense", one, {}),
        ("batchmax B=1", "batchmax", one, {}),
        *((f"switch #{i}", "switch",
           tuple(x[i:i + 1].contiguous() for x in big), {})
          for i in range(BATCH)),
    ]

    def run(req, use_kernels=True):
        _, mode, (rgb, depth), kw = req
        if mode == "baseline":
            with torch.inference_mode():
                logits, w = model(rgb, depth, hard=True, baseline=True,
                                  return_weight=True, use_kernels=use_kernels)
                return first_argmax(logits), w, logits
        cm, w = serve(model, rgb, depth, mode=mode, use_kernels=use_kernels,
                      **kw)
        return cm, w, None

    gate.paths = None
    for req in requests:  # warm-up (cuDNN picks its algorithms), not counted
        run(req)
        run(req, use_kernels=False)
    torch.cuda.synchronize()

    # the R50 path's run: counts at 0 just before, read just after
    reset_launches()
    served = []
    for req in requests:
        label, mode, images, kw = req
        before = dict(LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        class_map, weight, _ = run(req)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        delta = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                 if v - before.get(k, 0)}
        paths = weight.argmax(1).tolist()
        ran = ([True] * 4 if mode in ("dense", "baseline")
               else stages_run(mode, paths, kw))
        expected = path_launches(ran, False, R50_ENCODER_BLOCKS)
        if delta != expected:
            raise RuntimeError(f"R50 {label}: launches {delta} != {expected} "
                               f"(depth stages run {ran})")
        served.append((class_map, weight, ms, ran))
    launches = dict(LAUNCHES)

    methods = {"dense": "forward", "baseline": "forward",
               "batchmax": "forward_switch_batched",
               "compact": "forward_routed_compact", "switch": "forward_switch"}
    rows = []
    for req, (class_map, weight, ms, ran) in zip(requests, served):
        label, mode, (r, d), kw = req
        paths = weight.argmax(1).tolist()
        b = r.shape[0]
        with torch.inference_mode():
            dkw = {"hard": True, "baseline": mode == "baseline"}
            fwd = getattr(model, methods[mode])
            mkw = dkw if mode in ("dense", "baseline") else kw
            logits = fwd(r, d, **mkw)
            # dense on the request's own paths (its forced or live choices)
            gate.paths = paths
            logits_d = model(r, d, hard=True)
            gate.paths = None
            _, weight_p, _ = run(req, use_kernels=False)
            logits_p = fwd(r, d, use_kernels=False, **mkw)
        # a strict rung below a stage's participants drops their depth term
        counts = [sum(p >= i for p in paths) for i in range(1, 5)]
        overflow = kw.get("strict_caps", False) and any(
            n > c[-1] for n, c in zip(counts, kw["caps"]))
        routed_err = (logits - logits_d).abs().max().item()
        plain_rel = _rel(logits, logits_p)
        agree = (first_argmax(logits) == first_argmax(logits_p)
                 ).float().mean().item()
        same_gate = bool(torch.equal(weight, weight_p))
        ok_shape = (class_map.shape == (b, HEIGHT, WIDTH)
                    and logits.shape == (b, HEIGHT, WIDTH, CLASSES))
        row = {"request": label, "mode": mode, "batch": b, "paths": paths,
               "depth_stages_run": ran, "ms": ms,
               "routed_vs_dense_max_abs_err": routed_err,
               "strict_overflow": overflow,
               "kernels_vs_plain_rel_err": plain_rel,
               "class_map_agreement": agree, "same_gate": same_gate,
               "launches": path_launches(ran, False, R50_ENCODER_BLOCKS)}
        rows.append(row)
        print(f"  {label:16s} B={b} paths {paths} stages run "
              f"{[int(x) for x in ran]}: {ms:.2f} ms; routed vs dense max "
              f"abs err {routed_err:.3g}{' (strict overflow)' if overflow else ''}"
              f"; kernels vs plain rel err {plain_rel:.3g}, class maps agree "
              f"on {agree * 100:.4f} %, gate choices identical: {same_gate}",
              flush=True)
        if ((routed_err != 0 and not overflow) or not same_gate
                or plain_rel > 1e-3 or agree < 0.999 or not ok_shape
                or not bool(torch.isfinite(logits).all())):
            raise RuntimeError(f"R50 {label}: disagreement")
    mix = torch.nn.functional.one_hot(served[0][1].argmax(1), 5
                                      ).double().mean(0).tolist()
    print(f"  path mix of the batch {mix}; the asset's branch ratios "
          f"{ratios.tolist()}; ladders {ladders}, strict x1.25 {strict} "
          f"[{card}]", flush=True)
    report["r50"] = {"asset_branch_ratios": ratios.tolist(), "path_mix": mix,
                     "ladders": ladders, "strict": strict, "requests": rows,
                     "card": card}
    del model
    return launches


TRAIN_EPOCHS, TRAIN_STEPS = 2, 2  # phases 6 and 17: epochs of steps of B=8


def _train_data():
    """Phases 6 and 17's data and settings: (train loader, valid loader,
    class weights, config). Synthetic 480×640 batches, half of them
    depth-needed; the recipe's stage B
    (bench_assets/gate_recipe_logs/stage_b_argsv.txt), its first epochs:
    epoch_hard 60 keeps the gate soft."""
    from dynmm_tpu_torch.cli.seg_build import compute_class_weights
    from dynmm_tpu_torch.data.nyuv2 import SyntheticSegDataset
    from dynmm_tpu_torch.data.seg_preprocessing import SegLoader, SegPreprocessor
    from dynmm_tpu_torch.train.seg import SegTrainConfig

    train_ds = SyntheticSegDataset(n=TRAIN_STEPS * BATCH, height=HEIGHT,
                                   width=WIDTH, split="train",
                                   mixed_modality_frac=0.5)
    test_ds = SyntheticSegDataset(n=BATCH, height=HEIGHT, width=WIDTH,
                                  split="test", mixed_modality_frac=0.5)
    pre = lambda phase: SegPreprocessor(train_ds.depth_mean, train_ds.depth_std,
                                        HEIGHT, WIDTH, phase=phase)
    train_loader = SegLoader(train_ds, pre("train"), batch_size=BATCH,
                             shuffle=True, drop_last=True)
    valid_loader = SegLoader(test_ds, pre("test"), batch_size=BATCH)
    class_weights = compute_class_weights(train_ds, CLASSES,
                                          "median_frequency")
    cfg = SegTrainConfig(epochs=TRAIN_EPOCHS, lr=0.01, optimizer="SGD",
                         loss_ratio=1e-4, temp=1.0, end_temp=0.001,
                         epoch_hard=60, eval_every=1, batch_size=BATCH)
    return train_loader, valid_loader, class_weights, cfg


def _fit_counted(model, data, ckpt_dir: Path) -> dict:
    """``SegTrainer.fit`` of ``model`` on ``data`` (``_train_data``) into
    ``ckpt_dir``, each train step timed (ending in a synchronize) with its
    launches counted, each eval forward's launches recorded; the counts at 0
    just before the fit, read just after. Returns the trainer, its state and
    the fit's figures."""
    import shutil

    from dynmm_tpu_torch.kernels import LAUNCHES, reset_launches
    from dynmm_tpu_torch.train.seg import SegTrainer

    train_loader, valid_loader, class_weights, cfg = data
    trainer = SegTrainer(model, cfg, class_weights)
    state = trainer.init_state()
    steps_run, forwards = [], []
    train_step, model_forward = trainer.train_step, model.forward

    def timed_step(*args, **kw):
        before = dict(LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_step(*args, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        steps_run.append({"ms": ms, "loss": float(out[0]),
                          "launches": sum(LAUNCHES.values())
                          - sum(before.values())})
        return out

    def counted_forward(*args, **kw):
        before = dict(LAUNCHES)
        out = model_forward(*args, **kw)
        if not model.training:
            forwards.append({k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                             if v - before.get(k, 0)})
        return out

    trainer.train_step = timed_step
    model.forward = counted_forward
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    # the train path's run: counts at 0 just before, read just after
    reset_launches()
    t0 = time.perf_counter()
    _, best_miou, _ = trainer.fit(state, train_loader, valid_loader,
                                  str(ckpt_dir),
                                  log_fn=lambda m: print(f"  {m}", flush=True))
    fit_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    trainer.train_step, model.forward = train_step, model_forward
    return {"trainer": trainer, "state": state, "steps": steps_run,
            "forwards": forwards, "fit_s": fit_s, "peak": peak,
            "launches": launches, "best_miou": best_miou}


def _step_args(data) -> tuple:
    """One more train step's arguments after the fit: the first train
    batch on the card, the next epoch's temperature, soft, not ini."""
    from dynmm_tpu_torch.core.schedules import ExpDecayTemp
    from dynmm_tpu_torch.train.seg import DOWN_RATES

    train_loader, _, _, cfg = data
    tb = next(iter(train_loader))
    return (torch.from_numpy(tb["image"]).cuda(),
            torch.from_numpy(tb["depth"]).cuda(),
            [torch.from_numpy(tb["label"]).cuda()]
            + [torch.from_numpy(tb["label_down"][r]).cuda()
               for r in DOWN_RATES],
            ExpDecayTemp(cfg.temp, cfg.end_temp, cfg.epoch_hard)(TRAIN_EPOCHS),
            False, False)


def check_train(report: dict) -> dict:
    import shutil
    import statistics

    from dynmm_tpu_torch.models.esanet import ESANetConfig
    from dynmm_tpu_torch.models.skip_gate import SkipGateESANet
    from dynmm_tpu_torch.nn.layers import pack_weights
    from dynmm_tpu_torch.serve import build_flagship
    from dynmm_tpu_torch.train.seg import SegTrainer
    from dynmm_tpu_torch.utils.checkpoint import load_checkpoint, load_ckpt
    from dynmm_tpu_torch.utils.weights import load_checkpoint_into

    epochs, steps = TRAIN_EPOCHS, TRAIN_STEPS
    data = _train_data()
    _, valid_loader, class_weights, cfg = data
    model = build_flagship(HEIGHT, WIDTH, CLASSES, seed=3)
    ckpt_dir = ROOT / "build" / "chip_smoke_train"
    fit = _fit_counted(model, data, ckpt_dir)
    trainer, state, steps_run, forwards = (fit[k] for k in (
        "trainer", "state", "steps", "forwards"))
    fit_s, peak, launches, best_miou = (fit[k] for k in (
        "fit_s", "peak", "launches", "best_miou"))

    if len(steps_run) != epochs * steps:
        raise RuntimeError(f"{len(steps_run)} train steps, expected "
                           f"{epochs * steps}")
    if not all(math.isfinite(st["loss"]) for st in steps_run):
        raise RuntimeError(f"non-finite train loss: {steps_run}")
    if any(st["launches"] for st in steps_run):
        raise RuntimeError(f"a port kernel launched during a train step: "
                           f"{steps_run}")
    if len(forwards) != epochs or any(f != EXPECTED for f in forwards):
        raise RuntimeError(f"validation forwards launched {forwards}, expected "
                           f"{epochs} x {EXPECTED}")
    step_ms = statistics.median(st["ms"] for st in steps_run[1:])
    print(f"  {len(steps_run)} train steps of B={BATCH}: "
          f"{[round(st['ms'], 2) for st in steps_run]} ms (median after the "
          f"first {step_ms:.2f} ms), losses "
          f"{[round(st['loss'], 4) for st in steps_run]}; fit {fit_s:.2f} s; "
          f"peak memory {peak / 2 ** 30:.2f} GiB; best mIoU {best_miou:.4f}; "
          f"no kernel launch in a train step, {EXPECTED} in each of "
          f"{len(forwards)} validation forwards", flush=True)

    # the trained weights: kernel eval path against the plain one
    batch = next(iter(valid_loader))
    rgb = torch.from_numpy(batch["image"]).cuda()
    depth = torch.from_numpy(batch["depth"]).cuda()
    model.eval()
    pack_weights(model)
    with torch.inference_mode():
        logits_k, w_k = model(rgb, depth, hard=True, return_weight=True)
        logits_p, w_p = model(rgb, depth, hard=True, return_weight=True,
                              use_kernels=False)
    plain_rel = _rel(logits_k, logits_p)
    same_gate = bool(torch.equal(w_k, w_p))
    print(f"  trained weights, kernels vs plain: logits rel err "
          f"{plain_rel:.3g}, gate choices identical: {same_gate} (paths "
          f"{w_k.argmax(1).tolist()})", flush=True)
    if plain_rel > 1e-3 or not same_gate:
        raise RuntimeError("trained weights: kernel path disagrees with plain")

    # the rolling checkpoint into a fresh model
    latest = str(ckpt_dir / "ckpt_latest.msgpack")
    fresh = SkipGateESANet(ESANetConfig(height=HEIGHT, width=WIDTH,
                                        num_classes=CLASSES)).cuda()
    fresh = fresh.to(memory_format=torch.channels_last).eval()
    load_checkpoint_into(fresh, latest)
    with torch.inference_mode():
        logits_f = fresh(rgb, depth, hard=True)
    ckpt_err = (logits_f - logits_k).abs().max().item()
    print(f"  checkpoint loaded into a fresh model: eval logits max abs err "
          f"{ckpt_err:.3g}", flush=True)
    if ckpt_err != 0:
        raise RuntimeError("checkpoint reload changes the eval logits")
    del fresh

    # one step resumed from the rolling checkpoint against one more step of
    # the trained state, on the same batch
    args = _step_args(data)
    trainer.train_step(state, *args, torch.Generator())
    after = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del state, trainer, model
    model2 = build_flagship(HEIGHT, WIDTH, CLASSES, seed=4)
    trainer2 = SegTrainer(model2, cfg, class_weights)
    state2, epoch, _, _ = load_ckpt(latest, trainer2.init_state())
    trainer2.train_step(state2, *args, torch.Generator())
    resume_rel = max(
        ((v - after[k]).abs().max() / after[k].abs().max().clamp_min(1e-30)
         ).item() for k, v in model2.state_dict().items())
    print(f"  one step resumed from the epoch-{epoch} checkpoint vs one more "
          f"step of the trained state: max rel err over every parameter and "
          f"BN statistic {resume_rel:.3g}", flush=True)
    if resume_rel > 1e-5:
        raise RuntimeError("resumed training diverges from the trained state")
    PHASE6_CKPT.update(load_checkpoint(latest))  # for phase 17
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    report["train"] = {"steps": steps_run, "step_ms_median": step_ms,
                       "peak_memory_bytes": peak, "fit_s": fit_s,
                       "best_miou": best_miou,
                       "validation_launches": forwards,
                       "trained_kernels_vs_plain_rel_err": plain_rel,
                       "checkpoint_reload_max_abs_err": ckpt_err,
                       "resume_max_rel_err": resume_rel}
    return launches


# train-mode BN maps of the flagship at B=8: the stem, the four encoder
# stages, the PPM's 1×1 and 5×5 bins
BN_CHECK_SHAPES = [(BATCH, 64, HEIGHT // 2, WIDTH // 2),
                   (BATCH, 64, HEIGHT // 4, WIDTH // 4),
                   (BATCH, 128, HEIGHT // 8, WIDTH // 8),
                   (BATCH, 256, HEIGHT // 16, WIDTH // 16),
                   (BATCH, 512, HEIGHT // 32, WIDTH // 32),
                   (BATCH, 256, 1, 1), (BATCH, 256, 5, 5)]
# one step resumed from the bf16 rolling checkpoint against one more step of
# the trained state, max rel err over every parameter and BN statistic
# (5.1e-8 on the card): cuDNN's backward may sum in another order from run
# to run, and a bf16 step amplifies a flipped rounding
# (tests/test_torch_port_bf16_train.py); the same step from a fresh
# optimizer lies ~0.14 away
TRAIN_BF16_RESUME_TOL = 1e-3
STEADY_STEPS = 5  # phase 17's bf16 steps timed back to back after the fit
# phase 6's rolling checkpoint (fp32, SGD), read back before phase 6
# deletes it: phase 17 loads its optax-layout opt_state on the card
PHASE6_CKPT: dict = {}


def _bn_in_bf16(card: str) -> dict:
    """Train-mode BN of a bf16 map with fp32 parameters and running
    buffers, forward and backward on a seeded cotangent: the port's
    ``BatchNorm2d`` (on the card ``F.batch_norm`` on a channels-last bf16
    map, ``_WideBatchNorm`` on a contiguous one) against ``_WideBatchNorm``
    (the JAX BN's order: fp32 on the cast map, each result rounded once),
    at the flagship's BN shapes, the map and its gradient channels-last
    (the model's layout) or contiguous. The output, the input, weight and
    bias gradients and the running statistics must be bit-equal."""
    from dynmm_tpu_torch.nn.layers import BatchNorm2d, _WideBatchNorm

    g = torch.Generator(device="cuda").manual_seed(17)
    parts = ("output", "input grad", "weight grad", "bias grad",
             "running mean", "running var")
    differing = {}
    for shape in BN_CHECK_SHAPES:
        c = shape[1]
        x = (torch.randn(shape, device="cuda", generator=g) * 3 + 1).to(
            torch.bfloat16)
        cot = torch.randn(shape, device="cuda", generator=g).to(
            torch.bfloat16)
        weight = torch.rand(c, device="cuda", generator=g) + 0.5
        bias = torch.randn(c, device="cuda", generator=g)
        for layout in (torch.channels_last, torch.contiguous_format):
            def run(fn):
                xi = x.contiguous(memory_format=layout).requires_grad_()
                bn = BatchNorm2d(c).cuda().train()
                with torch.no_grad():
                    bn.weight.copy_(weight)
                    bn.bias.copy_(bias)
                y = fn(bn, xi)
                y.backward(cot.contiguous(memory_format=layout))
                return (y.detach(), xi.grad, bn.weight.grad, bn.bias.grad,
                        bn.running_mean, bn.running_var)

            port = run(lambda bn, t: bn(t))
            wide = run(lambda bn, t: _WideBatchNorm.apply(
                t, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                bn.momentum, bn.eps))
            key = f"{tuple(shape)} {str(layout).split('.')[-1]}"
            differing[key] = {p: int((a != b).sum().item())
                              for p, a, b in zip(parts, port, wide)
                              if a.dtype != b.dtype or not torch.equal(a, b)}
    bad = {k: v for k, v in differing.items() if v}
    print(f"  train-mode BN of a bf16 map, the port's BatchNorm2d "
          f"(F.batch_norm on a channels-last map, else _WideBatchNorm) "
          f"against _WideBatchNorm (fp32 on the cast map): output, "
          f"gradients and running statistics bit-equal at "
          f"{len(differing)} shapes and layouts: {not bad} "
          f"{dict(list(bad.items())[:3])} [{card}]", flush=True)
    if bad:
        raise RuntimeError("the port's bf16 BN on the card rounds otherwise "
                           f"than the JAX BN's order: {bad}")
    return {"cases": len(differing), "bit_equal": True}


def _same_bits(got, want, path: str = "") -> list:
    """The paths where two trees of arrays differ in dtype, shape or bits."""
    import numpy as np

    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(want):
            return [path or "/"]
        return [p for k in want for p in _same_bits(got[k], want[k],
                                                    f"{path}/{k}")]
    got, want = np.asarray(got), np.asarray(want)
    if (got.dtype, got.shape) != (want.dtype, want.shape):
        return [path]
    bits = f"u{got.dtype.itemsize}"
    return [] if np.array_equal(got.view(bits), want.view(bits)) else [path]


def check_train_bf16(report: dict) -> dict:
    """Phase 17: phase 6's fit of the flagship at ``dtype=torch.bfloat16``;
    the bf16 checkpoint resumed; phase 6's fp32 checkpoint's optax-layout
    optimizer state loaded on the card."""
    import shutil
    import statistics

    from dynmm_tpu_torch.nn.layers import first_argmax, pack_weights
    from dynmm_tpu_torch.serve import build_flagship
    from dynmm_tpu_torch.train.seg import SegTrainer
    from dynmm_tpu_torch.utils.checkpoint import (load_checkpoint, load_ckpt,
                                                  save_checkpoint)
    from dynmm_tpu_torch.utils.device import card_line
    from dynmm_tpu_torch.utils.weights import load_checkpoint_into

    card = card_line()
    t_phase = time.perf_counter()
    section = {"card": card, "batch_norm": _bn_in_bf16(card)}

    epochs, steps = TRAIN_EPOCHS, TRAIN_STEPS
    data = _train_data()
    _, valid_loader, class_weights, cfg = data
    bf16 = torch.bfloat16
    model = build_flagship(HEIGHT, WIDTH, CLASSES, seed=3, dtype=bf16)
    ckpt_dir = ROOT / "build" / "chip_smoke_train_bf16"
    fit = _fit_counted(model, data, ckpt_dir)
    trainer, state, steps_run, forwards = (fit[k] for k in (
        "trainer", "state", "steps", "forwards"))
    fit_s, peak, launches, best_miou = (fit[k] for k in (
        "fit_s", "peak", "launches", "best_miou"))

    if len(steps_run) != epochs * steps:
        raise RuntimeError(f"{len(steps_run)} bf16 train steps, expected "
                           f"{epochs * steps}")
    if not all(math.isfinite(st["loss"]) for st in steps_run):
        raise RuntimeError(f"non-finite bf16 train loss: {steps_run}")
    if any(st["launches"] for st in steps_run):
        raise RuntimeError(f"a port kernel launched during a bf16 train "
                           f"step: {steps_run}")
    if len(forwards) != epochs or any(f != EXPECTED_BF16 for f in forwards):
        raise RuntimeError(f"bf16 validation forwards launched {forwards}, "
                           f"expected {epochs} x {EXPECTED_BF16}")
    step_ms = statistics.median(st["ms"] for st in steps_run[1:])
    fp32 = report.get("train")
    fp32_line = ("phase 6 not run" if fp32 is None else
                 f"fp32, phase 6: {fp32['step_ms_median']:.2f} ms, "
                 f"{fp32['peak_memory_bytes'] / 2 ** 30:.2f} GiB")
    print(f"  {len(steps_run)} bf16 train steps of B={BATCH}: "
          f"{[round(st['ms'], 2) for st in steps_run]} ms (median after the "
          f"first {step_ms:.2f} ms), losses "
          f"{[round(st['loss'], 4) for st in steps_run]}; fit {fit_s:.2f} s; "
          f"peak memory {peak / 2 ** 30:.2f} GiB ({fp32_line}) [{card}]; best "
          f"mIoU {best_miou:.4f}; no kernel launch in a train step, "
          f"{EXPECTED_BF16} in each of {len(forwards)} validation forwards",
          flush=True)

    # the trained weights: the bf16 kernel eval path against the bf16 plain
    # one, phase 12's limits
    batch = next(iter(valid_loader))
    rgb = torch.from_numpy(batch["image"]).cuda()
    depth = torch.from_numpy(batch["depth"]).cuda()
    model.eval()
    pack_weights(model)
    with torch.inference_mode():
        logits_k, w_k = model(rgb, depth, hard=True, return_weight=True)
        logits_p, w_p = model(rgb, depth, hard=True, return_weight=True,
                              use_kernels=False)
    plain_err = (logits_k.float() - logits_p.float()).abs().max().item()
    plain_rel = plain_err / logits_p.float().abs().max().item()
    sure = _sure_pixels(logits_p, plain_err)
    sure_same = bool((first_argmax(logits_k) == first_argmax(logits_p))[
        sure].all())
    same_gate = bool(torch.equal(w_k, w_p))
    print(f"  trained bf16 weights, kernels vs plain: {plain_rel:.3g} of max "
          f"|plain| (bound {BF16_PLAIN_TOL}), class maps equal on the "
          f"{sure.float().mean().item() * 100:.4f} % of pixels with margin > "
          f"2x{plain_err:.3g}: {sure_same}, gate choices identical: "
          f"{same_gate} (paths {w_k.argmax(1).tolist()})", flush=True)
    if (plain_rel > BF16_PLAIN_TOL or not sure_same or not same_gate
            or logits_k.dtype != bf16):
        raise RuntimeError("trained bf16 weights: kernel path disagrees with "
                           "plain")

    # one more step of the trained state, on one batch
    args = _step_args(data)
    trainer.train_step(state, *args, torch.Generator())
    after = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del state, trainer, model

    def rel_err(m) -> float:
        return max(((v.float() - after[k].float()).abs().max()
                    / after[k].float().abs().max().clamp_min(1e-30)).item()
                   for k, v in m.state_dict().items())

    # the rolling checkpoint into a fresh bf16 trainer: bit-equal, then the
    # same step
    latest = str(ckpt_dir / "ckpt_latest.msgpack")
    written = load_checkpoint(latest)["state"]
    model2 = build_flagship(HEIGHT, WIDTH, CLASSES, seed=4, dtype=bf16)
    trainer2 = SegTrainer(model2, cfg, class_weights)
    state2, epoch, _, _ = load_ckpt(latest, trainer2.init_state())
    tree = state2.tree()
    diff = _same_bits(tree, written)
    print(f"  the bf16 rolling checkpoint (epoch {epoch}) in a fresh bf16 "
          f"trainer: weights, BN statistics and optimizer state bit-equal to "
          f"the file: {not diff} {diff[:3]}", flush=True)
    if diff:
        raise RuntimeError(f"bf16 resume differs from the file at {diff[:5]}")
    trainer2.train_step(state2, *args, torch.Generator())
    resume_rel = rel_err(model2)
    # the fit's four steps straddle an epoch's validation: five more steps
    # back to back on one batch give the step's time apart from that
    more = []
    for _ in range(STEADY_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer2.train_step(state2, *args, torch.Generator())
        torch.cuda.synchronize()
        more.append((time.perf_counter() - t0) * 1e3)
    steady_ms = statistics.median(more)
    print(f"  {STEADY_STEPS} more bf16 steps back to back: "
          f"{[round(t, 2) for t in more]} ms, median {steady_ms:.2f} ms "
          f"[{card}]", flush=True)
    del state2, trainer2, model2
    # the same step from the file's weights and a fresh optimizer
    model3 = build_flagship(HEIGHT, WIDTH, CLASSES, seed=4, dtype=bf16)
    trainer3 = SegTrainer(model3, cfg, class_weights)
    state3 = trainer3.init_state()
    load_checkpoint_into(model3, latest)
    trainer3.train_step(state3, *args, torch.Generator())
    fresh_rel = rel_err(model3)
    del state3, trainer3, model3
    print(f"  one bf16 step resumed from the checkpoint vs one more step of "
          f"the trained state: max rel err over every parameter and BN "
          f"statistic {resume_rel:.3g} (bound {TRAIN_BF16_RESUME_TOL}); from "
          f"a fresh optimizer {fresh_rel:.3g}", flush=True)
    if resume_rel > TRAIN_BF16_RESUME_TOL or resume_rel >= fresh_rel:
        raise RuntimeError("resumed bf16 training diverges from the trained "
                           "state")

    # phase 6's fp32 checkpoint through the port's writer; its optax-layout
    # opt_state loaded into a trainer on the card
    if not PHASE6_CKPT:
        raise RuntimeError("phase 6's checkpoint is not held: run phase 6 "
                           "first")
    path = str(ckpt_dir / "phase6_fp32.msgpack")
    save_checkpoint(path, PHASE6_CKPT["state"], PHASE6_CKPT["epoch"])
    written = load_checkpoint(path)["state"]
    model4 = build_flagship(HEIGHT, WIDTH, CLASSES, seed=4)
    trainer4 = SegTrainer(model4, cfg, class_weights)
    state4, _, _, _ = load_ckpt(path, trainer4.init_state())
    opt = state4.optimizer
    on_card = [t.device.type for st in opt.opt.state.values()
               for t in st.values() if torch.is_tensor(t)]
    diff = _same_bits(opt.state_tree(), written["opt_state"])
    layout = sorted(written["opt_state"])
    print(f"  phase 6's fp32 checkpoint, opt_state keys {layout} (optax's "
          f"inject_hyperparams state), in a fresh fp32 trainer: count "
          f"{opt.count}, {len(on_card)} momentum buffers, all on the card: "
          f"{set(on_card) == {'cuda'}}, bit-equal to the file: {not diff}",
          flush=True)
    if (diff or not on_card or set(on_card) != {"cuda"} or opt.count == 0
            or layout != ["count", "hyperparams", "hyperparams_states",
                          "inner_state"]):
        raise RuntimeError("phase 6's optax opt_state did not load on the "
                           "card")
    loss = float(trainer4.train_step(state4, *args, torch.Generator())[0])
    if not math.isfinite(loss):
        raise RuntimeError("a step from phase 6's optimizer state is not "
                           "finite")
    del state4, trainer4, model4
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    section.update({
        "steps": steps_run, "step_ms_median": step_ms,
        "steady_steps_ms": more, "steady_step_ms_median": steady_ms,
        "peak_memory_bytes": peak, "fit_s": fit_s, "best_miou": best_miou,
        "fp32_step_ms_median": None if fp32 is None else fp32[
            "step_ms_median"],
        "fp32_peak_memory_bytes": None if fp32 is None else fp32[
            "peak_memory_bytes"],
        "validation_launches": forwards,
        "trained_kernels_vs_plain_rel_err": plain_rel,
        "resume_bit_equal": True, "resume_max_rel_err": resume_rel,
        "fresh_optimizer_max_rel_err": fresh_rel,
        "phase6_opt_state_on_card": True, "seconds": seconds})
    report["train_bf16"] = section
    return launches


def _cli_run(fn, argv: list):
    """(result, printed lines) of a CLI's ``main(argv)``, stdout captured."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(argv)
    return result, out.getvalue().splitlines()


class StepProbe:
    """Patches ``SegTrainer.train_step``: each step's ms (host clock ending
    in a synchronize), loss and the port's kernel launches during it."""

    def __init__(self):
        from dynmm_tpu_torch.train.seg import SegTrainer

        self.cls, self.orig, self.steps = SegTrainer, SegTrainer.train_step, []
        probe = self

        def step(trainer, *args, **kw):
            from dynmm_tpu_torch.kernels import LAUNCHES

            before = sum(LAUNCHES.values())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = probe.orig(trainer, *args, **kw)
            torch.cuda.synchronize()
            probe.steps.append({
                "ms": (time.perf_counter() - t0) * 1e3,
                "loss": float(out[0]),
                "launches": sum(LAUNCHES.values()) - before})
            return out

        SegTrainer.train_step = step

    def close(self):
        self.cls.train_step = self.orig

    def check(self, label: str, n: int) -> None:
        if len(self.steps) != n:
            raise RuntimeError(f"{label}: {len(self.steps)} train steps, "
                               f"expected {n}")
        if not all(math.isfinite(st["loss"]) for st in self.steps):
            raise RuntimeError(f"{label}: non-finite loss {self.steps}")
        if any(st["launches"] for st in self.steps):
            raise RuntimeError(f"{label}: a port kernel launched during a "
                               f"train step: {self.steps}")


def _synthetic_argv(root: Path, height: int, width: int) -> list:
    return ["--dataset", "synthetic", "--height", str(height), "--width",
            str(width), "--batch_size", str(BATCH), "--synthetic_n",
            str(2 * BATCH), "--synthetic_mixed_frac", "0.5", "--epochs", "1",
            "--results_dir", str(root)]


def check_r50_train(report: dict) -> dict:
    """Phase 10: ``cli.train`` on the R50 SkipGateESANet, 2 steps of B=8 at
    480×640 and one validation batch."""
    import shutil

    from dynmm_tpu_torch.cli import train as train_cli
    from dynmm_tpu_torch.kernels import LAUNCHES, reset_launches

    root = ROOT / "build" / "chip_smoke_r50_train"
    shutil.rmtree(root, ignore_errors=True)
    argv = [*_synthetic_argv(root, HEIGHT, WIDTH), "--encoder", "resnet50",
            "--dynamic", "--global-gate", "--loss-ratio", "1e-4"]
    probe = StepProbe()
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        _, lines = _cli_run(train_cli.main, argv)
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        probe.check("R50 cli.train", 2)
    finally:
        probe.close()
        shutil.rmtree(root, ignore_errors=True)
    # one validation batch of B=8, the dense hard forward
    expected = path_launches([True] * 4, False, R50_ENCODER_BLOCKS)
    got = {k: v for k, v in launches.items() if v}
    if got != expected:
        raise RuntimeError(f"R50 cli.train: launches {got} != {expected}")
    steps = probe.steps
    print(f"  R50 cli.train: steps {[round(st['ms'], 2) for st in steps]} ms,"
          f" losses {[round(st['loss'], 4) for st in steps]}; peak memory "
          f"{peak / 2 ** 30:.2f} GiB; {wall:.2f} s in all; no kernel launch "
          f"in a step, {got} in the validation forward", flush=True)
    for ln in lines:
        if ln.startswith(("Epoch", "Test mIoU")):
            print(f"    {ln}", flush=True)
    report["r50_train"] = {"steps": steps, "peak_memory_bytes": peak,
                           "wall_s": wall, "validation_launches": got}
    return launches


def variant_launches(kind: str, bf16: bool = False) -> dict:
    """Launches of one eval forward of the R34-NBt1D variants: ``static``
    (the dense flagship's), ``local`` (the stem through ``stem_fuse_pool``
    with unit scales, one ``channel_sums`` a local gate, plain-add fusion),
    ``rgb-se`` (one encoder, five single-map SE cells). ``bf16``: the bf16
    net, whose NBt1D blocks launch nothing (cuDNN convs) and whose other
    kernels count as "<name>.bf16"."""
    from dynmm_tpu_torch.kernels.nbt1d import NBT1D_FUSED_MAX_C

    if bf16:
        return {f"{k}.bf16": v for k, v in variant_launches(kind).items()
                if not k.startswith("nbt1d")}
    if kind == "static":
        return dict(EXPECTED)
    counts = {"nbt1d_fused": 0, "nbt1d_pair": 0, "learned_upsample": 5}
    encoders = 2 if kind == "local" else 1
    for c, n in [(c, n * encoders) for c, n in ENCODER_BLOCKS] + list(
            DECODER_BLOCKS):
        if c <= NBT1D_FUSED_MAX_C:
            counts["nbt1d_fused"] += n
        else:
            counts["nbt1d_pair"] += 2 * n
    if kind == "local":
        counts.update(channel_sums=4, stem_fuse_pool=1)
    else:
        counts["fused_se"] = 5
    return counts


VARIANTS = {  # name: (kind, flags)
    "static ESANet": ("static", []),
    "SkipESANet 1122": ("local", ["--dynamic", "--block-rule", "1122"]),
    "one-modality rgb SE": ("rgb-se", ["--modality", "rgb"]),
}


def _variant_forward(model, kind: str, rgb, depth, use_kernels: bool = True):
    """(logits, the local gates' weights side by side or None) of one eval
    forward of a phase 11 variant; the local gates under ``test`` with the
    eval CLI's fixed generator."""
    if kind == "local":
        logits, ws = model(rgb, depth, torch.Generator().manual_seed(0),
                           test=True, return_weights=True,
                           use_kernels=use_kernels)
        return logits, torch.cat([w.float() for w in ws], 1)
    inputs = (rgb,) if kind == "rgb-se" else (rgb, depth)
    return model(*inputs, use_kernels=use_kernels), None


def _variant_model(eval_argv: list, ckpt: Path | None, dtype: str):
    """The eval CLI's model of ``eval_argv`` at ``dtype`` with the
    checkpoint's weights or, for ``ckpt=None``, the seeded weights of
    ``serve.init_weights`` (seed 0, the same at every dtype and run), on
    the card."""
    from dynmm_tpu_torch.cli import eval as eval_cli
    from dynmm_tpu_torch.cli.seg_build import build_model
    from dynmm_tpu_torch.nn.layers import pack_weights
    from dynmm_tpu_torch.serve import init_weights
    from dynmm_tpu_torch.utils.weights import load_checkpoint_into

    args = eval_cli.build_parser().parse_args([*eval_argv, "--dtype", dtype])
    model = build_model(args, CLASSES)
    if ckpt is None:
        init_weights(model, torch.Generator().manual_seed(0))
    else:
        load_checkpoint_into(model, str(ckpt))
    model = model.cuda().to(memory_format=torch.channels_last).eval()
    pack_weights(model)
    return model


def _drifts(models: dict, kind: str, rgb, depth) -> dict:
    """The bf16 net against the fp32 net on the same weights: the kernels'
    and the bf16 plain path's drifts (max abs error over max |fp32| on the
    samples whose gate choices agree: every one but a local gate's flips),
    the flips, and the class-map agreement."""
    from dynmm_tpu_torch.nn.layers import first_argmax

    with torch.inference_mode():
        lk, wk = _variant_forward(models["bf16"], kind, rgb, depth)
        lp, _ = _variant_forward(models["bf16"], kind, rgb, depth, False)
        l32, w32 = _variant_forward(models["fp32"], kind, rgb, depth)
    agree = (torch.ones(rgb.shape[0], dtype=torch.bool, device=rgb.device)
             if wk is None else (wk == w32).all(1))

    def drift(x):
        return ((x.float() - l32)[agree].abs().max()
                / l32.abs().max()).item() if bool(agree.any()) \
            else float("nan")

    return {"fp32_drift": drift(lk), "plain_fp32_drift": drift(lp),
            "gate_flips_vs_fp32": int((~agree).sum().item()),
            "fp32_max_abs": l32.abs().max().item(),
            "fp32_class_map_agreement":
                (first_argmax(lk) == first_argmax(l32)).float().mean().item()}


def _variant_bf16(name: str, kind: str, models: dict, seeded: dict, rgb,
                  depth, card: str) -> dict:
    """The bf16 variant against its bf16 plain versions on the trained
    weights (``models``), and against the fp32 net on the variant's seeded
    weights (``seeded``, the same for every run; the drift bound is held
    there) and on the trained ones (printed and stored, not bounded: cuDNN's
    nondeterministic backward moves the trained weights from run to run,
    and the bf16 plain path drifts with the kernels); both nets' request ms
    in turns (B=8 and B=1) with one traced request's device time and busy
    share each."""
    from dynmm_tpu_torch.nn.layers import first_argmax

    with torch.inference_mode():
        lk, wk = _variant_forward(models["bf16"], kind, rgb, depth)
        lp, wp = _variant_forward(models["bf16"], kind, rgb, depth, False)
    plain_err = (lk.float() - lp.float()).abs().max().item()
    plain_rel = plain_err / lp.float().abs().max().item()
    sure = _sure_pixels(lp, plain_err)
    sure_same = bool((first_argmax(lk) == first_argmax(lp))[sure].all())
    same_gate = wk is None or bool(torch.equal(wk, wp))
    initial = _drifts(seeded, kind, rgb, depth)
    trained = _drifts(models, kind, rgb, depth)
    drift = initial["fp32_drift"]
    ok = (lk.dtype == torch.bfloat16 and bool(torch.isfinite(lk).all())
          and same_gate and plain_rel <= BF16_PLAIN_TOL and sure_same
          and initial["gate_flips_vs_fp32"] < rgb.shape[0]
          and drift < BF16_DRIFT_TOL)
    row = {"kernels_vs_plain_max_abs_err": plain_err,
           "kernels_vs_plain_rel_err": plain_rel,
           "sure_pixel_share": sure.float().mean().item(),
           "sure_pixels_equal": sure_same, "same_gate_as_plain": same_gate,
           "seeded": initial, "trained": trained}
    flips, agree32 = (trained["gate_flips_vs_fp32"],
                      trained["fp32_class_map_agreement"])
    print(f"    bf16: kernels vs plain {plain_rel:.3g} of max |plain|, class "
          f"maps equal on the {row['sure_pixel_share'] * 100:.4f} % of "
          f"pixels with margin > 2x{plain_err:.3g}: {sure_same}; gate "
          f"choices as plain: {same_gate}; vs fp32 on the seeded weights: "
          f"{initial['gate_flips_vs_fp32']} of {rgb.shape[0]} samples with "
          f"other gate choices, drift {drift:.3g} of max |fp32| "
          f"({initial['fp32_max_abs']:.4g}) on the others (the plain path's "
          f"{initial['plain_fp32_drift']:.3g}; bound {BF16_DRIFT_TOL}); on "
          f"the trained weights (not bounded): {flips} flips, drift "
          f"{trained['fp32_drift']:.3g}, the plain path's "
          f"{trained['plain_fp32_drift']:.3g}, class maps agree on "
          f"{agree32 * 100:.4f} %", flush=True)
    if not ok:
        raise RuntimeError(f"{name} bf16: disagreement {row}")
    times = []
    for bb in (BATCH, 1):
        r, d = rgb[:bb].contiguous(), depth[:bb].contiguous()
        got = {"fp32": [], "bf16": []}
        with torch.inference_mode():
            for rep in range(TIMED_REPS + 1):  # the first is a warm-up
                for dt in ("fp32", "bf16") if rep % 2 else ("bf16", "fp32"):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    _variant_forward(models[dt], kind, r, d)
                    torch.cuda.synchronize()
                    if rep:
                        got[dt].append((time.perf_counter() - t0) * 1e3)
            med = {k: sorted(v)[len(v) // 2] for k, v in got.items()}
            traced = {k: _timed(lambda m=m: _variant_forward(m, kind, r, d),
                                reps=1)[3] for k, m in models.items()}
        times.append({"batch": bb, "fp32_ms": med["fp32"],
                      "bf16_ms": med["bf16"], "fp32_all": got["fp32"],
                      "bf16_all": got["bf16"], "traced": traced})
        print(f"    B={bb}: fp32 {med['fp32']:.2f} ms, bf16 {med['bf16']:.2f}"
              f" ms (median of {TIMED_REPS}, in turns); traced device ms / "
              f"busy share fp32 {traced['fp32']['device_ms']:.2f} / "
              f"{traced['fp32']['busy_share'] * 100:.1f} %, bf16 "
              f"{traced['bf16']['device_ms']:.2f} / "
              f"{traced['bf16']['busy_share'] * 100:.1f} % [{card}]",
              flush=True)
    row["request_ms"] = times
    return row


def check_variants(report: dict) -> dict:
    """Phase 11: ``cli.train`` (1 epoch of 2 steps of B=8) then ``cli.eval``
    on the rolling checkpoint for the static ESANet, the local-gate
    SkipESANet and the one-modality net with SE, R34-NBt1D at 480×640; the
    kernel eval path against the plain one on the trained weights. Then on
    the same checkpoint ``cli.eval --dtype bfloat16`` (and for the static
    net ``--quant int8 --dtype bfloat16``) and the bf16 net against its
    plain versions and the fp32 net (``_variant_bf16``)."""
    import shutil

    from dynmm_tpu_torch.cli import eval as eval_cli
    from dynmm_tpu_torch.cli import train as train_cli
    from dynmm_tpu_torch.data.nyuv2 import make_recipe_eval_batch
    from dynmm_tpu_torch.kernels import LAUNCHES, reset_launches
    from dynmm_tpu_torch.nn.layers import first_argmax
    from dynmm_tpu_torch.utils.device import card_line

    card = card_line()
    total: dict = {}
    rows = []
    rgb, depth = (torch.from_numpy(a).cuda()
                  for a in make_recipe_eval_batch(BATCH, HEIGHT, WIDTH))
    for name, (kind, flags) in VARIANTS.items():
        root = ROOT / "build" / "chip_smoke_variants"
        shutil.rmtree(root, ignore_errors=True)
        probe = StepProbe()
        try:
            reset_launches()
            t0 = time.perf_counter()
            _, train_lines = _cli_run(train_cli.main, [
                *_synthetic_argv(root, HEIGHT, WIDTH), *flags])
            train_s = time.perf_counter() - t0
            train_launches = dict(LAUNCHES)
            probe.check(f"{name} cli.train", 2)
            (ckpt,) = root.glob("synthetic/checkpoints_*/ckpt_latest.msgpack")
            eval_argv = [*_synthetic_argv(root, HEIGHT, WIDTH)[:-4], *flags,
                         *(["--hard"] if "--dynamic" in flags else []),
                         "--ckpt_path", str(ckpt)]
            # the eval CLI in fp32, bf16 and (static) int8-bf16; its one
            # valid batch: one forward, after one fp32 calibration forward
            # of the int8 net (no NBt1D launch: its convs are quantized)
            evals = [("fp32", [], variant_launches(kind)),
                     ("bf16", ["--dtype", "bfloat16"],
                      variant_launches(kind, bf16=True))]
            if kind == "static":
                calib = {k: v for k, v in variant_launches(kind).items()
                         if not k.startswith("nbt1d")}
                evals.append(("int8-bf16", ["--quant", "int8", "--dtype",
                                            "bfloat16", "--calib_batches",
                                            "1"],
                              _add(calib, variant_launches(kind, True))))
            eval_runs = {}
            for label, extra, expected in evals:
                reset_launches()
                t0 = time.perf_counter()
                result, _ = _cli_run(eval_cli.main, [*eval_argv, *extra])
                got = {k: v for k, v in LAUNCHES.items() if v}
                eval_runs[label] = {"miou": result.tolist(), "launches": got,
                                    "wall_s": time.perf_counter() - t0}
                if got != expected or not math.isfinite(float(result[0])):
                    raise RuntimeError(f"{name} cli.eval {label}: launches "
                                       f"{got}, expected {expected}, mIoU "
                                       f"{result.tolist()}")
                _add(total, got)
            models = {"fp32": _variant_model(eval_argv, ckpt, "float32"),
                      "bf16": _variant_model(eval_argv, ckpt, "bfloat16")}
            seeded = {"fp32": _variant_model(eval_argv, None, "float32"),
                      "bf16": _variant_model(eval_argv, None, "bfloat16")}
            # the trained weights: kernel eval path against the plain one
            with torch.inference_mode():
                (lk, wk), (lp, wp) = (
                    _variant_forward(models["fp32"], kind, rgb, depth, uk)
                    for uk in (True, False))
            print(f"  {name}:", flush=True)
            bf16_row = _variant_bf16(name, kind, models, seeded, rgb, depth,
                                     card)
            del models, seeded
        finally:
            probe.close()
            shutil.rmtree(root, ignore_errors=True)
        rel = _rel(lk, lp)
        agree = (first_argmax(lk) == first_argmax(lp)).float().mean().item()
        same_gate = wk is None or bool(torch.equal(wk, wp))
        expected = variant_launches(kind)
        got_train = {k: v for k, v in train_launches.items() if v}
        _add(total, got_train)
        miou_valid = next((ln.split()[2] for ln in train_lines
                           if ln.startswith("Test mIoU")), None)
        steps = probe.steps
        row = {"model": name, "steps": steps, "train_s": train_s,
               "eval": eval_runs, "train_valid_miou": miou_valid,
               "train_launches": got_train,
               "kernels_vs_plain_rel_err": rel, "class_map_agreement": agree,
               "same_gate": same_gate, "bf16": bf16_row}
        rows.append(row)
        print(f"    fp32: steps {[round(st['ms'], 2) for st in steps]} ms, "
              f"losses {[round(st['loss'], 4) for st in steps]}; validation "
              f"mIoU {miou_valid}; cli.eval mIoU "
              + ", ".join(f"{k} {v['miou']} ({v['wall_s']:.2f} s)"
                          for k, v in eval_runs.items())
              + f"; kernels vs plain rel err {rel:.3g}, class maps agree on "
              f"{agree * 100:.4f} %, gate choices identical: {same_gate} "
              f"[{card}]", flush=True)
        if got_train != expected:
            raise RuntimeError(f"{name}: launches train {got_train}, "
                               f"expected {expected}")
        if (rel > 1e-3 or agree < 0.999 or not same_gate
                or not bool(torch.isfinite(lk).all())):
            raise RuntimeError(f"{name}: kernel eval path disagrees with the "
                               "plain one")
    report["variants"] = rows
    return total


MODALITY_TOL = 1e-5  # routed vs dense requests, max abs err / max |dense|
CPU_TOL = 1e-4  # the card's dense forward vs the CPU's, same weights
MODALITY_REPS = 5  # timed repeats of each request, after one warm-up
IMDB_B, MOSEI_B, MOSEI_T = 4096, 1024, 50  # the JAX bench's serving batches


MARK = "spin_kernel"  # the device kernel of torch.cuda._sleep
TRACES = 3  # traces of a windowed call before a lost mark fails the phase


def _timed(fn, reps: int = MODALITY_REPS, window: bool = False):
    """(median ms, every ms, last output, device) of ``fn`` on the host
    clock ending in ``torch.cuda.synchronize()``, after one warm-up call;
    ``device``: the device time of one more call and its busy share of that
    call's window, from a ``torch.profiler`` trace. With ``window`` the
    traced call runs between two ``torch.cuda._sleep`` marks on the stream,
    with 128 tiny launches before and after them, and only the device
    events between the marks count, on the device's own clock: late in a
    long run of this script a trace lost ~45 device events at its edge
    and placed the host's window several ms off the device's. A trace
    that lost a mark's event is taken again, up to ``TRACES`` in all."""
    import statistics

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dynmm_tpu_torch.profile_serve import _busy_us

    out = fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    for attempt in range(1, TRACES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if window:
                pad = torch.zeros(1, device="cuda")
                for _ in range(128):
                    pad.add_(1)
                torch.cuda._sleep(1000)
                fn()
                torch.cuda._sleep(1000)
                for _ in range(128):
                    pad.add_(1)
                torch.cuda.synchronize()
            else:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
        events = [(e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not window:
            break
        marks = sorted((a, b) for a, b, name in events if MARK in name)
        if len(marks) == 2:
            break
        # the profiler dropped a mark's event (seen once late in a run):
        # the window cannot be placed, so the call is traced again
        print(f"    trace {attempt} of {TRACES} holds {len(marks)} of the 2 "
              f"{MARK} marks", flush=True)
    else:
        raise RuntimeError(f"{TRACES} traces lost a {MARK} mark around the "
                           "timed call")
    spans = [(a, b) for a, b, _ in events]
    if window:
        lo, hi = marks[0][1], marks[1][0]
        spans = [(a, b) for a, b, name in events
                 if lo <= a and b <= hi and MARK not in name]
        wall_us = hi - lo
    device = {"device_ms": sum(b - a for a, b in spans) / 1e3,
              "busy_share": _busy_us(spans) / wall_us, "kernels": len(spans)}
    return statistics.median(times), times, out, device


def _forced_gate(fc: torch.nn.Linear, branch: int) -> dict:
    """Zero the gate's last layer and bias it to ``branch``; returns the
    saved weights for ``fc.load_state_dict``."""
    saved = {k: v.clone() for k, v in fc.state_dict().items()}
    with torch.no_grad():
        fc.weight.zero_()
        fc.bias.fill_(0.0)
        fc.bias[branch] = 20.0
    return saved


def serve_router(name: str, model, args: tuple, gate_fc) -> dict:
    """Phase 7's requests on one router (see the module docstring)."""
    import copy

    bsz = args[0][0].shape[0]
    rows = []

    def check(label, timed, out, ref, same_gate, extra=None):
        ms, times, _, device = timed
        err = (out - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        ok = (rel <= MODALITY_TOL and same_gate
              and bool(torch.isfinite(out).all()))
        rows.append({"request": label, "ms": ms, "ms_all": times, **device,
                     "max_abs_err": err, "rel_err": rel,
                     "same_gate": same_gate, **(extra or {})})
        print(f"  {name} {label:22s} {ms:9.3f} ms (median of "
              f"{len(times)}; device {device['device_ms']:.3f} ms in "
              f"{device['kernels']} kernels, busy "
              f"{device['busy_share'] * 100:.1f} %); vs dense rel err "
              f"{rel:.3g}, gate identical: {same_gate}", flush=True)
        if not ok:
            raise RuntimeError(f"{name} {label}: disagrees with dense eval")

    with torch.inference_mode():
        d1 = model(*args, infer_mode=1)[0]
        d2 = model(*args, infer_mode=2)[0]
        hard_out, _, w_hard = model(*args, hard=True)
        k_gate = w_hard.argmax(1)
        for label, kw in (("dense soft", {"hard": False}),
                          ("dense hard", {"hard": True}),
                          ("infer_mode=2", {"infer_mode": 2})):
            timed = _timed(lambda kw=kw: model(*args, **kw))
            out = timed[2][0]
            ref = {"dense soft": out, "dense hard": hard_out,
                   "infer_mode=2": d2}[label]
            check(label, timed, out, ref, True)
        for frac in (0.0, 0.25, 0.5):
            fk = (torch.arange(bsz, device="cuda")
                  < int(round(frac * bsz))).int()
            timed = _timed(
                lambda fk=fk: model.forward_routed_compact(*args, force_k=fk))
            out, w = timed[2]
            ref = torch.where(fk[:, None] == 1, d2, d1)
            check(f"compact {int(frac * 100)} % expensive", timed, out, ref,
                  torch.equal(w, w_hard), {"expensive_rows": int(fk.sum())})
        timed = _timed(lambda: model.forward_routed_compact(*args))
        out, w = timed[2]
        check("compact live gate", timed, out, hard_out,
              torch.equal(w, w_hard), {"expensive_rows": int(k_gate.sum())})
        one = tuple([x[:1] for x in a] for a in args)
        for branch in (0, 1):
            saved = _forced_gate(gate_fc, branch)
            try:
                timed = _timed(lambda: model.forward_switch(*one))
                ref, _, w_d = model(*one, hard=True)
            finally:
                gate_fc.load_state_dict(saved)
            out, w = timed[2]
            check(f"switch B=1 branch {branch + 1}", timed, out, ref,
                  torch.equal(w, w_d) and int(w.argmax()) == branch)

        # the card's dense forward against the CPU's on the same weights
        n = bsz if name == "imdb" else 128
        cpu = copy.deepcopy(model).cpu()
        sub = tuple([x[:n].cpu() for x in a] for a in args)
        cpu_err = {}
        for label, kw in (("soft", {"hard": False}), ("branch 1",
                          {"infer_mode": 1}), ("branch 2", {"infer_mode": 2})):
            want = cpu(*sub, **kw)[0]
            got = model(*args, **kw)[0][:n].cpu()
            cpu_err[label] = ((got - want).abs().max()
                              / want.abs().max()).item()
        _, _, w_cpu = cpu(*sub, hard=True)
        gate_agree = (w_cpu.argmax(1) == k_gate[:n].cpu()).float().mean().item()
    print(f"  {name} card vs CPU on {n} rows: rel err {cpu_err}; hard gate "
          f"choices agree on {gate_agree * 100:.3f} %; the live gate sends "
          f"{int(k_gate.sum())} of {bsz} rows to the expensive branch",
          flush=True)
    if max(cpu_err.values()) > CPU_TOL:
        raise RuntimeError(f"{name}: the card's forward differs from the CPU's")
    return {"batch": bsz, "requests": rows, "cpu_rows": n,
            "card_vs_cpu_rel_err": cpu_err, "card_vs_cpu_gate_agreement":
            gate_agree, "live_gate_expensive_rows": int(k_gate.sum())}


def train_cli(name: str, cli, argv: list, router: str, ckpt: str,
              test_batch, workdir: str | None = None,
              start: dict | None = None) -> dict:
    """One CLI's ``main(argv)`` in a temporary working directory (or in
    ``workdir``, which it leaves in place), with its train steps timed (see
    the module docstring). ``start``: the flax params the CLI starts from
    (default: ``build_router(router, seed=0)``'s)."""
    import contextlib
    import io
    import os
    import statistics
    import tempfile

    import numpy as np

    from dynmm_tpu_torch.models.modality import build_router
    from dynmm_tpu_torch.train.supervised import SupervisedTrainer
    from dynmm_tpu_torch.utils.checkpoint import load_checkpoint
    from dynmm_tpu_torch.utils.weights import (flax_variables,
                                               load_checkpoint_into)

    steps, trainers = [], []
    step = SupervisedTrainer.train_step

    def timed_step(self, state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(self, state, batch)
        torch.cuda.synchronize()
        steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "loss": float(out[0])})
        if not trainers:
            trainers.append(self)
        return out

    log = io.StringIO()
    cwd = os.getcwd()
    with (contextlib.nullcontext(workdir) if workdir
          else tempfile.TemporaryDirectory()) as tmp:
        os.chdir(tmp)
        SupervisedTrainer.train_step = timed_step
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                cli.main(argv)
            run_s = time.perf_counter() - t0
        finally:
            SupervisedTrainer.train_step = step
            os.chdir(cwd)
        payload = load_checkpoint(os.path.join(tmp, "log", ckpt))
        fresh = build_router(router, seed=5, device="cuda")
        load_checkpoint_into(fresh, os.path.join(tmp, "log", ckpt))
    out_lines = log.getvalue().splitlines()
    for line in out_lines:
        print(f"    | {line[:200]}", flush=True)
    result = [ln for ln in out_lines if "Total Flops" in ln]
    if len(result) != 1:
        raise RuntimeError(f"{name}: no result line")

    def leaves(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, path + (k,))
            else:
                yield path + (k,), np.asarray(v)

    if start is None:  # the CLI's start
        start = flax_variables(build_router(router, seed=0,
                                            device="cpu"))["params"]
    before = dict(leaves(start))
    after = dict(leaves(payload["state"]["params"]))
    gate = [p for p in before if p[0] == "gate"]
    frozen_same = all(np.array_equal(after[p], v) for p, v in before.items()
                      if p[0] != "gate")
    gate_moved = bool(gate) and not any(np.array_equal(after[p], before[p])
                                        for p in gate)
    stat_leaves = [v for _, v in leaves(payload["state"].get(
        "model_state", {}).get("batch_stats", {}))]
    stats_finite = all(np.isfinite(v).all() for v in stat_leaves)

    model = trainers[0].model.eval()
    with torch.inference_mode():
        got = fresh(*test_batch, hard=True)
        want = model(*test_batch, hard=True)
    reload_err = max((g - w).abs().max().item() for g, w in zip(got, want))
    losses = [st["loss"] for st in steps]
    step_ms = statistics.median(st["ms"] for st in steps[1:])
    print(f"  {name}: {len(steps)} train steps, {step_ms:.3f} ms a step "
          f"(median after the first; all {[round(st['ms'], 3) for st in steps]}"
          f"), losses {[round(x, 4) for x in losses]}; run {run_s:.2f} s; "
          f"frozen parameters bit-identical: {frozen_same}; all {len(gate)} "
          f"gate leaves moved: {gate_moved}; {len(stat_leaves)} BN statistics "
          f"finite: {stats_finite}; checkpoint in a fresh router vs the CLI's "
          f"model, hard eval max abs err {reload_err:.3g}", flush=True)
    if not (all(math.isfinite(x) for x in losses) and frozen_same
            and gate_moved and stats_finite and reload_err == 0):
        raise RuntimeError(f"{name}: CLI training check failed")
    return {"argv": argv, "steps": steps, "step_ms_median": step_ms,
            "run_s": run_s, "result_line": result[0], "output": out_lines,
            "frozen_params_identical": frozen_same, "gate_moved": gate_moved,
            "bn_statistics": len(stat_leaves),
            "checkpoint_reload_max_abs_err": reload_err}


def check_modality(report: dict) -> None:
    from dynmm_tpu_torch.cli import affect_dyn, imdb_dyn
    from dynmm_tpu_torch.data.affect import synthetic_mosei_loaders
    from dynmm_tpu_torch.data.imdb import synthetic_imdb_loaders
    from dynmm_tpu_torch.kernels import LAUNCHES
    from dynmm_tpu_torch.models.modality import build_router

    before = dict(LAUNCHES)
    inp = Inputs(seed=7)
    imdb = build_router("imdb", seed=1)
    mosei = build_router("mosei", seed=2)
    lengths = torch.full((MOSEI_B,), MOSEI_T, dtype=torch.long, device="cuda")
    section = {
        "imdb": serve_router(
            "imdb", imdb, ([inp.randn(IMDB_B, 300), inp.randn(IMDB_B, 4096)],),
            imdb.gate.fc2),
        "mosei": serve_router(
            "mosei", mosei,
            ([inp.randn(MOSEI_B, MOSEI_T, d) for d in (35, 74, 300)],
             [lengths] * 3), mosei.gate.fc)}
    del imdb, mosei

    common = ["--synthetic", "--freeze", "--no-pretrain", "--n-epochs", "3",
              "--device", "cuda"]
    test = next(iter(synthetic_imdb_loaders(batch_size=128)[2]))
    imdb_batch = ([torch.from_numpy(x).cuda() for x in test.inputs],)
    section["imdb_train"] = train_cli(
        "imdb_dyn", imdb_dyn, common + ["--reg", "0.1"], "imdb",
        "imdb/DynMMNet_freezeTrue_reg_0.1.msgpack", imdb_batch)
    test = next(iter(synthetic_mosei_loaders(batch_size=32)[2]))
    mosei_batch = ([torch.from_numpy(x).cuda() for x in test.inputs],
                   [torch.from_numpy(x).long().cuda() for x in test.lengths])
    section["mosei_train"] = train_cli(
        "affect_dyn", affect_dyn, common + ["--reg", "0.01"], "mosei",
        "mosei/dyn_enc_transformer_reg_0.01freezeTrue.msgpack", mosei_batch)
    if dict(LAUNCHES) != before:
        raise RuntimeError(f"a port kernel launched in phase 7: {before} -> "
                           f"{dict(LAUNCHES)}")
    print("  no kernel launch counter moved in this phase", flush=True)
    report["modality"] = section


def _expert_table() -> list:
    """Phase 18's expert CLI runs: (label, CLI module, argv, serving input
    kind, files written under ``./log/``)."""
    from dynmm_tpu_torch.cli import affect_mm, affect_uni, imdb_mm, imdb_uni

    runs = [(f"imdb_uni --mod {m}", imdb_uni, ["--mod", str(m)], f"imdb{m}",
             (f"imdb/encoder_{n}", f"imdb/head_{n}"))
            for m, n in enumerate(imdb_uni.MOD_NAMES)]
    runs += [(f"imdb_mm --fuse {f}", imdb_mm, ["--fuse", str(f)], "imdb",
              (f"imdb/best_{n}",)) for f, n in enumerate(imdb_mm.FUSION_NAMES)]
    runs += [(f"affect_uni --mod 2 --enc {e}", affect_uni,
              ["--mod", "2", "--enc", e], "mosei2",
              (f"mosei/reg_{e}_encoder_text", f"mosei/reg_{e}_head_text"))
             for e in ("transformer", "gru")]
    runs += [(f"affect_mm --fusion {f}", affect_mm, ["--fusion", str(f)],
              "mosei", (f"mosei/{n}",))
             for f, n in affect_mm.FUSION_NAMES.items()]
    return runs


def _expert_run(label: str, cli, argv: list, files: tuple) -> dict:
    """One expert CLI's ``main(argv)`` in the working directory, its train
    steps timed (host clock ending in a synchronize); returns the trained
    model, the step times and losses, the result lines and the seconds.
    Each file it wrote must hold the model's trained tree bit for bit."""
    import statistics

    import numpy as np

    from dynmm_tpu_torch.train.experts import load_expert
    from dynmm_tpu_torch.train.supervised import SupervisedTrainer
    from dynmm_tpu_torch.utils.weights import flax_variables

    steps, trainers = [], []
    step = SupervisedTrainer.train_step

    def timed_step(self, state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(self, state, batch)
        torch.cuda.synchronize()
        steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "loss": float(out[0])})
        if not trainers:
            trainers.append(self)
        return out

    SupervisedTrainer.train_step = timed_step
    try:
        t0 = time.perf_counter()
        _, lines = _cli_run(cli.main, argv)
        run_s = time.perf_counter() - t0
    finally:
        SupervisedTrainer.train_step = step
    model = trainers[0].model.eval()
    trained = flax_variables(model)

    def leaves(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, path + (k,))
            else:
                yield path + (k,), np.asarray(v)

    same = True
    for f in files:
        payload = load_expert(f"./log/{f}.msgpack")
        sub = f.rsplit("/", 1)[1].split("_")
        want = trained["params"]
        if "encoder" in sub or "head" in sub:  # a unimodal expert's half
            want = want["encoder" if "encoder" in sub else "head"]
        got = dict(leaves(payload["params"]))
        same &= got.keys() == dict(leaves(want)).keys() and all(
            np.array_equal(got[p], v) for p, v in leaves(want))
    losses = [st["loss"] for st in steps]
    result = [ln for ln in lines if ln.startswith(("Test ", "Loss ", "Corr "))]
    step_ms = statistics.median(st["ms"] for st in steps[1:])
    print(f"  {label}: {len(steps)} train steps, {step_ms:.3f} ms a step "
          f"(median after the first), losses "
          f"{[round(x, 4) for x in losses]}; run {run_s:.2f} s; wrote "
          f"{', '.join(f + '.msgpack' for f in files)} (the trained tree, "
          f"bit for bit: {same}); {' / '.join(result)}", flush=True)
    if not (steps and all(math.isfinite(x) for x in losses) and same
            and result):
        raise RuntimeError(f"{label}: expert CLI check failed")
    return {"model": model, "steps": steps, "step_ms_median": step_ms,
            "run_s": run_s, "result": result, "files": list(files)}


def _expert_inputs(inp: Inputs) -> dict:
    """The serving inputs of each kind at the JAX bench's batches (MOSEI:
    ragged lengths in [1, T])."""
    text, image = inp.randn(IMDB_B, 300), inp.randn(IMDB_B, 4096)
    streams = [inp.randn(MOSEI_B, MOSEI_T, d) for d in (35, 74, 300)]
    g = torch.Generator(device="cuda").manual_seed(18)
    lengths = torch.randint(1, MOSEI_T + 1, (MOSEI_B,), generator=g,
                            device="cuda")
    return {"imdb0": (text,), "imdb1": (image,), "imdb": ([text, image],),
            "mosei2": (streams[2], lengths),
            "mosei": (streams, [lengths] * 3)}


def _rows(args, n: int):
    """The first ``n`` rows of a forward's arguments, on the CPU."""
    if isinstance(args, torch.Tensor):
        return args[:n].cpu()
    return type(args)(_rows(a, n) for a in args)


def check_experts(report: dict) -> None:
    """Phase 18 (see the module docstring)."""
    import copy
    import os
    import tempfile

    from dynmm_tpu_torch.cli import affect_dyn, imdb_dyn
    from dynmm_tpu_torch.data.affect import synthetic_mosei_loaders
    from dynmm_tpu_torch.data.imdb import synthetic_imdb_loaders
    from dynmm_tpu_torch.kernels import LAUNCHES
    from dynmm_tpu_torch.models.modality import build_router
    from dynmm_tpu_torch.train.experts import inject_expert, load_expert
    from dynmm_tpu_torch.utils.weights import flax_variables

    t_phase = time.perf_counter()
    before = dict(LAUNCHES)
    inputs = _expert_inputs(Inputs(seed=18))
    common = ["--synthetic", "--n-epochs", "2", "--device", "cuda"]
    section = {"experts": {}}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            for label, cli, argv, kind, files in _expert_table():
                run = _expert_run(label, cli, common + argv, files)
                model = run.pop("model")
                args = inputs[kind]
                with torch.inference_mode():
                    ms, times, out, device = _timed(lambda: model(*args),
                                                    window=True)
                    n = 256 if kind.startswith("imdb") else 128
                    want = copy.deepcopy(model).cpu()(*_rows(args, n))
                cpu_err = ((out[:n].cpu() - want).abs().max()
                           / want.abs().max()).item()
                finite = bool(torch.isfinite(out).all())
                print(f"    forward at B={out.shape[0]}: {ms:.3f} ms (median "
                      f"of {len(times)}; device {device['device_ms']:.3f} ms "
                      f"in {device['kernels']} kernels, busy "
                      f"{device['busy_share'] * 100:.1f} %); card vs CPU on "
                      f"{n} rows: rel err {cpu_err:.3g}", flush=True)
                if cpu_err > CPU_TOL or not finite:
                    raise RuntimeError(f"{label}: the card's forward differs "
                                       "from the CPU's")
                if not device["kernels"]:
                    raise RuntimeError(f"{label}: the trace shows no device "
                                       "work")
                section["experts"][label] = {
                    **run, "request_ms": ms, "request_ms_all": times,
                    **device, "batch": out.shape[0], "cpu_rows": n,
                    "card_vs_cpu_rel_err": cpu_err}
                del model
            section["step1_s"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            test = next(iter(synthetic_imdb_loaders(batch_size=128)[2]))
            imdb_batch = ([torch.from_numpy(x).cuda() for x in test.inputs],)
            test = next(iter(synthetic_mosei_loaders(batch_size=32)[2]))
            mosei_batch = (
                [torch.from_numpy(x).cuda() for x in test.inputs],
                [torch.from_numpy(x).long().cuda() for x in test.lengths])
            routers = (
                ("imdb_dyn", imdb_dyn, "imdb", ["--reg", "0.1"],
                 "imdb/DynMMNet_freezeTrue_reg_0.1.msgpack", imdb_batch,
                 "loaded expert", imdb_dyn.EXPERTS),
                ("affect_dyn", affect_dyn, "mosei", ["--reg", "0.01"],
                 "mosei/dyn_enc_transformer_reg_0.01freezeTrue.msgpack",
                 mosei_batch, "Loading model",
                 (("text_encoder",
                   "./log/mosei/reg_transformer_encoder_text.msgpack"),
                  ("text_head",
                   "./log/mosei/reg_transformer_head_text.msgpack"),
                  ("branch2", "./log/mosei/lf_tran.msgpack"))))
            for name, cli, router, extra, ckpt, batch, word, grafts in routers:
                start = flax_variables(build_router(router, seed=0,
                                                    device="cpu"))
                for sub, path in grafts:
                    start = inject_expert(start, sub, load_expert(path))
                run = train_cli(name, cli, common + ["--freeze"] + extra,
                                router, ckpt, batch, workdir=tmp,
                                start=start["params"])
                missing = [p for _, p in grafts
                           if f"{word} {p}" not in run["output"]]
                print(f"  {name} grafted {len(grafts) - len(missing)} of "
                      f"{len(grafts)} expert files; every leaf outside the "
                      "gate bit-identical to the files after training: "
                      f"{run['frozen_params_identical']}", flush=True)
                if missing:
                    raise RuntimeError(f"{name}: no graft line for {missing}")
                section[f"{name}_graft"] = run
            section["step2_s"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            _, lines = _cli_run(imdb_dyn.main, common + [
                "--freeze", "--reg", "0.1", "--eval-only", "--robust"])
            curves = [ln for ln in lines if ln.startswith("robustness (")]
            for ln in curves:
                print(f"    | {ln}", flush=True)
            values = [float(v) for ln in curves for v in
                      ln.split("[", 1)[1].split("]", 1)[0].split(",")]
            if len(curves) != 3 or len(values) != 18 or not all(
                    map(math.isfinite, values)):
                raise RuntimeError(f"imdb_dyn --robust: curves {curves}")
            section["robust"] = curves
            section["step3_s"] = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
    if dict(LAUNCHES) != before:
        raise RuntimeError(f"a port kernel launched in phase 18: {before} -> "
                           f"{dict(LAUNCHES)}")
    section["seconds"] = time.perf_counter() - t_phase
    print("  no kernel launch counter moved in this phase; seconds: step 1 "
          f"(14 expert CLIs and their requests) {section['step1_s']:.1f}, "
          f"step 2 (the routers graft them) {section['step2_s']:.1f}, step 3 "
          f"(--robust) {section['step3_s']:.1f}, phase "
          f"{section['seconds']:.1f}", flush=True)
    report["experts"] = section


CLI_SAMPLES = 16  # the prepared test split of phase 8: two batches of 8
CLI_SWITCH_NUM = 4  # samples predict serves at B=1 in the switch modes
# launches of one gate_only call (the stems and the gate): the stem cell
GATE_ONLY_LAUNCHES = {"channel_sums": 1, "stem_fuse_pool": 1}


def _add(total: dict, more: dict, times: int = 1) -> dict:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v * times
    return total


def _write_layout(root: Path) -> float:
    """The prepared NYUv2 layout of phase 8 (``data/png.py``): test/rgb,
    test/depth (uint16 mm), test/labels_40 and the split lists (the train
    list names the same ids; eval never reads the train files)."""
    import numpy as np

    from dynmm_tpu_torch.data import png
    from dynmm_tpu_torch.data.nyuv2 import SyntheticSegDataset

    ds = SyntheticSegDataset(n=CLI_SAMPLES, height=HEIGHT, width=WIDTH,
                             split="test", mixed_modality_frac=0.5)
    for kind in ("rgb", "depth", "labels_40"):
        (root / "test" / kind).mkdir(parents=True)
    t0 = time.perf_counter()
    ids = []
    for i in range(CLI_SAMPLES):
        s, name = ds[i], f"{i:05d}"
        ids.append(name)
        png.write(str(root / "test" / "rgb" / f"{name}.png"), s["image"])
        png.write(str(root / "test" / "depth" / f"{name}.png"),
                  np.round(s["depth"]).astype(np.uint16))
        png.write(str(root / "test" / "labels_40" / f"{name}.png"), s["label"])
    for split in ("train", "test"):
        (root / f"{split}.txt").write_text("\n".join(ids) + "\n")
    return time.perf_counter() - t0


def _host_share(root: Path, model, report: dict) -> None:
    """One batch's host work, each part apart: PNG decode (rgb, depth,
    label), preprocessing (resize, normalise, label maps), stacking, stem
    packing; beside the dense B=8 forward on the card."""
    import statistics

    import numpy as np

    from dynmm_tpu_torch.data.nyuv2 import NYUv2Dataset
    from dynmm_tpu_torch.data.seg_preprocessing import (SegLoader,
                                                        SegPreprocessor,
                                                        pack_stem_batch)
    from dynmm_tpu_torch.serve import serve

    ds = NYUv2Dataset(str(root), "test")
    pre = SegPreprocessor(ds.depth_mean, ds.depth_std, HEIGHT, WIDTH,
                          phase="test")
    rng = np.random.default_rng(0)
    parts = {"png_decode": [], "preprocess": [], "stack": [], "pack": [],
             "forward": []}
    for _ in range(3):
        t0 = time.perf_counter()
        samples = [ds[i] for i in range(BATCH)]
        t1 = time.perf_counter()
        samples = [pre(s, rng) for s in samples]
        t2 = time.perf_counter()
        batch = SegLoader._stack(samples)
        t3 = time.perf_counter()
        pack_stem_batch(batch)
        t4 = time.perf_counter()
        rgb = torch.from_numpy(batch["image"]).cuda()
        depth = torch.from_numpy(batch["depth"]).cuda()
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        serve(model, rgb, depth, mode="dense")
        torch.cuda.synchronize()
        t6 = time.perf_counter()
        for k, (a, b) in zip(parts, ((t0, t1), (t1, t2), (t2, t3), (t3, t4),
                                     (t5, t6))):
            parts[k].append((b - a) * 1e3)
    ms = {k: statistics.median(v) for k, v in parts.items()}
    loader_ms = ms["png_decode"] + ms["preprocess"] + ms["stack"]
    keeps_up = loader_ms + ms["pack"] <= ms["forward"]
    print("  host work of one B=8 batch (median of 3): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in ms.items())
          + f"; the loader thread's {loader_ms + ms['pack']:.2f} ms (packed) "
          f"{'keeps' if keeps_up else 'does not keep'} up with the "
          f"{ms['forward']:.2f} ms forward", flush=True)
    report["host_ms_per_batch"] = ms
    report["host_keeps_up"] = keeps_up


def check_clis(report: dict) -> dict:
    """Phase 8: ``cli.eval`` and ``cli.predict`` on a prepared layout."""
    import contextlib
    import io
    import shutil

    import numpy as np

    from dynmm_tpu_torch.cli import eval as eval_cli
    from dynmm_tpu_torch.cli import predict as predict_cli
    from dynmm_tpu_torch.data import png
    from dynmm_tpu_torch.data.nyuv2 import NYUv2Dataset, class_colors
    from dynmm_tpu_torch.data.seg_preprocessing import (SegLoader,
                                                        SegPreprocessor,
                                                        pack_stem_batch)
    from dynmm_tpu_torch.kernels import LAUNCHES, reset_launches
    from dynmm_tpu_torch.models.skip_gate import capacity_ladders
    from dynmm_tpu_torch.serve import build_flagship, serve
    from dynmm_tpu_torch.train.seg import SegTrainer
    from dynmm_tpu_torch.utils.checkpoint import save_checkpoint
    from dynmm_tpu_torch.utils.device import card_line
    from dynmm_tpu_torch.utils.weights import (flax_from_state_dict,
                                               load_recipe_gate)

    card = card_line()
    root = ROOT / "build" / "chip_smoke_cli"
    shutil.rmtree(root, ignore_errors=True)
    section: dict = {"eval": [], "predict": []}
    validate = SegTrainer.validate
    try:
        write_s = _write_layout(root)
        model = build_flagship(HEIGHT, WIDTH, CLASSES, seed=0)
        load_recipe_gate(model)
        v = flax_from_state_dict(model.state_dict())
        ckpt = str(root / "flagship.msgpack")
        save_checkpoint(ckpt, {"params": v["params"],
                               "model_state": {"batch_stats":
                                               v["batch_stats"]}}, epoch=0)
        pth = str(root / "flagship.pth")
        torch.save({k: t.cpu() for k, t in model.state_dict().items()}, pth)
        print(f"  wrote {CLI_SAMPLES} samples at {HEIGHT}x{WIDTH} in "
              f"{write_s:.2f} s, the flagship (recipe gate merged) as "
              ".msgpack and .pth", flush=True)

        # the test batches as the CLIs' loaders give them, raw and packed,
        # and each sample's path (the launches each run must give)
        ds = NYUv2Dataset(str(root), "test")
        pre = SegPreprocessor(ds.depth_mean, ds.depth_std, HEIGHT, WIDTH,
                              phase="test")
        batches = []
        for b in SegLoader(ds, pre, batch_size=BATCH, prefetch=0):
            p = pack_stem_batch(b)
            batches.append({k: torch.from_numpy(x).cuda() for k, x in (
                ("rgb", b["image"]), ("depth", b["depth"]),
                ("prgb", p["image"]), ("pdepth", p["depth"]))})
        with torch.inference_mode():
            paths = [model.gate_only(b["rgb"], b["depth"]).argmax(1).tolist()
                     for b in batches]
            ppaths = [model.gate_only(b["prgb"], b["pdepth"]).argmax(1)
                      .tolist() for b in batches]
        flat = sum(paths, [])
        mix = np.bincount(flat, minlength=5) / len(flat)
        print(f"  paths of the {len(flat)} samples {flat}, mix "
              f"{mix.tolist()}; packed inputs take the same paths: "
              f"{ppaths == paths}", flush=True)
        if ppaths != paths:
            raise RuntimeError(f"packed-stem gate choices {ppaths} != {paths}")
        ratios = mix.astype(np.float32)  # GateStats over the calib batches
        _host_share(root, model, section)

        # kernels against the plain versions on one batch, raw and packed;
        # the packed stem's logits against the raw stem's
        b0 = batches[0]
        with torch.inference_mode():
            agree = {}
            for kind, (r, d) in (("raw", (b0["rgb"], b0["depth"])),
                                 ("packed", (b0["prgb"], b0["pdepth"]))):
                cm_k, _ = serve(model, r, d, mode="dense")
                cm_p, _ = serve(model, r, d, mode="dense", use_kernels=False)
                agree[kind] = (cm_k == cm_p).float().mean().item()
            packed_rel = _rel(model(b0["prgb"], b0["pdepth"], hard=True),
                              model(b0["rgb"], b0["depth"], hard=True))
        print(f"  kernels vs plain class maps agree on {agree['raw'] * 100:.4f}"
              f" % (raw), {agree['packed'] * 100:.4f} % (packed); packed vs "
              f"raw stem logits rel err {packed_rel:.3g}", flush=True)
        section.update(kernels_vs_plain_agreement=agree,
                       packed_vs_raw_logits_rel_err=packed_rel,
                       paths=flat, path_mix=mix.tolist())
        if min(agree.values()) < 0.999 or packed_rel > 1e-4:
            raise RuntimeError("phase 8: kernel/plain or packed/raw mismatch")

        dense = path_launches([True] * 4, False)
        # the capacity runs' calibration: gate_only on every batch
        # (--calib_batches 8 ≥ 2)
        calib = _add({}, GATE_ONLY_LAUNCHES, len(batches))

        def strict(factor, p):
            return {"caps": capacity_ladders(ratios, len(p),
                                             capacity_factor=factor),
                    "strict_caps": True}

        def routed(mode, low_res=False, kw=lambda p: {}, pp=paths):
            out = {}
            for p in pp:
                _add(out, path_launches(stages_run(mode, p, kw(p)), low_res))
            return out

        timings = []

        def timed_validate(self, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = validate(self, *a, **k)
            torch.cuda.synchronize()
            timings.append((time.perf_counter() - t0,
                            out[1]["time_forward"]))
            return out

        SegTrainer.validate = timed_validate
        base = ["--dataset", "nyuv2", "--dataset_dir", str(root),
                "--height", str(HEIGHT), "--width", str(WIDTH),
                "--batch_size", str(BATCH)]
        hard = [*base, "--dynamic", "--global-gate", "--hard"]
        n_b = len(batches)
        evals = [
            ("msgpack", [*hard, "--ckpt_path", ckpt], _add({}, dense, n_b)),
            (".pth", [*hard, "--ckpt_path", pth], _add({}, dense, n_b)),
            ("noise x2", [*hard, "--ckpt_path", ckpt, "--num_runs", "2",
                          "--mode", "2", "--noise", "0.5"],
             _add({}, dense, 2 * n_b)),
            ("quarter", [*hard, "--ckpt_path", ckpt, "--output_res",
                         "quarter"],
             _add({}, path_launches([True] * 4, True), n_b)),
            ("capacity 8.0", [*hard, "--ckpt_path", ckpt,
                              "--capacity_factor", "8.0"],
             _add(routed("compact", kw=lambda p: strict(8.0, p)), calib)),
            ("packed", [*hard, "--ckpt_path", ckpt, "--packed_stem"],
             _add({}, dense, n_b)),
        ]
        # warm-up (cuDNN picks its algorithms), not counted
        with contextlib.redirect_stdout(io.StringIO()):
            eval_cli.main(evals[0][1])
        timings.clear()
        launches: dict = {}
        mious = {}
        for label, argv, expected in evals:
            out = io.StringIO()
            # each run: counts at 0 just before, read just after
            reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                result = eval_cli.main(argv)
            wall = time.perf_counter() - t0
            got = dict(LAUNCHES)
            _add(launches, got)
            if {k: v for k, v in got.items() if v} != expected:
                raise RuntimeError(f"eval {label}: launches {got} != "
                                   f"{expected}")
            runs = [timings.pop(0) for _ in range(len(result))]
            s_batch = sum(t for t, _ in runs) / (len(runs) * n_b)
            fwd_batch = sum(f for _, f in runs) / (len(runs) * n_b)
            mious[label] = result.tolist()
            lines = [ln for ln in out.getvalue().splitlines()
                     if ln.startswith(("Run", "  branch", "capacity"))]
            row = {"run": label, "miou": result.tolist(), "wall_s": wall,
                   "s_per_batch": s_batch, "forward_s_per_batch": fwd_batch,
                   "launches": got, "lines": lines}
            section["eval"].append(row)
            print(f"  eval {label:12s}: mIoU "
                  f"{[round(float(m), 4) for m in result]}, "
                  f"{s_batch:.4f} s a batch of {BATCH} ({fwd_batch:.4f} s "
                  f"forward to class map), {wall:.2f} s in all [{card}]",
                  flush=True)
            for ln in lines:
                print(f"    {ln.strip()}", flush=True)
        SegTrainer.validate = validate
        if mious[".pth"] != mious["msgpack"]:
            raise RuntimeError(f"eval: .pth mIoU {mious['.pth']} != msgpack "
                               f"{mious['msgpack']}")
        if mious["capacity 8.0"] != mious["msgpack"]:
            raise RuntimeError("eval: capacity factor 8.0 differs from the "
                               "exact chain")

        colors = class_colors(CLASSES + 1)
        pbase = [*base, "--ckpt_path", ckpt]
        sw = ["--batch_size", "1", "--num", str(CLI_SWITCH_NUM)]
        singles = [[p] for p in flat[:CLI_SWITCH_NUM]]
        predicts = [
            ("batchmax", [], "batchmax", False, False, {},
             routed("batchmax")),
            ("dense", ["--serve_mode", "dense"], "dense", False, False, {},
             _add({}, dense, n_b)),
            ("compact", ["--serve_mode", "compact"], "compact", False, False,
             {}, routed("compact")),
            ("compact x1.25", ["--serve_mode", "compact", "--capacity_factor",
                               "1.25"], "compact", False, False, "cf",
             _add(routed("compact", kw=lambda p: strict(1.25, p)), calib)),
            ("switch", ["--serve_mode", "switch", *sw], "switch", False,
             False, {}, routed("switch", pp=singles)),
            ("switch_host", ["--serve_mode", "switch_host", *sw],
             "switch_host", False, False, {}, routed("switch", pp=singles)),
            ("quarter", ["--output_res", "quarter"], "batchmax", True, False,
             {}, routed("batchmax", low_res=True)),
            ("packed", ["--packed_stem"], "batchmax", False, True, {},
             routed("batchmax")),
        ]
        for label, extra, mode, low_res, packed, kw, expected in predicts:
            out_dir = root / f"pred_{label.replace(' ', '_')}"
            out = io.StringIO()
            reset_launches()
            with contextlib.redirect_stdout(out):
                res = predict_cli.main([*pbase, *extra, "--out_dir",
                                        str(out_dir)])
            got = dict(LAUNCHES)
            _add(launches, got)
            if {k: v for k, v in got.items() if v} != expected:
                raise RuntimeError(f"predict {label}: launches {got} != "
                                   f"{expected}")
            # the written maps against serve()'s on the same batches
            single = mode in ("switch", "switch_host")
            keys = ("prgb", "pdepth") if packed else ("rgb", "depth")
            reqs = ([tuple(b[k][i:i + 1] for k in keys)
                     for b in batches for i in range(BATCH)] if single else
                    [tuple(b[k] for k in keys) for b in batches])
            maps = []
            for r, d in reqs:
                r, d = r.contiguous(), d.contiguous()
                skw = strict(1.25, [0] * r.shape[0]) if kw == "cf" else {}
                cm, _ = serve(model, r, d, mode=mode, low_res=low_res, **skw)
                maps.extend(cm.cpu().numpy())
                if len(maps) >= res["n"]:
                    break
            diff = [np.abs(png.read(str(out_dir / f"pred_{i:05d}.png"))
                           .astype(np.int32) - colors[maps[i] + 1])
                    for i in range(res["n"])]
            err = max(int(d.max()) for d in diff)
            same = float(np.mean([(d == 0).all(axis=-1).mean() for d in diff]))
            row = {"run": label, "n": res["n"], "fps": res["fps"],
                   "path_distribution": np.asarray(res["ratios"]).tolist(),
                   "png_max_abs_err": err, "png_pixels_equal": same,
                   "launches": got}
            section["predict"].append(row)
            print(f"  predict {label:13s}: {res['n']} maps, "
                  f"{res['fps']:.2f} frames/s, path distribution "
                  f"{np.round(np.float64(res['ratios']), 3).tolist()}, PNGs "
                  f"vs serve() max abs err {err} ({same * 100:.4f} % of "
                  f"pixels equal) [{card}]", flush=True)
            if err != 0:
                raise RuntimeError(f"predict {label}: written maps differ "
                                   "from serve()'s")

        # the R50 net (recipe gate merged) through predict --encoder resnet50
        del model
        r50 = build_flagship(HEIGHT, WIDTH, CLASSES, seed=0,
                             encoder="resnet50")
        load_recipe_gate(r50, "resnet50")
        v = flax_from_state_dict(r50.state_dict())
        r50_ckpt = str(root / "r50.msgpack")
        save_checkpoint(r50_ckpt, {"params": v["params"], "model_state": {
            "batch_stats": v["batch_stats"]}}, epoch=0)
        with torch.inference_mode():
            r50_paths = [r50.gate_only(b["rgb"], b["depth"]).argmax(1)
                         .tolist() for b in batches]
        expected = {}
        for p in r50_paths:
            _add(expected, path_launches(stages_run("batchmax", p, {}), False,
                                         R50_ENCODER_BLOCKS))
        out_dir = root / "pred_r50"
        reset_launches()
        res, _ = _cli_run(predict_cli.main, [
            *pbase[:-1], r50_ckpt, "--encoder", "resnet50", "--out_dir",
            str(out_dir)])
        got = dict(LAUNCHES)
        _add(launches, got)
        if {k: v for k, v in got.items() if v} != expected:
            raise RuntimeError(f"predict R50: launches {got} != {expected}")
        maps = []
        for b in batches:
            cm, _ = serve(r50, b["rgb"], b["depth"], mode="batchmax")
            maps.extend(cm.cpu().numpy())
        err = max(int(np.abs(png.read(str(out_dir / f"pred_{i:05d}.png"))
                             .astype(np.int32) - colors[maps[i] + 1]).max())
                  for i in range(res["n"]))
        row = {"run": "R50 batchmax", "n": res["n"], "fps": res["fps"],
               "path_distribution": np.asarray(res["ratios"]).tolist(),
               "png_max_abs_err": err, "launches": got}
        section["predict"].append(row)
        print(f"  predict --encoder resnet50: {res['n']} maps, "
              f"{res['fps']:.2f} frames/s, path distribution "
              f"{np.round(np.float64(res['ratios']), 3).tolist()} (paths "
              f"{sum(r50_paths, [])}), PNGs vs serve() max abs err {err} "
              f"[{card}]", flush=True)
        if err != 0 or res["n"] != CLI_SAMPLES:
            raise RuntimeError("predict R50: written maps differ from "
                               "serve()'s")
        del r50
    finally:
        SegTrainer.validate = validate
        shutil.rmtree(root, ignore_errors=True)
    report["clis"] = section
    return launches


BF16_ROUTED_TOL = 8e-3  # a routed bf16 request vs the dense bf16 forward
BF16_PLAIN_TOL = 2e-2  # bf16 kernels vs bf16 plain versions, same weights
# bf16 vs fp32 logits, of max |fp32 logits|: the JAX package's own bound
# (tests/test_routed_compact.py:251)
BF16_DRIFT_TOL = 5e-2
TIMED_REPS = 5  # requests timed per dtype, in turns


def _sure_pixels(logits: torch.Tensor, err: float) -> torch.Tensor:
    """Pixels whose top-two logit margin exceeds 2·err: no error of at most
    ``err`` on each logit can change their class."""
    top2 = logits.float().topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) > 2 * err


def check_bf16(report: dict) -> dict:
    """Phase 12: the bf16 flagship (480×640, recipe gate) served in every
    mode and through ``cli.eval`` / ``cli.predict --dtype bfloat16``, held
    against its dense forward, its plain versions and the fp32 flagship."""
    import shutil

    from dynmm_tpu_torch.cli import eval as eval_cli
    from dynmm_tpu_torch.cli import predict as predict_cli
    from dynmm_tpu_torch.data.nyuv2 import NYUv2Dataset, make_recipe_eval_batch
    from dynmm_tpu_torch.data.seg_preprocessing import SegLoader, SegPreprocessor
    from dynmm_tpu_torch.kernels import LAUNCHES, reset_launches
    from dynmm_tpu_torch.nn.layers import first_argmax
    from dynmm_tpu_torch.serve import build_flagship, capacity_schedule, serve
    from dynmm_tpu_torch.utils.checkpoint import save_checkpoint
    from dynmm_tpu_torch.utils.device import card_line
    from dynmm_tpu_torch.utils.weights import (flax_from_state_dict,
                                               load_recipe_gate)

    card = card_line()
    if path_launches([True] * 4, False, bf16=True) != EXPECTED_BF16:
        raise RuntimeError("EXPECTED_BF16 disagrees with path_launches")
    models = {}
    for name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        models[name] = build_flagship(HEIGHT, WIDTH, CLASSES, seed=0,
                                      dtype=dtype)
        load_recipe_gate(models[name])
    m16, m32 = models["bf16"], models["fp32"]
    rgb, depth = (torch.from_numpy(a).cuda()
                  for a in make_recipe_eval_batch(BATCH, HEIGHT, WIDTH))
    singles = [(rgb[i:i + 1].contiguous(), depth[i:i + 1].contiguous())
               for i in range(BATCH)]
    per_stage = capacity_schedule(m16, [(rgb, depth)], BATCH)
    requests = [("dense", "dense", (rgb, depth), {}),
                ("batchmax", "batchmax", (rgb, depth), {}),
                ("compact", "compact", (rgb, depth), {}),
                ("compact per-stage", "compact", (rgb, depth),
                 {"caps": per_stage}),
                *((f"switch #{i}", "switch", one, {})
                  for i, one in enumerate(singles))]
    for _, mode, images, kw in requests:  # warm-up, not counted
        for m in (m16, m32):
            serve(m, *images, mode=mode, **kw)
        serve(m16, *images, mode="dense", use_kernels=False)
    torch.cuda.synchronize()

    # the bf16 path's run: counts at 0 just before, read just after
    reset_launches()
    served = []
    for label, mode, images, kw in requests:
        before = dict(LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        class_map, weight = serve(m16, *images, mode=mode, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        delta = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                 if v - before.get(k, 0)}
        paths = weight.argmax(1).tolist()
        ran = [True] * 4 if mode == "dense" else stages_run(mode, paths, kw)
        expected = path_launches(ran, False, bf16=True)
        if delta != expected:
            raise RuntimeError(f"bf16 {label}: launches {delta} != {expected}")
        served.append((class_map, weight, ms, ran))
    launches = dict(LAUNCHES)
    print(f"  capacity_schedule (bf16 gate) {per_stage}; every request's "
          "launches those of its paths", flush=True)

    methods = {"dense": "forward", "batchmax": "forward_switch_batched",
               "compact": "forward_routed_compact", "switch": "forward_switch"}
    rows = []
    for (label, mode, (r, d), kw), (class_map, weight, ms, ran) in zip(
            requests, served):
        with torch.inference_mode():
            logits = getattr(m16, methods[mode])(
                r, d, **({"hard": True} if mode == "dense" else kw))
            dense, w_d = m16(r, d, hard=True, return_weight=True)
            plain, w_p = m16(r, d, hard=True, return_weight=True,
                             use_kernels=False)
            ref, w32 = m32(r, d, hard=True, return_weight=True)
        routed_err = (logits.float() - dense.float()).abs().max().item()
        routed_rel = routed_err / dense.float().abs().max().item()
        plain_err = (dense.float() - plain.float()).abs().max().item()
        plain_rel = plain_err / plain.float().abs().max().item()
        sure = _sure_pixels(plain, plain_err)
        sure_same = bool((class_map == first_argmax(plain))[sure].all())
        drift = ((dense.float() - ref).abs().max() / ref.abs().max()).item()
        agree32 = (class_map == first_argmax(ref)).float().mean().item()
        same_gate = (torch.equal(weight, w_d) and torch.equal(w_d, w_p)
                     and torch.equal(w_d, w32))
        ok_out = (logits.dtype == torch.bfloat16 and logits.shape == (
            r.shape[0], HEIGHT, WIDTH, CLASSES) and bool(
                torch.isfinite(logits).all()))
        row = {"request": label, "mode": mode, "batch": r.shape[0],
               "paths": weight.argmax(1).tolist(), "depth_stages_run": ran,
               "ms": ms, "routed_vs_dense_max_abs_err": routed_err,
               "routed_vs_dense_rel_err": routed_rel,
               "kernels_vs_plain_max_abs_err": plain_err,
               "kernels_vs_plain_rel_err": plain_rel,
               "sure_pixel_share": sure.float().mean().item(),
               "sure_pixels_equal": sure_same, "fp32_drift": drift,
               "fp32_class_map_agreement": agree32, "same_gate": same_gate,
               "launches": path_launches(ran, False, bf16=True)}
        rows.append(row)
        print(f"  {label:17s} B={r.shape[0]} paths {row['paths']}: {ms:.2f} "
              f"ms; routed vs dense max abs err {routed_err:.3g}; kernels vs "
              f"plain {plain_rel:.3g} of max |plain|, class maps equal on the "
              f"{row['sure_pixel_share'] * 100:.4f} % of pixels with margin > "
              f"2x{plain_err:.3g}: {sure_same}; vs fp32: drift {drift:.3g} of "
              f"max |fp32|, class maps agree on {agree32 * 100:.4f} %, gate "
              f"choices identical (bf16, plain, fp32): {same_gate}",
              flush=True)
        if (not ok_out or not same_gate or routed_rel > BF16_ROUTED_TOL
                or plain_rel > BF16_PLAIN_TOL or not sure_same
                or drift >= BF16_DRIFT_TOL):
            raise RuntimeError(f"bf16 {label}: disagreement")

    # request ms, fp32 and bf16 in turns, B=8 and B=1
    timed = [("dense", "dense", (rgb, depth)),
             ("batchmax", "batchmax", (rgb, depth)),
             ("compact", "compact", (rgb, depth)),
             ("dense", "dense", singles[0]),
             ("batchmax", "batchmax", singles[0]),
             ("switch", "switch", singles[0])]
    times = []
    for label, mode, images in timed:
        got = {"fp32": [], "bf16": []}
        for rep in range(TIMED_REPS):
            for name in ("fp32", "bf16") if rep % 2 == 0 else ("bf16", "fp32"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                serve(models[name], *images, mode=mode)
                torch.cuda.synchronize()
                got[name].append((time.perf_counter() - t0) * 1e3)
        med = {k: sorted(v)[len(v) // 2] for k, v in got.items()}
        times.append({"mode": mode, "batch": images[0].shape[0],
                      "fp32_ms": med["fp32"], "bf16_ms": med["bf16"],
                      "fp32_all": got["fp32"], "bf16_all": got["bf16"]})
        print(f"  {label:8s} B={images[0].shape[0]}: fp32 {med['fp32']:.2f} "
              f"ms, bf16 {med['bf16']:.2f} ms (median of {TIMED_REPS}, in "
              f"turns) [{card}]", flush=True)
    del m32

    # cli.eval and cli.predict --dtype bfloat16 on phase 8's layout
    root = ROOT / "build" / "chip_smoke_bf16"
    shutil.rmtree(root, ignore_errors=True)
    clis = {}
    try:
        _write_layout(root)
        v = flax_from_state_dict(m16.state_dict())
        ckpt = str(root / "flagship.msgpack")
        save_checkpoint(ckpt, {"params": v["params"], "model_state": {
            "batch_stats": v["batch_stats"]}}, epoch=0)
        ds = NYUv2Dataset(str(root), "test")
        pre = SegPreprocessor(ds.depth_mean, ds.depth_std, HEIGHT, WIDTH,
                              phase="test")
        with torch.inference_mode():
            paths = [m16.gate_only(torch.from_numpy(b["image"]).cuda(),
                                   torch.from_numpy(b["depth"]).cuda())
                     .argmax(1).tolist()
                     for b in SegLoader(ds, pre, batch_size=BATCH,
                                        prefetch=0)]
        base = ["--dataset", "nyuv2", "--dataset_dir", str(root), "--height",
                str(HEIGHT), "--width", str(WIDTH), "--batch_size",
                str(BATCH), "--ckpt_path", ckpt]
        hard = [*base, "--dynamic", "--global-gate", "--hard"]
        runs = [("eval", eval_cli.main, [*hard, "--dtype", "bfloat16"],
                 _add({}, path_launches([True] * 4, False, bf16=True),
                      len(paths))),
                ("predict", predict_cli.main,
                 [*base, "--dtype", "bfloat16", "--out_dir",
                  str(root / "pred")], {})]
        for p in paths:
            _add(runs[1][3], path_launches(stages_run("batchmax", p, {}),
                                           False, bf16=True))
        for label, fn, argv, expected in runs:
            reset_launches()
            t0 = time.perf_counter()
            res, lines = _cli_run(fn, argv)
            wall = time.perf_counter() - t0
            got = {k: v for k, v in LAUNCHES.items() if v}
            if got != expected:
                raise RuntimeError(f"{label} --dtype bfloat16: launches {got} "
                                   f"!= {expected}")
            _add(launches, got)
            clis[label] = {"wall_s": wall, "launches": got, "lines": [
                ln for ln in lines if ln.startswith(("Run", "  branch",
                                                     "path", "model"))]}
            if label == "eval":
                clis[label]["miou"] = res.tolist()
            else:
                clis[label].update(n=res["n"], fps=res["fps"])
                if res["n"] != CLI_SAMPLES:
                    raise RuntimeError("predict --dtype bfloat16 wrote "
                                       f"{res['n']} maps")
        res32, _ = _cli_run(eval_cli.main, hard)
        clis["eval"]["miou_fp32"] = res32.tolist()
        print(f"  cli.eval --dtype bfloat16: mIoU {clis['eval']['miou']} "
              f"(fp32 {clis['eval']['miou_fp32']}), {clis['eval']['wall_s']:.2f}"
              f" s; cli.predict --dtype bfloat16: {clis['predict']['n']} maps, "
              f"{clis['predict']['fps']:.2f} frames/s; launches those of the "
              f"samples' paths (paths {sum(paths, [])}) [{card}]", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    report["bf16"] = {"requests": rows, "request_ms": times, "clis": clis}
    return launches


# the 480×640 flagship's quantized convs: JAX's quant collection of the same
# net has 177 in_scale leaves (jax.eval_shape of its init)
INT8_CONVS_FLAGSHIP = 177
# make_recipe_eval_batch seeds of the calibration batches (the JAX bench's)
INT8_CALIB_SEEDS = (4321, 4322)
# a routed int8 request vs the dense forward, of max |dense|; 0 expected
INT8_ROUTED_TOL = {"int8": 1e-3, "int8-bf16": 8e-3}
# int8 kernel path vs int8 plain path, max abs err of the logits over max
# |plain|, with each quantized conv of the plain forward fed the input it got
# in the kernel forward (``_replayed_plain``): the float cells round apart by
# ~1e-6 in fp32, and without the replay inputs within that of a rounding
# boundary quantize one step apart and the flips cascade through later
# convs (printed as the upper reading, not held: it is about the int8 error
# itself). bf16: the kernels' bf16 forms, within the bound asked of the
# int8 phase (tighter than phase 12's BF16_PLAIN_TOL)
INT8_PLAIN_TOL = {"int8": 1e-5, "int8-bf16": 1e-2}
# against the fp32 net: the JAX package's bounds (tests/test_quantize.py)
INT8_FP32_L2_TOL, INT8_FP32_AGREE = 0.12, 0.85
# one conv of each shape class of the quantized nets (the flagship's, and
# BasicBlock's 3×3/2 on a stand-alone conv)
INT8_CONV_CLASSES = {
    "3x1": "encoder_rgb.layer1.1.conv3x1_1",
    "1x3": "encoder_rgb.layer1.1.conv1x3_1",
    "3x1/2": "encoder_rgb.layer2.0.conv3x1_1",
    "1x3/2": "encoder_rgb.layer2.0.conv1x3_1",
    "1x1/2": "encoder_rgb.layer2.0.downsample.0",
    "1x1": "skip_layer1.0.conv",
    "3x3": "decoder.decoder_module_1.conv3x3.conv",
    "conv_out": "decoder.conv_out",
}


def int8_launches(ran: list[bool], low_res: bool, bf16: bool = False) -> dict:
    """Kernel launches of one int8 flagship forward whose depth stages ran
    as ``ran`` says: no NBt1D launch (its convs are quantized), the fp32 or
    bf16 forms of the other kernels (``path_launches``)."""
    if bf16:
        return path_launches(ran, low_res, bf16=True)
    return {k: v for k, v in path_launches(ran, low_res, ()).items()
            if not k.startswith("nbt1d")}


def int8_conv_count(model, ran: list[bool]) -> int:
    """Quantized convs one forward runs: all but the depth encoder's, plus
    those of the depth stages that ran."""
    from dynmm_tpu_torch.utils.quantize import quant_convs

    names = [n for n, _ in quant_convs(model)]
    depth = [sum(n.startswith(f"encoder_depth.layer{i}.") for n in names)
             for i in range(1, 5)]
    return len(names) - sum(depth) + sum(d for d, r in zip(depth, ran) if r)


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def _replayed_plain(model, rgb, depth, low_res: bool):
    """((logits, weight) of the kernel forward, (logits, weight) of the plain
    forward with each quantized conv fed the input it got in the kernel
    forward): dense, hard gate. The two then differ by the float cells
    between the convs only, and not by the rounding flips at quantization
    boundaries that cascade through later convs."""
    from collections import defaultdict, deque

    from dynmm_tpu_torch.utils.quantize import quant_convs

    seen = defaultdict(deque)
    convs = [c for _, c in quant_convs(model)]
    kw = dict(hard=True, return_weight=True, low_res=low_res)
    for use_kernels, hook in (
            (True, lambda m, args: seen[m].append(args[0])),
            (False, lambda m, args: (seen[m].popleft(),))):
        hooks = [c.register_forward_pre_hook(hook) for c in convs]
        try:
            out = model(rgb, depth, use_kernels=use_kernels, **kw)
        finally:
            for h in hooks:
                h.remove()
        if use_kernels:
            kernel = out
    if any(seen.values()):
        raise RuntimeError("the plain forward ran fewer quantized convs than "
                           "the kernel forward")
    return kernel, out


def _int8_conv_classes(model, fp32_model, rgb, depth, card: str) -> list:
    """Each ``INT8_CONV_CLASSES`` conv on the input it gets in a dense B=8
    forward (and a stand-alone 3×3/2 BasicBlock conv on a seeded map):
    ``conv_int8``'s int32 sums against a float64 conv of the same int8
    operands (equal), the int8 conv's time beside the fp32 cuDNN conv's."""
    import torch.nn.functional as F

    from dynmm_tpu_torch.nn.layers import Conv2d
    from dynmm_tpu_torch.nn.quant import conv_int8, quantize_symmetric
    from dynmm_tpu_torch.utils.device import time_ms
    from dynmm_tpu_torch.utils.quantize import pack_int8

    inputs = {}
    hooks = [model.get_submodule(n).register_forward_pre_hook(
        lambda m, args, n=n: inputs.__setitem__(n, args[0]))
        for n in INT8_CONV_CLASSES.values()]
    with torch.inference_mode():
        model(rgb, depth, hard=True)
    for h in hooks:
        h.remove()
    g = torch.Generator(device="cuda").manual_seed(5)
    s2 = Conv2d(64, 128, 3, stride=2, padding=1, bias=False,
                quant="int8").cuda()
    s2_f = Conv2d(64, 128, 3, stride=2, padding=1, bias=False).cuda().eval()
    with torch.no_grad():
        s2.weight.normal_(0, 0.05, generator=g)
        s2_f.weight.copy_(s2.weight)
    x2 = torch.randn(BATCH, 64, HEIGHT // 4, WIDTH // 4, generator=g,
                     device="cuda").to(memory_format=torch.channels_last)
    s2.in_scale.fill_(x2.abs().max().item() / 127.0)
    pack_int8(s2.eval())
    cases = [(k, model.get_submodule(n), fp32_model.get_submodule(n),
              inputs[n]) for k, n in INT8_CONV_CLASSES.items()]
    cases.append(("3x3/2", s2, s2_f, x2))
    rows = []
    for label, conv, conv_f, x in cases:
        with torch.inference_mode():
            x_q = quantize_symmetric(x, conv.in_scale.clamp_min(1e-12))
            acc = conv_int8(x_q, conv.weight_q, conv.stride, conv.padding,
                            conv.dilation)
            ref = F.conv2d(x_q.double(), conv.weight_q.double(),
                           stride=conv.stride, padding=conv.padding,
                           dilation=conv.dilation)
            equal = torch.equal(acc.double(), ref)
            ms = time_ms(lambda: conv(x))
            ms_f = time_ms(lambda: conv_f(x.float()))
        rows.append({"conv": label, "x": list(x.shape),
                     "weight": list(conv.weight.shape), "sums_equal": equal,
                     "max_abs_sum": ref.abs().max().item(), "int8_ms": ms,
                     "fp32_cudnn_ms": ms_f})
        print(f"  {label:8s} x {tuple(x.shape)} w {tuple(conv.weight.shape)}:"
              f" int32 sums vs float64 equal {equal} (max |sum| "
              f"{ref.abs().max().item():.0f}); int8 {ms:.3f} ms, fp32 cuDNN "
              f"{ms_f:.3f} ms [{card}]", flush=True)
        if not equal:
            raise RuntimeError(f"int8 conv {label}: sums differ from float64")
    return rows


def check_int8(report: dict) -> dict:
    """Phase 13: the int8 flagship (480×640, recipe gate), fp32 and bf16
    compute, calibrated on the JAX bench's feed and packed, served in every
    mode and through ``cli.eval`` / ``cli.predict --quant int8``, held
    against its dense forward, its plain versions and the fp32 net."""
    import shutil

    import numpy as np

    from dynmm_tpu_torch.cli import eval as eval_cli
    from dynmm_tpu_torch.cli import predict as predict_cli
    from dynmm_tpu_torch.data import png
    from dynmm_tpu_torch.data.nyuv2 import (NYUv2Dataset, class_colors,
                                            make_recipe_eval_batch)
    from dynmm_tpu_torch.data.seg_preprocessing import (SegLoader,
                                                        SegPreprocessor,
                                                        pack_stem_batch)
    from dynmm_tpu_torch.kernels import LAUNCHES, reset_launches
    from dynmm_tpu_torch.nn.layers import first_argmax
    from dynmm_tpu_torch.nn.quant import INT8_CONVS
    from dynmm_tpu_torch.serve import build_flagship, serve
    from dynmm_tpu_torch.train.seg import SegTrainer
    from dynmm_tpu_torch.utils.checkpoint import save_checkpoint
    from dynmm_tpu_torch.utils.device import card_line
    from dynmm_tpu_torch.utils.quantize import (calibrate, pack_int8,
                                                quant_convs, quant_sanity,
                                                quantize_int8)
    from dynmm_tpu_torch.utils.weights import (flax_from_state_dict,
                                               load_recipe_gate)

    card = card_line()
    bf16 = torch.bfloat16
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    calib = [tuple(map(cuda, make_recipe_eval_batch(BATCH, HEIGHT, WIDTH,
                                                    seed=s)))
             for s in INT8_CALIB_SEEDS]
    raw = make_recipe_eval_batch(BATCH, HEIGHT, WIDTH)
    rgb, depth = map(cuda, raw)
    packed = pack_stem_batch({"image": raw[0], "depth": raw[1]})
    prgb, pdepth = cuda(packed["image"]), cuda(packed["depth"])
    models = {}
    for name, dtype, quant in (("fp32", None, None), ("bf16", bf16, None),
                               ("int8", None, "int8"),
                               ("int8-bf16", bf16, "int8")):
        models[name] = build_flagship(HEIGHT, WIDTH, CLASSES, seed=0,
                                      dtype=dtype, quant=quant)
        load_recipe_gate(models[name])

    # calibrate (fp32, the JAX bench's two batches), then pack; the packed
    # forward against the in-graph one
    section: dict = {"calibration": {}}
    for name in ("int8", "int8-bf16"):
        m = models[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        calibrate(m, calib, hard=True)
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - t0
        n = quant_sanity(m)
        with torch.inference_mode():
            in_graph = m(rgb, depth, hard=True)
            pack_int8(m)
            packed_out = m(rgb, depth, hard=True)
        packed_err = (packed_out.float() - in_graph.float()).abs().max().item()
        section["calibration"][name] = {"seconds": calib_s, "quant_sanity": n,
                                        "packed_vs_in_graph": packed_err}
        print(f"  {name}: calibrated {n} convs (quant_sanity; the model has "
              f"{len(quant_convs(m))}) on {len(calib)} batches of {BATCH} in "
              f"{calib_s:.2f} s; packed vs in-graph logits max abs err "
              f"{packed_err:.3g}", flush=True)
        if not n == len(quant_convs(m)) == INT8_CONVS_FLAGSHIP or packed_err:
            raise RuntimeError(f"{name}: calibration or packing failed")
    section["convs"] = _int8_conv_classes(models["int8"], models["fp32"], rgb,
                                          depth, card)

    singles = [(rgb[i:i + 1].contiguous(), depth[i:i + 1].contiguous())
               for i in range(BATCH)]
    requests = [("dense", "dense", (rgb, depth), {}),
                ("batchmax", "batchmax", (rgb, depth), {}),
                ("compact", "compact", (rgb, depth), {}),
                ("low_res", "batchmax", (rgb, depth), {"low_res": True}),
                ("packed stem", "dense", (prgb, pdepth), {}),
                *((f"switch #{i}", "switch", one, {})
                  for i, one in enumerate(singles))]
    for name in ("int8", "int8-bf16"):  # warm-up, not counted
        for _, mode, images, kw in requests:
            serve(models[name], *images, mode=mode, **kw)
    torch.cuda.synchronize()

    # the int8 path's run: counts at 0 just before, read just after
    reset_launches()
    INT8_CONVS.clear()
    served = []
    for name in ("int8", "int8-bf16"):
        m = models[name]
        for label, mode, images, kw in requests:
            before, c0 = dict(LAUNCHES), INT8_CONVS["cuda"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            class_map, weight = serve(m, *images, mode=mode, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            delta = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                     if v - before.get(k, 0)}
            n_int8 = INT8_CONVS["cuda"] - c0
            paths = weight.argmax(1).tolist()
            ran = ([True] * 4 if mode == "dense"
                   else stages_run(mode, paths, {}))
            low = kw.get("low_res", False)
            expected = int8_launches(ran, low, bf16=name == "int8-bf16")
            if delta != expected or n_int8 != int8_conv_count(m, ran):
                raise RuntimeError(
                    f"{name} {label}: launches {delta}, {n_int8} int8 convs; "
                    f"expected {expected}, {int8_conv_count(m, ran)}")
            served.append((name, label, mode, images, kw, class_map, weight,
                           ms, ran, n_int8))
    launches = dict(LAUNCHES)
    print(f"  every request's launches those of its paths, no NBt1D launch; "
          f"its int8 convs those of its paths ({INT8_CONVS['cuda']} in all)",
          flush=True)

    methods = {"dense": "forward", "batchmax": "forward_switch_batched",
               "compact": "forward_routed_compact", "switch": "forward_switch"}
    refs: dict = {}
    rows = []
    for (name, label, mode, (r, d), kw, class_map, weight, ms, ran,
         n_int8) in served:
        m = models[name]
        low = kw.get("low_res", False)
        with torch.inference_mode():
            logits = getattr(m, methods[mode])(
                r, d, low_res=low, **({"hard": True} if mode == "dense"
                                      else {}))
            key = (name, r.data_ptr(), r.shape[0], low)
            if key not in refs:
                refs[key] = (*_replayed_plain(m, r, d, low),
                             m(r, d, hard=True, return_weight=True,
                               low_res=low, use_kernels=False),
                             models["fp32"](r, d, hard=True,
                                            return_weight=True, low_res=low))
            (dense, w_d), (plain, w_p), (cascade, w_c), (ref, w32) = refs[key]
        routed_rel = ((logits.float() - dense.float()).abs().max()
                      / dense.float().abs().max()).item()
        plain_err = (dense.float() - plain.float()).abs().max().item()
        plain_rel = plain_err / plain.float().abs().max().item()
        cascade_rel = ((dense.float() - cascade.float()).abs().max()
                       / cascade.float().abs().max()).item()
        cascade_l2 = _rel_l2(dense, cascade)
        sure = _sure_pixels(plain, plain_err)
        sure_same = bool((first_argmax(dense) == first_argmax(plain))[sure]
                         .all())
        l2_32 = _rel_l2(dense, ref)
        agree32 = (first_argmax(dense) == first_argmax(ref)).float().mean(
            ).item()
        same_gate = (torch.equal(weight, w_d) and torch.equal(w_d, w_p)
                     and torch.equal(w_d, w_c) and torch.equal(w_d, w32))
        out_dtype = bf16 if name == "int8-bf16" else torch.float32
        hw = (HEIGHT // 4, WIDTH // 4) if low else (HEIGHT, WIDTH)
        ok_out = (logits.dtype == out_dtype
                  and logits.shape == (r.shape[0], *hw, CLASSES)
                  and bool(torch.isfinite(logits).all()))
        row = {"net": name, "request": label, "mode": mode,
               "batch": r.shape[0], "paths": weight.argmax(1).tolist(),
               "depth_stages_run": ran, "int8_convs": n_int8, "ms": ms,
               "routed_vs_dense_rel_err": routed_rel,
               "kernels_vs_plain_max_abs_err": plain_err,
               "kernels_vs_plain_rel_err": plain_rel,
               "kernels_vs_plain_cascade_rel_err": cascade_rel,
               "kernels_vs_plain_cascade_rel_l2": cascade_l2,
               "sure_pixel_share": sure.float().mean().item(),
               "sure_pixels_equal": sure_same, "fp32_rel_l2": l2_32,
               "fp32_class_map_agreement": agree32, "same_gate": same_gate}
        rows.append(row)
        print(f"  {name:9s} {label:11s} B={r.shape[0]} paths {row['paths']}:"
              f" {ms:.2f} ms, {n_int8} int8 convs; routed vs dense "
              f"{routed_rel:.3g} of max |dense|; kernels vs plain (conv "
              f"inputs replayed) max abs err {plain_err:.3g} ({plain_rel:.3g} "
              f"of max |plain|; without the replay {cascade_rel:.3g}, rel L2 "
              f"{cascade_l2:.3g}), class maps equal on the "
              f"{row['sure_pixel_share'] * 100:.2f} % of pixels with margin > "
              f"2x{plain_err:.3g}: {sure_same}; vs fp32: rel L2 {l2_32:.4f}, "
              f"class maps agree on {agree32 * 100:.2f} %; gate choices "
              f"identical (int8, plain, fp32): {same_gate}", flush=True)
        if (not ok_out or not same_gate
                or routed_rel > INT8_ROUTED_TOL[name]
                or plain_rel > INT8_PLAIN_TOL[name] or not sure_same
                or l2_32 >= INT8_FP32_L2_TOL or agree32 <= INT8_FP32_AGREE):
            raise RuntimeError(f"{name} {label}: disagreement")
    del refs

    # request ms, the four nets in turns, B=8 and B=1
    timed = [("dense", (rgb, depth)), ("batchmax", (rgb, depth)),
             ("dense", singles[0]), ("switch", singles[0])]
    names = ("fp32", "bf16", "int8", "int8-bf16")
    times = []
    for mode, images in timed:
        got = {k: [] for k in names}
        for rep in range(TIMED_REPS):
            for name in names[rep % 4:] + names[:rep % 4]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                serve(models[name], *images, mode=mode)
                torch.cuda.synchronize()
                got[name].append((time.perf_counter() - t0) * 1e3)
        med = {k: sorted(v)[len(v) // 2] for k, v in got.items()}
        times.append({"mode": mode, "batch": images[0].shape[0],
                      **{f"{k}_ms": v for k, v in med.items()},
                      **{f"{k}_all": v for k, v in got.items()}})
        print(f"  {mode:8s} B={images[0].shape[0]}: "
              + ", ".join(f"{k} {med[k]:.2f} ms" for k in names)
              + f" (median of {TIMED_REPS}, in turns) [{card}]", flush=True)
    for name in ("bf16", "int8", "int8-bf16"):
        del models[name]

    # cli.eval and cli.predict --quant int8 on phase 8's layout
    root = ROOT / "build" / "chip_smoke_int8"
    shutil.rmtree(root, ignore_errors=True)
    clis: dict = {}
    # the CLIs' calibration seconds (calibrate, select, pack): eval's
    # SegTrainer.calibrate_quant, predict's quantize_int8, each timed to a
    # synchronize
    calib_times: list = []
    originals = (SegTrainer.calibrate_quant, predict_cli.quantize_int8)

    def timed(fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            calib_times.append(time.perf_counter() - t0)
            return out
        return run

    SegTrainer.calibrate_quant = timed(originals[0])
    predict_cli.quantize_int8 = timed(originals[1])
    try:
        _write_layout(root)
        m32 = models.pop("fp32")
        v = flax_from_state_dict(m32.state_dict())
        ckpt = str(root / "flagship.msgpack")
        save_checkpoint(ckpt, {"params": v["params"], "model_state": {
            "batch_stats": v["batch_stats"]}}, epoch=0)
        ds = NYUv2Dataset(str(root), "test")
        pre = SegPreprocessor(ds.depth_mean, ds.depth_std, HEIGHT, WIDTH,
                              phase="test")
        batches = []
        for b in SegLoader(ds, pre, batch_size=BATCH, prefetch=0):
            p = pack_stem_batch(b)
            batches.append({k: cuda(x) for k, x in (
                ("rgb", b["image"]), ("depth", b["depth"]),
                ("prgb", p["image"]), ("pdepth", p["depth"]))})
        # the CLIs' nets: calibrated on their loaders' batches (all of them:
        # --calib_batches 8 ≥ 2), raw or packed, then packed
        refs = {}
        for name, dtype, keys in (("int8", None, ("rgb", "depth")),
                                  ("int8-bf16", bf16, ("prgb", "pdepth"))):
            m = build_flagship(HEIGHT, WIDTH, CLASSES, seed=0, dtype=dtype,
                               quant="int8")
            load_recipe_gate(m)
            quantize_int8(m, [tuple(b[k] for k in keys) for b in batches],
                          hard=True)
            refs[name] = (m, keys)
        with torch.inference_mode():
            paths = {name: [m.gate_only(*(b[k] for k in keys)).argmax(1)
                            .tolist() for b in batches]
                     for name, (m, keys) in refs.items()}
        n_b = len(batches)
        calib_l = _add({}, int8_launches([True] * 4, False), n_b)
        dense = int8_launches([True] * 4, False)
        base = ["--dataset", "nyuv2", "--dataset_dir", str(root), "--height",
                str(HEIGHT), "--width", str(WIDTH), "--batch_size",
                str(BATCH), "--ckpt_path", ckpt]
        hard = [*base, "--dynamic", "--global-gate", "--hard"]
        pct = ["--calib_estimator", "percentile", "--calib_percentile", "99.9"]
        runs = [
            ("eval", eval_cli.main, [*hard, "--quant", "int8"],
             _add(dict(calib_l), dense, n_b), None),
            ("eval p99.9", eval_cli.main, [*hard, "--quant", "int8", *pct],
             _add(dict(calib_l), dense, n_b), None),
            ("predict", predict_cli.main, [*base, "--quant", "int8",
                                           "--out_dir", str(root / "p1")],
             None, ("int8", False)),
            ("predict bf16 quarter packed", predict_cli.main,
             [*base, "--quant", "int8", "--dtype", "bfloat16", "--output_res",
              "quarter", "--packed_stem", "--out_dir", str(root / "p2")],
             None, ("int8-bf16", True)),
        ]
        colors = class_colors(CLASSES + 1)
        for label, fn, argv, expected, pred in runs:
            if pred is not None:
                name, low = pred
                expected = dict(calib_l)
                for p in paths[name]:
                    _add(expected, int8_launches(
                        stages_run("batchmax", p, {}), low,
                        bf16=name == "int8-bf16"))
            reset_launches()
            t0 = time.perf_counter()
            res, lines = _cli_run(fn, argv)
            wall = time.perf_counter() - t0
            got = {k: v for k, v in LAUNCHES.items() if v}
            if got != expected:
                raise RuntimeError(f"{label} --quant int8: launches {got} != "
                                   f"{expected}")
            _add(launches, got)
            row = {"wall_s": wall, "calib_s": calib_times.pop(),
                   "launches": got, "lines": [
                ln for ln in lines if ln.startswith(("Calibrated", "Run",
                                                     "  branch", "path",
                                                     "model"))]}
            if pred is None:
                row["miou"] = res.tolist()
            else:
                m, keys = refs[name]
                maps = []
                for b in batches:
                    cm, _ = serve(m, *(b[k] for k in keys), mode="batchmax",
                                  low_res=low)
                    maps.extend(cm.cpu().numpy())
                err = max(int(np.abs(png.read(str(Path(argv[-1]) /
                                                  f"pred_{i:05d}.png"))
                                     .astype(np.int32)
                                     - colors[maps[i] + 1]).max())
                          for i in range(res["n"]))
                row.update(n=res["n"], fps=res["fps"], png_max_abs_err=err)
                if err or res["n"] != CLI_SAMPLES:
                    raise RuntimeError(f"{label} --quant int8: written maps "
                                       "differ from serve()'s")
            clis[label] = row
            print(f"  cli.{label}: {row['lines']}, calibration "
                  f"{row['calib_s']:.2f} s, {wall:.2f} s in all [{card}]",
                  flush=True)
        res32, _ = _cli_run(eval_cli.main, hard)
        clis["eval"]["miou_fp32"] = res32.tolist()
        print(f"  cli.eval --quant int8: mIoU {clis['eval']['miou']} "
              f"(p99.9 {clis['eval p99.9']['miou']}; fp32 "
              f"{clis['eval']['miou_fp32']}); cli.predict --quant int8: "
              f"{clis['predict']['fps']:.2f} frames/s, bf16 quarter packed "
              f"{clis['predict bf16 quarter packed']['fps']:.2f} frames/s; "
              f"PNGs equal to serve()'s maps [{card}]", flush=True)
        del refs
    finally:
        SegTrainer.calibrate_quant, predict_cli.quantize_int8 = originals
        shutil.rmtree(root, ignore_errors=True)
    section.update(requests=rows, request_ms=times, clis=clis)
    report["int8"] = section
    return launches


EXPORT_REPS = 5  # requests timed per artifact, eager and replay in turns


def _nonzero(counter) -> dict:
    return {k: v for k, v in counter.items() if v}


def _in_turns(fns: dict, reps: int = EXPORT_REPS) -> dict:
    """Median host ms (ending in ``torch.cuda.synchronize``) of each of
    ``fns``, called in turns ``reps`` times after one warm-up round."""
    got = {k: [] for k in fns}
    for rep in range(reps + 1):
        for k in (list(fns) if rep % 2 else list(fns)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            if rep:
                got[k].append((time.perf_counter() - t0) * 1e3)
    return {k: sorted(v)[len(v) // 2] for k, v in got.items()}


def check_export(report: dict) -> dict:
    """Phase 14: the served forward as a ``torch.export`` artifact
    (``utils/serve_export.py``) of the recipe flagship in every form:
    exported, saved, reloaded from the file and replayed on the inputs of
    the eager forward; logits and gate weights equal with error 0, the
    replay's launches those of the eager forward (which are those its paths
    give), so the artifact runs the hand-written kernels through their
    ``dynmm::`` ops. The ``batchmax`` and int8 ``dense`` forms are the
    artifacts ``cli.predict --export_path`` writes on phase 8's layout (the
    module it exports held for the eager side), whose replays also write
    PNGs byte-equal to ``cli.predict``'s own; the other forms are exported
    in process. Returns the replays' launches."""
    import shutil

    import numpy as np

    from dynmm_tpu_torch.cli import predict as predict_cli
    from dynmm_tpu_torch.data import png
    from dynmm_tpu_torch.data.nyuv2 import (NYUv2Dataset, class_colors,
                                            make_recipe_eval_batch)
    from dynmm_tpu_torch.data.seg_preprocessing import (SegLoader,
                                                        SegPreprocessor)
    from dynmm_tpu_torch.kernels import LAUNCHES, reset_launches
    from dynmm_tpu_torch.nn.layers import first_argmax
    from dynmm_tpu_torch.nn.quant import INT8_CONVS
    from dynmm_tpu_torch.serve import (ServingForward, build_flagship,
                                       capacity_schedule)
    from dynmm_tpu_torch.utils.checkpoint import save_checkpoint
    from dynmm_tpu_torch.utils.device import card_line
    from dynmm_tpu_torch.utils.serve_export import (export_serving_fn,
                                                    load_serving_fn,
                                                    save_serving_artifact)
    from dynmm_tpu_torch.utils.weights import (flax_from_state_dict,
                                               load_recipe_gate)

    card = card_line()
    root = ROOT / "build" / "chip_smoke_export"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    rgb, depth = map(cuda, make_recipe_eval_batch(BATCH, HEIGHT, WIDTH))
    singles = [(rgb[i:i + 1].contiguous(), depth[i:i + 1].contiguous())
               for i in range(BATCH)]
    models = {}
    for net, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        models[net] = build_flagship(HEIGHT, WIDTH, CLASSES, seed=0,
                                     dtype=dtype)
        load_recipe_gate(models[net])
    caps = capacity_schedule(models["fp32"], [(rgb, depth)], BATCH)
    artifacts: dict = {}  # form: (module, fn, export s, load s, bytes)

    # cli.predict --export_path on phase 8's layout: the reloaded artifact
    # writes the PNGs cli.predict writes for the same checkpoint and mode
    clis = []
    real_export = predict_cli.export_serving_fn
    exported: dict = {}

    def held(module, *inputs, **kw):  # the CLI's export, its module held
        t0 = time.perf_counter()
        payload = real_export(module, *inputs, **kw)
        exported.update(module=module, export_s=time.perf_counter() - t0)
        return payload

    predict_cli.export_serving_fn = held
    try:
        _write_layout(root)
        v = flax_from_state_dict(models["fp32"].state_dict())
        ckpt = str(root / "flagship.msgpack")
        save_checkpoint(ckpt, {"params": v["params"],
                               "model_state": {"batch_stats":
                                               v["batch_stats"]}}, epoch=0)
        base = ["--dataset", "nyuv2", "--dataset_dir", str(root), "--height",
                str(HEIGHT), "--width", str(WIDTH), "--batch_size",
                str(BATCH), "--ckpt_path", ckpt]
        ds = NYUv2Dataset(str(root), "test")
        pre = SegPreprocessor(ds.depth_mean, ds.depth_std, HEIGHT, WIDTH,
                              phase="test")
        batch = next(iter(SegLoader(ds, pre, batch_size=BATCH, prefetch=0)))
        colors = class_colors(CLASSES + 1)
        for form, extra in (("batchmax", []),
                            ("int8 dense", ["--quant", "int8",
                                            "--serve_mode", "dense"])):
            out_dir = root / f"preds_{len(clis)}"
            _cli_run(predict_cli.main, [*base, *extra, "--num", str(BATCH),
                                        "--out_dir", str(out_dir)])
            art = root / f"cli_{len(clis)}.pt2"
            t0 = time.perf_counter()
            res, lines = _cli_run(predict_cli.main, [
                *base, *extra, "--export_path", str(art)])
            cli_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            fn = load_serving_fn(str(art))
            artifacts[form] = (exported.pop("module"), fn,
                               exported.pop("export_s"),
                               time.perf_counter() - t0, res["bytes"])
            logits, _ = fn(cuda(batch["image"]), cuda(batch["depth"]))
            maps = first_argmax(logits).cpu().numpy()
            equal = 0
            for i, img in enumerate(maps):
                mine = root / f"replay_{i:05d}.png"
                png.write(str(mine), colors[img + 1])
                equal += (mine.read_bytes()
                          == (out_dir / f"pred_{i:05d}.png").read_bytes())
            row = {"run": form, "cli_s": cli_s,
                   "export_s": artifacts[form][2],
                   "artifact_bytes": res["bytes"], "pngs_byte_equal": equal,
                   "pngs": len(maps)}
            clis.append(row)
            said = next(ln for ln in lines if ln.startswith("exported"))
            print(f"  cli.predict {' '.join(extra) or '(batchmax)'} "
                  f"--export_path: {cli_s:.2f} s (export {row['export_s']:.2f}"
                  f" s), {res['bytes']} bytes; the replay's PNGs byte-equal "
                  f"to the CLI's: {equal} of {len(maps)} [{said}]",
                  flush=True)
            if equal != len(maps):
                raise RuntimeError(f"export CLI {form}: {row}")
    finally:
        predict_cli.export_serving_fn = real_export

    forms = [  # (name, net, serving options, requests)
        ("dense", "fp32", {"mode": "dense"}, [(rgb, depth)]),
        ("batchmax", "fp32", {"mode": "batchmax"}, [(rgb, depth)]),
        ("compact", "fp32", {"mode": "compact"}, [(rgb, depth)]),
        ("compact schedule", "fp32", {"mode": "compact", "caps": caps},
         [(rgb, depth)]),
        ("switch", "fp32", {"mode": "switch"}, singles),
        ("low_res", "fp32", {"mode": "dense", "low_res": True},
         [(rgb, depth)]),
        ("bf16 dense", "bf16", {"mode": "dense"}, [(rgb, depth)]),
        ("int8 dense", "int8", {"mode": "dense"}, [(rgb, depth)]),
    ]
    total: dict = {}
    rows = []
    for name, net, opts, requests in forms:
        by = "cli.predict" if name in artifacts else "in process"
        if name not in artifacts:
            module = ServingForward(models[net], **opts)
            path = root / f"{name.replace(' ', '_')}.pt2"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            payload = export_serving_fn(module, *requests[0])
            export_s = time.perf_counter() - t0
            save_serving_artifact(str(path), payload)
            t0 = time.perf_counter()
            fn = load_serving_fn(str(path))
            artifacts[name] = (module, fn, export_s,
                               time.perf_counter() - t0, len(payload))
            del payload
        module, fn, export_s, load_s, nbytes = artifacts.pop(name)
        program_convs = sum(1 for n in fn.program.graph.nodes
                            if str(n.target) == "aten._int_mm.default")
        paths = []
        for images in requests:
            reset_launches()
            convs = INT8_CONVS["cuda"]
            with torch.inference_mode():
                want = module(*images)
            torch.cuda.synchronize()
            eager = _nonzero(LAUNCHES)
            convs = INT8_CONVS["cuda"] - convs
            reset_launches()
            got = fn(*images)
            torch.cuda.synchronize()
            replay = _nonzero(LAUNCHES)
            _add(total, replay)
            req_paths = want[1].argmax(1).tolist()
            paths += req_paths
            ran = ([True] * 4 if opts["mode"] == "dense" else
                   stages_run(opts["mode"], req_paths, opts))
            low_res = opts.get("low_res", False)
            expected = (int8_launches(ran, low_res) if net == "int8" else
                        path_launches(ran, low_res, bf16=net == "bf16"))
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            if not same or replay != eager or eager != expected:
                raise RuntimeError(
                    f"export {name}: artifact equal to eager {same}; launches "
                    f"replay {replay}, eager {eager}, expected {expected}")
            if net == "int8" and (convs != program_convs or convs
                                  != int8_conv_count(module.model, ran)):
                raise RuntimeError(f"export {name}: {program_convs} int8 "
                                   f"convs in the program, {convs} eager")
        r0 = requests[0]
        with torch.inference_mode():
            ms = _in_turns({"eager": lambda: module(*r0),
                            "artifact": lambda: fn(*r0)})
        row = {"form": name, "exported_by": by, "batch": r0[0].shape[0],
               "paths": paths, "export_s": export_s, "load_s": load_s,
               "artifact_bytes": nbytes, "eager_ms": ms["eager"],
               "artifact_ms": ms["artifact"],
               "launches_per_replay": replay, "int8_convs": program_convs}
        rows.append(row)
        print(f"  {name:16s} B={row['batch']} paths {paths}: exported "
              f"({by}) in {export_s:.2f} s, {nbytes} bytes, loaded in "
              f"{load_s:.2f} s; artifact = eager (error 0), launches "
              f"{replay}; request ms eager {ms['eager']:.2f}, artifact "
              f"{ms['artifact']:.2f} (median of {EXPORT_REPS}, in turns) "
              f"[{card}]", flush=True)
        del module, fn

    # one artifact for the card and the CPU, B=1: the CPU program runs the
    # plain versions; the class maps agree wherever the margin is sure
    module = ServingForward(models["fp32"], "dense")
    t0 = time.perf_counter()
    payload = export_serving_fn(module, *singles[0],
                                platforms=("cuda", "cpu"))
    export_s = time.perf_counter() - t0
    path = root / "dense_cuda_cpu.pt2"
    save_serving_artifact(str(path), payload)
    on_card = load_serving_fn(str(path))
    on_cpu = load_serving_fn(str(path), device="cpu")
    lk, wk = on_card(*singles[0])
    t0 = time.perf_counter()
    lc, wc = on_cpu(*(x.cpu() for x in singles[0]))
    cpu_s = time.perf_counter() - t0
    err = (lk.cpu() - lc).abs().max().item()
    sure = _sure_pixels(lc, err)
    sure_same = bool((first_argmax(lk).cpu() == first_argmax(lc))[sure].all())
    xplat = {"export_s": export_s, "artifact_bytes": len(payload),
             "platforms": list(on_card.platforms), "max_abs_err": err,
             "sure_pixel_share": sure.float().mean().item(),
             "sure_pixels_equal": sure_same, "cpu_replay_s": cpu_s,
             "same_gate": bool(torch.equal(wk.cpu(), wc))}
    shutil.rmtree(root, ignore_errors=True)
    print(f"  dense B=1 for cuda,cpu: exported in {export_s:.2f} s, "
          f"{len(payload)} bytes; the CPU replay ({cpu_s:.2f} s) against "
          f"the card's: max abs err {err:.3g}, class maps equal on the "
          f"{xplat['sure_pixel_share'] * 100:.4f} % of pixels with margin > "
          f"2x{err:.3g}: {sure_same}; gate choices identical: "
          f"{xplat['same_gate']}", flush=True)
    if not (sure_same and xplat["same_gate"]):
        raise RuntimeError(f"export cuda,cpu: the CPU replay disagrees "
                           f"{xplat}")
    report["export"] = {"forms": rows, "cuda_cpu": xplat, "clis": clis}
    return total


# the per-sample paths of phase 15's routed requests
ACT_PATHS = [0, 4, 2, 1, 3, 0, 1, 2]


def act_launches(low_res: bool = False, bf16: bool = False) -> dict:
    """Launches of one forward of a swish or hswish flagship, whatever its
    paths: the stem cell (``channel_sums``, ``stem_fuse_pool``) and the
    learned upsamples (3 at ``low_res``). The TPU kernels of the SE cell and
    the NBt1D block fuse relu, so these nets run those cells in PyTorch
    ops."""
    counts = {"channel_sums": 1, "stem_fuse_pool": 1,
              "learned_upsample": 3 if low_res else 5}
    return {f"{k}.bf16": v for k, v in counts.items()} if bf16 else counts


def check_activation(report: dict) -> dict:
    """Phase 15: the swish and hswish flagships (480×640, recipe gate):
    served in every mode with the launches of the routing rule, routed =
    dense (error 0), the kernel path against the plain one, the bf16 and
    int8 swish nets, ``cli.train`` / ``cli.eval`` / ``cli.predict
    --activation swish``, one export, and request ms beside relu's."""
    import shutil

    import numpy as np

    from dynmm_tpu_torch.cli import eval as eval_cli
    from dynmm_tpu_torch.cli import predict as predict_cli
    from dynmm_tpu_torch.cli import train as train_cli
    from dynmm_tpu_torch.data import png
    from dynmm_tpu_torch.data.nyuv2 import (NYUv2Dataset, class_colors,
                                            make_recipe_eval_batch)
    from dynmm_tpu_torch.data.seg_preprocessing import (SegLoader,
                                                        SegPreprocessor)
    from dynmm_tpu_torch.kernels import LAUNCHES, reset_launches
    from dynmm_tpu_torch.nn.layers import first_argmax, pack_weights
    from dynmm_tpu_torch.nn.quant import INT8_CONVS
    from dynmm_tpu_torch.serve import ServingForward, build_flagship, serve
    from dynmm_tpu_torch.utils.device import card_line
    from dynmm_tpu_torch.utils.quantize import (calibrate, pack_int8,
                                                quant_sanity)
    from dynmm_tpu_torch.utils.serve_export import (export_serving_fn,
                                                    load_serving_fn,
                                                    save_serving_artifact)
    from dynmm_tpu_torch.utils.torch_import import load_any_checkpoint
    from dynmm_tpu_torch.utils.weights import load_recipe_gate

    card = card_line()
    section: dict = {"card": card, "seconds": {}}
    clock = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        section["seconds"][name] = now - clock[0]
        clock[0] = now

    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    big = tuple(map(cuda, make_recipe_eval_batch(BATCH, HEIGHT, WIDTH)))
    one = tuple(x[:1].contiguous() for x in big)
    nets = {}
    for name, act, dtype, quant in (
            ("relu", "relu", None, None), ("swish", "swish", None, None),
            ("hswish", "hswish", None, None),
            ("swish-bf16", "swish", torch.bfloat16, None),
            ("swish-int8", "swish", None, "int8")):
        nets[name] = build_flagship(HEIGHT, WIDTH, CLASSES, seed=0,
                                    dtype=dtype, quant=quant, activation=act)
        load_recipe_gate(nets[name])
    calib = [tuple(map(cuda, make_recipe_eval_batch(BATCH, HEIGHT, WIDTH,
                                                    seed=s)))
             for s in INT8_CALIB_SEEDS]
    calibrate(nets["swish-int8"], calib, hard=True)
    n_quant = quant_sanity(nets["swish-int8"])
    pack_int8(nets["swish-int8"])
    torch.cuda.synchronize()
    lap("build and calibrate")
    print(f"  built the relu, swish, hswish, swish-bf16 and swish-int8 "
          f"flagships; the int8 net calibrated {n_quant} convs "
          f"(quant_sanity) [{section['seconds']['build and calibrate']:.1f}"
          f" s]", flush=True)
    if n_quant != INT8_CONVS_FLAGSHIP:
        raise RuntimeError(f"swish-int8: quant_sanity {n_quant} != "
                           f"{INT8_CONVS_FLAGSHIP}, the relu net's")

    # serve: (label, net, mode, paths (None: the live gate), images, kwargs)
    gates = {n: PathGate(nets[n]) for n in ("swish", "hswish")}
    requests = [
        ("dense", "swish", "dense", None, big, {}),
        ("dense B=1", "swish", "dense", None, one, {}),
        ("batchmax", "swish", "batchmax", ACT_PATHS, big, {}),
        ("compact", "swish", "compact", ACT_PATHS, big, {}),
        *((f"switch k={k}", "swish", "switch", [k], one, {})
          for k in range(5)),
        ("low_res", "swish", "batchmax", ACT_PATHS, big, {"low_res": True}),
        ("dense", "hswish", "dense", None, big, {}),
        ("batchmax", "hswish", "batchmax", ACT_PATHS, big, {}),
    ]

    def run(req, mode=None, use_kernels=True):
        label, net, m, paths, images, kw = req
        gates[net].paths = paths
        return serve(nets[net], *images, mode=mode or m,
                     use_kernels=use_kernels, **kw)

    for req in requests:  # warm-up (cuDNN picks its algorithms)
        run(req)
        run(req, "dense")
    torch.cuda.synchronize()
    # the main path's run: counts at 0 just before, read just after
    reset_launches()
    served = []
    for req in requests:
        label, net, mode, paths, images, kw = req
        before = dict(LAUNCHES)
        class_map, weight = run(req)
        torch.cuda.synchronize()
        delta = {k: LAUNCHES[k] - before.get(k, 0) for k in LAUNCHES}
        delta = {k: v for k, v in delta.items() if v}
        expected = act_launches(kw.get("low_res", False))
        if delta != expected:
            raise RuntimeError(f"{net} {label}: launches {delta} != "
                               f"{expected}")
        served.append((class_map, weight))
    total = _nonzero(LAUNCHES)
    lap("serve")

    # routed against dense on the same paths: error 0
    methods = {"batchmax": "forward_switch_batched",
               "compact": "forward_routed_compact",
               "switch": "forward_switch"}
    rows = []
    for req, (class_map, weight) in zip(requests, served):
        label, net, mode, paths, (rgb, depth), kw = req
        model = nets[net]
        gates[net].paths = paths
        low_res = kw.get("low_res", False)
        with torch.inference_mode():
            dense = model(rgb, depth, hard=True, low_res=low_res)
            routed = (dense if mode == "dense" else
                      getattr(model, methods[mode])(rgb, depth, **kw))
        err = (routed - dense).abs().max().item()
        dense_map, dense_w = run(req, "dense")
        same = (bool(torch.equal(class_map, dense_map))
                and bool(torch.equal(weight, dense_w)))
        rows.append({"net": net, "request": label, "mode": mode,
                     "batch": rgb.shape[0], "paths": weight.argmax(1).tolist(),
                     "routed_vs_dense_max_abs_err": err,
                     "class_map_and_gate_equal": same,
                     "launches": act_launches(low_res)})
        print(f"  {net:6s} {label:10s} B={rgb.shape[0]} paths "
              f"{rows[-1]['paths']}: launches {act_launches(low_res)}; "
              f"routed vs dense max abs err {err:.3g}, class map and gate "
              f"equal: {same}", flush=True)
        if err != 0 or not same or not bool(torch.isfinite(routed).all()):
            raise RuntimeError(f"{net} {label}: routed != dense")
    section["served"] = rows
    lap("routed vs dense")

    # the kernel path against the plain one (live gate), fp32
    plain_rows = []
    for net, (rgb, depth) in (("swish", big), ("swish", one),
                              ("hswish", big)):
        gates[net].paths = None
        with torch.inference_mode():
            lk, wk = nets[net](rgb, depth, hard=True, return_weight=True)
            lp, wp = nets[net](rgb, depth, hard=True, return_weight=True,
                               use_kernels=False)
        rel = _rel(lk, lp)
        agree = (first_argmax(lk) == first_argmax(lp)).float().mean().item()
        same_gate = bool(torch.equal(wk, wp))
        plain_rows.append({"net": net, "batch": rgb.shape[0],
                           "paths": wk.argmax(1).tolist(),
                           "logits_rel_err": rel, "class_map_agreement": agree,
                           "same_gate": same_gate})
        print(f"  {net:6s} kernels vs plain B={rgb.shape[0]} paths "
              f"{wk.argmax(1).tolist()}: logits rel err {rel:.3g}, class "
              f"maps agree on {agree * 100:.4f} %, gate choices identical: "
              f"{same_gate}", flush=True)
        if rel > 1e-3 or agree < 0.999 or not same_gate:
            raise RuntimeError(f"{net}: kernel path disagrees with the plain "
                               "one")
    section["kernels_vs_plain"] = plain_rows
    for g in gates.values():
        g.paths = None

    # the bf16 and int8 swish nets, dense B=8, against their plain path
    # (bf16) and the fp32 swish net
    rgb, depth = big
    with torch.inference_mode():
        ref, w32 = nets["swish"](rgb, depth, hard=True, return_weight=True)
    low = {}
    for name, bf16 in (("swish-bf16", True), ("swish-int8", False)):
        model = nets[name]
        with torch.inference_mode():
            reset_launches()
            convs = INT8_CONVS["cuda"]
            out, w = model(rgb, depth, hard=True, return_weight=True)
            torch.cuda.synchronize()
            got = _nonzero(LAUNCHES)
            convs = INT8_CONVS["cuda"] - convs
            plain, wp = model(rgb, depth, hard=True, return_weight=True,
                              use_kernels=False)
        _add(total, got)
        row = {"launches": got, "paths": w.argmax(1).tolist(),
               "same_gate": bool(torch.equal(w, w32) and torch.equal(w, wp))}
        if bf16:
            err = (out.float() - plain.float()).abs().max().item()
            sure = _sure_pixels(plain, err)
            row.update(
                plain_rel_err=err / plain.float().abs().max().item(),
                sure_pixel_share=sure.float().mean().item(),
                sure_pixels_equal=bool((first_argmax(out) == first_argmax(
                    plain))[sure].all()),
                fp32_drift=_rel(out.float(), ref))
            ok = (row["plain_rel_err"] <= BF16_PLAIN_TOL
                  and row["sure_pixels_equal"]
                  and row["fp32_drift"] < BF16_DRIFT_TOL)
        else:
            row.update(int8_convs=convs, fp32_rel_l2=_rel_l2(out, ref),
                       fp32_class_map_agreement=(first_argmax(out)
                                                 == first_argmax(ref))
                       .float().mean().item())
            ok = (convs == INT8_CONVS_FLAGSHIP
                  and row["fp32_rel_l2"] < INT8_FP32_L2_TOL
                  and row["fp32_class_map_agreement"] > INT8_FP32_AGREE)
        ok = ok and got == act_launches(bf16=bf16) and row["same_gate"]
        low[name] = row
        print(f"  {name}: dense B={BATCH} paths {row['paths']}, "
              + ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else
                          f"{k} {v}" for k, v in row.items()
                          if k != "paths"), flush=True)
        if not ok:
            raise RuntimeError(f"{name}: {row}")
    section["low_precision"] = low
    lap("bf16 and int8")

    # cli.train (2 steps of B=8, synthetic), then cli.eval and cli.predict
    # --activation swish on its checkpoint, on phase 8's prepared layout
    root = ROOT / "build" / "chip_smoke_activation"
    shutil.rmtree(root, ignore_errors=True)
    probe = StepProbe()
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        _, lines = _cli_run(train_cli.main, [
            *_synthetic_argv(root / "train", HEIGHT, WIDTH), "--dynamic",
            "--global-gate", "--loss-ratio", "1e-4", "--activation",
            "swish"])
        peak = torch.cuda.max_memory_allocated()
        probe.check("swish cli.train", 2)
        got = _nonzero(LAUNCHES)
        _add(total, got)
        steps = probe.steps
        (ckpt,) = root.glob("train/synthetic/checkpoints_*/ckpt_latest.msgpack")
        relu = report.get("train")  # phase 6's fit of the relu flagship
        relu = ("phase 6 not run" if relu is None else
                f"{relu['step_ms_median']:.2f} ms, "
                f"{relu['peak_memory_bytes'] / 2 ** 30:.2f} GiB")
        print(f"  swish cli.train: steps {[round(s['ms'], 2) for s in steps]}"
              f" ms, losses {[round(s['loss'], 4) for s in steps]}; peak "
              f"memory {peak / 2 ** 30:.2f} GiB (relu, phase 6: {relu}); "
              f"validation launches {got} [{card}]", flush=True)
        for ln in lines:
            if ln.startswith(("Epoch", "Test mIoU")):
                print(f"    {ln}", flush=True)
        section["train"] = {"steps": steps, "peak_memory_bytes": peak,
                            "validation_launches": got}
        lap("cli.train")

        _write_layout(root)
        base = ["--dataset", "nyuv2", "--dataset_dir", str(root), "--height",
                str(HEIGHT), "--width", str(WIDTH), "--batch_size", str(BATCH),
                "--activation", "swish", "--ckpt_path", str(ckpt)]
        n_b = CLI_SAMPLES // BATCH
        reset_launches()
        miou, _ = _cli_run(eval_cli.main, [*base, "--dynamic",
                                           "--global-gate", "--hard"])
        got = _nonzero(LAUNCHES)
        _add(total, got)
        if got != _add({}, act_launches(), n_b) or not math.isfinite(
                float(miou[0])):
            raise RuntimeError(f"swish cli.eval: launches {got}, mIoU {miou}")
        out_dir = root / "preds"
        reset_launches()
        res, _ = _cli_run(predict_cli.main, [*base, "--out_dir",
                                             str(out_dir)])
        got_p = _nonzero(LAUNCHES)
        _add(total, got_p)
        # the written maps against serve()'s (batchmax) on the same weights
        model = build_flagship(HEIGHT, WIDTH, CLASSES, seed=0,
                               activation="swish")
        load_any_checkpoint(model, str(ckpt))
        pack_weights(model)
        ds = NYUv2Dataset(str(root), "test")
        pre = SegPreprocessor(ds.depth_mean, ds.depth_std, HEIGHT, WIDTH,
                              phase="test")
        colors = class_colors(CLASSES + 1)
        maps = []
        for b in SegLoader(ds, pre, batch_size=BATCH, prefetch=0):
            cm, _ = serve(model, cuda(b["image"]), cuda(b["depth"]))
            maps.extend(cm.cpu().numpy())
        err = max(int(np.abs(png.read(str(out_dir / f"pred_{i:05d}.png"))
                             .astype(np.int32) - colors[maps[i] + 1]).max())
                  for i in range(res["n"]))
        print(f"  swish cli.eval --hard: mIoU {miou.tolist()}, launches "
              f"{got}; cli.predict: {res['n']} maps, {res['fps']:.2f} "
              f"frames/s, launches {got_p}, PNGs vs serve() max abs err "
              f"{err} [{card}]", flush=True)
        section["clis"] = {"eval_miou": miou.tolist(), "eval_launches": got,
                           "predict_fps": res["fps"], "predict_n": res["n"],
                           "predict_launches": got_p, "png_max_abs_err": err}
        if (err != 0 or res["n"] != CLI_SAMPLES
                or got_p != _add({}, act_launches(), n_b)):
            raise RuntimeError(f"swish cli.predict: {section['clis']}")
        del model
        lap("cli.eval and cli.predict")

        # one dense B=8 export of the swish net, replayed
        del nets["swish"].gate_weights  # the PathGate: back to the live gate
        module = ServingForward(nets["swish"], "dense")
        t0 = time.perf_counter()
        payload = export_serving_fn(module, *big)
        export_s = time.perf_counter() - t0
        path = root / "swish_dense.pt2"
        save_serving_artifact(str(path), payload)
        fn = load_serving_fn(str(path))
        ops = {str(n.target).split(".")[1] for n in fn.program.graph.nodes
               if str(n.target).startswith("dynmm.")}
        reset_launches()
        with torch.inference_mode():
            want = module(*big)
        torch.cuda.synchronize()
        eager = _nonzero(LAUNCHES)
        reset_launches()
        got = fn(*big)
        torch.cuda.synchronize()
        replay = _nonzero(LAUNCHES)
        _add(total, replay)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        section["export"] = {"export_s": export_s, "bytes": len(payload),
                             "replay_equal": same, "launches": replay,
                             "dynmm_ops": sorted(ops)}
        print(f"  swish dense B={BATCH} exported in {export_s:.2f} s, "
              f"{len(payload)} bytes, dynmm ops {sorted(ops)}; replay = "
              f"eager: {same}, launches {replay} (eager {eager}) [{card}]",
              flush=True)
        if (not same or replay != eager or eager != act_launches()
                or ops != set(act_launches())):
            raise RuntimeError(f"swish export: {section['export']}")
        del payload, fn
    finally:
        probe.close()
        shutil.rmtree(root, ignore_errors=True)
    lap("export")

    # request ms of the relu and the swish flagship in turns (live gate)
    timing = {}
    for label, images in ((f"B={BATCH}", big), ("B=1", one)):
        with torch.inference_mode():
            ms = _in_turns({n: (lambda n=n: serve(nets[n], *images,
                                                  mode="dense"))
                            for n in ("relu", "swish", "hswish")})
        timing[label] = ms
        print(f"  dense {label} request ms (median of {EXPORT_REPS}, in "
              f"turns): " + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
              + f" [{card}]", flush=True)
    section["request_ms"] = timing
    lap("request ms")
    print("  phase 15 seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in section["seconds"].items()), flush=True)
    report["activation"] = section
    return total


# ------------------------------------------------------------------ phase 19
def _lines_of(fn, argv: list) -> list:
    return [ln for ln in _cli_run(fn, argv)[1]
            if ln.startswith(("branch ", "gate:", "params:", "Time "))]


def check_profiling(report: dict) -> None:
    """FLOP counting and the latency harness on the card (no port kernel
    runs here: the launch counters must not move)."""
    import os
    import re
    import tempfile

    from dynmm_tpu_torch.cli import (affect_count_flop, affect_dyn,
                                     imdb_count_flop, imdb_dyn)
    from dynmm_tpu_torch.data.affect import synthetic_mosei_loaders
    from dynmm_tpu_torch.data.imdb import synthetic_imdb_loaders
    from dynmm_tpu_torch.kernels import LAUNCHES
    from dynmm_tpu_torch.models.modality import build_router

    before = dict(LAUNCHES)
    section = {}
    for name, cli in (("imdb", imdb_count_flop),
                      ("affect", affect_count_flop)):
        card = _lines_of(cli.main, ["--device", "cuda"])
        cpu = _lines_of(cli.main, ["--device", "cpu"])
        for ln in card:
            print(f"  {name}_count_flop (card): {ln}", flush=True)
        if card != cpu or len(card) < 4:
            raise RuntimeError(f"{name}_count_flop: the card's lines {card} "
                               f"differ from the CPU's {cpu}")
        section[f"{name}_count_flop"] = card
    timing = re.compile(r"Time measured over 10 reps: \d+\.\d{4} ± "
                        r"\d+\.\d{4}s per pass")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)  # the CLIs read ./log/
        try:
            for name, cli in (("imdb_dyn", imdb_dyn), ("affect_dyn",
                                                       affect_dyn)):
                for routed in ([], ["--routed"]):
                    argv = ["--synthetic", "--eval-only", "--measure",
                            "--device", "cuda", *routed]
                    (line,) = _lines_of(cli.main, argv)
                    if not timing.fullmatch(line):
                        raise RuntimeError(f"{name} {argv}: {line!r}")
                    label = f"{name}{' --routed' if routed else ''}"
                    print(f"  {label} --measure: {line}", flush=True)
                    section[f"{label} --measure"] = line
        finally:
            os.chdir(cwd)
    # what --measure --routed times computes the dense hard eval's rows
    imdb_b = next(iter(synthetic_imdb_loaders(batch_size=128)[2]))
    mosei_b = next(iter(synthetic_mosei_loaders(batch_size=32)[2]))
    cases = (("imdb", ([torch.from_numpy(x).cuda() for x in imdb_b.inputs],)),
             ("mosei", ([torch.from_numpy(x).cuda() for x in mosei_b.inputs],
                        [torch.from_numpy(x).long().cuda()
                         for x in mosei_b.lengths])))
    for name, args in cases:
        model = build_router(name, seed=0)
        with torch.inference_mode():
            dense, _, w_dense = model(*args, hard=True)
            routed, w = model.forward_routed_compact(*args)
        err = _rel(routed, dense)
        same = bool(torch.equal(w, w_dense))
        print(f"  {name}: routed compact vs dense hard eval, B="
              f"{dense.shape[0]}: max abs err / max |dense| {err:.3e}, gate "
              f"choices {'identical' if same else 'DIFFER'}", flush=True)
        if err > MODALITY_TOL or not same:
            raise RuntimeError(f"{name}: the routed forward differs from the "
                               "dense hard eval")
        section[f"{name}_routed_err"] = err
    if dict(LAUNCHES) != before:
        raise RuntimeError(f"a port kernel launched in phase 19: {before} -> "
                           f"{dict(LAUNCHES)}")
    report["profiling"] = section


# ------------------------------------------------------------------ phase 20
MESH_B = 2  # the float64 2×2 step's global batch (one sample a data rank)
ROUTED_B = 4  # the sharded routed forwards' global batch over D = 2
# The 2×2 mesh step against the one-process step, twice. In float64 at
# B=2 the mesh must be exact, leaf by leaf: the bounds of the CPU step
# tests (loss rel err; weights and BN statistics, max err / the leaf's max
# |entry|; the update, max err / the leaf's max |update|). In fp32, what
# cli.train --mesh-data trains in, at phase 6's B=8 (four samples a data
# rank), the step's own rounding is as large as some leaves' updates
# (conv biases before a train-mode BN, whose exact gradient is 0; the SE
# biases): a leaf's update can differ by more than itself between two
# fp32 steps that differ only in summation order (PERF.md, PR 19). There
# the loss is held to 1e-5 relative, and the update and the BN statistics'
# change over the whole net (relative L2) must lie within twice the
# distance of the one-process fp32 step from the float64 one on the same
# batch: the mesh step is no further from the one-process step than two
# fp32 steps of the same accuracy can be.
MESH_STEPS = ((torch.float64, MESH_B), (torch.float32, BATCH))
MESH_TOLS = {torch.float64: (1e-6, 1e-5, 1e-3), torch.float32: (1e-5,)}


def _mesh_batches() -> list:
    """A batch for each of ``MESH_STEPS``: the first B samples of phase 6's
    first train batch, on the host."""
    batch = next(iter(_train_data()[0]))
    return [{"image": batch["image"][:b], "depth": batch["depth"][:b],
             "label": batch["label"][:b],
             "label_down": {r: v[:b] for r, v in batch["label_down"].items()}}
            for _, b in MESH_STEPS]


def _mesh_trainer(model, settings: tuple, mesh=None):
    """Phase 6's trainer (``settings``: its class weights and config) of
    ``model``, on the card or on ``mesh``."""
    from dynmm_tpu_torch.train.seg import SegTrainer

    class_weights, cfg = settings
    return SegTrainer(model, cfg, class_weights, device="cuda", mesh=mesh)


def _one_step(trainer, batch: dict) -> tuple:
    """One train step of ``trainer`` on ``batch`` (this rank's rows under
    a mesh), as ``train_one_epoch`` takes it at epoch 0."""
    import numpy as np

    from dynmm_tpu_torch.train.seg import DOWN_RATES

    state = trainer.init_state()
    trainer.place(state)
    state.optimizer.set_lr(trainer.cfg.lr)
    rows = (slice(None) if trainer.mesh is None
            else trainer.mesh.rows(len(batch["image"])))
    put = lambda a: torch.as_tensor(np.asarray(a[rows])).cuda()
    targets = [put(batch["label"])] + [put(batch["label_down"][r])
                                       for r in DOWN_RATES]
    dtype = next(trainer.model.parameters()).dtype
    total = trainer.train_step(state, put(batch["image"]).to(dtype),
                               put(batch["depth"]).to(dtype), targets,
                               temp=trainer.cfg.temp, hard=False, ini=False,
                               generator=torch.Generator())[0]
    return float(total), state


class BlankGate:
    """Gate override that decides from the sample alone: a blank sample
    (flat pooled stem maps) takes path 0, no depth stage; any other path 4."""

    def __init__(self, model):
        model.gate_weights = self

    def __call__(self, rgb, depth, temp=1.0, hard=False, baseline=False):
        flat = rgb.flatten(2)
        spread = flat.std(dim=-1).amax(dim=-1)
        paths = torch.where(spread <= 1e-4 * (flat.abs().amax((1, 2)) + 1),
                            0, 4)
        return torch.nn.functional.one_hot(paths, 5).to(rgb.dtype)


def _routed_inputs():
    """ROUTED_B samples: the first half blank, the rest seeded noise."""
    inp = Inputs(seed=20)
    rgb = inp.randn(ROUTED_B, HEIGHT, WIDTH, 3)
    depth = inp.randn(ROUTED_B, HEIGHT, WIDTH, 1)
    rgb[:ROUTED_B // 2] = 0.0
    depth[:ROUTED_B // 2] = 0.0
    return rgb.cpu(), depth.cpu()


ROUTED_METHODS = (("forward_switch_batched", {}),
                  ("forward_routed_compact", {"caps": (0, ROUTED_B // 2)}))


def _mesh_rank(batches: list, settings: tuple) -> dict:
    """One rank of phase 20 (world 4 on the card): the 2×2 mesh's train
    steps (``MESH_STEPS``, a batch each), then, on ranks 0-1, the sharded
    routed forwards over D = 2."""
    import torch.distributed as dist

    from dynmm_tpu_torch.kernels import LAUNCHES, reset_launches
    from dynmm_tpu_torch.parallel.mesh import full_state_dict, make_mesh
    from dynmm_tpu_torch.parallel.routing import make_sharded_routed_forward
    from dynmm_tpu_torch.serve import build_flagship

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
    out = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "device": str(torch.cuda.current_device()), "steps": []}
    mesh = make_mesh(2, 2)
    for (dtype, _), batch in zip(MESH_STEPS, batches):
        trainer = _mesh_trainer(build_flagship(HEIGHT, WIDTH, CLASSES, seed=0)
                                .to(dtype), settings, mesh)
        reset_launches()
        t0 = time.perf_counter()
        loss, state = _one_step(trainer, batch)
        torch.cuda.synchronize()
        step = {"loss": loss, "step_s": time.perf_counter() - t0,
                "launches": sum(LAUNCHES.values()),
                "local_params": sum(p.numel()
                                    for p in state.model.parameters())}
        sd = full_state_dict(state.model)  # every rank gathers
        if rank == 0:
            step["state"] = {k: v.detach().cpu() for k, v in sd.items()}
        out["steps"].append(step)
        del state, trainer, sd
        torch.cuda.empty_cache()

    dmesh = make_mesh(2, 1)
    if dmesh is not None:
        model = build_flagship(HEIGHT, WIDTH, CLASSES, seed=0)
        BlankGate(model)
        rgb, depth = _routed_inputs()
        out["routed"] = []
        for method, kw in ROUTED_METHODS:
            fn = make_sharded_routed_forward(model, dmesh, method, **kw)
            reset_launches()
            logits = fn(rgb, depth)
            torch.cuda.synchronize()
            out["routed"].append({"logits": logits.cpu(),
                                  "launches": dict(LAUNCHES)})
    return out


def _one_process(dtype, batch: dict, settings: tuple) -> tuple:
    """The one-process step on the card: (loss, the weights before, the
    weights after, the number of parameter entries)."""
    from dynmm_tpu_torch.serve import build_flagship

    trainer = _mesh_trainer(build_flagship(HEIGHT, WIDTH, CLASSES, seed=0)
                            .to(dtype), settings)
    start = {k: v.detach().cpu().clone()
             for k, v in trainer.model.state_dict().items()}
    loss, state = _one_step(trainer, batch)
    after = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    full = sum(p.numel() for p in state.model.parameters())
    del state, trainer
    torch.cuda.empty_cache()
    return loss, start, after, full


def _step_errs(got: dict, start: dict, want: dict) -> tuple:
    """(the largest max err / max |leaf| over the weights and BN
    statistics, its leaf, the largest max err of the update / the leaf's
    max |update|, its leaf) of the state ``got`` against ``want``, both
    from ``start``."""
    w_err, u_err, w_worst, u_worst = 0.0, 0.0, "", ""
    for k, v in want.items():
        g, v0, v = got[k].double(), start[k].double(), v.double()
        e = float((g - v).abs().max()) / max(float(v.abs().max()), 1e-30)
        step = float((v - v0).abs().max())
        u = float(((g - v0) - (v - v0)).abs().max()) / step if step else 0.0
        if e > w_err:
            w_err, w_worst = e, k
        if u > u_err:
            u_err, u_worst = u, k
    return w_err, w_worst, u_err, u_worst


def _moves(start: dict, after: dict) -> dict:
    """The step's parameter update and BN statistics' change, each flat
    over the whole net (float64)."""
    flat = lambda stats: torch.cat([
        (after[k].double() - start[k].double()).ravel() for k in start
        if k.endswith(("running_mean", "running_var")) == stats])
    return {"update": flat(False), "BN statistics": flat(True)}


def _l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


def check_mesh(report: dict) -> dict:
    """Phase 20: mesh training and device-local routing over
    torch.distributed, four ranks on this card."""
    from dynmm_tpu_torch.parallel.launch import default_backend, run_ranks
    from dynmm_tpu_torch.serve import build_flagship

    batches = _mesh_batches()
    settings = tuple(_train_data()[2:])
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(_mesh_rank, 4, (batches, settings), device="cuda",
                      timeout=600)
    spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    print(f"  world {r0['world']} on one card, backend {r0['backend']} "
          f"(default_backend: "
          f"{default_backend(torch.device('cuda'), 4)}), ranks on cuda:"
          f"{sorted({r['device'] for r in ranks})}; the ranks' run "
          f"{spawn_s:.1f} s", flush=True)
    if any(s["launches"] for r in ranks for s in r["steps"]):
        raise RuntimeError("a port kernel launched in a mesh train step")

    section = {"backend": r0["backend"], "ranks_s": spawn_s, "steps": {},
               "routed": {}}
    for i, ((dtype, b), batch) in enumerate(zip(MESH_STEPS, batches)):
        name = str(dtype).split(".")[-1]
        loss, start, want, full = _one_process(dtype, batch, settings)
        got = r0["steps"][i]
        loss_err = abs(got["loss"] - loss) / abs(loss)
        w_err, w_worst, u_err, u_worst = _step_errs(got["state"], start, want)
        tols = MESH_TOLS[dtype]
        local = min(r["steps"][i]["local_params"] for r in ranks)
        print(f"  2x2 mesh step vs one process, B={b} at {HEIGHT}x{WIDTH} "
              f"in {name}: loss {got['loss']:.6f} vs {loss:.6f} (rel err "
              f"{loss_err:.2e}, bound {tols[0]:.0e}); weights and BN "
              f"statistics max err / max |leaf| {w_err:.2e} ({w_worst}); the "
              f"update's max err / its max {u_err:.2e} ({u_worst}); each "
              f"rank holds {local} of {full} parameter entries; step "
              f"{max(r['steps'][i]['step_s'] for r in ranks):.1f} s",
              flush=True)
        result = {"loss_rel_err": loss_err, "weight_err": w_err,
                  "update_err": u_err, "worst": [w_worst, u_worst]}
        bad = loss_err > tols[0]
        if dtype == torch.float64:
            print(f"  bounds in float64: weights {tols[1]:.0e}, the update "
                  f"{tols[2]:.0e}", flush=True)
            bad = bad or w_err > tols[1] or u_err > tols[2]
        else:
            # the yardstick: the one-process step's distance from float64
            loss64, _, exact, _ = _one_process(torch.float64, batch,
                                               settings)
            mesh, one, exact = (_moves(start, x) for x in (got["state"],
                                                           want, exact))
            for part in ("update", "BN statistics"):
                err, yard = _l2(mesh[part], one[part]), _l2(one[part],
                                                            exact[part])
                print(f"  {part} over the net, rel L2: mesh vs one process "
                      f"{err:.2e}; the one-process {name} step vs float64 "
                      f"{yard:.2e} (bound twice that)", flush=True)
                result[part] = {"err": err, "fp32_vs_float64": yard}
                bad = bad or not err <= 2 * yard
            result["loss_fp32_vs_float64"] = abs(loss - loss64) / abs(loss64)
            print(f"  the one-process {name} loss vs float64: rel err "
                  f"{result['loss_fp32_vs_float64']:.2e}", flush=True)
            del exact
        section["steps"][f"{name} B={b}"] = result
        if bad:
            raise RuntimeError(f"the 2x2 mesh step in {name} differs from "
                               "the one-process step")
        if not all(r["steps"][i]["local_params"] < full for r in ranks):
            raise RuntimeError("a rank holds whole weights the mesh splits")

    # the sharded routed forwards against one process a shard
    model = build_flagship(HEIGHT, WIDTH, CLASSES, seed=0)
    BlankGate(model)
    rgb, depth = _routed_inputs()
    half = ROUTED_B // 2
    launches = {}
    for i, (method, kw) in enumerate(ROUTED_METHODS):
        with torch.inference_mode():
            want = torch.cat([getattr(model, method)(
                rgb[s].cuda(), depth[s].cuda(), **kw).cpu()
                for s in (slice(0, half), slice(half, None))])
        errs = [_rel(r["routed"][i]["logits"], want) for r in ranks[:2]]
        easy, hard = (ranks[r]["routed"][i]["launches"] for r in (0, 1))
        want_easy = path_launches([False] * 4, low_res=False)
        want_hard = path_launches([True] * 4, low_res=False)
        ok = (max(errs) <= KERNEL_TOL and _nonzero(easy) == _nonzero(want_easy)
              and _nonzero(hard) == _nonzero(want_hard))
        print(f"  sharded {method}{kw or ''} over D=2: each rank's gathered "
              f"logits vs the one-process runs of its shard, max err / max "
              f"{max(errs):.2e}; the blank shard's rank launched "
              f"{_nonzero(easy)} (no depth stage), the other "
              f"{_nonzero(hard)}", flush=True)
        if not ok:
            raise RuntimeError(f"sharded {method}: wrong output or launches")
        section["routed"][method] = {"err": max(errs), "easy": easy,
                                     "hard": hard}
        for counts in (easy, hard):
            launches = _add(launches, counts)
    report["mesh"] = section
    return launches


# ------------------------------------------------------------------ phase 21
ORBAX_SEED = 22  # phase 22's request


def _bf16_bits(tree):
    """A restored tree with its bfloat16 tensors as uint16 numpy bits."""
    if isinstance(tree, dict):
        return {k: _bf16_bits(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.view(torch.int16).numpy().view("<u2")
    return tree


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return getattr(tree, "nbytes", 0)


def check_orbax(report: dict) -> dict:
    """Phase 22: phase 6's trained state through ``save_orbax`` and
    ``load_orbax``, served from the restored weights; the JAX-written
    fixture decoded (module docstring)."""
    import shutil

    from dynmm_tpu_torch.kernels import LAUNCHES, reset_launches
    from dynmm_tpu_torch.nn.layers import pack_weights
    from dynmm_tpu_torch.serve import build_flagship, serve
    from dynmm_tpu_torch.train.seg import SegTrainer
    from dynmm_tpu_torch.utils.checkpoint import load_orbax, save_orbax
    from dynmm_tpu_torch.utils.device import card_line
    from dynmm_tpu_torch.utils.msgpack import msgpack_restore

    if not PHASE6_CKPT:
        raise RuntimeError("phase 6's checkpoint is not held: run phase 6 "
                           "first")
    card = card_line()
    _, _, class_weights, cfg = _train_data()
    root = ROOT / "build" / "chip_smoke_orbax"
    shutil.rmtree(root, ignore_errors=True)

    def trainer_state(seed: int):
        model = build_flagship(HEIGHT, WIDTH, CLASSES, seed=seed)
        return SegTrainer(model, cfg, class_weights).init_state()

    source = trainer_state(3)
    source.load_tree(PHASE6_CKPT["state"])
    want, epoch = source.tree(), PHASE6_CKPT["epoch"]
    nbytes = _nbytes(want)
    t0 = time.perf_counter()
    path = save_orbax(str(root / "flagship"), source, epoch=epoch)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    payload = load_orbax(path)
    load_s = time.perf_counter() - t0
    target = trainer_state(4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    load_orbax(path, target=target)
    torch.cuda.synchronize()
    target_s = time.perf_counter() - t0
    bad = _same_bits(payload["state"], want)
    bad_target = _same_bits(target.tree(), want)
    on_disk = sum(f.stat().st_size for f in Path(path).rglob("*")
                  if f.is_file())
    print(f"  the flagship's trained fp32 state ({nbytes} bytes of arrays, "
          f"{on_disk} on disk): save_orbax {save_s:.3f} s, load_orbax "
          f"{load_s:.3f} s, into a fresh trainer state {target_s:.3f} s "
          f"[{card}]; leaves differing: {len(bad)} without a target, "
          f"{len(bad_target)} in the target", flush=True)
    if bad or bad_target or payload["epoch"] != epoch:
        raise RuntimeError(f"orbax round trip differs: {bad[:5]} "
                           f"{bad_target[:5]}, epoch {payload['epoch']}")

    # a dense request from the restored weights and from the source's
    inp = Inputs(seed=ORBAX_SEED)
    rgb = inp.randn(BATCH, HEIGHT, WIDTH, 3)
    depth = inp.randn(BATCH, HEIGHT, WIDTH, 1)
    models = [source.model.eval(), target.model.eval()]
    for m in models:
        pack_weights(m)
    with torch.inference_mode():
        logits = [m(rgb, depth, hard=True) for m in models]
    logits_err = (logits[0] - logits[1]).abs().max().item()
    ref_map, ref_w = serve(models[0], rgb, depth, mode="dense")
    torch.cuda.synchronize()
    reset_launches()  # counts at 0 just before the request, read just after
    class_map, weight = serve(models[1], rgb, depth, mode="dense")
    torch.cuda.synchronize()
    got = {k: v for k, v in LAUNCHES.items() if v}
    same = bool(torch.equal(class_map, ref_map) and torch.equal(weight, ref_w))
    print(f"  dense B={BATCH} serve() from the restored weights: class map "
          f"and gate choices equal to the source's: {same}; logits max abs "
          f"err {logits_err}; launches {got}", flush=True)
    if not same or logits_err != 0 or got != EXPECTED:
        raise RuntimeError(f"phase 22 serve: same {same}, logits err "
                           f"{logits_err}, launches {got} vs {EXPECTED}")
    del source, target, models, logits

    # the JAX-written fixture
    fixture = ROOT / "tests" / "fixtures_torch_orbax"
    expected = msgpack_restore((fixture / "expected.msgpack").read_bytes())
    t0 = time.perf_counter()
    restored = load_orbax(str(fixture / "ckpt"))
    fixture_s = time.perf_counter() - t0
    bad_fixture = _same_bits(_bf16_bits(restored["state"]), expected["state"])
    print(f"  the JAX-written fixture (tests/fixtures_torch_orbax): epoch "
          f"{restored['epoch']}, leaves differing from expected.msgpack: "
          f"{len(bad_fixture)}, {fixture_s:.3f} s", flush=True)
    if bad_fixture or restored["epoch"] != expected["epoch"]:
        raise RuntimeError(f"the fixture decodes wrong: {bad_fixture}")
    report["orbax"] = {"state_bytes": nbytes, "disk_bytes": on_disk,
                       "save_s": save_s, "load_s": load_s,
                       "load_target_s": target_s, "logits_max_abs_err":
                       logits_err, "launches": got, "fixture_s": fixture_s}
    shutil.rmtree(root, ignore_errors=True)
    return got


def check_prepare(report: dict) -> dict:
    """Phase 21: JPEG decoding, the four dataset converters and cli.eval on
    the converted NYUv2 layout (module docstring)."""
    import contextlib
    import io
    import shutil

    import numpy as np

    sys.path.insert(0, str(ROOT / "tests"))
    import _torch_prepare_raw as raw

    from dynmm_tpu_torch.cli import eval as eval_cli
    from dynmm_tpu_torch.data import (jpeg, png, prepare_cityscapes,
                                      prepare_nyuv2, prepare_scenenet,
                                      prepare_sunrgbd)
    from dynmm_tpu_torch.kernels import LAUNCHES, reset_launches
    from dynmm_tpu_torch.serve import build_flagship
    from dynmm_tpu_torch.train.seg import SegTrainer
    from dynmm_tpu_torch.utils.checkpoint import save_checkpoint
    from dynmm_tpu_torch.utils.device import card_line
    from dynmm_tpu_torch.utils.weights import (flax_from_state_dict,
                                               load_recipe_gate)

    card = card_line()
    section: dict = {"jpeg": {}, "converters": {}}
    root = ROOT / "build" / "chip_smoke_prepare"
    shutil.rmtree(root, ignore_errors=True)

    # the fixture JPEGs against their stored cv2 pixels
    folder = raw.FIXTURES / "jpeg"
    with np.load(folder / "expected.npz") as want:
        for path in sorted(folder.glob("*.jpg")):
            if path.stem == "progressive":
                continue
            errs = []
            for color, mode in ((True, "color"), (False, "unchanged")):
                got, ref = jpeg.read(str(path), color), want[
                    f"{path.stem}:{mode}"]
                if got.shape != ref.shape:
                    raise RuntimeError(f"{path.name} ({mode}): shape "
                                       f"{got.shape} != {ref.shape}")
                errs.append(int(np.abs(got.astype(int) - ref).max()))
            section["jpeg"][path.name] = max(errs)
    try:
        jpeg.read(str(folder / "progressive.jpg"), True)
        raise RuntimeError("a progressive JPEG decoded")
    except ValueError as e:
        progressive = str(e)
    print(f"  {len(section['jpeg'])} fixture JPEGs vs cv2.imread (colour and "
          f"unchanged): max abs err {max(section['jpeg'].values())}; "
          f"progressive raises: {progressive.split(': ', 1)[1]}", flush=True)
    if any(section["jpeg"].values()):
        raise RuntimeError(f"JPEG pixels differ from cv2's: {section['jpeg']}")

    # the converters on raw trees built from the fixtures
    converters = {"nyuv2": prepare_nyuv2, "sunrgbd": prepare_sunrgbd,
                  "cityscapes": prepare_cityscapes,
                  "scenenet": prepare_scenenet}
    for kind, module in converters.items():
        kw = raw.BUILDERS[kind](root / kind / "in")
        out = root / kind / "out"
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            module.convert(str(out), **kw)
        seconds = time.perf_counter() - t0
        got = raw.written(out, png.read)
        bad = raw.differences(got, raw.expected(kind))
        samples = sum(1 for k in got if "/rgb/" in k)
        row = {"files": len(got), "samples": samples,
               "s_per_sample": seconds / samples, "differences": bad}
        section["converters"][kind] = row
        print(f"  prepare_{kind}: {samples} samples, {len(got)} files equal "
              f"to the JAX converter's: {not bad}; "
              f"{row['s_per_sample']:.4f} s a sample [{card}]", flush=True)
        if bad:
            raise RuntimeError(f"prepare_{kind} differs from the JAX "
                               f"converter: {bad[:5]}")

    # cli.eval on the converted NYUv2 layout
    layout = root / "nyuv2" / "out"
    model = build_flagship(HEIGHT, WIDTH, CLASSES, seed=0)
    load_recipe_gate(model)
    v = flax_from_state_dict(model.state_dict())
    ckpt = str(root / "flagship.msgpack")
    save_checkpoint(ckpt, {"params": v["params"], "model_state": {
        "batch_stats": v["batch_stats"]}}, epoch=0)
    del model
    n_test = len((layout / "test.txt").read_text().split())
    n_batches = -(-n_test // BATCH)
    expected = _add({}, path_launches([True] * 4, False), n_batches)
    validate, timings = SegTrainer.validate, []

    def timed_validate(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = validate(self, *a, **k)
        torch.cuda.synchronize()
        timings.append(time.perf_counter() - t0)
        return result

    argv = ["--dataset", "nyuv2", "--dataset_dir", str(layout), "--height",
            str(HEIGHT), "--width", str(WIDTH), "--batch_size", str(BATCH),
            "--dynamic", "--global-gate", "--hard", "--ckpt_path", ckpt]
    SegTrainer.validate = timed_validate
    try:
        reset_launches()  # counts at 0 just before the run, read just after
        result, lines = _cli_run(eval_cli.main, argv)
        got = {k: v for k, v in LAUNCHES.items() if v}
    finally:
        SegTrainer.validate = validate
    miou = [float(m) for m in result]
    s_batch = sum(timings) / (len(timings) * n_batches)
    section["eval"] = {"miou": miou, "launches": got,
                       "s_per_batch": s_batch, "samples": n_test}
    print(f"  cli.eval on the converted NYUv2 layout ({n_test} test sample at "
          f"{HEIGHT}x{WIDTH}, fp32, recipe gate): mIoU {miou}, "
          f"{s_batch:.4f} s a batch [{card}]; "
          f"launches {got}", flush=True)
    if got != expected:
        raise RuntimeError(f"phase 21 eval: launches {got} != {expected}")
    if not all(math.isfinite(m) for m in miou):
        raise RuntimeError(f"phase 21 eval: mIoU {miou}")
    report["prepare"] = section
    shutil.rmtree(root, ignore_errors=True)
    return got


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 1
    if not (ROOT / "dynmm_tpu_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no dynmm_tpu_torch package beside {__file__}; "
              "run it from the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from dynmm_tpu_torch.kernels import build_all
    from dynmm_tpu_torch.utils.device import card_line

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print("TF32 off for cuDNN convolutions and matmuls: kernels and plain "
          "versions compare in fp32", flush=True)
    report = {"card": card, "torch": torch.__version__, "kernel_cases": [],
              "serve": [], "routed": []}

    print("[1] build", flush=True)
    report["build_s"] = build_all(verbose=True)
    print(f"  built the kernels in {report['build_s']:.2f} s", flush=True)

    print(f"[2] kernels vs plain versions at the flagship's shapes, B={BATCH}",
          flush=True)
    kernels = check_kernels(report)

    print(f"[3] serve the {HEIGHT}x{WIDTH} flagship, dense", flush=True)
    model, launches = check_serve(report)
    print(f"[4] serve the {HEIGHT}x{WIDTH} flagship through the routed "
          "strategies", flush=True)
    runs = [launches, check_routed(model, report)]
    del model
    phases = [
        (5, f"recipe gate: the {HEIGHT}x{WIDTH} flagship with "
            "bench_assets/gate_recipe.msgpack", check_recipe_gate),
        (6, f"train the {HEIGHT}x{WIDTH} flagship: SegTrainer.fit, 2 epochs "
            f"of 2 steps of B={BATCH}", check_train),
        (7, f"modality-level DynMM: MM-IMDB at B={IMDB_B}, CMU-MOSEI at "
            f"B={MOSEI_B} T={MOSEI_T}; the imdb_dyn and affect_dyn CLIs",
         check_modality),
        (8, f"the eval and predict CLIs on a prepared NYUv2 layout of "
            f"{CLI_SAMPLES} samples at {HEIGHT}x{WIDTH}, B={BATCH}",
         check_clis),
        (9, f"the R50 SkipGateESANet at {HEIGHT}x{WIDTH} with "
            "bench_assets/gate_recipe_resnet50.msgpack, every serving mode",
         check_r50),
        (10, f"train the R50 net through cli.train: 2 steps of B={BATCH}",
         check_r50_train),
        (11, f"cli.train then cli.eval: the static ESANet, the local-gate "
             f"SkipESANet and the one-modality net with SE, R34-NBt1D at "
             f"{HEIGHT}x{WIDTH}", check_variants),
        (12, f"the bf16 flagship at {HEIGHT}x{WIDTH} with the recipe gate: "
             "every serving mode, cli.eval and cli.predict --dtype bfloat16",
         check_bf16),
        (13, f"the int8 flagship at {HEIGHT}x{WIDTH} with the recipe gate, "
             "fp32 and bf16 compute: calibration, every serving mode, "
             "cli.eval and cli.predict --quant int8", check_int8),
        (14, f"export: the {HEIGHT}x{WIDTH} recipe flagship's serving forward "
             "as torch.export artifacts, replayed; cli.predict --export_path",
         check_export),
        (15, f"the swish and hswish flagships at {HEIGHT}x{WIDTH}: every "
             "serving mode, bf16, int8, cli.train/eval/predict --activation "
             "swish, export", check_activation),
        (17, f"train the {HEIGHT}x{WIDTH} flagship in bf16: SegTrainer.fit, 2 "
             f"epochs of 2 steps of B={BATCH}; resume; phase 6's optax "
             "opt_state on the card", check_train_bf16),
        (18, "the modality experts' two steps: the 14 expert CLIs, their "
             f"requests at B={IMDB_B} (MM-IMDB) and B={MOSEI_B} T={MOSEI_T} "
             "(CMU-MOSEI); imdb_dyn and affect_dyn grafting them; --robust",
         check_experts),
        (19, "FLOP counting and the latency harness: the count_flop CLIs on "
             "the card, imdb_dyn and affect_dyn --measure [--routed]",
         check_profiling),
        (20, f"mesh training and sharded routing over torch.distributed: a "
             f"2x2 mesh train step of the {HEIGHT}x{WIDTH} flagship and the "
             f"sharded routed forwards over D=2, four ranks on this card",
         check_mesh),
        (21, "the dataset converters on the card's machine: the fixture "
             "JPEGs, prepare_{nyuv2,sunrgbd,cityscapes,scenenet} against the "
             "JAX converters' outputs, cli.eval on the converted NYUv2 "
             "layout", check_prepare),
        (22, f"orbax checkpoints: the {HEIGHT}x{WIDTH} flagship's trained "
             "state through save_orbax and load_orbax, served; the "
             "JAX-written fixture", check_orbax),
    ]
    for n, title, check in phases:
        print(f"[{n}] {title}", flush=True)
        t0 = time.perf_counter()
        runs.append(check(report) or {})
        print(f"  phase {n}: {time.perf_counter() - t0:.1f} s", flush=True)
    print("[16] kernels", flush=True)
    for k in kernels:
        k["launches"] = sum(run.get(k["name"], 0) for run in runs)
        if k["launches"] == 0:
            raise RuntimeError(f"{k['name']} never launched on the main path")
    report["kernels"] = kernels

    out = ROOT / "chiprun_out" / "chip_smoke.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
