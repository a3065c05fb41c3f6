#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SFC (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card of compute capability 9.0 (an H100) and the CUDA
toolkit's ``nvcc``; it builds the port's kernels from ``src/repro_torch/
csrc`` at first use.  Phases, each of which raises on failure:

  1. probe: PyTorch, CUDA, the card, ``nvcc``, its name and power limit;
  2. build the kernels and report the seconds it took;
  3. each kernel against its plain PyTorch version on the card, at VGG-16
     layer shapes, at depthwise shapes of MobileNetV2 and at the lowered
     convs' sub-conv shapes (sfc6_7_r2, sfc6_6_r4, sfc4_4_r2, sfc4_5_r2,
     VALID, each also timed beside a compiled algorithm on the same input),
     with the tolerance stated beside each check; the fused kernels also
     bit for bit against the staged ones (B4 against B1 -> B2 -> B3, B7
     against B1 -> B6 -> B3) on snapped and raw inputs at a second
     geometry, B7 at batch 4, VALID and a run-time algorithm too, B3's NHWC
     entry bit for bit against its tile entry followed by ``untile``, and
     B1's (P, T, C) entry against its plain version and bit for bit
     against its tile entry, B1 and B5 also at a second geometry; then B2
     and B6 bit for bit against their plain versions at the per-layer
     geometry and at a second one, B2 at every VGG-16 layer shape and at
     ragged tiles and channels (T 1, 9, 17; K 3, 40; N 8, 24, 520), B6 at
     every depthwise layer and at C 3, 20 and 960; B1, B4 and B7 at 4
     bits (``INT4_FREQ``), B4 and B7 bit for bit the staged paths;
     phases 3-6 run with the degradation chain off, so a kernel that
     fails raises;
     c. B4 at sfc6_7 (t = 12) with every ``tuning.DEFAULT_CANDIDATES``
        config over VGG-16's 13 convs at batch 1 (one weight stage at
        ``cout_block`` 16, one stage of 8 tiles at ``k_block`` 64), each
        bit for bit the staged trio and within the int8 bounds of the
        reference path, timed per layer;
  4. the direct path on the card under PyTorch's default TF32 flags (the
     run sets none): a 1x1, a 3x3, a 3x3/2 and a lowered 3x3/2's 1x1 phase
     as ``"direct"`` plans against the same plan on CPU copies of the
     inputs, within 1e-4 rel L2 and 1e-4 of max |y|, and, as what the guard
     prevents, the same plans with the port's cuDNN guard taken out;
  5. the paths, each forward of which starts from launch counts of 0 and
     must launch its own kernels, and only those, the stated number of
     times; every layer is held against the ``reference`` backend on the
     same input:
     a. int8 VGG-16: requests through VGG-16's 13-layer conv stack at
        224x224 and its published widths, every layer through
        ``ConvSpec -> plan(backend="cuda", algo="sfc6_6") -> calibrate ->
        prepare_weights -> apply``, on the fused and the staged datapath;
     b. fp VGG-16: the same stack with ``quant=FP32`` (B5 -> f32 product
        -> B3), one request of batch 1 and one of batch 4, and the batch-1
        request once more with the caller's TF32 turned on for cuBLAS;
     c. depthwise: the 13 stride-1 depthwise 3x3 convs of MobileNetV2
        (width 1.0, 224x224) and the repo's ``dw3x3`` workload, each a
        request of batch 1 and of batch 4, on the int8 fused, int8 staged
        and fp paths; fused and staged must be bit-identical;
     d. the lowered convs (``repro_torch.api.lowering``) at 224x224 widths,
        batch 1 and 4: ResNet-18's 7x7/2 stem and 3x3/2 transitions (int8
        fused, int8 staged, fp; ``algo="sfc6_6"``), MobileNetV2's four
        stride-2 depthwise convs (``auto`` planned direct, int8 sfc4_4_r2
        fused and staged, fp sfc6_6) and a 56x56 128->128 groups=4 conv
        (int8 fused and staged); each timed, card and wall, beside the
        strided direct conv (cuDNN, full fp32) and cuDNN's fp16 conv, with
        the glue (the phase cut, the sums) timed apart;
     e. the measured tier: ``tuning.autotune`` of VGG-16's and ResNet-18's
        distinct specs at batch 1 into the run's own cache
        (``build/chip_smoke_tuning.json``, deleted first), each spec's
        candidates, winner and the card time of each datapath printed;
        then a tuned VGG-16 request (no config given: each plan carries its
        winner) at batch 1 and 4, bit for bit the fused and staged ones;
     f. ResNet-18's 20-conv stack at 224x224, batch 1 and 4 (ReLU,
        residual adds, the max-pool; no normalization or head), on the int8
        fused, staged and tuned datapaths and fp, every layer against the
        reference backend, fused = staged = tuned bit for bit, card and
        wall time and the batch-4 peak memory;
  6. per kernel, the times over the layers of one batch-1 request: the
     kernel, its plain version, one PyTorch library call where one
     computes the same function, and the least time the card could take
     (B1 and B3 as the paths call them: B1's (P, T, C) entry, B3's NHWC
     entry on the product's output); also B3's tile entry and the copies
     the NHWC entry replaced, B1, B3 and B5 over the depthwise layers, the
     card's time for a launch of nothing, and one batch-1 fp and staged
     VGG-16 forward under ``torch.profiler`` (the card's kernels by name,
     and its busy share), where the profiler traces the card;
  7. the serving path: ``repro_torch.serve.Engine`` over VGG-16's
     third-stage conv (256 -> 256, int8 sfc6_6, buckets 28x28, 42x42 and
     56x56, EDF with a 2 ms hold, at most 8 a batch), 32 requests of six
     shapes: a deterministic pass (launch counts checked per dispatch,
     every answer bit for bit its own ``plan.apply`` and within the int8
     bounds of the reference backend), a threaded pass (requests/s, e2e
     p50 and p99, service ms, occupancy), armed fused faults (served by
     staged bit for bit, the breaker opened, raised with the chain off),
     and the cost model fitted on the card (fit error, its top-1 beside
     the measured winner and the card's fastest datapath per VGG-16 and
     ResNet-18 spec; a cold bucket warmed from it); any resilience event
     it did not arm fails the run;
  8. the paper's CNNs (``repro_torch.models.cnn``), the chain off again:
     a. VGG-16 and ResNet-18 at 224x224, published widths and 1000
        classes, weights from a seeded ``torch.Generator`` on the card, a
        batch of 2 images, each with ``conv_algo`` "direct", "sfc6_6" and
        "sfc6_6" with ``quant="int8"`` (dynamic fake quant through the
        hook) on the reference backend, which launches no kernel of the
        port: fp32 sfc6_6 against direct within rtol = atol = 1e-3, int8
        logits against fp32 within rel L2 0.15, ResNet-18 lowered against
        ``lowering.disabled()`` within 1e-3, the wall ms of each forward
        and the card's busy ms and launches from a ``torch.profiler``
        trace; ``CIFAR_RESNET18`` on the card against CPU copies within
        1e-4 rel L2;
     b. PTQ deployment: every native 3x3/1 conv of both networks, its
        input the fp32 activation of the model's own forward (recorded at
        the module's ``conv_apply``), calibrated by a
        ``PTQLayer(INT8_FREQ)`` on 4 images through the reference backend
        and deployed by ``PTQLayer.prepare`` on a ``cuda`` plan on 2 others:
        B4 once (fused), B1, B2, B3 once each (staged), bit for bit equal,
        within the int8 bounds of the reference deployment and of the
        ``quantized_hook()`` simulation; its rel L2 against the fp32 direct
        conv printed; the lowered transitions refused by ``prepare``;
     c. ``iterative_conv1d`` on the card for the three pairs of
        ``benchmarks/appendixB_iterative.py``, within 1e-3 of the direct
        correlation;
  9. training on the card (``repro_torch.train``: ``Trainer``,
     ``make_train_step``, AdamW, the checkpointer), the chain off and
     cuDNN deterministic; a train step runs the reference path and its
     autograd and must launch no kernel of the port:
     a. ResNet-18 at 224x224, published widths, 1000 classes, trained 8
        steps at batch 16 on ``SyntheticImagePipeline`` (seed 3) with
        ``AdamW(cosine_schedule(1e-3, 2, 8), weight_decay=1e-4)``,
        checkpoints every 4 steps under ``build/``, with ``conv_algo``
        "direct" and with int8 "sfc6_6" (dynamic fake quant through the
        STE): finite losses; a ``TransientError`` at step 6 rolls back to
        step 4 and the resumed losses are the first run's within 1e-5
        relative; step wall ms, one traced step's card busy ms and
        kernels, peak memory; then one step's loss and gradients at batch
        2 on the card against CPU copies: direct and fp32 sfc6_6 within
        1e-4 of max |g| (and again with the backward's float32 guard taken
        out, as what it prevents); int8 sfc6_6 with the loss within 1e-4
        relative and every leaf within 1e-2 rel L2, or 3x the CPU's own
        spread when the images move by 1e-7 where that is larger (dynamic
        int8 is chaotic: the spread is ~0.35 at this depth), the biases
        that feed a normalization, whose gradient is rounding noise,
        within 1e-4 of max |g|; and each native 3x3/1 conv alone through
        the int8 hook, input and weight gradients within 1e-2 rel L2;
     b. the paper's §6.1 experiment: ``CIFAR_RESNET18`` trained 150 steps
        at batch 32 with the example's recipe (``AdamW(cosine_schedule(
        3e-3, 10, 150), weight_decay=1e-4)``, "direct"): the mean loss of
        the last 5 steps at least 0.5 below the first 5's, held-out fp32
        accuracy (6 batches from index 5000) at least 0.5; the example's
        seven-row accuracy table; a ``PTQLayer(INT8_FREQ)`` per native
        3x3/1 conv (13) calibrated on 4 other batches on the "sfc6_6"
        config, the ``quantized_hook()`` simulation, and a deployed
        forward with those 13 convs on ``cuda`` plans (13 B4 launches
        fused, 13 each of B1, B2, B3 staged, bit for bit each other),
        within 1e-3 rel L2 of the simulation's logits (or 3x the
        simulation's own spread when the images move by 1e-7, where that
        is larger) and agreeing on the argmax of 99% of the held-out
        images; per layer, on the trained
        model's own activations, the deployed output within 1e-4 rel L2 of
        the simulation on the same input, against the fp32 direct conv,
        and Fig. 5's MSE ratio of sfc6_6 and wino4 to direct int8.

  10. the sharded conv backend (``cuda_spmd``,
     ``repro_torch.distributed.conv_spmd``), the chain off: VGG-16's 13
     convs, ResNet-18's 20 (the stem and transitions lowered) and
     MobileNetV2's 13 stride-1 depthwise convs at batch 4, 224x224 and
     published widths, on the int8 fused, staged and tuned (each conv
     carrying the single-device plan's measured config) datapaths, fp and
     direct, over the (data, model) meshes (1, 1), (2, 1), (1, 2), (2, 2),
     (4, 1) and (1, 4) from ``make_forced_host_mesh`` (the visible GPUs
     where there are enough, else ``cuda:0`` repeated); every conv on the
     single-device conv's input against its output: int8 bit for bit, fp
     and direct bit for bit or within 1e-4 (a finding); the placed weight
     blocks' devices and shapes; launches mesh size times the
     single-device count; VGG-16 and ResNet-18 at batch 1 on (2, 1) and
     (2, 2) (the data axis dropped); each stack's card and wall ms beside
     the single-device stack's, findings with no bound;
     b. ``python -m repro_torch.analysis --check`` on this host (exit 0)
     and ``compressed_psum`` over a one-rank NCCL group, bit for bit the
     int8 round trip.

  11. the LM serving path (``repro_torch.models``, ``launch.serve``), the
     chain off; no forward may launch any of B1-B7 (the JAX pallas backend
     sends rank-1 plans to its reference path, and the models reach no
     other conv):
     a. the rank-1 depthwise causal conv at mamba2-1.3b's conv shapes (B 2,
        T 512 and a ragged 37, C 4352, R 4), ``sfc6_6_r4`` and ``direct``
        on the ``reference``, ``cuda`` and ``cuda_spmd`` ((2, 1) mesh)
        backends: bit for bit each other, within 1e-4 rel L2 of CPU
        copies, SFC within 1e-4 of direct; card ms of each;
     b. mamba2-1.3b, zamba2-1.2b and phi4-mini-3.8b at their published
        widths and depths, weights from a seeded ``torch.Generator`` on
        the card: a bf16 prefill of 2 x 512 tokens (card ms spin-queued
        where the host can enqueue it within the spin, busy ms and kernels
        from a ``torch.profiler`` trace, wall ms); at full width with 2
        layers in fp32, the card within 1e-4 rel L2 of CPU copies,
        teacher-forced decode within 1e-3 of the forward, ``use_sfc_conv``
        on within 1e-4 of off (max |diff| / (1 + |ref|)); the same three
        figures at full depth in bf16, as findings;
     c. ``launch.serve.main`` for each of the three (``--no-smoke``, batch
        4, gen 32, max-len 128, 12 requests): 12 served, 48, 38 and 0 conv
        layers warmed; tok/s, request p50 and p99, steps, wall ms a decode
        step, the card's ms and busy ms a step, the host-bound share, peak
        memory;
     d. the smoke configs of qwen3-14b, qwen2.5-32b and stablelm-3b on the
        card within 1e-4 rel L2 of CPU copies in fp32.

  12. the moe, vlm and encdec families, the chain off, no forward, decode
     step or serving run launching any of B1-B7: deepseek-v3-671b (cut to
     4 layers: its 3 dense layers, 1 MoE layer, the MTP head), mixtral-8x7b
     (cut to 4 of 32 layers), llama-3.2-vision-11b and whisper-tiny (full
     depth) at published widths, weights from a generator seeded 0 on the
     card:
     a. 12 requests each through ``launch.serve`` (``main`` at full depth,
        ``serve`` on the cut config; batch 4, gen 32, max-len 128): tok/s,
        request p50 and p99, wall and busy ms a decode step, kernels a
        step, the host-bound share, peak memory;
     b. a bf16 prefill of 2 x 512 tokens (1,601 seeded vision embeddings
        for the vlm, 512 seeded frames for whisper): busy and wall ms;
     c. fp32 at full width and a cut depth (deepseek 2 layers, 1 dense and
        1 MoE, no MTP; mixtral 2; llama 4, one group, its gates 0.5 and
        -0.7; whisper full): the card within 1e-4 rel L2 of CPU copies, the
        lossless decode within 1e-3 of the lossless forward;
     d. the same two figures at the served depth in bf16, as findings;
     e. the four smoke configs on the card within 1e-4 of CPU copies in
        fp32, the logits and each term of the loss (deepseek's MTP too).

  13. LM training, the chain off, deterministic algorithms on, no step,
     forward or gradient launching any of B1-B7 (the rank-1 conv runs the
     reference path, as in phases 11 and 12):
     a. mamba2-1.3b and zamba2-1.2b (full depth, batch 2 x 2048),
        whisper-tiny (full, 8 x 448) and mixtral-8x7b (1 of 32 layers, 1 x
        5120, past its 4096-token window) at published widths trained 5
        steps (bf16 compute, fp32 parameters, AdamW) by the Trainer's
        step loop: finite losses, the median step ms of steps 2-5, one
        traced step's busy ms, kernels and top kernels, peak memory
        beside the reckoned state (16 bytes a parameter) and update (28);
        then mamba2-1.3b at 4 layers (2 x 2048) by that step loop and by
        the ``Trainer`` with a TransientError at step 3 and a checkpoint
        at step 5: it restarts from the seed and replays the losses bit
        for bit (a 3 GB state: the full-depth states' 14-21 GB
        checkpoints took a minute each);
     b. fp32 gradients at full width (mamba2 and zamba2 at 2 layers,
        zamba2's shared block at layer 0; whisper whole; mixtral 1 layer)
        on 512 tokens against a CPU copy: each leaf within 1e-4 rel L2 (a
        leaf zero in exact arithmetic within 1e-6 of the largest max |g|),
        the loss within 1e-5, as the caller leaves TF32 and with TF32
        allowed by the caller;
     c. mamba2-1.3b at 8 layers, batch 2 x 2048, bf16: gradients with
        remat off, ``full`` and ``dots`` bit for bit, peak memory of each;
     d. the flash attention backward at zamba2's (2 x 2048, 32 x 64,
        causal) and mixtral's (1 x 5120, GQA 32/8 x 128, window 4096)
        shapes against autograd through the plain forward loop, within
        1e-5 rel L2, peak memory of both;
     e. (with b, mamba2 and zamba2) after a no_grad forward warms the
        conv serving cache, the gradients bit for bit a fresh run's.

  14. The sharded LM train step (``repro_torch.distributed.lm_spmd``) and
     elastic restore, the chain off, deterministic algorithms on, no call
     launching any of B1-B7; meshes over the visible GPUs where there are
     enough, else cuda:0 repeated:
     a. fp32 gradients and one AdamW step (lr 1e-4) at full width on
        meshes (1, 1), (2, 1), (1, 2) and (2, 2), batch 2 x 512, each
        against the single-device step on the same card (with the data
        axis's MoE chunks), compared on the host: mamba2-1.3b and
        zamba2-1.2b at 2 layers (zamba2's shared block at layer 0),
        mixtral-8x7b at 1 layer (8 experts), llama-3.2-vision-11b at one
        cross group of one self layer (the published group of four beside
        the reference does not fit one card), whisper-tiny whole,
        phi4-mini-3.8b at 2 layers: the loss within 1e-5, each leaf within
        1e-4 rel L2 (dead leaves within 1e-6 of the largest max |g|), the
        new parameters within 1e-5 rel L2 (across data shards, a leaf the
        step moves by more than 1% of its norm, as a zero-init leaf or
        mixtral's router, has its step held within 1e-3 rel L2 instead:
        the first AdamW step is about lr an element whatever |g|, which
        turns the gradients' rounding into update differences in
        proportion to the step's share of the leaf);
        on (1, m) the loss and gradients bit for bit; each block on its
        device with its spec's shape; then stablelm-3b at 4 layers in bf16
        compute: on (1, 2) the loss and gradients bit for bit the
        unsharded bf16 step's, on (2, 1) the loss within 1e-3 and each
        gradient leaf within 5e-2 rel L2; the sharded state drawn by the
        sharded init;
     b. mixtral-8x7b's MoE block over a (2, 1) mesh's shards bit for bit
        one device with ``data_shards`` 2 installed;
     c. a whisper-tiny state saved from (2, 2) restores onto (4, 1) and
        (1, 1) bit for bit, and a CPU subprocess of numpy alone reads it
        as the JAX package's reader reads its format (manifest, digest,
        keys, bf16 bits); a (2, 2) ``Trainer`` with a TransientError at
        step 3 of 4 restores step 2 onto its mesh and replays the losses
        bit for bit;
     d. ``pipeline_apply`` of 8 mamba2-1.3b layers over 4 stages, 4
        microbatches of 1 x 512: forward and gradients within 1e-5 rel L2
        of the sequential stack run on the same microbatches, and within
        1e-4 of it on the whole batch (other product shapes);
     e. with four cards only: stablelm-3b and phi4-mini-3.8b at full depth,
        5 bf16 steps at 4 x 2048 on (4, 1) and (2, 2): finite losses, the
        median step ms, each card's peak against its state blocks, and the
        single-device reckoning; on one card a line says it did not run.

  15. Sharded LM serving (``repro_torch.distributed.serve_spmd``: each
     weight block computes on its own coordinate), the chain off, no call
     launching any of B1-B7:
     a. over meshes (1, 1), (2, 1), (1, 2), (2, 2) and (1, 4) (the
        visible GPUs where there are enough, else cuda:0 repeated), fp32:
        phi4-mini-3.8b, mamba2-1.3b, zamba2-1.2b at 2 layers, mixtral-8x7b
        at 1 (its ring of 4096), two of deepseek-v3's dense MLA layers,
        llama-3.2-vision-11b at one cross group of one self layer,
        whisper-tiny whole; batch 4, the caches filled with seeded entries,
        each row from its own position, 8 teacher-forced steps against the
        unsharded step: (1, 1) bit for bit, else logits and final caches
        within 1e-5 rel L2 and the greedy tokens equal where the top-2
        margin exceeds 1e-3; every cache block in place, no cache byte
        copied; the weight bytes copied exactly the data axes' all-gather
        (0 on (1, m)); phi4-mini's and mixtral's sharded prefill within
        1e-5 of the forward; bytes copied and wall ms a step; the same
        steps in bf16 on (2, 2) and (1, 4) against the unsharded bf16 step
        (their spread); deepseek-v3's first dense and first MoE layer (256
        experts, 45.1 GB in fp32) likewise on (1, 1), (1, 2) and (1, 4),
        its blocks views of the unsharded tree (no bf16 spread; (2, 1) and
        (2, 2) do not fit one card);
     b. with four cards only: mixtral-8x7b at full depth on (1, 4) and
        (2, 2), deepseek-v3 at 12 layers (3 dense, 9 MoE) on (1, 4), bf16,
        served through ``SlotLoop`` and ``GreedyStep`` (12 requests of 4-16
        prompt tokens, 96 generated, batch 4, cache 128): tok/s, request
        p50 and p99, wall ms and GB copied a step (weights exactly the data
        axes' all-gather), peak GB a card placing, over the first steps and
        serving; one traced step's host waits; logits finite; mixtral's 8
        fp32 steps from one seeded cache on each mesh within 1e-5 rel L2 of
        each other (bf16's, a finding); on one card a line says it did not
        run.

``--sharded`` runs phases 10 and 10b alone (after the build), over the
visible GPUs where a mesh has enough (on four cards, every mesh of up to
four shards has a card a shard; the tuned path then carries no measured
config, as nothing was tuned), and writes ``chiprun_out/sharded.json``.
``--lm`` runs phases 11 and 12 alone (after the build) and writes
``chiprun_out/lm.json``; ``--lm-train`` runs phase 13 alone and writes
``chiprun_out/lm_train.json``; ``--lm-sharded`` runs phase 14 alone
(14e only on a host with four cards) and writes
``chiprun_out/lm_sharded.json``; ``--lm-serve-sharded`` runs phase 15
alone (15b only on a host with four cards) and writes
``chiprun_out/lm_serve_sharded.json``; ``--b4-candidates`` runs phase 3c alone and
writes ``chiprun_out/b4_candidates.json``.
``--sweep-b4``, ``--sweep-b7``, ``--sweep-b1`` and ``--sweep-b2`` time
B4's, B7's, B1's and B5's, and B2's and B6's geometries per layer instead
(each held bit for bit to the default) and write
``chiprun_out/b4_sweep.json``, ``b7_sweep.json``, ``b1_sweep.json`` and
``b2_sweep.json``.

The run keeps PyTorch's default TF32 flags: the port guards its own
float32 library calls (``repro_torch.core.precision``).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  A longer report goes to
``build/chip_smoke_report.json``.  Weights and images are random, from
numpy seeds (the LMs' weights from seeded ``torch.Generator``s).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.resnet18 import RESNET18, VGG16  # noqa: E402

# VGG-16's conv stack at 224x224 (VGG16 of repro_torch.configs): convs per
# stage and widths, (2, 2, 3, 3, 3) and (64, 128, 256, 512, 512)
VGG_STAGES = VGG16.stages
VGG_WIDTHS = VGG16.widths
IMAGE = VGG16.image_size
REQUEST_BATCHES = (1, 1, 1, 4)
FP_REQUEST_BATCHES = (1, 4)
ALGO = "sfc6_6"
# the 13 stride-1 depthwise 3x3 convs of MobileNetV2 at width 1.0 and
# 224x224 (Sandler et al. 2018, arXiv:1801.04381, Table 2), named by
# bottleneck block and repeat, as (name, H = W, C); its four stride-2
# depthwise convs are LOWERED_DW below.  Then the repo's own depthwise
# workload, dw3x3 of benchmarks/table3_throughput.py.
DW_LAYERS = (("mbv2_b1.1", 112, 32), ("mbv2_b2.2", 56, 144),
             ("mbv2_b3.2", 28, 192), ("mbv2_b3.3", 28, 192),
             ("mbv2_b4.2", 14, 384), ("mbv2_b4.3", 14, 384),
             ("mbv2_b4.4", 14, 384), ("mbv2_b5.1", 14, 384),
             ("mbv2_b5.2", 14, 576), ("mbv2_b5.3", 14, 576),
             ("mbv2_b6.2", 7, 960), ("mbv2_b6.3", 7, 960),
             ("mbv2_b7.1", 7, 960), ("dw3x3", 28, 256))
DW_BATCHES = (1, 4)
# the convs the lowering pass rewrites, at 224x224 and published widths:
# ResNet-18's 7x7/2 stem and 3x3/2 stage transitions
# (RESNET_LOWERED_LAYERS, benchmarks/table3_throughput.py), as (name,
# H = W, C_in, C_out, R); MobileNetV2's four stride-2 depthwise 3x3 convs
# (the first depthwise conv of bottleneck blocks 2, 3, 4 and 6), as (name,
# H = W, C); and one grouped conv, (name, H = W, C_in, C_out, groups)
LOWERED_LAYERS = (("stem7x7s2", 224, 3, 64, 7), ("s1tos2", 56, 64, 128, 3),
                  ("s2tos3", 28, 128, 256, 3), ("s3tos4", 14, 256, 512, 3))
LOWERED_DW = (("mbv2_b2.1", 112, 96), ("mbv2_b3.1", 56, 144),
              ("mbv2_b4.1", 28, 192), ("mbv2_b6.1", 14, 576))
LOWERED_GROUPED = (("g4_56", 56, 128, 128, 4),)
LOWERED_BATCHES = (1, 4)
DW_LOWERED_ALGO = "sfc4_4_r2"
# ResNet-18 (He et al. 2016, arXiv:1512.03385, Table 1; RESNET18 of
# repro_torch.configs): blocks per stage and widths
RESNET_STAGES = RESNET18.stages
RESNET_WIDTHS = RESNET18.widths
RESNET_BATCHES = (1, 4)
# H100 SXM peaks (NVIDIA data sheet, dense): HBM, int8 tensor cores, and
# float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
TIMED_RUNS = 25
SPIN_CYCLES = 20_000_000        # ~10 ms at the H100's clock; doubled on need
SERVE_REPEATS = 5
CHAIN_REPEATS = 25              # wall runs of each chain-cost quarter
# (algo, H = W, C_in, C_out, batch, padding): VGG-16 shapes, sfc6_7,
# sfc4_4, a ragged sfc6_6 case whose channel counts are no multiple of any
# block, the deepest layer at batch 4 (36 tiles, three groups of 16), and
# B4's other weight loaders: C_out 20 (no multiple of 8: weights copied by
# bytes, scales 16 bytes a copy) and C_out 13 (no multiple of 4: scales by
# single loads), the latter with wino4, whose (t, L, M) B4 takes at run
# time; then the lowered convs' dense sub-convs at their own shapes (VALID,
# the phase's input extent): sfc6_7_r2 at ResNet-18's 56x56 3x3/2
# transition (also at batch 4) and sfc6_6_r4 at its stem, both tiles B1,
# B5, B3 and B4 take at run time
KERNEL_CHECKS = (("sfc6_6", 224, 3, 64, 1, "SAME"),
                 ("sfc6_6", 56, 256, 256, 1, "SAME"),
                 ("sfc6_6", 14, 512, 512, 1, "SAME"),
                 ("sfc6_7", 56, 256, 256, 1, "SAME"),
                 ("sfc4_4", 28, 64, 128, 1, "SAME"),
                 ("sfc6_6", 13, 40, 24, 1, "SAME"),
                 ("sfc6_6", 14, 512, 512, 4, "SAME"),
                 ("sfc6_6", 13, 40, 20, 1, "SAME"),
                 ("wino4", 13, 40, 13, 1, "SAME"),
                 ("sfc6_7_r2", 29, 64, 128, 1, "VALID"),
                 ("sfc6_7_r2", 29, 64, 128, 4, "VALID"),
                 ("sfc6_6_r4", 115, 3, 64, 1, "VALID"))
# B4 at a geometry other than the per-layer default: 8 output channels
# per block, four of them sharing each transform, C_in split in two; bit
# for bit the same
B4_ALT = {"cout_block": 8, "n_share": 4, "k_split": 2}
# B7 and B6 checks, (algo, H = W, C, batch, padding): MobileNetV2 shapes
# at batch 1 and 4, sfc6_7, VALID padding, C 40 (no multiple of 16: B7
# loads by plain loads, not TMA), and wino4, whose (t, L, M) B7 takes at
# run time; B7 is held bit for bit to the staged B1 -> B6 -> B3 at the
# per-layer geometry, at B7_ALT (16 channels, runs of 4 tiles, some idle
# at a row's end, 3 threads a tile and channel) and at 24 channels a
# block (plain loads), on snapped and on raw inputs
DW_CHECKS = (("sfc6_6", 112, 32, 1, "SAME"), ("sfc6_6", 56, 144, 4, "SAME"),
             ("sfc6_7", 7, 960, 1, "SAME"), ("sfc6_6", 14, 384, 4, "VALID"),
             ("sfc4_4", 13, 40, 2, "VALID"), ("wino4", 13, 48, 1, "SAME"),
             # the strided depthwise convs' sub-convs at their own shapes:
             # sfc4_4_r2 at MobileNetV2's 112x112 C96 and 56x56 C144 (batch
             # 4), sfc4_5_r2 at 28x28 C192, tiles B1, B5, B3 and B7 take at
             # run time
             ("sfc4_4_r2", 57, 96, 1, "VALID"),
             ("sfc4_4_r2", 29, 144, 4, "VALID"),
             ("sfc4_5_r2", 15, 192, 1, "VALID"))
# each sub-algorithm of the lowered convs beside a compiled algorithm, on
# the same input, for the kernel times at the new tiles: sfc6_7_r2 (t 10,
# L 8) beside sfc6_6 (t 10, L 8: the same transform work), the others
# beside the 3x3 algorithm of the nearest tile
TILE_PAIRS = {"sfc6_7_r2": "sfc6_6", "sfc6_6_r4": "sfc6_6",
              "sfc4_4_r2": "sfc4_4", "sfc4_5_r2": "sfc4_4"}
B7_ALT = {"cout_block": 16, "tiles": 4, "splits": 3}
# B1 and B5 at a geometry other than the per-layer default: 18 channels a
# block (no multiple of 4: plain loads, not TMA, and a channel tail), runs
# of 3 tiles (some idle at a row's end), 3 threads a (tile, channel) (rows
# unevenly shared); bit for bit the same
B1_ALT = {"channel_block": 18, "tiles": 3, "splits": 3}
# B2's checks beyond VGG-16's layers, (T, K, N) at P = 100: one, 9 and 17
# tiles, K 3 and 40 (X by bytes), N 8, 24 and 520 (W by bytes, Y by
# floats); each at the per-layer geometry and at b2_alt's
B2_CHECKS = tuple((T, K, N) for T in (1, 9, 17)
                  for K, N in ((3, 8), (40, 24), (64, 520)))
# the direct path's checks under PyTorch's default TF32 flags: (label, x
# shape, w shape, stride, algo) of four "direct" plans: a 1x1 conv, a 3x3
# conv planned direct, a 3x3/2 conv planned direct, and the 1x1 phase of
# ResNet-18's 56x56 3x3/2 transition
DIRECT_CHECKS = (("1x1 56x56 256->128", (1, 56, 56, 256), (1, 1, 256, 128),
                  1, "auto"),
                 ("3x3 28x28 256->256 direct", (1, 28, 28, 256),
                  (3, 3, 256, 256), 1, "direct"),
                 ("3x3/2 56x56 128->256 direct", (1, 56, 56, 128),
                  (3, 3, 128, 256), 2, "direct"),
                 ("1x1 28x28 64->128, a lowered 3x3/2's direct phase",
                  (1, 28, 28, 64), (1, 1, 64, 128), 1, "auto"))
# B6's checks beyond the depthwise layers: C 3 and 20 (channels one at a
# time, a partial group) and 960, at 9 tiles; each at the per-layer
# geometry and at B6_ALT (3 groups, 5 lanes, runs of 2)
B6_CHECKS = (3, 20, 960)
B6_ALT = {"groups": 3, "lanes": 5, "run": 2}
# INT4_FREQ (4-bit activations and weights on the int8 carrier; the
# kernels take qmax at run time): (algo, H = W, C_in, C_out, batch) of a
# dense check (B1 and B4, B4 also bit for bit the staged path) and a
# depthwise one (C_out None: B7, bit for bit the staged depthwise path)
INT4_CHECKS = (("sfc6_6", 56, 64, 64, 1), ("sfc6_6", 56, 144, None, 1))
# phase 7, the serving path: VGG-16's third-stage 3x3 conv (256 -> 256,
# SAME, int8 sfc6_6) at the extents of 112, 168 and 224 px inputs
SERVE_C = 256
SERVE_BUCKETS = ((28, 28), (42, 42), (56, 56))
SERVE_MIX = ((24, 24), (28, 28), (36, 36), (42, 42), (48, 48), (56, 56))
SERVE_REQUESTS = 32
SERVE_MAX_BATCH = 8
SERVE_HOLD_MS = 2.0
# the measured windows: open-loop Poisson arrivals at each offered rate
# (requests/s), SERVE_WINDOW_REQUESTS each, images from a host pool of
# SERVE_POOL per shape; the first SERVE_WINDOW_CHECKED answers of each
# window are held bit for bit to their own plan.apply
SERVE_WINDOW_RATES = (500.0, 1000.0, 2000.0)
SERVE_WINDOW_REQUESTS = 3000
SERVE_POOL = 4
SERVE_WINDOW_CHECKED = 64
# phase 8, the paper's CNNs (repro_torch.models.cnn): VGG16 and RESNET18 at
# IMAGE and the widths above (1000 classes), weights from a torch.Generator
# seeded CNN_SEED on the card, CNN_BATCH N(0, 1) images; PTQ calibration on
# PTQ_CALIB_IMAGES images, deployment on PTQ_HELD_IMAGES others; the int8
# logits against fp32 within CNN_INT8_REL (rel L2, the JAX package's bound)
CNN_SEED = 1900
CNN_BATCH = 2
CNN_INT8_REL = 0.15
PTQ_CALIB_IMAGES = 4
PTQ_HELD_IMAGES = 2
CIFAR_REL = 1e-4               # CIFAR_RESNET18, card against CPU, rel L2
# benchmarks/appendixB_iterative.py's (kernel, inner (N, M, R), outer), and
# its bound on |y - direct correlation|
ITERATIVE_PAIRS = ((30, (6, 5, 5), (6, 6, 6)), (9, (4, 3, 3), (6, 7, 3)),
                   (24, (6, 4, 4), (6, 6, 6)))
ITERATIVE_BOUND = 1e-3
# phase 9, training on the card (repro_torch.train, the reference path and
# its autograd): RESNET18 at IMAGE and RESNET_WIDTHS (1000 classes) trained
# TRAIN_STEPS steps at batch TRAIN_BATCH in TRAIN_MODES, checkpointed every
# TRAIN_CKPT_EVERY steps, then again with a TransientError at FAULT_STEP
# (the resumed losses within RESUME_REL of the first run's); gradients on
# the card against CPU copies at batch GRAD_BATCH, fp32 within GRAD_TOL of
# max |g|, int8 within INT8_GRAD_REL rel L2 per leaf.  Then the paper's
# §6.1 experiment: CIFAR_RESNET18 trained CIFAR_STEPS steps at batch
# CIFAR_BATCH (the example's recipe), its loss down MIN_LOSS_DROP and its
# held-out accuracy (HELD_BATCHES batches from HELD_INDEX) at least
# MIN_HELD_ACC; its 13 native 3x3/1 convs PTQ-calibrated on CALIB_BATCHES
# batches from CALIB_INDEX and deployed on B4 and B1 -> B2 -> B3, within
# DEPLOY_REL of the simulation, argmax agreeing on MIN_ARGMAX_AGREE
TRAIN_SEED = 0
TRAIN_BATCH = 16
TRAIN_STEPS = 8
TRAIN_CKPT_EVERY = 4
FAULT_STEP = 6
TRAIN_MODES = (("direct", {"conv_algo": "direct"}),
               ("sfc6_6 int8", {"conv_algo": ALGO, "quant": "int8"}))
RESUME_REL = 1e-5
GRAD_BATCH = 2
GRAD_TOL = 1e-4
INT8_GRAD_REL = 1e-2
CIFAR_STEPS = 150
CIFAR_BATCH = 32
HELD_INDEX, HELD_BATCHES = 5000, 6
CALIB_INDEX, CALIB_BATCHES = 9000, 4
MIN_LOSS_DROP = 0.5
MIN_HELD_ACC = 0.5
DEPLOY_REL = 1e-3
# dynamic and static int8 networks are chaotic functions of their input:
# .5 ties flip (C4), and the rounding error the scale's gradient sums is
# re-drawn wherever activations move by a quantization step.  Where a
# network-level int8 comparison of two implementations is bounded, the
# bound is the stated one or CHAOS_FACTOR times the spread the reference
# shows when the images move by NUDGE (relative), whichever is larger
NUDGE = 1e-7
CHAOS_FACTOR = 3.0
LAYER_SIM_REL = 1e-4           # one conv, deployed against the simulation
MIN_ARGMAX_AGREE = 0.99
# phase 10, the sharded conv backend (repro_torch.distributed.conv_spmd,
# backend "cuda_spmd"): VGG-16's 13 convs, ResNet-18's 20 (stem and
# transitions lowered) and MobileNetV2's 13 stride-1 depthwise convs at
# SHARD_BATCH, IMAGE and published widths, over each (data, model) mesh of
# SHARD_MESHES (the visible GPUs where there are enough, else cuda:0
# repeated), on SHARD_PATHS; every output against the single-device cuda
# backend on the same input: int8 bit for bit, fp and direct bit for bit or
# within SHARD_FP_TOL (rel L2 and max |diff| / max |ref|, a finding);
# SHARD_SANITIZED meshes also at batch 1 (the data axis dropped); stack
# card and wall ms, medians of SHARD_RUNS
SHARD_MESHES = ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (1, 4))
SHARD_BATCH = 4
SHARD_PATHS = ("fused", "staged", "tuned", "fp", "direct")
SHARD_SANITIZED = ((2, 1), (2, 2))
SHARD_RUNS = 5
SHARD_FP_TOL = 1e-4
SHARD_SEED = 1100
# per conv, card ms sharded against one device: (net, path, mesh)
SHARD_PER_LAYER = ("vgg16", "fused", (2, 2))
# phase 11, the LM serving path (repro_torch.models, launch.serve), the
# chain off: the rank-1 conv at mamba2-1.3b's conv shapes (CONV1D_SHAPES:
# (B, T, C, R)); LM_ARCHS at their published widths and depths, weights
# from a torch.Generator seeded LM_SEED on the card, a prefill of
# LM_PREFILL (batch, tokens) in the configured compute dtype (bf16), then
# fp32 checks at full width with n_layers cut to LM_CHECK_LAYERS on
# LM_CHECK_T tokens (card against CPU copies LM_REL rel L2, teacher-forced
# decode against the forward LM_DECODE_ABS, use_sfc_conv True against False
# LM_SFC: max |diff| / (1 + |ref|)); at full depth the same three figures
# in bf16 (LM_BF16_T tokens for the CPU copy, LM_DECODE_T decode steps) as
# findings; launch.serve.main for each of LM_ARCHS with LM_SERVE_ARGS
# (LM_WARMED conv layers warmed); LM_SMOKE_ARCHS' smoke configs on the card
# against CPU copies in fp32
CONV1D_SHAPES = ((2, 512, 4352, 4), (2, 37, 4352, 4))
LM_ARCHS = ("mamba2-1.3b", "zamba2-1.2b", "phi4-mini-3.8b")
LM_SEED = 2200
LM_PREFILL = (2, 512)
LM_CHECK_LAYERS = 2
LM_CHECK_T = {"ssm": 272, "hybrid": 272, "dense": 96}
LM_BF16_T = 8
LM_DECODE_T = 16
LM_REL = 1e-4
LM_DECODE_ABS = 1e-3
LM_SFC = 1e-4
LM_RUNS = 5
LM_SPIN = SPIN_CYCLES << 5     # ~0.3 s: one LM call a spin
LM_SERVE_ARGS = ("--no-smoke", "--batch", "4", "--gen", "32", "--max-len",
                 "128", "--requests", "12")
LM_WARMED = {"mamba2-1.3b": 48, "zamba2-1.2b": 38, "phi4-mini-3.8b": 0}
LM_SMOKE_ARCHS = ("qwen3-14b", "qwen2.5-32b", "stablelm-3b")
# phase 3c (C12): B4 at sfc6_7's t = 12 with every default candidate over
# VGG-16's convs, inputs and weights seeded C12_SEED + layer
C12_ALGO = "sfc6_7"
C12_SEED = 2300
# phase 12, the moe, vlm and encdec families (A14), the chain off: each of
# LM12_ARCHS at its published width, at the depth LM12_DEPTH cuts it to
# (none: full depth) where one 80 GB card forces a cut, weights from a
# torch.Generator seeded 0 on the card: LM_SERVE_ARGS' requests through
# launch.serve (main at full depth; serve() on the cut config); a bf16
# prefill of LM_PREFILL with seeded vision embeddings (vlm) or frames
# (encdec, as many as tokens); fp32 checks at full width and LM12_CHECK's
# depth on LM12_CHECK_T tokens (card against CPU copies LM_REL rel L2, the
# lossless MoE decode against the lossless forward LM_DECODE_ABS), the vlm's
# gates set to LM12_GATES; the same two figures at the served depth in bf16
# (findings); the smoke configs card against CPU, the loss's terms too
LM12_ARCHS = ("deepseek-v3-671b", "mixtral-8x7b", "llama-3.2-vision-11b",
              "whisper-tiny")
LM12_DEPTH = {"deepseek-v3-671b": {"n_layers": 4},  # 3 dense + 1 MoE, MTP
              "mixtral-8x7b": {"n_layers": 4}}
LM12_CHECK = {"deepseek-v3-671b": {"n_layers": 2, "first_dense_layers": 1,
                                   "mtp_depth": 0},
              "mixtral-8x7b": {"n_layers": 2},
              "llama-3.2-vision-11b": {"n_layers": 4},
              "whisper-tiny": {}}
LM12_CHECK_T = {"deepseek-v3-671b": 16, "mixtral-8x7b": 64,
                "llama-3.2-vision-11b": 64, "whisper-tiny": 64}
LM12_GATES = {"gate": 0.5, "ffn_gate": -0.7}
LM12_SEED = 2400
# phase 13, LM training (A15), the chain off, deterministic algorithms on:
# 13a each of LM13_TRAIN (arch, depth cut, batch, sequence) at its published
# width trained LM13_STEPS steps (AdamW on a cosine schedule, bf16 compute)
# by make_train_step; LM13_REPLAY the same, then by the Trainer with a
# TransientError at step LM13_FAULT and a checkpoint at the last step, whose
# losses must replay the first run's bit for bit; 13b fp32 gradients at full width and LM13_GRAD's
# depth on LM13_GRAD_T tokens, card against a CPU copy: each leaf within
# LM13_REL rel L2, or, zero in exact arithmetic, within LM13_DEAD of the
# largest max |g|; the loss within LM13_LOSS; as the caller leaves TF32 and
# with it allowed; 13c LM13_REMAT's gradients with remat off, full and dots,
# bit for bit; 13d the flash attention backward at LM13_FLASH's shapes
# against autograd through the plain forward loop, LM13_FLASH_REL rel L2;
# 13e after a no_grad forward, the gradients bit for bit a fresh run's
LM13_TRAIN = (("mamba2-1.3b", {}, 2, 2048), ("zamba2-1.2b", {}, 2, 2048),
              ("whisper-tiny", {}, 8, 448),
              ("mixtral-8x7b", {"n_layers": 1}, 1, 5120))
# the Trainer's fault replay, on a state small enough to save in seconds
LM13_REPLAY = ("mamba2-1.3b", {"n_layers": 4}, 2, 2048)
LM13_STEPS = 5
LM13_FAULT = 3
LM13_LR = 3e-4
LM13_GRAD = {"mamba2-1.3b": {"n_layers": 2}, "zamba2-1.2b": {"n_layers": 2},
             "whisper-tiny": {}, "mixtral-8x7b": {"n_layers": 1}}
LM13_GRAD_T = 512
LM13_REL = 1e-4
LM13_DEAD = 1e-6
LM13_LOSS = 1e-5
LM13_REMAT = ("mamba2-1.3b", {"n_layers": 8}, 2, 2048)
# (name, batch, sequence, kv heads, groups, head dim, window)
LM13_FLASH = (("zamba2-1.2b", 2, 2048, 32, 1, 64, 0),
              ("mixtral-8x7b", 1, 5120, 8, 4, 128, 4096))
LM13_FLASH_REL = 1e-5
LM13_SEED = 2500
# phase 14, the sharded LM train step (A16) and elastic restore (A17), the
# chain off, deterministic algorithms on; meshes from make_forced_host_mesh
# (the visible GPUs where there are enough, else cuda:0 repeated).  14a
# fp32 gradients and one AdamW step (lr LM14_LR) of each LM14_ARCHS at full
# width and its depth cut, batch LM14_BATCH, on each of LM14_MESHES, against
# the single-device step on the same card (data_shards = the data axis's
# size), compared on the host: the loss within LM14_LOSS, each leaf within
# LM13_REL rel L2 (dead leaves LM13_DEAD), the new parameters within
# LM14_UPDATE (a leaf the step moves by more than LM14_MOVED of its norm
# has its step held within LM14_STEP_REL instead; where 'model' cuts the
# mesh, over the elements whose clipped reference gradient exceeds
# LM14_NEAR_EPS times AdamW's eps, with the worst element and the
# whole leaf's distance logged); on (1, 1) the loss and gradients bit for
# bit; every block on its
# device with its spec's shape; each weight block computed where it lies:
# the weight bytes a step copies exactly lm14_reckoned (the data axes'
# all-gather, a rematerialised layer's twice; 0 on one data row), and the
# step's wall ms and activation bytes logged; LM14_MB_CELL microbatched
# (mb 2) against the unsharded microbatched step and LM14_GC_CELL's int8
# compressed gradients ((1, 1) bit for bit the unsharded compressed step's,
# elsewhere within one int8 step, 1.01 max |g| / 127, of the uncompressed
# ones, and a second run bit for bit).  14b mixtral's MoE block over a (2, 1)
# mesh's shards bit for bit one device with data_shards 2.  14c LM14_ELASTIC
# saved from (2, 2), restored onto (4, 1) and (1, 1) bit for bit, read by a
# CPU subprocess in the on-disk format the JAX package's reader reads; a
# sharded Trainer of LM14_TRAINER_STEPS with a fault at LM13_FAULT replays
# bit for bit.  14d pipeline_apply over LM14_PIPE's stages against the
# sequential stack on the same microbatches, LM14_PIPE_REL (on the whole
# batch, LM13_REL).  14e (four cards only) LM14_BIG at full depth, LM14_BIG_STEPS
# bf16 steps at LM14_BIG_BATCH on LM14_BIG_MESHES: step wall ms, one traced
# step's busy ms a card, bytes copied a step, peak a card; on (1, 4) two
# steps from one state bit for bit (the gradients of a tensor four cards'
# backward threads take, summed in one order).
LM14_ARCHS = (("mamba2-1.3b", {"n_layers": 2}),
              ("zamba2-1.2b", {"n_layers": 2}),
              ("mixtral-8x7b", {"n_layers": 1}),
              # one cross group of one self layer: the group of the
              # published 4 beside the reference does not fit one card
              ("llama-3.2-vision-11b", {"n_layers": 1,
                                        "cross_attn_every": 1}),
              ("whisper-tiny", {}),
              ("phi4-mini-3.8b", {"n_layers": 2}))
LM14_MESHES = ((1, 1), (2, 1), (1, 2), (2, 2), (1, 4))
LM14_BATCH = (2, 512)
LM14_LR = 1e-4
LM14_LOSS = 1e-5
LM14_UPDATE = 1e-5
LM14_MOVED = 1e-2
LM14_STEP_REL = 1e-3
# AdamW's first step is lr g / (|g| + eps) an element, whose derivative
# eps / (|g| + eps)^2 is at most 1 / ((K + 1)^2 eps) where |g| >= K eps:
# with K 100 a rounding difference of 1e-7 in g moves such an element's
# step by at most 1e-3 lr, while below it the row blocks' partial sums
# can turn an element's step round (one element of mixtral's router on
# (1, 2) moves the leaf's step 1/181 of its norm)
LM14_NEAR_EPS = 100.0
LM14_CHUNK = 1 << 24
LM14_ELASTIC = ("whisper-tiny", {}, 2, 448)      # a 0.7 GB state
LM14_TRAINER_STEPS = 4
LM14_PIPE = ("mamba2-1.3b", 8, 4, (4, 512), 4)   # layers, stages, batch, M
LM14_PIPE_REL = 1e-5
LM14_BIG = (("stablelm-3b", {}), ("phi4-mini-3.8b", {}))
LM14_BIG_MESHES = ((4, 1), (2, 2), (1, 4))
LM14_BIG_BATCH = (4, 2048)
LM14_BIG_STEPS = 5
LM14_SEED = 2600
# 14a's bf16 step: LM14_BF16 (fp32 parameters, bf16 compute) at batch
# LM14_BATCH on one card against the unsharded bf16 step: on (1, 2) and
# (2, 1) the loss within LM14_BF16_LOSS and each gradient leaf within
# LM14_BF16_GRAD rel L2 (the blocks' and rows' bf16 products round
# otherwise)
LM14_BF16 = ("stablelm-3b", {"n_layers": 4})
LM14_BF16_LOSS = 1e-3
LM14_BF16_GRAD = 5e-2
# 14a's microbatched and compressed cells: fp32, (arch, cut, batch,
# meshes); the microbatched step's chunks of 2 rows split over the data
# rows
LM14_MB_CELL = ("stablelm-3b", {"n_layers": 4}, (4, 512),
                ((1, 1), (2, 2), (1, 4)))
LM14_GC_CELL = ("stablelm-3b", {"n_layers": 4}, (2, 512),
                ((1, 1), (2, 2), (1, 4)))
# phase 15, sharded LM serving (A16's serving half), the chain off: 15a each
# of LM15_ARCHS at its published width and its depth cut, fp32 parameters
# and compute under the full-fp32 matmul guard, batch LM15_BATCH, its cache
# of LM15_MAX_LEN filled with seeded N(0, 1) entries (SSM states too; the
# cross K/V as init_cache computes them from seeded memory), each row from
# its own position (LM15_STARTS: LM15_STEPS steps cross every 'model' block
# edge, mixtral's ring of 4096 wraps), LM15_STEPS teacher-forced steps on
# each of LM15_MESHES (the visible GPUs where there are enough, else cuda:0
# repeated) against the unsharded decode_step on the card: (1, 1) bit for
# bit (logits, final cache); elsewhere each step's logits and each final
# cache entry, gathered, within LM15_REL rel L2, and the greedy tokens equal
# wherever the unsharded top-2 margin exceeds LM15_MARGIN; the weight bytes
# copied a step exactly the data axes' all-gather (lm15_reckoned: 0 on one
# data row, each block computing where it lies); LM15_PREFILL's
# archs' sharded prefill within LM15_REL of model.forward (its MoE dispatch
# in the mesh's data rows' chunks); bytes copied and wall ms a step; the
# same steps in bf16 compute on LM15_BF16_MESHES against the unsharded bf16
# step (findings: the spread); LM15_MOE likewise on its meshes.  15b (four
# cards only) LM15_BIG at full depth (or as cut), bf16, served through
# SlotLoop + GreedyStep (LM15_SERVE): tok/s, request p50 and p99, wall ms,
# GB copied a step against lm15_reckoned, peak GB a card after placement,
# over the first steps and over the serving, one traced step's host waits;
# logits finite; where an arch has two meshes, LM15_STEPS teacher-forced
# steps from one seeded cache on each, in fp32 within LM15_REL rel L2 of
# each other (in bf16 a finding: at depth bf16 rounding flips MoE routes
# and the meshes part chaotically, as the unsharded bf16 step does).
LM15_ARCHS = (("phi4-mini-3.8b", {"n_layers": 2}),
              ("mamba2-1.3b", {"n_layers": 2}),
              ("zamba2-1.2b", {"n_layers": 2}),   # one shared invocation
              ("mixtral-8x7b", {"n_layers": 1}),
              # two of its dense MLA layers, as the dense family, on every
              # mesh (its MoE layer: LM15_MOE)
              ("deepseek-v3-671b", {"family": "dense", "n_layers": 2,
                                    "first_dense_layers": 0,
                                    "mtp_depth": 0}),
              ("llama-3.2-vision-11b", {"n_layers": 1,
                                        "cross_attn_every": 1}),
              ("whisper-tiny", {}))
LM15_MESHES = ((1, 1), (2, 1), (1, 2), (2, 2), (1, 4))
# deepseek-v3's first dense layer and its first MoE layer (256 experts:
# 45.1 GB of fp32 experts, 54.4 GB the tree), its placed blocks views of
# the unsharded tree where a block is a contiguous slice (the experts over
# 'model'), so one card holds the layer once; the meshes of one data row
LM15_MOE = ("deepseek-v3-671b", {"n_layers": 2, "first_dense_layers": 1,
                                 "mtp_depth": 0}, ((1, 1), (1, 2), (1, 4)))
LM15_MOE_NOT_RUN = {
    "meshes": [[2, 1], [2, 2]],
    "why": "a data row's all-gather of the layer's model block over 'data' "
           "(45.1 GB on (2, 1), 22.6 GB on (2, 2)) and the data-cut blocks' "
           "own copies do not fit one card beside the 54.4 GB tree; nor "
           "does the unsharded bf16 step's 27 GB compute copy (no bf16 "
           "spread)"}
LM15_BF16_MESHES = ((2, 2), (1, 4))
LM15_BATCH = 4
LM15_STEPS = 8
LM15_MAX_LEN = {"mixtral-8x7b": 4096}          # the ring's length
LM15_LEN = 256
LM15_STARTS = {"mixtral-8x7b": (1020, 2044, 3068, 4094)}
LM15_START = (60, 124, 188, 240)
LM15_PREFILL = (("phi4-mini-3.8b", 64), ("mixtral-8x7b", 64))
LM15_REL = 1e-5
LM15_MARGIN = 1e-3
LM15_BIG = (("mixtral-8x7b", {}, ((1, 4), (2, 2))),
            # 3 dense + 9 MoE layers, 212 GB of bf16: ~53 GB of blocks a
            # card; the MoE layer init_params draws whole (22.5 GB) sits on
            # cuda:0 beside its blocks while it is placed
            ("deepseek-v3-671b", {"n_layers": 12, "mtp_depth": 0},
             ((1, 4),)))
LM15_SERVE = {"batch": 4, "max_len": 128, "requests": 12, "gen": 96,
              "prompts": (4, 16)}
LM15_BIG_STARTS = (28, 60, 92, 110)      # 8 steps cross 32, 64 and 96
LM15_BIG_PREFILL = (4, 128)              # 15b's prefill: batch, tokens
LM15_SEED = 2700
# phase 14c's reader of a checkpoint as the JAX package's Checkpointer reads
# it (manifest, digest, keys, bf16 as uint16 bits), in a CPU subprocess of
# numpy alone: argv[1] the step directory, argv[2] the gathered state's npz
JAX_FORMAT_READER = """
import hashlib, json, pathlib, sys
import numpy as np
d, ref = pathlib.Path(sys.argv[1]), np.load(sys.argv[2])
manifest = json.loads((d / "manifest.json").read_text())
raw = (d / "arrays.npz").read_bytes()
if hashlib.sha256(raw).hexdigest() != manifest["sha256"]:
    raise SystemExit("digest mismatch")
data = np.load(d / "arrays.npz")
keys = sorted(k.replace("|", "/") for k in data.files)
if keys != manifest["keys"] or keys != sorted(
        k.replace("|", "/") for k in ref.files):
    raise SystemExit("keys differ")
bf16 = 0
for k in keys:
    a, want = data[k.replace("/", "|")], ref[k.replace("/", "|")]
    if list(a.shape) != manifest["shapes"][k]:
        raise SystemExit(f"{k}: shape")
    if manifest["dtypes"][k] == "bfloat16":
        bf16 += 1
        if a.dtype != np.uint16:
            raise SystemExit(f"{k}: bfloat16 not stored as uint16")
    elif str(a.dtype) != manifest["dtypes"][k]:
        raise SystemExit(f"{k}: dtype")
    if a.dtype != want.dtype or a.tobytes() != want.tobytes():
        raise SystemExit(f"{k}: values")
print(f"{len(keys)} arrays ({bf16} bf16) by the manifest's keys, shapes, "
      f"dtypes and digest, bit for bit the gathered state")
"""
# examples/train_cnn_sfc_torch.py's accuracy table: (row, config changes)
ACCURACY_ROWS = (
    ("direct fp32", {}),
    ("direct int8", {"quant": "int8", "conv_algo": "direct"}),
    ("SFC-6(6x6,3x3) int8", {"conv_algo": "sfc6_6", "quant": "int8"}),
    ("SFC-6(7x7,3x3) int8", {"conv_algo": "sfc6_7", "quant": "int8"}),
    ("SFC-6 int6", {"conv_algo": "sfc6_6", "quant": "int6"}),
    ("Wino(4x4,3x3) int8", {"conv_algo": "wino4", "quant": "int8"}),
    ("Wino(4x4,3x3) int6", {"conv_algo": "wino4", "quant": "int6"}))
REPLACES = {
    "sfc_transform_quantize": ("src/repro_torch/csrc/sfc_transform.cu",
                               "src/repro/kernels/sfc_transform.py:36"),
    "tdmm_int8": ("src/repro_torch/csrc/sfc_tdmm.cu",
                  "src/repro/kernels/sfc_tdmm.py:41"),
    "sfc_inverse": ("src/repro_torch/csrc/sfc_inverse.cu",
                    "src/repro/kernels/sfc_inverse.py:20"),
    "sfc_fused_conv2d": ("src/repro_torch/csrc/sfc_fused.cu",
                         "src/repro/kernels/sfc_fused.py:490"),
    "sfc_transform": ("src/repro_torch/csrc/sfc_transform.cu",
                      "src/repro/kernels/sfc_transform.py:26"),
    "tdmm_int8_depthwise": ("src/repro_torch/csrc/sfc_tdmm_dw.cu",
                            "src/repro/kernels/sfc_tdmm.py:71"),
    "sfc_fused_conv2d_depthwise": ("src/repro_torch/csrc/sfc_fused_dw.cu",
                                   "src/repro/kernels/sfc_fused.py:600"),
}


def only(times=1, **counts):
    """Launches of one forward: the named kernels, each other kernel 0."""
    return {k: counts.get(k, 0) * times for k in REPLACES}


N_VGG = sum(VGG_STAGES)
# what one forward of each path launches
EXPECTED = {
    "vgg_fused": only(sfc_fused_conv2d=N_VGG),
    "vgg_staged": only(sfc_transform_quantize=N_VGG, tdmm_int8=N_VGG,
                       sfc_inverse=N_VGG),
    "vgg_fp": only(sfc_transform=N_VGG, sfc_inverse=N_VGG),
    "dw_fused": only(sfc_fused_conv2d_depthwise=1),
    "dw_staged": only(sfc_transform_quantize=1, tdmm_int8_depthwise=1,
                      sfc_inverse=1),
    "dw_fp": only(sfc_transform=1, sfc_inverse=1),
}
# per layer on the same input: (rel L2, max |diff| / max |ref|) bounds
BOUNDS = {"int8": (1e-4, 1e-2), "fp": (1e-4, 1e-4)}


def vgg_layers():
    """(name, H, C_in, C_out) of VGG-16's 13 convs, and the stage ends."""
    layers, ends, cin, hw = [], [], 3, IMAGE
    for si, (n, width) in enumerate(zip(VGG_STAGES, VGG_WIDTHS)):
        for ci in range(n):
            layers.append((f"s{si}c{ci}", hw, cin, width))
            cin = width
        ends.append(len(layers) - 1)
        hw //= 2
    return layers, set(ends)


def resnet_convs():
    """(name, R, stride, H = W of its input, C_in, C_out) of ResNet-18's 20
    convs in forward order: the 7x7/2 stem, then per basic block conv1
    (3x3/2 where a stage opens), conv2 and, where the block changes width,
    the 1x1 projection of the shortcut (src/repro/models/cnn.py,
    init_resnet)."""
    convs = [("stem", 7, 2, IMAGE, 3, RESNET_WIDTHS[0])]
    hw, cin = IMAGE // 4, RESNET_WIDTHS[0]      # after the 3x3/2 max-pool
    for si, (n, width) in enumerate(zip(RESNET_STAGES, RESNET_WIDTHS)):
        for bi in range(n):
            stride = 2 if bi == 0 and si > 0 else 1
            name = f"s{si}b{bi}"
            out = -(-hw // stride)
            convs.append((f"{name}.conv1", 3, stride, hw, cin, width))
            convs.append((f"{name}.conv2", 3, 1, out, width, width))
            if stride != 1 or cin != width:
                convs.append((f"{name}.proj", 1, stride, hw, cin, width))
            hw, cin = out, width
    return convs


def resnet_forward(x, conv):
    """ResNet-18's conv stack as ``resnet_forward`` (src/repro/models/
    cnn.py) runs it, normalization and head left out: ReLU after the stem,
    a 3x3/2 SAME max-pool, basic blocks with ReLU and residual adds;
    ``conv(name, h)`` runs one conv."""
    import torch

    from repro_torch.models.cnn import max_pool_same
    h = torch.relu(conv("stem", x))
    h = max_pool_same(h, 3, 2)
    for si, n in enumerate(RESNET_STAGES):
        for bi in range(n):
            name = f"s{si}b{bi}"
            y = torch.relu(conv(f"{name}.conv1", h))
            y = conv(f"{name}.conv2", y)
            sc = conv(f"{name}.proj", h) if si > 0 and bi == 0 else h
            h = torch.relu(y + sc)
    return h


def log(*args):
    print(*args, flush=True)


@contextlib.contextmanager
def conv_inputs(params):
    """Record ``(name, x, w, b, stride)`` of every conv a forward of
    ``repro_torch.models.cnn`` runs through its ``conv_apply``, named by
    the weight's place in ``params`` (``s0c1``, ``s1b0.conv1``, ...)."""
    from repro_torch.models import cnn

    def names(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from names(v, prefix + k + ".")
            elif k == "w":
                yield id(v), prefix[:-1]

    by_id, seen, conv_apply = dict(names(params)), [], cnn.conv_apply

    def recording(x, w, b, cfg, stride=1, qhook=None):
        seen.append((by_id[id(w)], x, w, b, stride))
        return conv_apply(x, w, b, cfg, stride=stride, qhook=qhook)

    cnn.conv_apply = recording
    try:
        yield seen
    finally:
        cnn.conv_apply = conv_apply


def profile_forward(fn):
    """One ``fn`` call under ``torch.profiler``: the card's kernels by name
    and count, its busy time (the kernels' summed durations), the device
    span and the wall time; ``not_measured`` where the profiler does not
    trace the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        spans = [(e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    except Exception as e:     # the profiler may not trace this card
        return {"not_measured": f"{type(e).__name__}: {e}"[:200]}
    if not spans:
        return {"not_measured": "the trace holds no device events"}
    by_name = {}
    for start, end, kname in spans:
        n, us = by_name.get(kname, (0, 0.0))
        by_name[kname] = (n + 1, us + end - start)
    busy = sum(end - start for start, end, _ in spans)
    span = max(e for _, e, _ in spans) - min(s for s, _, _ in spans)
    return {"kernels": {k: {"count": n, "us": us}
                        for k, (n, us) in sorted(by_name.items())},
            "busy_us": busy, "device_span_us": span, "wall_us": wall_us,
            "busy_share_of_span": busy / span if span else None,
            "busy_share_of_wall": busy / wall_us}


def tree_to(tree, device):
    """A nested parameter dict with every tensor copied to ``device``."""
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def rel_l2(y, ref) -> float:
    return ((y - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def paper_cnns(dev, counted, held) -> dict:
    """Phase 8: the paper's CNNs through ``repro_torch.models.cnn`` on the
    card (8a), their native 3x3/1 convs PTQ-calibrated and deployed through
    B4 and B1 -> B2 -> B3 (8b), iterative SFC (8c).  Raises on any miss;
    returns the phase's report."""
    import torch

    from repro_torch.api import ConvSpec, lowering, plan, tuning
    from repro_torch.configs import CIFAR_RESNET18
    from repro_torch.core import iterative
    from repro_torch.core.generator import generate_sfc
    from repro_torch.models import cnn
    from repro_torch.quant import INT8_FREQ, PTQLayer

    out = {"forwards": [], "cifar": [], "ptq": [], "iterative": []}
    nets = {
        "vgg16": (dataclasses.replace(VGG16, widths=VGG_WIDTHS,
                                      image_size=IMAGE),
                  cnn.init_vgg, cnn.vgg_forward),
        "resnet18": (dataclasses.replace(RESNET18, widths=RESNET_WIDTHS,
                                         image_size=IMAGE),
                     cnn.init_resnet, cnn.resnet_forward)}
    modes = {"direct": {"conv_algo": "direct"},
             "sfc6_6": {"conv_algo": ALGO},
             "sfc6_6 int8": {"conv_algo": ALGO, "quant": "int8"}}

    def images(seed, n, size=IMAGE):
        return torch.tensor(np.random.RandomState(seed).randn(
            n, size, size, 3), dtype=torch.float32, device=dev)

    def reference_only(what, fn):
        """One no-grad forward that must launch no kernel of the port."""
        with torch.no_grad():
            return counted("cnn_reference", what, fn, want=only())

    def timings(fn):
        """Median wall ms of SERVE_REPEATS synchronised calls, and the card's
        busy ms and kernel launches of one call from torch.profiler's
        trace.  A reference forward launches hundreds of kernels, so calls
        queued behind a spin (``timed``) would overrun the card's launch
        queue and time the host's gaps."""
        def call():
            with torch.no_grad():
                fn()
        walls = []
        for _ in range(SERVE_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        prof = profile_forward(call)
        if "not_measured" in prof:
            return {"wall_ms": statistics.median(walls),
                    "card_busy_ms": "not measured: " + prof["not_measured"]}
        return {"wall_ms": statistics.median(walls),
                "card_busy_ms": prof["busy_us"] / 1e3,
                "device_span_ms": prof["device_span_us"] / 1e3,
                "kernels": sum(v["count"] for v in prof["kernels"].values())}

    # -- 8a. the models at full width, reference backend --------------------
    x = images(CNN_SEED, CNN_BATCH)
    params = {}
    for net, (cfg0, init, fwd) in nets.items():
        params[net] = init(torch.Generator(device=dev).manual_seed(CNN_SEED),
                           cfg0, device=dev)
        logits = {}
        for mode, kw in modes.items():
            cfg = dataclasses.replace(cfg0, **kw)
            y = reference_only(f"{net} {mode}",
                               lambda: fwd(params[net], cfg, x))
            if y.shape != (CNN_BATCH, cfg.n_classes) \
                    or not torch.isfinite(y).all():
                raise AssertionError(f"cnn: {net} {mode}: logits "
                                     f"{tuple(y.shape)} not finite "
                                     f"({CNN_BATCH}, {cfg.n_classes})")
            t = timings(lambda: fwd(params[net], cfg, x))
            logits[mode] = y
            out["forwards"].append({"net": net, "mode": mode, **t})
            card = (f"card busy {t['card_busy_ms']:.3f} ms of a "
                    f"{t['device_span_ms']:.3f} ms device span, "
                    f"{t['kernels']} kernels (one traced call)"
                    if "kernels" in t else f"card busy {t['card_busy_ms']}")
            log(f"cnn: {net} {mode} batch {CNN_BATCH} at {IMAGE}x{IMAGE}, "
                f"reference backend, no kernel of the port launched: "
                f"{t['wall_ms']:.3f} ms wall (median of {SERVE_REPEATS}); "
                f"{card}")
        fp_rel = rel_l2(logits["sfc6_6"], logits["direct"])
        if not torch.allclose(logits["sfc6_6"], logits["direct"], rtol=1e-3,
                              atol=1e-3):
            raise AssertionError(f"cnn: {net} fp32 sfc6_6 against direct: "
                                 f"rel L2 {fp_rel}, outside rtol = atol = "
                                 f"1e-3")
        q_rel = rel_l2(logits["sfc6_6 int8"], logits["sfc6_6"])
        if not q_rel < CNN_INT8_REL:
            raise AssertionError(f"cnn: {net} int8 logits against fp32: rel "
                                 f"L2 {q_rel} (bound {CNN_INT8_REL})")
        row = {"net": net, "fp32_sfc_vs_direct_rel_l2": fp_rel,
               "int8_vs_fp32_rel_l2": q_rel}
        log(f"cnn: {net}: fp32 sfc6_6 against direct rel L2 {fp_rel:.3e} "
            f"(held to rtol = atol = 1e-3); dynamic int8 sfc6_6 against "
            f"fp32 rel L2 {q_rel:.4e} (bound {CNN_INT8_REL})")
        if net == "resnet18":
            cfg = dataclasses.replace(cfg0, conv_algo=ALGO)
            with lowering.disabled():
                y_pre = reference_only("resnet18 lowering disabled",
                                       lambda: fwd(params[net], cfg, x))
            low_rel = rel_l2(logits["sfc6_6"], y_pre)
            if not torch.allclose(logits["sfc6_6"], y_pre, rtol=1e-3,
                                  atol=1e-3):
                raise AssertionError(f"cnn: resnet18 lowered against "
                                     f"lowering disabled: rel L2 {low_rel}")
            row["lowered_vs_disabled_rel_l2"] = low_rel
            log(f"cnn: resnet18 fp32 sfc6_6, lowered against lowering "
                f"disabled: rel L2 {low_rel:.3e} (held to 1e-3)")
        out.setdefault("accuracy", []).append(row)
    # CIFAR_RESNET18 on the card and on CPU copies of its inputs
    cx = images(CNN_SEED + 1, CNN_BATCH, CIFAR_RESNET18.image_size)
    cp = cnn.init_resnet(torch.Generator(device=dev).manual_seed(CNN_SEED),
                         CIFAR_RESNET18, device=dev)
    cp_cpu, cx_cpu = tree_to(cp, "cpu"), cx.cpu()
    for algo in ("direct", ALGO):
        cfg = dataclasses.replace(CIFAR_RESNET18, conv_algo=algo)
        y = reference_only(f"cifar {algo}",
                           lambda: cnn.resnet_forward(cp, cfg, cx))
        with torch.no_grad():
            y_cpu = cnn.resnet_forward(cp_cpu, cfg, cx_cpu)
        r = rel_l2(y.cpu(), y_cpu)
        if not r <= CIFAR_REL:
            raise AssertionError(f"cnn: CIFAR_RESNET18 {algo}: card against "
                                 f"CPU rel L2 {r} (bound {CIFAR_REL})")
        out["cifar"].append({"algo": algo, "card_vs_cpu_rel_l2": r})
        log(f"cnn: CIFAR_RESNET18 {algo}: card against CPU rel L2 {r:.3e} "
            f"(bound {CIFAR_REL})")

    # -- 8b. PTQ deployment through the kernels -----------------------------
    calib = images(CNN_SEED + 2, PTQ_CALIB_IMAGES)
    held_x = images(CNN_SEED + 3, PTQ_HELD_IMAGES)
    fused_want = only(sfc_fused_conv2d=1)
    staged_want = only(sfc_transform_quantize=1, tdmm_int8=1, sfc_inverse=1)
    lowered_checked = []
    for net, (cfg0, _, fwd) in nets.items():
        # each conv's input: the fp32 activation of the model's own
        # forward, on the calibration and on the held-out images
        cfg = dataclasses.replace(cfg0, conv_algo="direct")
        with torch.no_grad(), conv_inputs(params[net]) as seen:
            fwd(params[net], cfg, calib)
            fwd(params[net], cfg, held_x)
        half = len(seen) // 2
        for (name, xc, w, b, stride), (_, xh, _, _, _) in zip(seen[:half],
                                                             seen[half:]):
            if w.shape[0] != 3:
                continue               # the 7x7 stem, the 1x1 projections
            if stride != 1:
                # planned as the model's forward plans it (the reference
                # backend, whose lowering no card timing steers)
                spec_q = ConvSpec.for_conv2d(tuple(xh.shape), tuple(w.shape),
                                             stride=stride, quant=INT8_FREQ)
                p = plan(spec_q, backend="reference", algo=ALGO)
                if p.path != "lowered":
                    raise AssertionError(f"ptq: {net} {name} planned "
                                         f"{p.path}, not lowered")
                try:
                    PTQLayer(INT8_FREQ).prepare(p, w)
                except NotImplementedError:
                    lowered_checked.append(f"{net} {name}")
                    continue
                raise AssertionError(f"ptq: PTQLayer.prepare took the "
                                     f"lowered {net} {name}")
            layer = PTQLayer(INT8_FREQ)
            fp_spec = ConvSpec.for_conv2d(tuple(xc.shape), tuple(w.shape))
            with torch.no_grad():
                plan(fp_spec, backend="reference", algo=ALGO).apply(
                    xc, w, bias=b, elementwise_hook=layer.calibration_hook())
            spec_q = ConvSpec.for_conv2d(tuple(xh.shape), tuple(w.shape),
                                         quant=INT8_FREQ)
            p = plan(spec_q, backend="cuda", algo=ALGO)
            if p.path != "fast" or p.algo_name != ALGO:
                raise AssertionError(f"ptq: {net} {name} planned {p.path} "
                                     f"{p.algo_name}")
            prep = layer.prepare(p, w)
            fused, staged = (p.with_config(tuning.DEFAULT_FUSED),
                             p.with_config(tuning.DEFAULT_STAGED))
            y = counted("ptq_fused", f"{net} {name}",
                        lambda: fused.apply(xh, prep, bias=b),
                        want=fused_want)
            y_staged = counted("ptq_staged", f"{net} {name}",
                               lambda: staged.apply(xh, prep, bias=b),
                               want=staged_want)
            if not torch.equal(y, y_staged):
                raise AssertionError(f"ptq: {net} {name}: the fused and the "
                                     f"staged deployment differ")
            with torch.no_grad():
                p_ref = plan(spec_q, backend="reference", algo=ALGO)
                y_ref = p_ref.apply(xh, layer.prepare(p_ref, w), bias=b)
                y_sim = plan(ConvSpec.for_conv2d(tuple(xh.shape),
                                                 tuple(w.shape)),
                             backend="reference", algo=ALGO).apply(
                    xh, w, bias=b, elementwise_hook=layer.quantized_hook())
                y_fp = plan(ConvSpec.for_conv2d(tuple(xh.shape),
                                                tuple(w.shape)),
                            backend="reference", algo="direct").apply(
                    xh, w, bias=b)
            ref_rel, ref_scaled = held(f"ptq {net} {name} against the "
                                       f"reference deployment", y, y_ref,
                                       "int8")
            sim_rel, sim_scaled = held(f"ptq {net} {name} against the "
                                       f"quantized_hook simulation", y,
                                       y_sim, "int8")
            fp_rel = rel_l2(y, y_fp)
            out["ptq"].append({
                "net": net, "layer": name, "hw": xh.shape[1],
                "cin": w.shape[2], "cout": w.shape[3],
                "vs_reference_rel_l2": ref_rel,
                "vs_reference_scaled_max": ref_scaled,
                "vs_simulation_rel_l2": sim_rel,
                "vs_simulation_scaled_max": sim_scaled,
                "vs_fp32_direct_rel_l2": fp_rel})
            log(f"ptq: {net} {name} {xh.shape[1]}x{xh.shape[2]} "
                f"{w.shape[2]}->{w.shape[3]}: int8 deployment (B4 = B1 -> "
                f"B2 -> B3 bit for bit) against fp32 direct rel L2 "
                f"{fp_rel:.4e}; against the reference deployment "
                f"{ref_rel:.2e}, the quantized_hook simulation {sim_rel:.2e}")
    if not lowered_checked:
        raise AssertionError("ptq: no lowered conv was offered to PTQLayer")
    log(f"ptq: PTQLayer.prepare raised NotImplementedError on the lowered "
        f"{', '.join(lowered_checked)}")
    for net in nets:
        rows = [r for r in out["ptq"] if r["net"] == net]
        log(f"ptq: {net}: {len(rows)} native 3x3/1 convs calibrated on "
            f"{PTQ_CALIB_IMAGES} images and deployed on {PTQ_HELD_IMAGES}; "
            f"int8 against fp32 direct rel L2 "
            f"{min(r['vs_fp32_direct_rel_l2'] for r in rows):.4e} to "
            f"{max(r['vs_fp32_direct_rel_l2'] for r in rows):.4e}")
    out["lowered_rejected"] = lowered_checked

    # -- 8c. iterative SFC (Appendix B) on the card -------------------------
    for ksize, inner_nmr, outer_nmr in ITERATIVE_PAIRS:
        inner, outer = generate_sfc(*inner_nmr), generate_sfc(*outer_nmr)
        rng = np.random.RandomState(0)
        Rw, Mt = inner.R * outer.R, inner.M * outer.M
        xs = rng.randn(Mt + Rw - 1).astype(np.float32)
        ws = rng.randn(Rw).astype(np.float32)
        y = iterative.iterative_conv1d(torch.tensor(xs, device=dev),
                                       torch.tensor(ws, device=dev),
                                       inner, outer)
        if y.device != dev or y.shape != (Mt,):
            raise AssertionError(f"iterative: {ksize}: {y.shape} on "
                                 f"{y.device}")
        ref = np.array([(xs[m:m + Rw].astype(np.float64) * ws).sum()
                        for m in range(Mt)])
        err = float(np.abs(y.cpu().numpy() - ref).max())
        if not err < ITERATIVE_BOUND:
            raise AssertionError(f"iterative: kernel {ksize}: max |y - "
                                 f"direct| {err} (bound {ITERATIVE_BOUND})")
        report = iterative.large_kernel_report(ksize, inner, outer)
        out["iterative"].append({**report, "max_abs_err": err})
        log(f"iterative: kernel {ksize} ({inner.name} in {outer.name}) on "
            f"the card: max |y - direct| {err:.2e} (bound "
            f"{ITERATIVE_BOUND}); {report['nested_mults']} mults for "
            f"{report['outputs_2d']} outputs, {report['ratio_pct']:.2f}% of "
            f"direct")
    return out


class CNNModel:
    """A CNN of ``repro_torch.models.cnn`` as ``repro_torch.train`` takes a
    model: ``init(generator)`` on the generator's device and
    ``loss(params, batch) -> (loss, metrics)``."""

    def __init__(self, cfg):
        self.cfg = cfg

    def init(self, gen):
        from repro_torch.models import cnn
        return cnn.init_resnet(gen, self.cfg, device=gen.device)

    def loss(self, params, batch):
        from repro_torch.models import cnn
        return cnn.cnn_loss(params, self.cfg, batch)


def native_convs(cfg):
    """The names of a ResNet's native 3x3/1 convs, which take a hook (the
    stride-2 conv1 that opens a stage lowers)."""
    return [f"s{si}b{bi}.conv{k}" for si, n in enumerate(cfg.stages)
            for bi in range(n) for k in (1, 2)
            if not (k == 1 and bi == 0 and si > 0)]


@contextlib.contextmanager
def deployed(params, layers, config):
    """Run the convs named in ``layers`` (name -> calibrated ``PTQLayer``)
    of a ``repro_torch.models.cnn`` forward on a ``cuda`` plan of ``ALGO``
    with ``config``, on weights ``PTQLayer.prepare`` quantizes once; every
    other conv runs as the model runs it (its hook included)."""
    from repro_torch.api import ConvSpec, plan
    from repro_torch.models import cnn
    from repro_torch.quant import INT8_FREQ
    by_id = {id(params[n.split(".")[0]][n.split(".")[1]]["w"]): n
             for n in layers}
    preps, conv_apply = {}, cnn.conv_apply

    def conv(x, w, b, cfg, stride=1, qhook=None):
        name = by_id.get(id(w))
        if name is None:
            return conv_apply(x, w, b, cfg, stride=stride, qhook=qhook)
        p = plan(ConvSpec.for_conv2d(tuple(x.shape), tuple(w.shape),
                                     quant=INT8_FREQ),
                 backend="cuda", algo=ALGO).with_config(config)
        if p.path != "fast" or p.algo_name != ALGO:
            raise AssertionError(f"deploy: {name} planned {p.path} "
                                 f"{p.algo_name}")
        if name not in preps:
            preps[name] = layers[name].prepare(p, w)
        return p.apply(x, preps[name], bias=b)

    cnn.conv_apply = conv
    try:
        yield
    finally:
        cnn.conv_apply = conv_apply


@contextlib.contextmanager
def backward_unguarded():
    """The port's float32 guards taken out of the reference path's calls
    made inside the block (a backward run in it), as what they prevent."""
    from repro_torch.core import conv2d as c2d
    saved = c2d.full_fp32_conv, c2d.full_fp32_matmul
    c2d.full_fp32_conv = c2d.full_fp32_matmul = contextlib.nullcontext
    try:
        yield
    finally:
        c2d.full_fp32_conv, c2d.full_fp32_matmul = saved


def loss_and_grads(params, cfg, batch, backward=contextlib.nullcontext):
    """``cnn_loss`` and the gradient of every parameter leaf by name; the
    backward runs inside ``backward()``."""
    import torch

    from repro_torch.models import cnn
    from repro_torch.tree import flatten_with_path, tree_map
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = cnn.cnn_loss(live, cfg, batch)
    named = [("/".join(path), leaf) for path, leaf in
             flatten_with_path(live)]
    with backward():
        grads = torch.autograd.grad(loss, [leaf for _, leaf in named])
    return loss.item(), {n: g for (n, _), g in zip(named, grads)}


def dead_bias(name) -> bool:
    """A conv bias that feeds a normalization: its gradient is zero in
    exact arithmetic, rounding noise on any machine."""
    return name.endswith(("stem/b", "conv1/b", "conv2/b"))


def training(dev, counted) -> dict:
    """Phase 9: ResNet-18 trained at published width on the card (9a), then
    the paper's §6.1 experiment (9b): CIFAR_RESNET18 trained, its native
    3x3/1 convs PTQ-calibrated and deployed through B4 and B1 -> B2 -> B3.
    Raises on any miss; returns the phase's report."""
    import shutil

    import torch

    from repro_torch.api import ConvSpec, plan, tuning
    from repro_torch.configs import CIFAR_RESNET18
    from repro_torch.data import ImagePipelineConfig, SyntheticImagePipeline
    from repro_torch.models import cnn
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.quant import INT8_FREQ, PTQLayer, QuantConfig
    from repro_torch.quant import fake_quant as fq
    from repro_torch.train import (Trainer, TrainerConfig, TransientError,
                                   make_train_step)

    out = {"resnet18": [], "grads": [], "cifar": {}}
    ckpt_root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)

    def on_card(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    def nudged(batch):
        """The batch with its images moved by NUDGE relative (seeded)."""
        x = batch["images"]
        noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(
            1)).to(x.device)
        return dict(batch, images=x * (1 + NUDGE * noise))

    def trained(name, cfg, opt, batches, steps, every, fault_hook=None):
        """A ``Trainer`` run from an empty checkpoint directory, which must
        launch no kernel of the port."""
        trainer = Trainer(CNNModel(cfg), opt, TrainerConfig(
            total_steps=steps, checkpoint_every=every,
            checkpoint_dir=str(ckpt_root / name.replace(" ", "_")),
            log_every=10 ** 9), fault_hook=fault_hook, device=dev)
        rep = counted("training", f"train {name}",
                      lambda: trainer.run(batches, TRAIN_SEED), want=only())
        trainer.ckpt.close()
        if not all(math.isfinite(v) for v in rep.losses):
            raise AssertionError(f"train {name}: losses {rep.losses}")
        return trainer, rep

    # -- 9a. ResNet-18 at published width ---------------------------------
    t0 = time.perf_counter()
    r18 = dataclasses.replace(RESNET18, widths=RESNET_WIDTHS,
                              image_size=IMAGE)
    pipe = SyntheticImagePipeline(ImagePipelineConfig(
        IMAGE, r18.n_classes, global_batch=TRAIN_BATCH, seed=3))
    out["pipeline_s"] = time.perf_counter() - t0

    def batches(i):
        return on_card(pipe.batch(i))

    for mode, kw in TRAIN_MODES:
        cfg = dataclasses.replace(r18, **kw)

        def optimizer():
            return AdamW(lr=cosine_schedule(1e-3, 2, TRAIN_STEPS),
                         weight_decay=1e-4)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer, rep = trained(mode, cfg, optimizer(), batches, TRAIN_STEPS,
                               TRAIN_CKPT_EVERY)
        peak = torch.cuda.max_memory_allocated()
        pending = {FAULT_STEP}

        def fault(step):
            if step in pending:
                pending.discard(step)
                raise TransientError(f"injected at step {step}")
        _, rep_f = trained(f"{mode} fault", cfg, optimizer(), batches,
                           TRAIN_STEPS, TRAIN_CKPT_EVERY, fault_hook=fault)
        if rep_f.restarts != 1 or rep_f.steps_run != \
                FAULT_STEP + TRAIN_STEPS - TRAIN_CKPT_EVERY:
            raise AssertionError(f"train {mode}: the fault run restarted "
                                 f"{rep_f.restarts} times and ran "
                                 f"{rep_f.steps_run} steps")
        resumed = rep_f.losses[FAULT_STEP:]
        want = rep.losses[TRAIN_CKPT_EVERY:]
        resume_rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, want))
        if not resume_rel <= RESUME_REL:
            raise AssertionError(f"train {mode}: resumed losses {resumed} "
                                 f"against {want} (rel {resume_rel})")
        # one traced step from the final checkpoint
        state, _ = trainer.init_or_restore(TRAIN_SEED)
        step_fn = make_train_step(CNNModel(cfg), optimizer())
        batch = batches(0)
        prof = counted("training", f"traced {mode} step",
                       lambda: profile_forward(lambda: step_fn(state, batch)),
                       want=only())
        row = {"mode": mode, "losses": rep.losses,
               "fault_losses": rep_f.losses,
               "resume_max_rel": resume_rel,
               "resume_bitwise": resumed == want,
               "first_steps_bitwise": rep_f.losses[:FAULT_STEP]
               == rep.losses[:FAULT_STEP],
               "step_ms_median": statistics.median(rep.step_times[1:]) * 1e3,
               "first_step_ms": rep.step_times[0] * 1e3,
               "peak_mib": peak / 2 ** 20}
        if "not_measured" in prof:
            row["card_busy_ms"] = "not measured: " + prof["not_measured"]
        else:
            row.update({"card_busy_ms": prof["busy_us"] / 1e3,
                        "device_span_ms": prof["device_span_us"] / 1e3,
                        "traced_wall_ms": prof["wall_us"] / 1e3,
                        "kernels": sum(v["count"]
                                       for v in prof["kernels"].values())})
        out["resnet18"].append(row)
        busy = (f"card busy {row['card_busy_ms']:.1f} ms of a "
                f"{row['device_span_ms']:.1f} ms device span and "
                f"{row['traced_wall_ms']:.1f} ms wall, {row['kernels']} "
                f"kernels (one traced step)" if "kernels" in row
                else f"card busy {row['card_busy_ms']}")
        log(f"train: resnet18 {mode} batch {TRAIN_BATCH} at {IMAGE}x{IMAGE}: "
            f"losses {', '.join(f'{v:.4f}' for v in rep.losses)}; step "
            f"{row['step_ms_median']:.1f} ms wall (median of steps 2-"
            f"{TRAIN_STEPS}; first {row['first_step_ms']:.0f} ms); {busy}; "
            f"peak {row['peak_mib']:.0f} MiB; no kernel of the port launched")
        log(f"train: resnet18 {mode}: TransientError at step {FAULT_STEP} "
            f"rolled back to step {TRAIN_CKPT_EVERY}; resumed losses within "
            f"{resume_rel:.2e} relative (bound {RESUME_REL}), bit for bit "
            f"{row['resume_bitwise']}")

    # gradients on the card against CPU copies of the same parameters and
    # batch, with the guards, then with the backward's guard taken out
    params = cnn.init_resnet(torch.Generator(device=dev).manual_seed(
        TRAIN_SEED), r18, device=dev)
    params_cpu = tree_to(params, "cpu")
    b = pipe.batch(0)
    gb = {k: v[:GRAD_BATCH] for k, v in b.items()}
    gb_card, gb_cpu = on_card(gb), {k: torch.from_numpy(v)
                                    for k, v in gb.items()}
    for mode, kw in (("direct", {"conv_algo": "direct"}),
                     ("sfc6_6", {"conv_algo": ALGO}),
                     ("sfc6_6 int8", {"conv_algo": ALGO, "quant": "int8"})):
        cfg = dataclasses.replace(r18, **kw)
        loss, g = counted("training", f"{mode} gradients",
                          lambda: loss_and_grads(params, cfg, gb_card),
                          want=only())
        loss_cpu, g_cpu = loss_and_grads(params_cpu, cfg, gb_cpu)
        scale = max(v.abs().max().item() for v in g_cpu.values())
        err = max((g[n].cpu() - v).abs().max().item()
                  for n, v in g_cpu.items())
        leaf_rel = {n: rel_l2(g[n].cpu(), v) for n, v in g_cpu.items()
                    if not dead_bias(n)}
        row = {"mode": mode, "loss": loss, "loss_cpu": loss_cpu,
               "loss_rel": abs(loss - loss_cpu) / abs(loss_cpu),
               "max_err_over_max_g": err / scale,
               "worst_leaf_rel_l2": max(leaf_rel.values())}
        # the dead biases' gradients are noise on both sides: held to
        # GRAD_TOL of max |g| in every mode, not by their rel L2
        row["dead_bias_max_err_over_max_g"] = max(
            (g[n].cpu() - v).abs().max().item()
            for n, v in g_cpu.items() if dead_bias(n)) / scale
        if "int8" in mode:
            # dynamic int8 is a chaotic function of its input: the CPU's own
            # spread when the images move by NUDGE sets what two
            # implementations can agree on
            _, g_nudged = loss_and_grads(params_cpu, cfg, nudged(gb_cpu))
            row["cpu_spread_worst_leaf_rel_l2"] = max(
                rel_l2(g_nudged[n], v) for n, v in g_cpu.items()
                if not dead_bias(n))
            leaf_bound = max(INT8_GRAD_REL,
                             CHAOS_FACTOR * row["cpu_spread_worst_leaf_rel_l2"])
            if not (row["worst_leaf_rel_l2"] <= leaf_bound
                    and row["loss_rel"] <= GRAD_TOL
                    and row["dead_bias_max_err_over_max_g"] <= GRAD_TOL):
                raise AssertionError(f"grads {mode}: card against CPU {row}")
        elif not (err <= GRAD_TOL * scale and row["loss_rel"] <= GRAD_TOL):
            raise AssertionError(f"grads {mode}: card against CPU {row}")
        if "int8" not in mode:
            _, g_open = loss_and_grads(params, cfg, gb_card,
                                       backward=backward_unguarded)
            row["unguarded_max_err_over_max_g"] = max(
                (g_open[n].cpu() - v).abs().max().item()
                for n, v in g_cpu.items()) / scale
            row["unguarded_worst_leaf_rel_l2"] = max(
                rel_l2(g_open[n].cpu(), v) for n, v in g_cpu.items()
                if not dead_bias(n))
        out["grads"].append(row)
        if "int8" in mode:
            # the bounds the int8 row is held to: the worst leaf, the loss
            # and the dead biases (max |dg| / max |g| is printed unbounded)
            log(f"grads: resnet18 {mode} batch {GRAD_BATCH}, card against "
                f"CPU: worst leaf rel L2 {row['worst_leaf_rel_l2']:.2e} "
                f"(bound {leaf_bound:.2e}: {INT8_GRAD_REL}, or "
                f"{CHAOS_FACTOR}x the CPU's own spread for a {NUDGE} nudge "
                f"of the images, {row['cpu_spread_worst_leaf_rel_l2']:.2e}), "
                f"loss rel {row['loss_rel']:.2e} (bound {GRAD_TOL}), dead "
                f"biases max |dg| / max |g| "
                f"{row['dead_bias_max_err_over_max_g']:.2e} (bound "
                f"{GRAD_TOL}); max |dg| / max |g| over all leaves "
                f"{row['max_err_over_max_g']:.2e} (no bound: dynamic int8 "
                f"is chaotic)")
        else:
            log(f"grads: resnet18 {mode} batch {GRAD_BATCH}, card against "
                f"CPU: loss rel {row['loss_rel']:.2e}, max |dg| / max |g| "
                f"{row['max_err_over_max_g']:.2e} (bound {GRAD_TOL} each), "
                f"worst leaf rel L2 {row['worst_leaf_rel_l2']:.2e}; with the "
                f"backward's guard taken out (what it prevents, PyTorch's "
                f"default TF32 flags): max |dg| / max |g| "
                f"{row['unguarded_max_err_over_max_g']:.2e}, worst leaf rel "
                f"L2 {row['unguarded_worst_leaf_rel_l2']:.2e}")

    # one int8 conv at a time, on the fp32 activations of the model's own
    # forward: the gradients of input and weights through the hook's
    # straight-through estimator, card against CPU (no chaos in one layer)
    int8 = cnn.quant_config(dataclasses.replace(r18, quant="int8")).hook()
    native = native_convs(r18)
    with torch.no_grad(), conv_inputs(params) as seen:
        cnn.resnet_forward(params, r18, gb_card["images"])
    layer_rel = []
    for name, x, w, bias, stride in seen:
        if name not in native:
            continue
        cot = np.random.RandomState(7).randn(*x.shape[:3], w.shape[3])
        grads = []
        for where in (dev, torch.device("cpu")):
            xs, ws, bs = (t.detach().to(where) for t in (x, w, bias))
            xs.requires_grad_()
            ws.requires_grad_()
            p = plan(ConvSpec.for_conv2d(tuple(xs.shape), tuple(ws.shape)),
                     backend="reference", algo=ALGO)

            def layer_grads():
                y = p.apply(xs, ws, bias=bs, elementwise_hook=int8)
                return torch.autograd.grad((y * torch.tensor(
                    cot, dtype=y.dtype, device=where)).sum(), (xs, ws))
            grads.append([g.cpu() for g in counted(
                "training", f"int8 {name} gradients", layer_grads,
                want=only())])
        rel = max(rel_l2(a, b) for a, b in zip(*grads))
        if not rel <= INT8_GRAD_REL:
            raise AssertionError(f"grads: int8 {name}: card against CPU rel "
                                 f"L2 {rel} (bound {INT8_GRAD_REL})")
        layer_rel.append({"layer": name, "rel_l2": rel})
    if len(layer_rel) != len(native):
        raise AssertionError(f"grads: {len(layer_rel)} of {len(native)} "
                             f"int8 convs checked")
    out["int8_layer_grads"] = layer_rel
    log(f"grads: resnet18's {len(native)} native 3x3/1 convs one at a time, "
        f"dynamic int8 sfc6_6, batch {GRAD_BATCH}: input and weight "
        f"gradients card against CPU rel L2 "
        f"{min(r['rel_l2'] for r in layer_rel):.2e} to "
        f"{max(r['rel_l2'] for r in layer_rel):.2e} (bound {INT8_GRAD_REL})")

    # -- 9b. the paper's §6.1 experiment on trained weights ---------------
    cfg = dataclasses.replace(CIFAR_RESNET18, conv_algo="direct")
    cpipe = SyntheticImagePipeline(ImagePipelineConfig(
        cfg.image_size, cfg.n_classes, global_batch=CIFAR_BATCH, seed=3))
    t0 = time.perf_counter()
    trainer, rep = trained("cifar", cfg, AdamW(
        lr=cosine_schedule(3e-3, 10, CIFAR_STEPS), weight_decay=1e-4),
        lambda i: on_card(cpipe.batch(i)), CIFAR_STEPS, CIFAR_STEPS)
    train_s = time.perf_counter() - t0
    first, last = (statistics.mean(rep.losses[:5]),
                   statistics.mean(rep.losses[-5:]))
    if not last <= first - MIN_LOSS_DROP:
        raise AssertionError(f"cifar: mean loss of the last 5 steps {last} "
                             f"against the first 5 {first}")
    params = trainer.init_or_restore(TRAIN_SEED)[0].params
    held = [on_card(cpipe.batch(i))
            for i in range(HELD_INDEX, HELD_INDEX + HELD_BATCHES)]

    def logits_of(fn):
        with torch.no_grad():
            return [fn(h["images"]) for h in held]

    def accuracy(logits):
        right = sum(int((y.argmax(-1) == h["labels"].long()).sum())
                    for y, h in zip(logits, held))
        return right / sum(len(h["labels"]) for h in held)

    table = []
    for row_name, kw in ACCURACY_ROWS:
        c = dataclasses.replace(cfg, **kw)
        acc = accuracy(counted("training", f"cifar {row_name}",
                               lambda: logits_of(lambda x: cnn.resnet_forward(
                                   params, c, x)), want=only()))
        table.append({"variant": row_name, "accuracy": acc})
    fp_acc = table[0]["accuracy"]
    if not fp_acc >= MIN_HELD_ACC:
        raise AssertionError(f"cifar: held-out fp32 accuracy {fp_acc} "
                             f"(bound {MIN_HELD_ACC})")
    log(f"cifar: CIFAR_RESNET18 trained {CIFAR_STEPS} steps at batch "
        f"{CIFAR_BATCH} on the card in {train_s:.1f} s (step "
        f"{statistics.median(rep.step_times[1:]) * 1e3:.1f} ms wall, "
        f"median): mean loss {first:.4f} over the first 5 steps, {last:.3e} "
        f"over the last 5 (bound: {MIN_LOSS_DROP} lower); held-out "
        f"accuracy ({HELD_BATCHES} batches from {HELD_INDEX}): "
        + "; ".join(f"{r['variant']} {r['accuracy']:.3f}" for r in table))

    # PTQ: calibrate each native conv's PTQLayer on batches that are neither
    # training nor held-out, on the sfc6_6 config (a direct plan drops the
    # hook), then simulate
    sfc = dataclasses.replace(cfg, conv_algo=ALGO)
    names = native_convs(sfc)
    layers = {n: PTQLayer(INT8_FREQ) for n in names}
    calib = [on_card(cpipe.batch(i))
             for i in range(CALIB_INDEX, CALIB_INDEX + CALIB_BATCHES)]
    with torch.no_grad():
        for c in calib:
            cnn.resnet_forward(params, sfc, c["images"], qhooks={
                n: layer.calibration_hook() for n, layer in layers.items()})
    sim_hooks = {n: layer.quantized_hook() for n, layer in layers.items()}
    sim = counted("training", "cifar PTQ simulation",
                  lambda: logits_of(lambda x: cnn.resnet_forward(
                      params, sfc, x, qhooks=sim_hooks)), want=only())
    fp = logits_of(lambda x: cnn.resnet_forward(params, cfg, x))
    n = len(names)
    deploys = {}
    for path, config, want in (
            ("train_ptq_fused", tuning.DEFAULT_FUSED,
             only(sfc_fused_conv2d=n)),
            ("train_ptq_staged", tuning.DEFAULT_STAGED,
             only(sfc_transform_quantize=n, tdmm_int8=n, sfc_inverse=n))):
        with deployed(params, layers, config), torch.no_grad():
            deploys[path] = [counted(path, f"cifar deployed held {i}",
                                     lambda: cnn.resnet_forward(
                                         params, sfc, h["images"],
                                         qhooks=sim_hooks), want=want)
                             for i, h in enumerate(held)]
    # per layer, on the fp32 activations of the trained model's own
    # forward: the deployed int8 output against the fp32 direct conv, and
    # Fig. 5's MSE ratio of dynamic int8 sfc6_6 and wino4 to direct int8
    dyn = QuantConfig(8, 8, "frequency", "channel+frequency").hook()
    per_layer = []
    with torch.no_grad(), conv_inputs(params) as seen:
        cnn.resnet_forward(params, cfg, held[0]["images"])
    for name, x, w, bias, stride in seen:
        if name not in layers:
            continue
        fp_spec = ConvSpec.for_conv2d(tuple(x.shape), tuple(w.shape))
        p = plan(ConvSpec.for_conv2d(tuple(x.shape), tuple(w.shape),
                                     quant=INT8_FREQ), backend="cuda",
                 algo=ALGO).with_config(tuning.DEFAULT_FUSED)
        prep = layers[name].prepare(p, w)
        y = counted("train_ptq_fused", f"cifar {name}",
                    lambda: p.apply(x, prep, bias=bias),
                    want=only(sfc_fused_conv2d=1))
        with torch.no_grad():
            direct = plan(fp_spec, backend="reference", algo="direct")
            y_fp = direct.apply(x, w, bias=bias)
            y_sim = plan(fp_spec, backend="reference", algo=ALGO).apply(
                x, w, bias=bias, elementwise_hook=sim_hooks[name])
        sim_rel = rel_l2(y, y_sim)
        if not sim_rel <= LAYER_SIM_REL:
            raise AssertionError(f"cifar: {name} deployed against the "
                                 f"simulation on the same input: rel L2 "
                                 f"{sim_rel} (bound {LAYER_SIM_REL})")
        with torch.no_grad():

            def mse(y_q):
                return torch.mean((y_q - y_fp) ** 2).item()
            base = mse(direct.apply(fq.fake_quant_activation(x, 8, "tensor"),
                                    fq.fake_quant_weight(w, 8, "channel"),
                                    bias=bias))
            ratios = {a: mse(plan(fp_spec, backend="reference", algo=a).apply(
                x, w, bias=bias, elementwise_hook=dyn)) / max(base, 1e-30)
                for a in ("sfc6_6", "wino4")}
        per_layer.append({"layer": name, "hw": x.shape[1],
                          "cin": w.shape[2], "cout": w.shape[3],
                          "deployed_vs_fp32_rel_l2": rel_l2(y, y_fp),
                          "deployed_vs_simulation_rel_l2": sim_rel,
                          "mse_direct_int8": base,
                          "mse_ratio_sfc6_6": ratios["sfc6_6"],
                          "mse_ratio_wino4": ratios["wino4"]})
    if len(per_layer) != n:
        raise AssertionError(f"cifar: {len(per_layer)} of {n} native convs "
                             f"recorded")
    log(f"cifar: per native conv (trained weights, held-out activations), "
        f"deployed on B4 against the simulation on the same input rel L2 "
        f"{min(r['deployed_vs_simulation_rel_l2'] for r in per_layer):.2e} "
        f"to {max(r['deployed_vs_simulation_rel_l2'] for r in per_layer):.2e}"
        f" (bound {LAYER_SIM_REL}); deployed int8 against fp32 direct rel "
        f"L2 / Fig. 5 MSE ratio to direct int8 of sfc6_6, wino4: "
        + "; ".join(
            f"{r['layer']} {r['deployed_vs_fp32_rel_l2']:.3e} / "
            f"{r['mse_ratio_sfc6_6']:.2f}, {r['mse_ratio_wino4']:.2f}"
            for r in per_layer))
    fused, staged = deploys["train_ptq_fused"], deploys["train_ptq_staged"]
    if not all(torch.equal(a, b) for a, b in zip(fused, staged)):
        raise AssertionError("cifar: the fused and the staged deployment "
                             "differ")
    dep_rel = max(rel_l2(a, b) for a, b in zip(fused, sim))
    sim_vs_fp = max(rel_l2(a, b) for a, b in zip(sim, fp))
    # the simulation's own spread when the images move by NUDGE: a network
    # of int8 convs amplifies the last-bit differences of two
    # implementations as it does that nudge (.5 ties flip, C4)
    with torch.no_grad():
        sim_spread = max(rel_l2(cnn.resnet_forward(
            params, sfc, nudged(h)["images"], qhooks=sim_hooks), y)
            for h, y in zip(held, sim))
    dep_bound = max(DEPLOY_REL, CHAOS_FACTOR * sim_spread)
    agree = sum(int((a.argmax(-1) == b.argmax(-1)).sum())
                for a, b in zip(fused, sim)) / sum(len(h["labels"])
                                                   for h in held)
    accs = {"fp32": accuracy(fp), "simulation": accuracy(sim),
            "deployed": accuracy(fused)}
    log(f"cifar: {n} native 3x3/1 convs calibrated on {CALIB_BATCHES} "
        f"batches of {CIFAR_BATCH} and deployed ({n} B4 launches a forward "
        f"fused, {n} each of B1, B2, B3 staged, bit for bit): logits "
        f"against the quantized_hook simulation rel L2 {dep_rel:.2e} "
        f"(bound {DEPLOY_REL}, or {CHAOS_FACTOR}x the simulation's own "
        f"spread for a {NUDGE} nudge of the images, {sim_spread:.2e}; the "
        f"simulation against fp32 {sim_vs_fp:.2e}), argmax agreement "
        f"{agree:.4f}; held-out "
        f"accuracy fp32 {accs['fp32']:.4f}, simulation "
        f"{accs['simulation']:.4f}, kernel deployment "
        f"{accs['deployed']:.4f}")

    out["cifar"] = {"losses": rep.losses, "train_s": train_s,
                    "step_ms_median":
                        statistics.median(rep.step_times[1:]) * 1e3,
                    "first5": first, "last5": last, "table": table,
                    "deploy_vs_simulation_rel_l2": dep_rel,
                    "simulation_vs_fp32_rel_l2": sim_vs_fp,
                    "simulation_spread_rel_l2": sim_spread,
                    "argmax_agreement": agree, "accuracy": accs,
                    "per_layer": per_layer}
    if not (dep_rel <= dep_bound and agree >= MIN_ARGMAX_AGREE):
        raise AssertionError(f"cifar: deployed logits against the "
                             f"simulation rel L2 {dep_rel} (bound "
                             f"{dep_bound}), argmax agreement {agree} "
                             f"(bound {MIN_ARGMAX_AGREE})")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    return out


def shard_nets():
    """(name, convs, forward, depthwise) of phase 10's three stacks: each
    conv (name, R, stride, H = W of its input, C_in, C_out); ``forward(x,
    conv)`` runs the stack with ``conv(name, h)``, ``x`` the images or, for
    the depthwise convs (each on its own input), a dict of inputs."""
    vgg, ends = vgg_layers()
    vgg = [(n, 3, 1, hw, cin, cout) for n, hw, cin, cout in vgg]

    def vgg_forward(x, conv):
        from repro_torch.models.cnn import max_pool_same
        h = x
        for li, (lname, *_) in enumerate(vgg):
            h = conv(lname, h).relu()
            if li in ends:
                h = max_pool_same(h, 2, 2)
        return h

    dw = [(n, 3, 1, hw, c, c) for n, hw, c in DW_LAYERS
          if n.startswith("mbv2")]

    def dw_forward(xs, conv):
        return [conv(n, xs[n]) for n, *_ in dw]

    return (("vgg16", vgg, vgg_forward, False),
            ("resnet18", resnet_convs(), resnet_forward, False),
            ("mbv2_dw", dw, dw_forward, True))


def sharded_convs(dev, counted, plan_launches, smi) -> dict:
    """Phase 10: the ``cuda_spmd`` backend over device meshes against the
    single-device ``cuda`` backend.  Raises on any miss; returns the
    phase's report."""
    import torch

    from repro_torch.api import ConvSpec, costmodel, get_backend, plan, tuning
    from repro_torch.api.plan import PrepCache
    from repro_torch.distributed.sharding import Sharded
    from repro_torch.launch.mesh import make_forced_host_mesh
    from repro_torch.quant import FP32, INT8_FREQ
    spmd = get_backend("cuda_spmd")
    n_gpus = torch.cuda.device_count()
    out = {"meshes": [], "stacks": [], "findings": [], "sanitized": [],
           "cuda_plans_differ": 0}

    def mesh_of(shape):
        n = math.prod(shape)
        return make_forced_host_mesh(shape) if n_gpus >= n \
            else make_forced_host_mesh(shape, device=dev)

    def calibration(p, x):
        if not p.spec.quant.enabled or p.path == "direct":
            return None
        if p.path == "lowered":
            return p.calibrate(x)
        return tuning.calibrate_act_scale(x, p.algorithm, p.spec.quant,
                                          p.spec.padding)

    def tuned(p):
        """Each native (sub-)plan with the config the cuda backend's
        planner gives it: the measured winner, else the cost model's."""
        if p.path == "lowered":
            return dataclasses.replace(p, sub_plans=tuple(
                tuned(q) for q in p.sub_plans))
        if p.algorithm is None:
            return p
        return p.with_config(
            tuning.get_config(p.spec, "cuda", p.algo_name)
            or costmodel.best_config(p.spec, "cuda", p.algo_name))

    def on_backend(p, backend):
        """The same plan (algorithms, sub-plans, configs) on ``backend``,
        with prepared-weight caches of its own."""
        subs = {"sub_plans": tuple(on_backend(q, backend)
                                   for q in p.sub_plans)} \
            if p.path == "lowered" else {}
        return dataclasses.replace(p, backend=backend, _prep=PrepCache(),
                                   **subs)

    def structure(p, configs=True):
        if p.path == "lowered":
            return (p.algo_name, tuple(structure(q, configs)
                                       for q in p.sub_plans))
        return (p.algo_name, p.config if configs else None)

    def spec_of(conv, batch, quant, depthwise):
        _, R, stride, hw, cin, cout = conv
        if depthwise:
            return ConvSpec.for_conv2d_depthwise(
                (batch, hw, hw, cin), (R, R, 1, cin), quant=quant)
        return ConvSpec.for_conv2d((batch, hw, hw, cin), (R, R, cin, cout),
                                   stride=stride, quant=quant)

    def plans_for(convs, batch, path, depthwise):
        """cuda_spmd plans of one path, through ``plan``."""
        quant = FP32 if path in ("fp", "direct") else INT8_FREQ
        algo = "direct" if path == "direct" else ALGO
        cfg = {"fused": tuning.DEFAULT_FUSED,
               "staged": tuning.DEFAULT_STAGED}.get(path)
        plans = {}
        for conv in convs:
            p = plan(spec_of(conv, batch, quant, depthwise),
                     backend="cuda_spmd", algo=algo)
            plans[conv[0]] = tuned(p) if path == "tuned" else \
                p if cfg is None else p.with_config(cfg)
        return plans

    def card_ms(fn):
        """Median device ms of one ``fn`` call over SHARD_RUNS, each call
        queued alone behind a spin kernel that outlasts its enqueue (a
        sharded forward launches hundreds of kernels: several calls behind
        one spin would fill the card's launch queue and block the host).
        The spin doubles until it holds and stays doubled; None where it
        never held (the time would include the host's gaps)."""
        fn()
        torch.cuda.synchronize()
        cycles, times = SPIN_CYCLES, []
        while len(times) < SHARD_RUNS:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            torch.cuda._sleep(cycles)
            ev[1].record()
            t0 = time.perf_counter()
            fn()
            ev[2].record()
            enqueue_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            if enqueue_ms < ev[0].elapsed_time(ev[1]):
                times.append(ev[1].elapsed_time(ev[2]))
            elif cycles >= SPIN_CYCLES << 8:
                log(f"shard: the host outran every spin ({enqueue_ms:.1f} "
                    f"ms to enqueue one forward); card time not measured")
                return None
            else:
                cycles *= 2
        return statistics.median(times)

    def fmt_ms(v):
        return "not measured" if v is None else f"{v:.3f}"

    def wall_ms(fn):
        runs = []
        for _ in range(SHARD_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(runs)

    def placed_blocks(p, prep, mesh, where):
        """Every placed block on its coordinate's device, C_out / model
        wide where the model axis divides C_out."""
        m = mesh.shape["model"]
        for coord in mesh.coords():
            for name in ("wq", "w_scale", "tw", "act_scale"):
                a = getattr(prep, name)
                if a is None:
                    continue
                if not isinstance(a, Sharded):
                    raise AssertionError(f"{where}: {name} was not placed")
                blk = a.shard(coord)
                if blk.device != mesh.device(coord):
                    raise AssertionError(f"{where}: {name} block {coord} on "
                                         f"{blk.device}")
                full = a.shape[-1]
                want = full if name == "act_scale" or full % m else full // m
                if blk.shape[-1] != want or blk.shape[:-1] != a.shape[:-1]:
                    raise AssertionError(f"{where}: {name} block {coord} "
                                         f"{tuple(blk.shape)} of {a.shape}")

    def held_shard(where, kind, y_s, y_1):
        """int8 bit for bit; fp and direct bit for bit or a finding within
        SHARD_FP_TOL."""
        if torch.equal(y_s, y_1):
            return True
        if kind == "int8":
            raise AssertionError(f"{where}: the sharded int8 output differs "
                                 f"from the single-device one")
        rel = rel_l2(y_s, y_1)
        scaled = ((y_s - y_1).abs().max()
                  / y_1.abs().max().clamp_min(1e-30)).item()
        out["findings"].append({"where": where, "shape": list(y_1.shape),
                                "rel_l2": rel, "scaled_max": scaled})
        if not (rel <= SHARD_FP_TOL and scaled <= SHARD_FP_TOL):
            raise AssertionError(f"{where}: rel L2 {rel}, max |diff| / max "
                                 f"|ref| {scaled} against one device (bound "
                                 f"{SHARD_FP_TOL})")
        return False

    def run_net(net, batch, paths, meshes, tag):
        name, convs, forward, dw = net
        rng = np.random.RandomState(SHARD_SEED + len(convs))
        ws = {c[0]: torch.tensor(
            rng.randn(c[1], c[1], 1 if dw else c[4], c[5])
            * math.sqrt(2.0 / (c[1] * c[1] * (1 if dw else c[4]))),
            dtype=torch.float32, device=dev) for c in convs}
        bs = {c[0]: torch.tensor(rng.randn(c[5]) * 0.1, dtype=torch.float32,
                                 device=dev) for c in convs}
        if dw:
            x = {c[0]: torch.tensor(rng.randn(batch, c[3], c[3], c[4]),
                                    dtype=torch.float32, device=dev)
                 for c in convs}
        else:
            x = torch.tensor(rng.randn(batch, IMAGE, IMAGE, 3),
                             dtype=torch.float32, device=dev)
        for path in paths:
            kind = "int8" if path in ("fused", "staged", "tuned") else "fp"
            # the single-device reference: the cuda_spmd plans' algorithms,
            # sub-plans and configs on the cuda backend (the measured tiers
            # are per backend: plan(spec, backend="cuda") may lower onto
            # other sub-algorithms)
            p1 = {n: on_backend(p, "cuda")
                  for n, p in plans_for(convs, batch, path, dw).items()}
            out["cuda_plans_differ"] += sum(
                structure(p, False) != structure(plan(
                    p.spec, backend="cuda",
                    algo="direct" if path == "direct" else ALGO), False)
                for p in p1.values())
            want1 = {k: sum(plan_launches(p, kind == "fp")[k]
                            for p in p1.values()) for k in REPLACES}
            one = {}                      # conv -> (input, act, output)

            def record(lname, h):
                p = p1[lname]
                act = calibration(p, h)
                y = p.apply(h, p.prepare_weights(ws[lname], act_scale=act),
                            bias=bs[lname])
                one[lname] = (h, act, y)
                return y

            counted(f"shard_{name}_{path}_1", f"{name} {path} batch {batch} "
                    f"on one device", lambda: forward(x, record), want=want1)
            prep1 = {n: p1[n].prepare_weights(ws[n], act_scale=one[n][1])
                     for n in p1}

            def single(lname, h):
                return p1[lname].apply(h, prep1[lname], bias=bs[lname])

            base = {"card_ms": card_ms(lambda: forward(x, single)),
                    "wall_ms": wall_ms(lambda: forward(x, single))}
            for shape in meshes:
                mesh = mesh_of(shape)
                spmd.set_mesh(mesh)
                ps = plans_for(convs, batch, path, dw)
                if any(structure(ps[n]) != structure(p1[n]) for n in ps):
                    raise AssertionError(f"{name} {path} mesh {shape}: the "
                                         f"plans changed with the mesh")
                preps = {n: ps[n].prepare_weights(ws[n],
                                                  act_scale=one[n][1])
                         for n in ps}
                first = next(n for n in ps if ps[n].path == "fast") \
                    if any(p.path == "fast" for p in ps.values()) else None
                if first is not None:
                    placed_blocks(ps[first], preps[first], mesh,
                                  f"{name} {path} {shape} {first}")
                exact = []

                def check(lname, h):
                    # every conv on the single-device input of that conv
                    h1, _, y1 = one[lname]
                    y = ps[lname].apply(h1, preps[lname], bias=bs[lname])
                    exact.append(held_shard(
                        f"{name} {path} batch {batch} mesh {shape} {lname}",
                        kind, y, y1))
                    return y

                want = {k: v * mesh.size for k, v in want1.items()}
                counted(f"shard_{name}_{path}", f"{name} {path} batch "
                        f"{batch} mesh {shape}", lambda: forward(x, check),
                        want=want)

                def sharded(lname, h):
                    return ps[lname].apply(h, preps[lname], bias=bs[lname])

                row = {"net": name, "path": path, "batch": batch,
                       "mesh": list(shape), "tag": tag,
                       "devices": sorted({str(d) for d in
                                          mesh.devices.flat}),
                       "bit_exact_convs": sum(exact), "convs": len(exact),
                       "launches": {k: v for k, v in want.items() if v},
                       "card_ms": card_ms(lambda: forward(x, sharded)),
                       "wall_ms": wall_ms(lambda: forward(x, sharded)),
                       "one_device_card_ms": base["card_ms"],
                       "one_device_wall_ms": base["wall_ms"]}
                if (name, path, shape) == SHARD_PER_LAYER and tag == "stack":
                    row["per_layer"] = [{
                        "layer": n, "shape": list(one[n][0].shape),
                        "card_ms": card_ms(lambda: sharded(n, one[n][0])),
                        "one_device_card_ms": card_ms(
                            lambda: single(n, one[n][0]))} for n in ps]
                    log("shard: per conv, card ms sharded / one device: "
                        + ", ".join(f"{r['layer']} {fmt_ms(r['card_ms'])} / "
                                    f"{fmt_ms(r['one_device_card_ms'])}"
                                    for r in row["per_layer"]))
                out["stacks" if tag == "stack" else "sanitized"].append(row)
                log(f"shard: {name} {path} batch {batch} mesh {shape} "
                    f"({mesh.size} shards on {row['devices']}): "
                    f"{row['bit_exact_convs']}/{len(exact)} convs bit for "
                    f"bit one device; card {fmt_ms(row['card_ms'])} ms, wall "
                    f"{row['wall_ms']:.3f} ms, against one device "
                    f"{fmt_ms(base['card_ms'])} / {base['wall_ms']:.3f} ms; "
                    f"launches {json.dumps(row['launches'])}")
                del ps, preps
            del one, prep1

    t0 = time.perf_counter()
    try:
        for net in shard_nets():
            paths = [p for p in SHARD_PATHS if not (net[3] and p == "tuned")]
            run_net(net, SHARD_BATCH, paths, SHARD_MESHES, "stack")
            if not net[3]:
                # batch 1 on a 2-way data axis: the axis drops, replicated
                run_net(net, 1, ("fused",), SHARD_SANITIZED, "sanitized")
    finally:
        spmd.set_mesh(None)
    torch.cuda.synchronize()
    out["meshes"] = [list(m) for m in SHARD_MESHES]
    out["gpus"] = n_gpus
    out["seconds"] = time.perf_counter() - t0
    if out["findings"]:
        worst = max(out["findings"], key=lambda f: f["rel_l2"])
        log(f"shard: {len(out['findings'])} fp or direct convs not bit for "
            f"bit one device, all within {SHARD_FP_TOL}; worst rel L2 "
            f"{worst['rel_l2']:.3e} at {worst['where']} {worst['shape']}")
    else:
        log("shard: every sharded output bit for bit the single-device one, "
            "fp and direct included")
    log(f"shard: {out['cuda_plans_differ']} conv plans (over all paths and "
        f"batches) lower onto other sub-algorithms on the cuda backend (its "
        f"measured tiers); each is held to its own plan on one device")
    log(f"shard: phase 10 took {out['seconds']:.1f} s on {smi}")
    return out


def gate_and_psum(dev) -> dict:
    """Phase 10b: ``python -m repro_torch.analysis --check`` on this host
    (exit 0), and ``compressed_psum`` on a one-rank NCCL group, bit for bit
    ``dequantize_int8(*quantize_int8(x))``."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch.optim import grad_compression as gc
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    gate = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           "--check"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    tail = gate.stdout.strip().splitlines()[-1:] or [gate.stderr[-300:]]
    log(f"gate: python -m repro_torch.analysis --check exited "
        f"{gate.returncode}: {tail[0]}")
    if gate.returncode != 0:
        raise AssertionError(f"the analysis gate failed:\n{gate.stdout}"
                             f"\n{gate.stderr}")
    store = ROOT / "build" / "chip_smoke_nccl_store"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        x = torch.tensor(np.random.RandomState(1200).randn(1 << 20),
                         dtype=torch.float32, device=dev)
        y = gc.compressed_psum(x, torch.Generator(device=dev).manual_seed(7))
        want = gc.dequantize_int8(*gc.quantize_int8(
            x, torch.Generator(device=dev).manual_seed(7)))
        torch.cuda.synchronize()
        same = torch.equal(y, want)
        err = (y - x).abs().max().item()
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    log(f"psum: compressed_psum over a one-rank NCCL group on {dev}: bit for "
        f"bit the int8 round trip {same}; max |y - x| {err:.3e} (one int8 "
        f"step {x.abs().max().item() / 127:.3e})")
    if not same:
        raise AssertionError("compressed_psum on one NCCL rank differs from "
                             "the int8 round trip")
    return {"gate_exit": gate.returncode, "gate_tail": tail[0],
            "psum_bit_exact": same, "psum_max_abs_err": err}


def close_err(y, ref) -> float:
    """max |y - ref| / (1 + |ref|): within b means allclose at rtol = atol
    = b."""
    return ((y - ref).abs() / (1 + ref.abs())).max().item()


def lm_free():
    """Drop what a served model leaves: the serving cache's entries, the
    compute copies, the allocator's cached blocks."""
    import torch

    from repro_torch.api import serving_cache
    from repro_torch.models import transformer
    serving_cache.clear()
    transformer.clear_compute_cache()
    gc.collect()
    torch.cuda.empty_cache()


def lm_tokens(cfg, shape, seed, dev):
    import torch
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, shape)).to(dev)


def lm_decoded(model, params, toks, memory=None):
    """Teacher-forced decode of ``toks``: the logits of every step."""
    import torch
    B, T = toks.shape
    cache = model.init_cache(params, B, T, memory)
    outs = []
    for t in range(T):
        lg, cache = model.decode_step(
            params, cache, toks[:, t:t + 1],
            torch.full((B,), t, dtype=torch.int32, device=toks.device))
        outs.append(lg[:, 0])
    return torch.stack(outs, dim=1)


def lm_wall_ms(fn, runs=LM_RUNS):
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / runs


def lm_queued_ms(fn, runs=3):
    """Median card ms of one ``fn`` call queued alone behind a spin of
    ``LM_SPIN`` cycles; None where the host could not enqueue the call
    before the spin ended (a call of more launches than the card's launch
    queue holds blocks the host behind the spin)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(LM_SPIN)
        ev[1].record()
        t0 = time.perf_counter()
        fn()
        ev[2].record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if enqueue_ms >= ev[0].elapsed_time(ev[1]):
            return None
        times.append(ev[1].elapsed_time(ev[2]))
    return statistics.median(times)


def lm_traced(fn):
    """The card's busy ms and kernels of one ``fn`` call, from a
    ``torch.profiler`` trace (``profile_forward``)."""
    prof = profile_forward(fn)
    if "not_measured" in prof:
        return {"busy_ms": None, "kernels": None, **prof}
    top = sorted(prof["kernels"].items(), key=lambda kv: -kv[1]["us"])
    return {"busy_ms": prof["busy_us"] / 1e3,
            "kernels": sum(v["count"] for v in prof["kernels"].values()),
            "span_ms": prof["device_span_us"] / 1e3,
            "traced_wall_ms": prof["wall_us"] / 1e3,
            "top": [(k[:60], v["count"], v["us"] / 1e3)
                    for k, v in top[:4]]}


def lm_fmt_ms(v):
    return "not measured" if v is None else f"{v:.3f}"


@contextlib.contextmanager
def captured_steps():
    """``launch.serve``'s loop swapped for one that keeps the step of each
    run (the served model, its tree and cache) for the card's timing;
    yields the list the steps go to."""
    import repro_torch.launch.serve as serve
    steps = []

    class Captured(serve.SlotLoop):
        def run(self, step_fn, max_steps=None):
            steps.append(step_fn)
            return super().run(step_fn, max_steps)

    loop_class, serve.SlotLoop = serve.SlotLoop, Captured
    try:
        yield steps
    finally:
        serve.SlotLoop = loop_class


def lm_serving(dev, counted, timed, smi) -> dict:
    """Phase 11: the rank-1 SFC conv and the LM serving path (11a-11d), each
    forward launching none of B1-B7 (the JAX pallas backend sends rank-1
    plans to its reference path; the models reach no other conv)."""
    import torch

    import repro_torch.configs as configs
    import repro_torch.launch.serve as serve
    from repro_torch import tree as tree_util
    from repro_torch.api import ConvSpec, get_backend, plan, serving_cache
    from repro_torch.launch.mesh import make_forced_host_mesh
    from repro_torch.models import build, transformer

    t_phase = time.perf_counter()
    none = only()
    out = {"conv1d": [], "models": {}, "serving": {}, "smoke": {}}

    def tokens(cfg, shape, seed):
        return lm_tokens(cfg, shape, seed, dev)

    def generator(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # ---- 11a. the rank-1 conv -------------------------------------------
    spmd = get_backend("cuda_spmd")
    spmd.set_mesh(make_forced_host_mesh((2, 1), device=dev))
    try:
        for B, T, C, R in CONV1D_SHAPES:
            rng = np.random.RandomState(LM_SEED + T)
            x, w, b = (torch.tensor(a, dtype=torch.float32, device=dev) for a
                       in (rng.randn(B, T, C), rng.randn(R, C) * 0.3,
                           rng.randn(C) * 0.1))
            spec = ConvSpec.for_conv1d_depthwise(x.shape, w.shape)
            row = {"shape": [B, T, C, R]}
            ys = {}
            for algo in ("sfc6_6_r4", "direct"):
                for backend in ("reference", "cuda", "cuda_spmd"):
                    p = plan(spec, backend=backend, algo=algo)
                    if p.algo_name != algo:
                        raise AssertionError(f"{spec} planned {p.algo_name}")
                    prep = p.prepare_weights(w)
                    ys[algo, backend] = counted(
                        "lm_conv1d", f"conv1d {algo} on {backend}",
                        lambda: p.apply(x, prep, bias=b), want=none)
                    if backend == "cuda":
                        row[f"{algo}_ms"] = timed(
                            lambda: p.apply(x, prep, bias=b), runs=LM_RUNS)
                for backend in ("reference", "cuda_spmd"):
                    if not torch.equal(ys[algo, backend], ys[algo, "cuda"]):
                        raise AssertionError(f"conv1d {algo}: {backend} is "
                                             f"not bit for bit cuda's")
                p_cpu = plan(spec, backend="reference", algo=algo)
                y_cpu = p_cpu.apply(x.cpu(), p_cpu.prepare_weights(w.cpu()),
                                    bias=b.cpu())
                row[f"{algo}_card_vs_cpu"] = rel_l2(ys[algo, "cuda"].cpu(),
                                                    y_cpu)
                if not row[f"{algo}_card_vs_cpu"] <= LM_REL:
                    raise AssertionError(f"conv1d {algo} {row}: the card "
                                         f"against CPU copies")
            sfc, direct = ys["sfc6_6_r4", "cuda"], ys["direct", "cuda"]
            row["sfc_vs_direct_rel_l2"] = rel_l2(sfc, direct)
            row["sfc_vs_direct_close"] = close_err(sfc, direct)
            if not (row["sfc_vs_direct_rel_l2"] <= LM_SFC
                    and row["sfc_vs_direct_close"] <= LM_SFC):
                raise AssertionError(f"conv1d SFC against direct: {row}")
            out["conv1d"].append(row)
            log(f"lm conv1d: (B, T, C, R) {row['shape']} sfc6_6_r4 "
                f"{row['sfc6_6_r4_ms']:.4f} ms, direct "
                f"{row['direct_ms']:.4f} ms on the card (reference path, "
                f"no kernel of the port); card against CPU "
                f"{row['sfc6_6_r4_card_vs_cpu']:.2e} / "
                f"{row['direct_card_vs_cpu']:.2e} rel L2; SFC against "
                f"direct {row['sfc_vs_direct_rel_l2']:.2e} rel L2, "
                f"{row['sfc_vs_direct_close']:.2e} close; reference and "
                f"cuda_spmd (2, 1) bit for bit cuda")
    finally:
        spmd.set_mesh(None)

    # ---- 11b. the models at published widths and depths ----------------
    for arch in LM_ARCHS:
        cfg = configs.get_config(arch)
        model = build(cfg)
        row = {"family": cfg.family, "n_layers": cfg.n_layers,
               "compute_dtype": cfg.compute_dtype}
        with torch.no_grad():
            t0 = time.perf_counter()
            params = model.init(generator(LM_SEED), device=dev)
            torch.cuda.synchronize()
            row["init_s"] = time.perf_counter() - t0
            row["params"] = sum(a.numel() for a in tree_util.leaves(params))
            toks = tokens(cfg, LM_PREFILL, LM_SEED + 1)
            logits = counted("lm_prefill", f"{arch} prefill",
                             lambda: model.forward(params, toks), want=none)
            if tuple(logits.shape) != LM_PREFILL + (cfg.padded_vocab,) \
                    or not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{arch} prefill: {logits.shape}")
            row["prefill_ms"] = lm_queued_ms(
                lambda: model.forward(params, toks))
            row["prefill_trace"] = lm_traced(
                lambda: model.forward(params, toks))
            row["prefill_wall_ms"] = lm_wall_ms(
                lambda: model.forward(params, toks))
            # the same three figures at full depth in bf16: findings
            short = toks[:, :LM_BF16_T]
            t0 = time.perf_counter()
            cpu_params = tree_to(transformer.cast_compute(params, cfg),
                                 "cpu")
            row["bf16_card_vs_cpu"] = rel_l2(
                model.forward(params, short).cpu(),
                model.forward(cpu_params, short.cpu()))
            del cpu_params
            row["bf16_cpu_s"] = time.perf_counter() - t0
            dec = toks[:, :LM_DECODE_T]
            row["bf16_decode_vs_forward"] = (
                lm_decoded(model, params, dec)
                - model.forward(params, dec)).abs().max().item()
            if cfg.family in ("ssm", "hybrid"):
                off = build(dataclasses.replace(cfg, use_sfc_conv=False))
                row["bf16_sfc_vs_direct_close"] = close_err(
                    logits, off.forward(params, toks))
            del params, logits
            lm_free()
            # fp32 at full width, n_layers cut
            cfg2 = dataclasses.replace(cfg, n_layers=LM_CHECK_LAYERS,
                                       compute_dtype="float32")
            m2 = build(cfg2)
            p2 = m2.init(generator(LM_SEED + 2), device=dev)
            toks2 = tokens(cfg, (2, LM_CHECK_T[cfg.family]), LM_SEED + 3)
            y = counted("lm_prefill", f"{arch} fp32 check",
                        lambda: m2.forward(p2, toks2), want=none)
            row["fp32_card_vs_cpu"] = rel_l2(
                y.cpu(), m2.forward(tree_to(p2, "cpu"), toks2.cpu()))
            row["fp32_decode_vs_forward"] = (
                lm_decoded(m2, p2, toks2) - y).abs().max().item()
            if cfg.family in ("ssm", "hybrid"):
                off = build(dataclasses.replace(cfg2, use_sfc_conv=False))
                row["fp32_sfc_vs_direct_close"] = close_err(
                    y, off.forward(p2, toks2))
            del p2, y
            lm_free()
        if not (row["fp32_card_vs_cpu"] <= LM_REL
                and row["fp32_decode_vs_forward"] <= LM_DECODE_ABS
                and row.get("fp32_sfc_vs_direct_close", 0.0) <= LM_SFC):
            raise AssertionError(f"{arch}: the fp32 checks {row}")
        out["models"][arch] = row
        log(f"lm model: {arch} ({row['params'] / 1e9:.3f} B parameters, "
            f"{cfg.n_layers} layers, init {row['init_s']:.1f} s): prefill "
            f"of {LM_PREFILL} tokens in {cfg.compute_dtype} "
            f"{lm_fmt_ms(row['prefill_ms'])} ms on the card (spin-queued), "
            f"busy {lm_fmt_ms(row['prefill_trace']['busy_ms'])} ms in "
            f"{row['prefill_trace']['kernels']} kernels (traced), "
            f"{row['prefill_wall_ms']:.2f} ms wall; fp32 at "
            f"{LM_CHECK_LAYERS} layers: card against CPU "
            f"{row['fp32_card_vs_cpu']:.2e} rel L2, decode against forward "
            f"{row['fp32_decode_vs_forward']:.2e} max abs"
            + (f", SFC against direct {row['fp32_sfc_vs_direct_close']:.2e}"
               if "fp32_sfc_vs_direct_close" in row else "")
            + f"; full depth bf16 (findings): card against CPU "
            f"{row['bf16_card_vs_cpu']:.2e} rel L2 ({LM_BF16_T} tokens, "
            f"{row['bf16_cpu_s']:.1f} s), decode against forward "
            f"{row['bf16_decode_vs_forward']:.2e} max abs"
            + (f", SFC against direct {row['bf16_sfc_vs_direct_close']:.2e}"
               if "bf16_sfc_vs_direct_close" in row else ""))

    # ---- 11c. serving through launch.serve ------------------------------
    with captured_steps() as steps:
        for arch in LM_ARCHS:
            lm_free()
            torch.cuda.reset_peak_memory_stats(dev)
            resident = torch.cuda.memory_allocated(dev)
            argv = ["--arch", arch, *LM_SERVE_ARGS]
            stats = counted("lm_serve", f"{arch} serving",
                            lambda: serve.main(argv), want=none)
            warmed = serving_cache.stats()["size"]
            if stats.served != 12 or warmed != LM_WARMED[arch]:
                raise AssertionError(f"{arch} served {stats.served}, warmed "
                                     f"{warmed} conv layers")
            step = steps.pop()
            batch = int(argv[argv.index("--batch") + 1])
            tok = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
            pos = torch.full((batch,), 64, dtype=torch.int32, device=dev)
            # the serving's own peak, above what earlier phases left
            peak = (torch.cuda.max_memory_allocated(dev) - resident) / 1e9
            with torch.no_grad():
                card = lm_queued_ms(lambda: step.logits(tok, pos))
                trace = lm_traced(lambda: step.logits(tok, pos))
            lat = stats.latency_ms
            row = {"summary": stats.summary(), "warmed": warmed,
                   "wall_ms_per_step": stats.elapsed_s * 1e3 / stats.steps,
                   "card_ms_per_step": card, "step_trace": trace,
                   "peak_gb": peak}
            busy = trace["busy_ms"]
            row["host_share"] = None if busy is None \
                else 1 - busy / row["wall_ms_per_step"]
            out["serving"][arch] = row
            log(f"lm serve: {arch} served {stats.served} requests in "
                f"{stats.elapsed_s:.2f} s, {stats.steps} steps, "
                f"{stats.tok_per_s:.1f} tok/s, request p50 "
                f"{lat.percentile(50):.1f} ms p99 {lat.percentile(99):.1f} "
                f"ms; {row['wall_ms_per_step']:.2f} ms wall a decode step, "
                f"{lm_fmt_ms(card)} ms on the card (spin-queued), busy "
                f"{lm_fmt_ms(busy)} ms in {trace['kernels']} kernels "
                f"(traced; host-bound share "
                f"{lm_fmt_ms(row['host_share'])}); peak "
                f"{peak:.1f} GB; {warmed} conv layers warmed")
            step = None
    lm_free()

    # ---- 11d. smoke configs on the card against CPU copies ---------------
    for arch in LM_SMOKE_ARCHS:
        cfg = dataclasses.replace(configs.get_smoke_config(arch),
                                  compute_dtype="float32")
        m = build(cfg)
        with torch.no_grad():
            p = m.init(generator(LM_SEED + 4), device=dev)
            toks = tokens(cfg, (2, 16), LM_SEED + 5)
            y = counted("lm_prefill", f"{arch} smoke",
                        lambda: m.forward(p, toks), want=none)
            err = rel_l2(y.cpu(), m.forward(tree_to(p, "cpu"), toks.cpu()))
        if not err <= LM_REL:
            raise AssertionError(f"{arch} smoke: card against CPU {err}")
        out["smoke"][arch] = err
    log("lm smoke: card against CPU copies in fp32, rel L2 " + ", ".join(
        f"{a} {e:.2e}" for a, e in out["smoke"].items()))
    lm_free()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"lm: phase 11 took {out['seconds']:.1f} s on {smi}; no kernel of "
        f"the port launched")
    return out


def b4_candidates(dev, counted, timed, smi) -> dict:
    """Phase 3c (C12): B4 at sfc6_7 (t = 12) with every
    ``tuning.DEFAULT_CANDIDATES`` config over VGG-16's 13 convs at batch 1,
    each layer's input and weights from seeds: every fused config bit for
    bit the staged trio and within the int8 bounds of the reference path;
    its geometry (two weight stages of 16 tiles, one stage, or one stage of
    8 tiles) and its card time per layer, summed over the stack."""
    import torch

    from repro_torch.api import ConvSpec, plan, tuning
    from repro_torch.core import conv2d as c2d
    from repro_torch.kernels import sfc_fused
    from repro_torch.quant import INT8_FREQ

    staged_want = only(sfc_transform_quantize=1, tdmm_int8=1, sfc_inverse=1)
    rows, totals = [], {str(c): 0.0 for c in tuning.DEFAULT_CANDIDATES}
    layers, _ = vgg_layers()
    for li, (lname, hw, cin, cout) in enumerate(layers):
        rng = np.random.RandomState(C12_SEED + li)
        x = torch.tensor(rng.randn(1, hw, hw, cin), dtype=torch.float32,
                         device=dev)
        w = torch.tensor(rng.randn(3, 3, cin, cout)
                         * math.sqrt(2.0 / (9 * cin)), dtype=torch.float32,
                         device=dev)
        spec = ConvSpec.for_conv2d(x.shape, w.shape, quant=INT8_FREQ)
        p = plan(spec, backend="cuda", algo=C12_ALGO)
        if p.algo_name != C12_ALGO:
            raise AssertionError(f"{lname}: planned {p.algo_name}")
        act = tuning.calibrate_act_scale(x, p.algorithm, INT8_FREQ, "SAME")
        prep = p.prepare_weights(w, act_scale=act)
        y_ref = plan(spec, backend="reference", algo=C12_ALGO).apply(x, prep)
        staged = p.with_config(tuning.DEFAULT_STAGED)
        y_staged = counted("b4_candidates", f"{lname} staged",
                           lambda: staged.apply(x, prep), want=staged_want)
        grid = c2d.tile_grid(hw, hw, p.algorithm.M, p.algorithm.R, "SAME")
        for cfg in tuning.DEFAULT_CANDIDATES:
            pc = p.with_config(cfg)
            fused = cfg.datapath == "fused"
            y = counted("b4_candidates", f"{lname} {cfg}",
                        lambda: pc.apply(x, prep),
                        want=only(sfc_fused_conv2d=1) if fused
                        else staged_want)
            row = {"layer": lname, "hw": hw, "cin": cin, "cout": cout,
                   "config": str(cfg), "equal_staged": bool(
                       torch.equal(y, y_staged)),
                   "rel_l2": rel_l2(y, y_ref),
                   "scaled_max": ((y - y_ref).abs().max()
                                  / y_ref.abs().max()).item()}
            if fused:
                g = sfc_fused.fused_geometry(
                    p.algorithm, grid.nH * grid.nW, cin, cout,
                    k_block=cfg.k_block, cout_block=cfg.cout_block)
                row["geometry"] = {"tiles": g.tiles, "stages": g.stages,
                                   "cb": g.cb, "kb": g.kb,
                                   "n_share": g.n_share,
                                   "k_split": g.k_split,
                                   "smem": g.smem_bytes}
            max_rel, max_scaled = BOUNDS["int8"]
            if not (row["equal_staged"] and row["rel_l2"] <= max_rel
                    and row["scaled_max"] <= max_scaled):
                raise AssertionError(f"B4 at {C12_ALGO}: {row}")
            row["ms"] = timed(lambda: pc.apply(x, prep))
            totals[str(cfg)] += row["ms"]
            rows.append(row)
    log(f"c12: B4 at {C12_ALGO} (t = 12) over VGG-16's {len(layers)} convs, "
        f"batch 1, every default candidate bit for bit the staged trio and "
        f"within the int8 bounds of the reference (worst rel L2 "
        f"{max(r['rel_l2'] for r in rows):.3e}); card ms over the stack on "
        f"{smi}: " + "; ".join(f"{c} {t:.4f}" for c, t in totals.items()))
    for cfg in tuning.DEFAULT_CANDIDATES:
        geoms = sorted({json.dumps(r["geometry"], sort_keys=True)
                        for r in rows
                        if r["config"] == str(cfg) and "geometry" in r})
        if geoms:
            log(f"c12: {cfg} geometries: {', '.join(geoms)}")
    return {"rows": rows, "stack_ms": totals}


@contextlib.contextmanager
def lossless_moe():
    """The MoE FFN at capacity E / k (no token dropped) in the forward too,
    as the decode step runs it (tests/test_models.py patches the JAX
    package the same way)."""
    from repro_torch.models import moe
    orig = moe.moe_block
    moe.moe_block = lambda p, c, x, capacity_factor=None: orig(
        p, c, x, capacity_factor=c.n_experts / c.n_experts_active)
    try:
        yield
    finally:
        moe.moe_block = orig


def set_gates(params):
    """The vlm's gates (zero at init, where a wrong cross path would pass)
    set to LM12_GATES, in place."""
    import torch
    with torch.no_grad():
        params["cross_blocks"]["xattn"]["gate"].fill_(LM12_GATES["gate"])
        params["cross_blocks"]["ffn_gate"].fill_(LM12_GATES["ffn_gate"])


def lm_families(dev, counted, smi) -> dict:
    """Phase 12: the moe, vlm and encdec families (A14) at published
    widths, each forward, decode step and serving run launching none of
    B1-B7."""
    import torch

    import repro_torch.configs as configs
    import repro_torch.launch.serve as serve
    from repro_torch import tree as tree_util
    from repro_torch.models import build, transformer

    t_phase = time.perf_counter()
    none = only()
    out = {"models": {}, "smoke": {}}

    def memory_of(cfg, B, S, seed):
        """Seeded vision embeddings (vlm) or frames (encdec), else None."""
        rng = np.random.RandomState(seed)
        if cfg.family == "vlm":
            return torch.tensor(rng.randn(B, cfg.n_vision_tokens,
                                          cfg.d_model),
                                dtype=torch.float32, device=dev)
        if cfg.family == "encdec":
            return torch.tensor(rng.randn(B, S, cfg.d_model),
                                dtype=torch.float32, device=dev)
        return None

    def on_cpu(t):
        return None if t is None else t.cpu()

    for arch in LM12_ARCHS:
        t_arch = time.perf_counter()
        cut = LM12_DEPTH.get(arch)
        cfg = configs.get_config(arch)
        if cut:
            cfg = dataclasses.replace(cfg, **cut)
        row = {"family": cfg.family, "n_layers": cfg.n_layers,
               "first_dense_layers": cfg.first_dense_layers,
               "mtp_depth": cfg.mtp_depth, "depth_cut": cut or None,
               "compute_dtype": cfg.compute_dtype}
        # ---- 12a. serving ----------------------------------------------
        lm_free()
        torch.cuda.reset_peak_memory_stats(dev)
        resident = torch.cuda.memory_allocated(dev)
        argv = ["--arch", arch, *LM_SERVE_ARGS]
        with captured_steps() as steps:
            t0 = time.perf_counter()
            stats = counted(
                "lm_families", f"{arch} serving",
                (lambda: serve.serve(cfg, serve.parse_args(argv))) if cut
                else (lambda: serve.main(argv)), want=none)
            row["serve_s"] = time.perf_counter() - t0
            step = steps.pop()
        if stats.served != 12:
            raise AssertionError(f"{arch} served {stats.served}")
        model, params = step.model, step.params
        row["params"] = sum(a.numel() for a in tree_util.leaves(params))
        row["param_gb"] = sum(a.numel() * a.element_size()
                              for a in tree_util.leaves(params)) / 1e9
        batch = int(argv[argv.index("--batch") + 1])
        tok = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
        pos = torch.full((batch,), 64, dtype=torch.int32, device=dev)
        with torch.no_grad():
            card = lm_queued_ms(lambda: step.logits(tok, pos))
            trace = lm_traced(lambda: step.logits(tok, pos))
        lat = stats.latency_ms
        row["serving"] = {
            "summary": stats.summary(), "steps": stats.steps,
            "tok_per_s": stats.tok_per_s, "p50_ms": lat.percentile(50),
            "p99_ms": lat.percentile(99),
            "wall_ms_per_step": stats.elapsed_s * 1e3 / stats.steps,
            "card_ms_per_step": card, "step_trace": trace,
            "peak_gb": (torch.cuda.max_memory_allocated(dev) - resident)
            / 1e9}
        busy = trace["busy_ms"]
        sv = row["serving"]
        sv["host_share"] = None if busy is None \
            else 1 - busy / sv["wall_ms_per_step"]
        log(f"lm12 serve: {arch} ({row['params'] / 1e9:.3f} B parameters, "
            f"{row['param_gb']:.1f} GB, {cfg.n_layers} layers"
            + (f", cut from {configs.get_config(arch).n_layers}" if cut
               else "")
            + f") served {stats.served} requests in {stats.elapsed_s:.2f} "
            f"s, {stats.steps} steps, {stats.tok_per_s:.1f} tok/s, request "
            f"p50 {sv['p50_ms']:.1f} ms p99 {sv['p99_ms']:.1f} ms; "
            f"{sv['wall_ms_per_step']:.2f} ms wall a decode step, "
            f"{lm_fmt_ms(card)} ms on the card (spin-queued), busy "
            f"{lm_fmt_ms(busy)} ms in {trace['kernels']} kernels (traced; "
            f"host-bound share {lm_fmt_ms(sv['host_share'])}); peak "
            f"{sv['peak_gb']:.1f} GB above the resident")
        del step
        # ---- 12b. a bf16 prefill; 12d. bf16 findings at the served depth -
        if cfg.family == "vlm":
            transformer.clear_compute_cache()   # one compute copy at a time
            set_gates(params)
        with torch.no_grad():
            toks = lm_tokens(cfg, LM_PREFILL, LM12_SEED + 1, dev)
            mem = memory_of(cfg, LM_PREFILL[0], LM_PREFILL[1], LM12_SEED + 2)
            logits = counted("lm_families", f"{arch} prefill",
                             lambda: model.forward(params, toks, mem),
                             want=none)
            if tuple(logits.shape) != LM_PREFILL + (cfg.padded_vocab,) \
                    or not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{arch} prefill: {logits.shape}")
            del logits
            row["prefill_trace"] = lm_traced(
                lambda: model.forward(params, toks, mem))
            row["prefill_wall_ms"] = lm_wall_ms(
                lambda: model.forward(params, toks, mem))
            short, smem = toks[:, :LM_BF16_T], memory_of(
                cfg, 2, LM_BF16_T, LM12_SEED + 3)
            t0 = time.perf_counter()
            cpu_params = tree_to(transformer.cast_compute(params, cfg),
                                 "cpu")
            row["bf16_card_vs_cpu"] = rel_l2(
                counted("lm_families", f"{arch} bf16 short",
                        lambda: model.forward(params, short, smem),
                        want=none).cpu(),
                model.forward(cpu_params, short.cpu(), on_cpu(smem)))
            del cpu_params
            row["bf16_cpu_s"] = time.perf_counter() - t0
            dec = toks[:, :LM_DECODE_T]
            dmem = memory_of(cfg, 2, LM_DECODE_T, LM12_SEED + 4)
            with lossless_moe():
                row["bf16_decode_vs_forward"] = (
                    counted("lm_families", f"{arch} bf16 decode",
                            lambda: lm_decoded(model, params, dec, dmem),
                            want=none)
                    - model.forward(params, dec, dmem)).abs().max().item()
        del model, params, stats
        lm_free()
        # ---- 12c. fp32 at full width, the check depth --------------------
        cfg2 = dataclasses.replace(configs.get_config(arch),
                                   compute_dtype="float32",
                                   param_dtype="float32", **LM12_CHECK[arch])
        m2 = build(cfg2)
        with torch.no_grad():
            p2 = m2.init(torch.Generator(device=dev).manual_seed(
                LM12_SEED + 5), device=dev)
            if cfg2.family == "vlm":
                set_gates(p2)
            T = LM12_CHECK_T[arch]
            toks2 = lm_tokens(cfg2, (2, T), LM12_SEED + 6, dev)
            mem2 = memory_of(cfg2, 2, T, LM12_SEED + 7)
            y = counted("lm_families", f"{arch} fp32 check",
                        lambda: m2.forward(p2, toks2, mem2), want=none)
            t0 = time.perf_counter()
            cpu2 = tree_to(p2, "cpu")
            row["fp32_card_vs_cpu"] = rel_l2(
                y.cpu(), m2.forward(cpu2, toks2.cpu(), on_cpu(mem2)))
            del cpu2
            row["fp32_cpu_s"] = time.perf_counter() - t0
            with lossless_moe():
                y = m2.forward(p2, toks2, mem2)
                row["fp32_decode_vs_forward"] = (
                    counted("lm_families", f"{arch} fp32 decode",
                            lambda: lm_decoded(m2, p2, toks2, mem2),
                            want=none) - y).abs().max().item()
            row["fp32_check"] = {"n_layers": cfg2.n_layers,
                                 "first_dense_layers":
                                 cfg2.first_dense_layers,
                                 "mtp_depth": cfg2.mtp_depth, "tokens": T,
                                 "params": sum(a.numel() for a in
                                               tree_util.leaves(p2))}
            del p2, y
        lm_free()
        if not (row["fp32_card_vs_cpu"] <= LM_REL
                and row["fp32_decode_vs_forward"] <= LM_DECODE_ABS):
            raise AssertionError(f"{arch}: the fp32 checks {row}")
        row["seconds"] = time.perf_counter() - t_arch
        out["models"][arch] = row
        tr = row["prefill_trace"]
        log(f"lm12 model: {arch}: bf16 prefill of {LM_PREFILL} tokens busy "
            f"{lm_fmt_ms(tr['busy_ms'])} ms in {tr['kernels']} kernels "
            f"(traced), {row['prefill_wall_ms']:.2f} ms wall; fp32 at "
            f"{row['fp32_check']['n_layers']} layers "
            f"({row['fp32_check']['params'] / 1e9:.3f} B parameters, "
            f"{T} tokens): card against CPU {row['fp32_card_vs_cpu']:.2e} "
            f"rel L2, lossless decode against forward "
            f"{row['fp32_decode_vs_forward']:.2e} max abs (CPU "
            f"{row['fp32_cpu_s']:.1f} s); served depth bf16 (findings): "
            f"card against CPU {row['bf16_card_vs_cpu']:.2e} rel L2 "
            f"({LM_BF16_T} tokens, {row['bf16_cpu_s']:.1f} s), decode "
            f"against forward {row['bf16_decode_vs_forward']:.2e} max abs; "
            f"{row['seconds']:.1f} s")

    # ---- 12e. the smoke configs on the card against CPU copies -----------
    for arch in LM12_ARCHS:
        cfg = dataclasses.replace(configs.get_smoke_config(arch),
                                  compute_dtype="float32")
        m = build(cfg)
        with torch.no_grad():
            p = m.init(torch.Generator(device=dev).manual_seed(
                LM12_SEED + 8), device=dev)
            if cfg.family == "vlm":
                set_gates(p)
            toks = lm_tokens(cfg, (2, 16), LM12_SEED + 9, dev)
            labels = lm_tokens(cfg, (2, 16), LM12_SEED + 10, dev)
            mem = memory_of(cfg, 2, 16, LM12_SEED + 11)
            batch = {"tokens": toks, "labels": labels}
            if mem is not None:
                batch["vision" if cfg.family == "vlm" else "frames"] = mem
            y = counted("lm_families", f"{arch} smoke",
                        lambda: m.forward(p, toks, mem), want=none)
            _, metrics = counted("lm_families", f"{arch} smoke loss",
                                 lambda: m.loss(p, batch), want=none)
            cp = tree_to(p, "cpu")
            errs = {"logits": rel_l2(y.cpu(), m.forward(
                cp, toks.cpu(), on_cpu(mem)))}
            _, cpu_metrics = m.loss(cp, {k: v.cpu() for k, v in
                                         batch.items()})
            for k, v in cpu_metrics.items():
                errs[k] = abs(metrics[k].item() - v.item()) \
                    / max(abs(v.item()), 1e-30)
        if cfg.mtp_depth and "mtp" not in errs:
            raise AssertionError(f"{arch} smoke: no MTP term")
        if not all(e <= LM_REL for e in errs.values()):
            raise AssertionError(f"{arch} smoke: card against CPU {errs}")
        out["smoke"][arch] = errs
    log("lm12 smoke: card against CPU copies in fp32 (logits rel L2; loss "
        "terms relative): " + "; ".join(
            f"{a} " + ", ".join(f"{k} {v:.2e}" for k, v in e.items())
            for a, e in out["smoke"].items()))
    lm_free()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"lm12: phase 12 took {out['seconds']:.1f} s on {smi}; no kernel of "
        f"the port launched")
    return out


@contextlib.contextmanager
def caller_tf32():
    """TF32 allowed by the caller for cuBLAS's and cuDNN's float32 calls,
    by the API this PyTorch has; the caller's settings restored after."""
    import torch
    matmul = torch.backends.cuda.matmul
    conv = getattr(torch.backends.cudnn, "conv", None)
    if hasattr(matmul, "fp32_precision") and hasattr(conv, "fp32_precision"):
        where = ((matmul, "fp32_precision", "tf32"),
                 (conv, "fp32_precision", "tf32"))
    else:
        where = ((matmul, "allow_tf32", True),
                 (torch.backends.cudnn, "allow_tf32", True))
    saved = [getattr(obj, name) for obj, name, _ in where]
    try:
        for obj, name, on in where:
            setattr(obj, name, on)
        yield
    finally:
        for (obj, name, _), was in zip(where, saved):
            setattr(obj, name, was)


@contextlib.contextmanager
def remat_off():
    """The LM's layers not rematerialised (``lm_hidden``'s ``remat``)."""
    from repro_torch.models import transformer
    orig = transformer.lm_hidden
    transformer.lm_hidden = functools.partial(orig, remat=False)
    try:
        yield
    finally:
        transformer.lm_hidden = orig


@contextlib.contextmanager
def remat_policy(policy):
    """``REPRO_TORCH_REMAT_POLICY`` set to ``policy`` in the block."""
    from repro_torch.models import transformer
    name = transformer.REMAT_POLICY_ENV
    was = os.environ.get(name)
    os.environ[name] = policy
    try:
        yield
    finally:
        if was is None:
            del os.environ[name]
        else:
            os.environ[name] = was


def named_grads(grads):
    from repro_torch.tree import flatten_with_path
    return {"/".join(path): g for path, g in flatten_with_path(grads)}


def grads_close(got, ref) -> dict:
    """Each leaf of ``got`` against ``ref``'s (CPU tensors): rel L2, or,
    for a leaf zero in exact arithmetic (its reference's max |g| within
    LM13_DEAD of the largest), max |diff| over the largest max |g|."""
    gmax = max(g.abs().max().item() for g in ref.values())
    worst = {"rel_l2": 0.0, "leaf": None, "dead": [], "dead_max": 0.0}
    for k, r in ref.items():
        g = got[k].cpu()
        if r.abs().max().item() <= LM13_DEAD * gmax:
            worst["dead"].append(k)
            worst["dead_max"] = max(worst["dead_max"],
                                    (g - r).abs().max().item() / gmax)
            continue
        e = rel_l2(g.double(), r.double())
        if e >= worst["rel_l2"]:
            worst["rel_l2"], worst["leaf"] = e, k
    worst["ok"] = worst["rel_l2"] <= LM13_REL \
        and worst["dead_max"] <= LM13_DEAD
    return worst


def plain_flash(qg, k, v, causal, window):
    """The flash forward loop under autograd (no custom backward)."""
    from repro_torch.models import attention
    kp, vp, chunk, n = attention._flash_prep(k, v, 512)
    _, l, acc = attention._flash_fwd_scan(
        qg, kp, vp, qg.shape[1], k.shape[1], chunk, n, causal, window, 0,
        1.0 / np.sqrt(qg.shape[-1]))
    return (acc / l.clamp_min(1e-30)[..., None]).to(qg.dtype)


def lm_training(dev, counted, smi) -> dict:
    """Phase 13: LM training (A15) at published widths on the card; every
    step, forward and gradient launching none of B1-B7."""
    import shutil

    import torch

    import repro_torch.configs as configs
    from repro_torch import tree as tree_util
    from repro_torch.api import serving_cache
    from repro_torch.core.precision import full_fp32_backward
    from repro_torch.launch.train import token_batches
    from repro_torch.models import attention, build
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.train import (Trainer, TrainerConfig, TransientError,
                                   init_train_state, make_train_step)
    from repro_torch.train.steps import _value_and_grad

    t_phase = time.perf_counter()
    none = only()
    out = {"train": {}, "grads": {}, "remat": {}, "flash": {}}
    ckpt_root = ROOT / "build" / "chip_smoke_lm_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    deterministic = (torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled())
    # a resumed run, and a rematerialised one, replay the first bit for bit
    # only where every backward is deterministic (the embedding's and the
    # MoE dispatch's index_put accumulate)
    torch.use_deterministic_algorithms(True, warn_only=True)

    def n_params(tree):
        return sum(a.numel() for a in tree_util.leaves(tree))

    def seeded_batch(cfg, B, T, seed):
        """Seeded tokens and labels, and seeded vision embeddings or frames
        (zero ones would leave the encoder's gradients zero)."""
        rng = np.random.RandomState(seed)
        b = {"tokens": lm_tokens(cfg, (B, T), seed, dev),
             "labels": lm_tokens(cfg, (B, T), seed + 1, dev)}
        if cfg.family == "encdec":
            b["frames"] = torch.tensor(rng.randn(B, T, cfg.d_model),
                                       dtype=torch.float32, device=dev)
        return b

    try:
        # ---- 13a. training runs at published width -----------------------
        def optimizer():
            return AdamW(lr=cosine_schedule(LM13_LR, 1, LM13_STEPS))

        def clean_run(arch, cfg, model, batches):
            """The Trainer's step loop, without its checkpoints: losses,
            step times, peak above what was resident, the state."""
            lm_free()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            resident = torch.cuda.memory_allocated(dev)   # earlier phases'
            state = init_train_state(model, optimizer(), LM13_SEED, dev)
            step_fn = make_train_step(model, optimizer())
            losses, times = [], []
            for i in range(LM13_STEPS):
                t0 = time.perf_counter()
                state, metrics = counted(
                    "lm_training", f"{arch} step {i}",
                    lambda: step_fn(state, batches(i)), want=none)
                losses.append(float(metrics["loss"]))
                times.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated(dev) - resident
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"{arch}: losses {losses}")
            return losses, times, peak, resident, state, step_fn

        for arch, cut, B, S in LM13_TRAIN:
            t_arch = time.perf_counter()
            cfg = dataclasses.replace(configs.get_config(arch), **cut)
            model = build(cfg)
            batches = token_batches(cfg, B, S, dev)
            losses, times, peak, resident, state, step_fn = clean_run(
                arch, cfg, model, batches)
            n = n_params(state.params)
            batch = batches(LM13_STEPS)
            trace = counted("lm_training", f"{arch} traced step",
                            lambda: lm_traced(lambda: step_fn(state, batch)),
                            want=none)
            del state, batch
            lm_free()
            row = {"family": cfg.family, "n_layers": cfg.n_layers,
                   "depth_cut": cut or None, "batch": B, "seq": S,
                   "params": n, "losses": losses,
                   "step_ms_median": statistics.median(times[1:]) * 1e3,
                   "first_step_ms": times[0] * 1e3,
                   "step_trace": trace, "peak_gb": peak / 1e9,
                   "resident_gb": resident / 1e9,
                   "reckoned_state_gb": 16 * n / 1e9,
                   "reckoned_update_gb": 28 * n / 1e9}
            row["seconds"] = time.perf_counter() - t_arch
            out["train"][arch] = row
            log(f"lm13 train: {arch} ({n / 1e9:.3f} B parameters, "
                f"{cfg.n_layers} layers"
                + (f", cut from {configs.get_config(arch).n_layers}" if cut
                   else "")
                + f") batch {B} x {S}, bf16 compute, AdamW: losses "
                f"{', '.join(f'{v:.4f}' for v in losses)}; step "
                f"{row['step_ms_median']:.1f} ms wall (median of steps 2-"
                f"{LM13_STEPS}; first {row['first_step_ms']:.0f} ms); one "
                f"traced step busy {lm_fmt_ms(trace['busy_ms'])} ms in "
                f"{trace['kernels']} kernels, top {trace.get('top')}; peak "
                f"{row['peak_gb']:.1f} GB above the {row['resident_gb']:.1f} "
                f"GB resident before it (reckoned: state "
                f"{row['reckoned_state_gb']:.1f}, update "
                f"{row['reckoned_update_gb']:.1f}); {row['seconds']:.1f} s")

        # the Trainer with a TransientError at step LM13_FAULT and a
        # checkpoint at the last step: no checkpoint exists at the fault,
        # so it restarts from the seed and must replay the clean run's
        # losses bit for bit
        t_arch = time.perf_counter()
        arch, cut, B, S = LM13_REPLAY
        cfg = dataclasses.replace(configs.get_config(arch), **cut)
        model = build(cfg)
        batches = token_batches(cfg, B, S, dev)
        losses, _, _, _, state, _ = clean_run(arch, cfg, model, batches)
        n = n_params(state.params)
        del state
        lm_free()
        pending = {LM13_FAULT}

        def fault(step):
            if step in pending:
                pending.discard(step)
                raise TransientError(f"injected at step {step}")
        ckpt_dir = ckpt_root / arch
        trainer = Trainer(model, optimizer(), TrainerConfig(
            total_steps=LM13_STEPS, checkpoint_every=LM13_STEPS,
            checkpoint_dir=str(ckpt_dir), keep_checkpoints=1,
            log_every=10 ** 9), fault_hook=fault, device=dev)
        t0 = time.perf_counter()
        rep = counted("lm_training", f"{arch} Trainer with a fault",
                      lambda: trainer.run(batches, LM13_SEED), want=none)
        trainer_s = time.perf_counter() - t0
        trainer.ckpt.close()
        saved = trainer.ckpt.latest_step()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        if rep.restarts != 1 or rep.steps_run != LM13_FAULT + LM13_STEPS \
                or saved != LM13_STEPS:
            raise AssertionError(f"{arch}: the Trainer restarted "
                                 f"{rep.restarts} times, ran "
                                 f"{rep.steps_run} steps, saved {saved}")
        if rep.losses != losses[:LM13_FAULT] + losses:
            raise AssertionError(f"{arch}: the Trainer's losses "
                                 f"{rep.losses} against {losses}")
        lm_free()
        out["replay"] = {
            "arch": arch, "n_layers": cfg.n_layers, "batch": B, "seq": S,
            "params": n, "losses": losses, "trainer_losses": rep.losses,
            "resume_bitwise": True, "trainer_step_ms_median":
            statistics.median(rep.step_times[1:]) * 1e3,
            "trainer_s": trainer_s,
            "seconds": time.perf_counter() - t_arch}
        log(f"lm13 replay: {arch} at {cfg.n_layers} layers ({n / 1e9:.3f} B "
            f"parameters), batch {B} x {S}: the Trainer with a "
            f"TransientError at step {LM13_FAULT} restarted from the seed, "
            f"replayed the step loop's losses bit for bit and saved step "
            f"{saved} ({trainer_s:.1f} s; "
            f"{out['replay']['seconds']:.1f} s)")

        # ---- 13b. fp32 gradients, card against a CPU copy; 13e. C13 ------
        for arch, cut in LM13_GRAD.items():
            t_arch = time.perf_counter()
            cfg = dataclasses.replace(configs.get_config(arch),
                                      compute_dtype="float32",
                                      param_dtype="float32", **cut)
            model = build(cfg)
            with torch.no_grad():
                params = model.init(torch.Generator(device=dev).manual_seed(
                    LM13_SEED + 1), device=dev)
            batch = seeded_batch(cfg, 1, LM13_GRAD_T, LM13_SEED + 2)
            cpu = tree_to(params, "cpu")
            loss_c, _, g_c = _value_and_grad(
                model, cpu, {k: v.cpu() for k, v in batch.items()})
            g_c = named_grads(g_c)
            del cpu
            row = {"n_layers": cfg.n_layers, "params": n_params(params),
                   "tokens": LM13_GRAD_T}
            for setting, ctx in (("caller_default", contextlib.nullcontext),
                                 ("caller_tf32", caller_tf32)):
                with ctx():
                    loss, _, g = counted(
                        "lm_training", f"{arch} fp32 gradients {setting}",
                        lambda: _value_and_grad(model, params, batch),
                        want=none)
                err = grads_close(named_grads(g), g_c)
                err["loss_rel"] = abs(loss.item() - loss_c.item()) \
                    / abs(loss_c.item())
                del g
                row[setting] = err
                if not (err["ok"] and err["loss_rel"] <= LM13_LOSS):
                    raise AssertionError(f"{arch} {setting}: {err}")
            if cfg.family in ("ssm", "hybrid"):
                # 13e: a no_grad forward warms the serving cache; the
                # gradients after it are a fresh run's, bit for bit
                lm_free()
                _, _, fresh = _value_and_grad(model, params, batch)
                bypassed = serving_cache.stats()["size"] == 0
                with torch.no_grad():
                    counted("lm_training", f"{arch} no_grad forward",
                            lambda: model.loss(params, batch), want=none)
                warmed = serving_cache.stats()["size"]
                _, _, after = counted(
                    "lm_training", f"{arch} gradients after no_grad",
                    lambda: _value_and_grad(model, params, batch),
                    want=none)
                same = all(torch.equal(a, b) for a, b in zip(
                    tree_util.leaves(fresh), tree_util.leaves(after)))
                conv_g = after["blocks"]["mixer"]["conv_w"]
                row["c13"] = {"bypassed": bypassed, "warmed": warmed,
                              "bitwise": same,
                              "conv_w_grad_max": conv_g.abs().max().item()}
                if not (same and bypassed and warmed == cfg.n_layers
                        and row["c13"]["conv_w_grad_max"] > 0):
                    raise AssertionError(f"{arch} C13: {row['c13']}")
                del fresh, after
            del params, g_c
            lm_free()
            row["seconds"] = time.perf_counter() - t_arch
            out["grads"][arch] = row
            log(f"lm13 grads: {arch} fp32 at {cfg.n_layers} layers "
                f"({row['params'] / 1e9:.3f} B parameters, 1 x "
                f"{LM13_GRAD_T} tokens), card against a CPU copy: "
                + "; ".join(
                    f"{s} worst leaf {row[s]['leaf']} {row[s]['rel_l2']:.2e}"
                    f" rel L2, {len(row[s]['dead'])} dead leaves within "
                    f"{row[s]['dead_max']:.1e} of max |g|, loss "
                    f"{row[s]['loss_rel']:.1e}"
                    for s in ("caller_default", "caller_tf32"))
                + (f"; C13: after a no_grad forward ({row['c13']['warmed']}"
                   f" entries warmed; none under grad) the gradients bit "
                   f"for bit a fresh run's" if "c13" in row else "")
                + f"; {row['seconds']:.1f} s")

        # ---- 13c. remat off, full and dots -------------------------------
        arch, cut, B, S = LM13_REMAT
        cfg = dataclasses.replace(configs.get_config(arch), **cut)
        model = build(cfg)
        with torch.no_grad():
            params = model.init(torch.Generator(device=dev).manual_seed(
                LM13_SEED + 3), device=dev)
        batch = token_batches(cfg, B, S, dev)(0)
        runs = {}
        for policy, ctx in (("off", remat_off),
                            ("full", lambda: remat_policy("full")),
                            ("dots", lambda: remat_policy("dots"))):
            lm_free()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            with ctx():
                loss, _, g = counted("lm_training", f"remat {policy}",
                                     lambda: _value_and_grad(model, params,
                                                             batch),
                                     want=none)
            torch.cuda.synchronize()
            runs[policy] = (loss, tree_util.leaves(g),
                            (torch.cuda.max_memory_allocated(dev) - base)
                            / 1e9)
            del g
        ref_loss, ref_g, _ = runs["off"]
        for policy, (loss, g, peak) in runs.items():
            out["remat"][policy] = {
                "peak_gb_above_params": peak,
                "loss_diff": abs(loss.item() - ref_loss.item()),
                "grad_max_abs_diff": max((a - b).abs().max().item()
                                         for a, b in zip(g, ref_g))}
        del runs, ref_g, params
        lm_free()
        if any(r["loss_diff"] or r["grad_max_abs_diff"]
               for r in out["remat"].values()):
            raise AssertionError(f"remat: {out['remat']}")
        log(f"lm13 remat: {arch} at {cfg.n_layers} layers, batch {B} x {S}, "
            f"bf16 compute: " + "; ".join(
                f"{p} peak {r['peak_gb_above_params']:.2f} GB above the "
                f"parameters, loss and gradients max |diff| "
                f"{r['loss_diff']:.1e}, {r['grad_max_abs_diff']:.1e} from off"
                for p, r in out["remat"].items()))

        # ---- 13d. the flash backward against the plain loop --------------
        for name, B, S, hkv, g, hd, window in LM13_FLASH:
            gen = torch.Generator(device=dev).manual_seed(LM13_SEED + 4)
            qg, k, v, dout = (torch.randn(shape, generator=gen, device=dev)
                              for shape in ((B, S, hkv, g, hd),
                                            (B, S, hkv, hd), (B, S, hkv, hd),
                                            (B, S, hkv, g, hd)))
            row = {"shape": [B, S, hkv, g, hd], "window": window}
            grads = {}
            for how, fn in (("function", lambda q, kk, vv: (
                    attention.flash_attention(q, kk, vv, causal=True,
                                              window=window))),
                            ("plain", lambda q, kk, vv: plain_flash(
                                q, kk, vv, True, window))):
                lm_free()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
                live = [t.detach().requires_grad_() for t in (qg, k, v)]

                def run():
                    from repro_torch.core.precision import full_fp32_matmul
                    with full_fp32_matmul():
                        o = fn(*live)
                    with full_fp32_backward():
                        return torch.autograd.grad(o, live, dout)
                grads[how] = counted("lm_training", f"flash {name} {how}",
                                     run, want=none)
                torch.cuda.synchronize()
                row[f"{how}_peak_gb"] = (torch.cuda.max_memory_allocated(dev)
                                         - base) / 1e9
            row["rel_l2"] = {n: rel_l2(a, b) for n, a, b in zip(
                ("dq", "dk", "dv"), grads["function"], grads["plain"])}
            del grads, qg, k, v, dout
            lm_free()
            out["flash"][name] = row
            if not all(e <= LM13_FLASH_REL for e in row["rel_l2"].values()):
                raise AssertionError(f"flash {name}: {row}")
            log(f"lm13 flash: {name}'s shape {row['shape']} window {window}:"
                f" the Function's gradients against autograd through the "
                f"plain loop " + ", ".join(f"{n} {e:.2e}" for n, e in
                                           row["rel_l2"].items())
                + f" rel L2; peak {row['function_peak_gb']:.2f} GB against "
                f"{row['plain_peak_gb']:.2f}")
    finally:
        torch.use_deterministic_algorithms(deterministic[0],
                                           warn_only=deterministic[1])
        shutil.rmtree(ckpt_root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"lm13: phase 13 took {out['seconds']:.1f} s on {smi}; no kernel of "
        f"the port launched")
    return out


def lm_sharded(dev, counted, smi) -> dict:
    """Phase 14: the sharded LM train step (A16) and elastic restore (A17)
    on the card; every step, forward and gradient launching none of
    B1-B7 (the module's docstring, phase 14)."""
    import shutil

    import torch

    import repro_torch.configs as configs
    from repro_torch import tree as tree_util
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core.precision import (full_fp32_backward,
                                            full_fp32_matmul)
    from repro_torch.distributed import (act_sharding, lm_spmd, model_split,
                                         sharding)
    from repro_torch.distributed.pipeline import (pipeline_apply,
                                                  stack_params_for_stages)
    from repro_torch.launch.mesh import make_forced_host_mesh
    from repro_torch.launch.train import token_batches
    from repro_torch.models import build, moe, transformer
    from repro_torch.optim import AdamW
    from repro_torch.train import (Trainer, TrainerConfig, TransientError,
                                   abstract_train_state, init_train_state,
                                   make_train_step)
    from repro_torch.train.steps import _value_and_grad

    t_phase = time.perf_counter()
    none = only()
    out = {"grads": {}, "dispatch": {}, "elastic": {}, "pipeline": {},
           "big": {}}
    ckpt_root = ROOT / "build" / "chip_smoke_lm14_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    deterministic = (torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled())
    # the sums over data shards replay only where every backward is
    # deterministic (the embedding's and the MoE dispatch's index_put)
    torch.use_deterministic_algorithms(True, warn_only=True)

    def mesh_of(shape, axes=("data", "model")):
        """The visible GPUs where there are enough, else ``dev`` repeated,
        as phase 10 has its meshes."""
        if cards >= math.prod(shape):
            return make_forced_host_mesh(shape, axes)
        return make_forced_host_mesh(shape, axes, device=dev)

    def seeded_batch(cfg, B, T, seed):
        rng = np.random.RandomState(seed)
        b = {"tokens": lm_tokens(cfg, (B, T), seed, dev),
             "labels": lm_tokens(cfg, (B, T), seed + 1, dev)}
        if cfg.family == "vlm":
            b["vision"] = torch.tensor(
                rng.randn(B, cfg.n_vision_tokens, cfg.d_model),
                dtype=torch.float32, device=dev)
        if cfg.family == "encdec":
            b["frames"] = torch.tensor(rng.randn(B, T, cfg.d_model),
                                       dtype=torch.float32, device=dev)
        return b

    def on_host(tree):
        return {k: (v.gather("cpu") if isinstance(v, sharding.Sharded)
                    else v.detach().cpu())
                for k, v in named_grads(tree).items()}

    def against(tree, ref):
        """Each leaf of ``tree`` (``Sharded``, gathered on ``dev``) against
        its host reference, one leaf at a time on the card: name -> (rel
        L2, max |diff|, bit for bit, the reference's max |x|, the
        difference's L2 norm)."""
        out = {}
        for k, sh in named_grads(tree).items():
            g, r = sh.gather(dev), ref[k].to(dev)
            d = (g - r).double()
            norm = torch.linalg.vector_norm(d).item()
            out[k] = (norm / max(torch.linalg.vector_norm(r.double()).item(),
                                 1e-30),
                      d.abs().max().item() if d.numel() else 0.0,
                      bool(torch.equal(g, r)),
                      r.abs().max().item() if r.numel() else 0.0, norm)
            del g, r, d
        return out

    def check_blocks(state, shardings) -> int:
        """Each block on its coordinate's device with its spec's shape;
        the number of distinct blocks."""
        seen = set()
        for sh, s in zip(tree_util.leaves(state),
                         tree_util.leaves(shardings)):
            if tuple(sh.spec) != tuple(s.spec):
                raise AssertionError(f"spec {sh.spec} placed, {s.spec} "
                                     f"wanted")
            for coord in s.mesh.coords():
                block = sh.shards[coord]
                want = sharding.block_of(
                    torch.empty(sh.shape, device="meta"), sh.spec, s.mesh,
                    sh.block_index(coord))
                if block.device != s.mesh.device(coord) \
                        or tuple(block.shape) != tuple(want.shape):
                    raise AssertionError(
                        f"block {coord} of a {sh.shape} leaf: "
                        f"{tuple(block.shape)} on {block.device}, wanted "
                        f"{tuple(want.shape)} on {s.mesh.device(coord)}")
                seen.add(id(block))
        return len(seen)

    def synchronize():
        if dev.type == "cuda":
            for i in range(max(cards, 1)):
                torch.cuda.synchronize(i)

    def big_run(arch, cut):
        """14e: ``arch`` at full depth trained LM14_BIG_STEPS bf16 steps on
        each of LM14_BIG_MESHES over four cards."""
        cfg = dataclasses.replace(configs.get_config(arch), **cut)
        model, opt = build(cfg), AdamW(lr=LM13_LR)
        n = sum(a.numel() for a in tree_util.leaves(model.init_abstract()))
        B, T = LM14_BIG_BATCH
        batches = token_batches(cfg, B, T, dev)
        row = {"params": n, "n_layers": cfg.n_layers, "batch": [B, T],
               "one_device_state_gb": 16 * n / 1e9,
               "one_device_update_gb": 28 * n / 1e9, "meshes": {}}
        for shape in LM14_BIG_MESHES:
            mesh = make_forced_host_mesh(shape)
            shardings = lm_spmd.state_shardings(model, opt, mesh)
            lm_free()
            synchronize()
            for i in range(cards):
                torch.cuda.reset_peak_memory_stats(i)
            base = [torch.cuda.memory_allocated(i) for i in range(cards)]
            t0 = time.perf_counter()
            st = init_train_state(model, opt, LM14_SEED + 5, dev,
                                  shardings=shardings)
            synchronize()
            init_s = time.perf_counter() - t0
            held, seen = [0] * cards, set()
            for sh in tree_util.leaves(st):
                for blk in sh.shards.flat:
                    if id(blk) not in seen:
                        seen.add(id(blk))
                        held[blk.device.index or 0] += blk.numel() \
                            * blk.element_size()
            step_fn = make_train_step(model, opt)
            losses, times, replay = [], [], None
            reckoned = lm14_reckoned(st.params, mesh, B)
            model_split.reset_copied()
            for i in range(LM14_BIG_STEPS):
                if i == 1 and shape[1] > 1:
                    # two steps from one state: the same bits (the
                    # gradients four cards' backward threads send to a
                    # row, summed in one order)
                    a, _ = step_fn(st, batches(i))
                    b, _ = step_fn(st, batches(i))
                    replay = all(
                        torch.equal(x.shards[c], y.shards[c])
                        for x, y in zip(tree_util.leaves(a),
                                        tree_util.leaves(b))
                        for c in x.mesh.coords())
                    del a, b
                    model_split.reset_copied()
                    synchronize()
                t0 = time.perf_counter()
                st, metrics = counted(
                    "lm_sharded", f"{arch} {shape} step {i}",
                    lambda: step_fn(st, batches(i)), want=none)
                losses.append(float(metrics["loss"]))
                synchronize()
                times.append(time.perf_counter() - t0)
            moved = {k: v / (LM14_BIG_STEPS - (1 if replay is not None
                                                else 0))
                     for k, v in model_split.copied().items()}
            peaks = [(torch.cuda.max_memory_allocated(i) - base[i]) / 1e9
                     for i in range(cards)]
            traced = host_waits(lambda: step_fn(st, batches(0)), cards)
            del st, metrics
            lm_free()
            if not all(math.isfinite(v) for v in losses) \
                    or replay is False \
                    or moved["weights"] != reckoned:
                raise AssertionError(f"{arch} {shape}: losses {losses}, "
                                     f"replay {replay}, copied {moved}, "
                                     f"reckoned {reckoned}")
            row["meshes"][str(shape)] = {
                "losses": losses,
                "step_ms_median": statistics.median(times[1:]) * 1e3,
                "first_step_ms": times[0] * 1e3, "init_s": init_s,
                "peak_gb": peaks,
                "copied_gb_a_step": {k: v / 1e9 for k, v in moved.items()},
                "weights_reckoned_gb": reckoned / 1e9,
                "replayed_bitwise": replay, "traced": traced,
                "state_blocks_gb": [h / 1e9 for h in held],
                # the functional update holds the old and the new state
                # and the gradients: 28 of the state's 12 bytes a parameter
                "reckoned_update_gb": [h * 28 / 12 / 1e9 for h in held]}
            r = row["meshes"][str(shape)]
            log(f"lm14 full depth: {arch} ({n / 1e9:.3f} B parameters, "
                f"{cfg.n_layers} layers) on {shape} over {cards} cards, "
                f"batch {B} x {T}, bf16 compute: losses "
                f"{', '.join(f'{v:.4f}' for v in losses)}; step "
                f"{r['step_ms_median']:.1f} ms (median of steps 2-"
                f"{LM14_BIG_STEPS}; first {r['first_step_ms']:.0f} ms; init "
                f"{init_s:.1f} s); per card peak "
                f"{', '.join(f'{v:.1f}' for v in peaks)} GB against state "
                f"blocks {', '.join(f'{v:.1f}' for v in r['state_blocks_gb'])}"
                f" GB (update reckoned "
                f"{', '.join(f'{v:.1f}' for v in r['reckoned_update_gb'])});"
                f" one device would need {row['one_device_update_gb']:.1f} "
                f"GB for the update; copied a step "
                f"{r['copied_gb_a_step']['weights']:.2f} GB of weights "
                f"(reckoned {r['weights_reckoned_gb']:.2f}), "
                f"{r['copied_gb_a_step']['activations']:.3f} GB of "
                f"activations, {r['copied_gb_a_step']['gradients']:.2f} GB "
                f"of gradients; a traced step: "
                + (traced["not_measured"] if "not_measured" in traced else
                   f"wall {traced['wall_us'] / 1e3:.0f} ms, busy "
                   + ", ".join(f"{v / 1e3:.0f}"
                               for v in traced["busy_us"].values())
                   + " ms a card")
                + ("; two steps from one state bit for bit"
                   if replay else ""))
        return row

    def microbatched_cell():
        """14a: ``make_train_step(..., microbatches=2)`` over placed
        states against the unsharded microbatched step's gradients (its
        chunks' float32 sum, halved) and loss, fp32."""
        arch, cut, (B, T), meshes = LM14_MB_CELL
        cfg = dataclasses.replace(configs.get_config(arch),
                                  compute_dtype="float32",
                                  param_dtype="float32", **cut)
        model, opt = build(cfg), AdamW(lr=LM14_LR)
        batch = seeded_batch(cfg, B, T, LM14_SEED + 7)
        lm_free()
        state = init_train_state(model, opt, LM14_SEED, dev)
        grads, losses = None, []
        for i in range(2):
            chunk = {k: v[i * B // 2:(i + 1) * B // 2]
                     for k, v in batch.items()}
            loss, _, g = counted(
                "lm_sharded", f"{arch} one-device chunk {i}",
                lambda: _value_and_grad(model, state.params, chunk),
                want=none)
            grads = tree_util.tree_map(
                torch.add, tree_util.tree_map(
                    lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), state.params)
                if grads is None else grads, g)
            losses.append(loss)
        ref_loss = ((losses[0] + losses[1]) / 2).item()
        g_ref = on_host(tree_util.tree_map(lambda g: g / 2, grads))
        del state, grads, g
        lm_free()
        row = {"arch": arch, "n_layers": cfg.n_layers, "batch": [B, T],
               "microbatches": 2}
        for shape in meshes:
            mesh = mesh_of(shape)
            st = init_train_state(model, opt, LM14_SEED, dev,
                                  shardings=lm_spmd.state_shardings(
                                      model, opt, mesh))
            model_split.reset_copied()
            synchronize()
            t0 = time.perf_counter()
            loss, _, leaves = counted(
                "lm_sharded", f"{arch} {shape} microbatched gradients",
                lambda: lm_spmd.value_and_grad(model, st.params, batch,
                                               microbatches=2), want=none)
            synchronize()
            step_s = time.perf_counter() - t0
            moved = model_split.copied()
            grads = against(lm_spmd.gradients(leaves), g_ref)
            worst = max(grads, key=lambda k: grads[k][0])
            new, metrics = counted(
                "lm_sharded", f"{arch} {shape} microbatched step",
                lambda: make_train_step(model, opt, microbatches=2)(
                    st, batch), want=none)
            reckoned = lm14_reckoned(st.params, mesh, B, chunks=2)
            err = {"loss_rel": abs(loss.item() - ref_loss) / abs(ref_loss),
                   "leaf": worst, "rel_l2": grads[worst][0],
                   "bitwise": loss.item() == ref_loss
                   and all(v[2] for v in grads.values()),
                   "step_loss_same": float(metrics["loss"]) == loss.item(),
                   "copied": moved, "weights_reckoned": reckoned,
                   "gradients_s": step_s}
            row[str(shape)] = err
            del st, leaves, new
            lm_free()
            if not (err["loss_rel"] <= LM14_LOSS
                    and err["rel_l2"] <= LM13_REL and err["step_loss_same"]
                    and moved["weights"] == reckoned
                    and (shape != (1, 1) or err["bitwise"])):
                raise AssertionError(f"{arch} microbatched {shape}: {err}")
        log(f"lm14 microbatched: {arch} at {cfg.n_layers} layers, fp32, "
            f"{B} x {T} in 2 chunks, against the unsharded microbatched "
            f"step: " + "; ".join(
                f"{m} " + ("bit for bit" if row[str(m)]["bitwise"] else
                           f"loss {row[str(m)]['loss_rel']:.1e}, worst leaf "
                           f"{row[str(m)]['leaf']} "
                           f"{row[str(m)]['rel_l2']:.2e}")
                + f", {row[str(m)]['gradients_s'] * 1e3:.0f} ms, "
                f"{row[str(m)]['copied']['weights'] / 1e9:.3f} GB of "
                f"weights (reckoned "
                f"{row[str(m)]['weights_reckoned'] / 1e9:.3f})"
                for m in meshes))
        return row

    def compressed_cell():
        """14a: ``grad_compression=True`` over placed states: on (1, 1)
        the unsharded compressed gradients bit for bit; elsewhere each
        element within 1.01 max |g| / 127 of the uncompressed sharded
        gradient, and a second run bit for bit."""
        from repro_torch.optim import grad_compression as gcomp
        arch, cut, (B, T), meshes = LM14_GC_CELL
        cfg = dataclasses.replace(configs.get_config(arch),
                                  compute_dtype="float32",
                                  param_dtype="float32", **cut)
        model, opt = build(cfg), AdamW(lr=LM14_LR)
        batch = seeded_batch(cfg, B, T, LM14_SEED + 8)
        row = {"arch": arch, "n_layers": cfg.n_layers, "batch": [B, T]}

        def compressed(st):
            _, _, leaves = lm_spmd.value_and_grad(model, st.params, batch)
            # the uncompressed blocks: compress replaces them
            raw = named_grads(lm_spmd.gradients(leaves))
            lm_spmd.compress(leaves)
            return raw, lm_spmd.gradients(leaves)
        for shape in meshes:
            mesh = mesh_of(shape)
            lm_free()
            st = init_train_state(model, opt, LM14_SEED, dev,
                                  shardings=lm_spmd.state_shardings(
                                      model, opt, mesh))
            raw, got = counted("lm_sharded", f"{arch} {shape} compressed",
                               lambda: compressed(st), want=none)
            _, again = counted("lm_sharded",
                               f"{arch} {shape} compressed again",
                               lambda: compressed(st), want=none)
            new, _ = counted(
                "lm_sharded", f"{arch} {shape} compressed step",
                lambda: make_train_step(model, opt, grad_compression=True)(
                    st, batch), want=none)
            worst, same = 0.0, True
            for k, g in named_grads(got).items():
                q = g.gather(dev)
                r = raw[k].gather(dev)
                step = r.abs().max() / 127.0
                worst = max(worst, ((q - r).abs().max()
                                    / max(step.item(), 1e-30)).item())
                same = same and torch.equal(q, named_grads(again)[k].gather(
                    dev))
            err = {"worst_in_steps": worst, "replayed": same}
            if shape == (1, 1):
                state = init_train_state(model, opt, LM14_SEED, dev)
                _, _, g1 = _value_and_grad(model, state.params, batch)
                want = {k: gcomp.roundtrip_leaf(v)
                        for k, v in named_grads(g1).items()}
                err["bitwise"] = all(
                    torch.equal(g.gather(dev), want[k])
                    for k, g in named_grads(got).items())
                del state, g1, want
            row[str(shape)] = err
            del st, raw, got, again, new
            lm_free()
            if not (worst <= 1.01 and same and err.get("bitwise", True)):
                raise AssertionError(f"{arch} compressed {shape}: {err}")
        log(f"lm14 compressed: {arch} at {cfg.n_layers} layers, fp32, {B} x "
            f"{T}, int8 round trip of the sharded gradients: " + "; ".join(
                f"{m} within {row[str(m)]['worst_in_steps']:.3f} int8 steps"
                + (", bit for bit the unsharded compressed step"
                   if row[str(m)].get("bitwise") else "")
                + (", replayed bit for bit" if row[str(m)]["replayed"]
                   else "") for m in meshes))
        return row

    try:
        # ---- 14a. sharded fp32 steps against one device ------------------
        for arch, cut in LM14_ARCHS:
            t_arch = time.perf_counter()
            cfg = dataclasses.replace(configs.get_config(arch),
                                      compute_dtype="float32",
                                      param_dtype="float32", **cut)
            model, opt = build(cfg), AdamW(lr=LM14_LR)
            batch = seeded_batch(cfg, *LM14_BATCH, LM14_SEED + 1)
            refs = {}
            lm_free()
            state = init_train_state(model, opt, LM14_SEED, dev)
            n = sum(a.numel() for a in tree_util.leaves(state.params))
            for nd in sorted({shape[0] for shape in LM14_MESHES}):
                if refs and cfg.family != "moe":
                    refs[nd] = next(iter(refs.values()))
                    continue
                # the single-device step with the data shards' MoE chunks
                with act_sharding.local(nd):
                    loss, _, g = counted(
                        "lm_sharded", f"{arch} one-device gradients",
                        lambda: _value_and_grad(model, state.params, batch),
                        want=none)
                new_p, _, ref_m = opt.apply(state.params, g, state.opt)
                # how far the step moves each leaf, against its norm: the
                # first AdamW step is lr g / (|g| + eps), about lr an
                # element whatever |g|, so where it moves a leaf by more
                # than LM14_MOVED of its norm (a zero-init leaf, mixtral's
                # router) the update's difference is the gradients'
                # rounding amplified by the step's share
                old = named_grads(state.params)
                steps = {k: (v - old[k]).norm().item()
                         for k, v in named_grads(new_p).items()}
                moved = {k: steps[k] / max(old[k].norm().item(), 1e-30)
                         for k in steps}
                gmax = max(v.abs().max().item() for v in tree_util.leaves(g))
                # the moved leaves' old values and the step's clip scale,
                # for their steps element by element
                olds = {k: v.detach().cpu() for k, v in old.items()
                        if moved[k] > LM14_MOVED}
                scale = min(opt.clip_norm
                            / (ref_m["grad_norm"].item() + 1e-9), 1.0)
                refs[nd] = (loss.item(), on_host(g), on_host(new_p), steps,
                            moved, gmax, olds, scale)
                del g, new_p, old, ref_m
            del state
            lm_free()
            row = {"params": n, "n_layers": cfg.n_layers,
                   "depth_cut": cut or None, "batch": list(LM14_BATCH)}
            for shape in LM14_MESHES:
                mesh = mesh_of(shape)
                shardings = lm_spmd.state_shardings(model, opt, mesh)
                lm_free()
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
                st = init_train_state(model, opt, LM14_SEED, dev,
                                      shardings=shardings)
                blocks = check_blocks(st, shardings)
                reckoned = lm14_reckoned(st.params, mesh, LM14_BATCH[0])
                model_split.reset_copied()
                synchronize()
                t0 = time.perf_counter()
                loss, metrics, leaves = counted(
                    "lm_sharded", f"{arch} {shape} sharded gradients",
                    lambda: lm_spmd.value_and_grad(model, st.params, batch),
                    want=none)
                new, metrics = lm_spmd.apply_gradients(opt, st, leaves,
                                                       metrics)
                synchronize()
                step_s = time.perf_counter() - t0
                copies = model_split.copied()
                peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
                check_blocks(new, shardings)
                ref_loss, g_ref, p_ref, steps, moved, gmax, olds, scale = \
                    refs[shape[0]]
                del st
                err = {"loss_rel": abs(loss.item() - ref_loss)
                       / abs(ref_loss), "rel_l2": 0.0, "leaf": None,
                       "dead": [], "dead_max": 0.0}
                bitwise = loss.item() == ref_loss
                for k, (rel, diff, same, ref_max, _) in against(
                        lm_spmd.gradients(leaves), g_ref).items():
                    bitwise = bitwise and same
                    if ref_max <= LM13_DEAD * gmax:
                        err["dead"].append(k)
                        err["dead_max"] = max(err["dead_max"], diff / gmax)
                    elif rel >= err["rel_l2"]:
                        err["rel_l2"], err["leaf"] = rel, k
                err["bitwise"] = bitwise
                err["ok"] = err["rel_l2"] <= LM13_REL \
                    and err["dead_max"] <= LM13_DEAD
                # the moved leaves' gradient blocks, for the check below
                got_g = {k: v for k, v in named_grads(
                    lm_spmd.gradients(leaves)).items()
                    if shape != (1, 1) and moved[k] > LM14_MOVED}
                del leaves
                # the new parameters alone (the moments freed)
                got_p = named_grads(new.params)
                del new
                upd = against(got_p, p_ref)
                held = [k for k in upd if k not in got_g]
                err["update_leaf"] = max(held, key=lambda k: upd[k][0])
                err["update_rel"] = upd[err["update_leaf"]][0]
                # the others: the step itself within LM14_STEP_REL, where
                # 'model' cuts the mesh over the elements whose clipped
                # reference gradient exceeds LM14_NEAR_EPS eps; on the
                # card LM14_CHUNK elements at a time
                err["step_rel"], err["near_eps"] = {}, {}
                got_scale = min(opt.clip_norm / (
                    metrics["grad_norm"].item() + 1e-9), 1.0)
                near = LM14_NEAR_EPS * opt.eps if shape[1] > 1 else -1.0
                for k in sorted(got_g):
                    p = got_p[k].gather(dev).flatten()
                    r, o, gr = (t.flatten() for t in
                                (p_ref[k], olds[k], g_ref[k]))
                    num = den = 0.0
                    excluded, worst = 0, (0, 0.0, 0.0)
                    for a in range(0, p.numel(), LM14_CHUNK):
                        rc = r[a:a + LM14_CHUNK].to(dev)
                        gc = gr[a:a + LM14_CHUNK].to(dev) * scale
                        d = (p[a:a + LM14_CHUNK] - rc).double()
                        keep = gc.abs() > near
                        num += d[keep].square().sum().item()
                        den += (rc - o[a:a + LM14_CHUNK].to(dev)).double()[
                            keep].square().sum().item()
                        excluded += int((~keep).sum())
                        j = int(d.abs().argmax())
                        if abs(d[j].item()) >= abs(worst[1]):
                            worst = (a + j, d[j].item(), gc[j].item())
                        del rc, gc, d, keep
                    del p
                    err["step_rel"][k] = math.sqrt(num) / max(
                        math.sqrt(den), 1e-30)
                    if shape[1] > 1:
                        i = worst[0]
                        err["near_eps"][k] = {
                            "excluded": excluded, "of": r.numel(),
                            "whole_leaf_step_rel": upd[k][4]
                            / max(steps[k], 1e-30),
                            "worst_element": i,
                            "its_step_diff_in_lr": worst[1] / LM14_LR,
                            "its_ref_clipped_g": worst[2],
                            "its_clipped_g": got_g[k].gather(
                                dev).flatten()[i].item() * got_scale}
                del got_g, got_p
                err.update({"blocks": blocks, "step_s": step_s,
                            "peak_gb_above": peak, "copied": copies,
                            "weights_reckoned": reckoned})
                row[str(shape)] = err
                if not (err["ok"] and err["loss_rel"] <= LM14_LOSS
                        and err["update_rel"] <= LM14_UPDATE
                        and all(v <= LM14_STEP_REL
                                for v in err["step_rel"].values())
                        and copies["weights"] == reckoned
                        and (reckoned == 0) == (shape[0] == 1)) \
                        or (shape == (1, 1) and not err["bitwise"]):
                    raise AssertionError(f"{arch} {shape}: {err}")
            del refs
            lm_free()
            row["seconds"] = time.perf_counter() - t_arch
            out["grads"][arch] = row
            log(f"lm14 grads: {arch} fp32 at {cfg.n_layers} layers "
                f"({n / 1e9:.3f} B parameters, {LM14_BATCH[0]} x "
                f"{LM14_BATCH[1]} tokens), sharded against one device: "
                + "; ".join(
                    f"{shape} worst leaf {row[str(shape)]['leaf']} "
                    f"{row[str(shape)]['rel_l2']:.2e}, loss "
                    f"{row[str(shape)]['loss_rel']:.1e}, update "
                    f"{row[str(shape)]['update_rel']:.1e}"
                    + (", bit for bit" if row[str(shape)]['bitwise'] else "")
                    + (f", the steps of {len(row[str(shape)]['step_rel'])} "
                       f"leaves moved over {LM14_MOVED:.0%} within "
                       f"{max(row[str(shape)]['step_rel'].values()):.1e}"
                       if row[str(shape)]['step_rel'] else "")
                    + "".join(
                        f" ({k}: {v['excluded']} of {v['of']} elements "
                        f"near eps left out, the whole leaf "
                        f"{v['whole_leaf_step_rel']:.1e}, its worst element"
                        f" {v['worst_element']} {v['its_step_diff_in_lr']:.2f}"
                        f" lr apart, g {v['its_ref_clipped_g']:.2e} there, "
                        f"{v['its_clipped_g']:.2e} sharded)"
                        for k, v in row[str(shape)]['near_eps'].items())
                    + f", {row[str(shape)]['blocks']} blocks, step "
                    f"{row[str(shape)]['step_s'] * 1e3:.0f} ms, copied "
                    f"{row[str(shape)]['copied']['weights'] / 1e9:.3f} GB "
                    f"of weights (reckoned "
                    f"{row[str(shape)]['weights_reckoned'] / 1e9:.3f}), "
                    f"{row[str(shape)]['copied']['activations'] / 1e6:.2f}"
                    f" MB of activations, "
                    f"{row[str(shape)]['copied']['gradients'] / 1e9:.3f} GB"
                    f" of gradients, peak "
                    f"{row[str(shape)]['peak_gb_above']:.1f} GB"
                    for shape in LM14_MESHES)
                + f"; {row['seconds']:.1f} s")

        # ---- 14a, bf16: the sharded step against the unsharded one ------
        arch, cut = LM14_BF16
        cfg = dataclasses.replace(configs.get_config(arch), **cut)
        model, opt = build(cfg), AdamW(lr=LM14_LR)
        batch = seeded_batch(cfg, *LM14_BATCH, LM14_SEED + 6)
        lm_free()
        state = init_train_state(model, opt, LM14_SEED, dev)
        loss, _, g = counted(
            "lm_sharded", f"{arch} bf16 one-device gradients",
            lambda: _value_and_grad(model, state.params, batch), want=none)
        ref_loss, g_ref = loss.item(), on_host(g)
        del state, g
        lm_free()
        row = {"n_layers": cfg.n_layers, "compute_dtype": cfg.compute_dtype,
               "batch": list(LM14_BATCH), "loss": ref_loss}
        for shape in ((1, 2), (2, 1)):
            mesh = mesh_of(shape)
            st = init_train_state(model, opt, LM14_SEED, dev,
                                  shardings=lm_spmd.state_shardings(
                                      model, opt, mesh))
            loss, _, leaves = counted(
                "lm_sharded", f"{arch} bf16 {shape} sharded gradients",
                lambda: lm_spmd.value_and_grad(model, st.params, batch),
                want=none)
            grads = against(lm_spmd.gradients(leaves), g_ref)
            worst = max(grads, key=lambda k: grads[k][0])
            err = {"loss_rel": abs(loss.item() - ref_loss) / abs(ref_loss),
                   "bitwise": loss.item() == ref_loss
                   and all(v[2] for v in grads.values()),
                   "leaf": worst, "rel_l2": grads[worst][0]}
            row[str(shape)] = err
            del st, leaves
            lm_free()
            if not (err["loss_rel"] <= LM14_BF16_LOSS
                    and err["rel_l2"] <= LM14_BF16_GRAD):
                raise AssertionError(f"{arch} bf16 {shape}: {err}")
        out["grads"][f"{arch} bf16"] = row
        log(f"lm14 grads: {arch} at {cfg.n_layers} layers, bf16 compute, "
            f"sharded against the unsharded bf16 step: "
            + "; ".join(f"{k} loss {row[k]['loss_rel']:.1e}, worst leaf "
                        f"{row[k]['leaf']} {row[k]['rel_l2']:.2e} rel L2"
                        for k in ("(1, 2)", "(2, 1)")))

        # ---- 14a, microbatched and compressed cells ----------------------
        out["microbatched"] = microbatched_cell()
        out["compressed"] = compressed_cell()

        # ---- 14b. shard-local MoE dispatch, bit for bit ------------------
        cfg = dataclasses.replace(configs.get_config("mixtral-8x7b"),
                                  compute_dtype="float32",
                                  param_dtype="float32", n_layers=1)
        gen = torch.Generator(device=dev).manual_seed(LM14_SEED + 2)
        with torch.no_grad():
            params = build(cfg).init(gen, device=dev)
            ffn = transformer.layer(params["blocks"], 0)["ffn"]
            B, T = LM14_BATCH
            x = torch.randn((B, T, cfg.d_model), generator=gen, device=dev)
            mesh = mesh_of((2, 1))
            act_sharding.install(mesh, ("data",))
            try:
                with full_fp32_matmul():
                    whole, stats = counted(
                        "lm_sharded", "mixtral MoE block, data_shards 2",
                        lambda: moe.moe_block(ffn, cfg, x,
                                              router_stats=True), want=none)
                    with act_sharding.local(1):
                        parts = [counted(
                            "lm_sharded", f"mixtral MoE block, shard {s}",
                            lambda: moe.moe_block(
                                tree_util.tree_map(
                                    lambda a: a.to(mesh.device((s, 0))),
                                    ffn), cfg,
                                x[s * B // 2:(s + 1) * B // 2].to(
                                    mesh.device((s, 0))),
                                router_stats=True), want=none)
                            for s in range(2)]
            finally:
                act_sharding.clear()
            joined = torch.cat([p[0].to(dev) for p in parts])
            density = torch.stack([p[1][0].to(dev) for p in parts]).mean(0)
            out["dispatch"] = {
                "bitwise": bool(torch.equal(joined, whole)),
                "density_bitwise": bool(torch.equal(density, stats[0])),
                "max_abs_diff": (joined - whole).abs().max().item()}
            del params, ffn, x, whole, stats, parts, joined
        lm_free()
        if not (out["dispatch"]["bitwise"]
                and out["dispatch"]["density_bitwise"]):
            raise AssertionError(f"shard-local dispatch: {out['dispatch']}")
        log(f"lm14 dispatch: mixtral-8x7b's MoE block over a (2, 1) mesh's "
            f"shards bit for bit one device with data_shards 2 (output and "
            f"top-1 density), {LM14_BATCH[0]} x {LM14_BATCH[1]} tokens")

        # ---- 14c. elastic restore; a sharded Trainer's fault replay -------
        t_el = time.perf_counter()
        arch, cut, B, T = LM14_ELASTIC
        cfg = dataclasses.replace(configs.get_config(arch), **cut)
        model, opt = build(cfg), AdamW(lr=LM14_LR)
        batches = token_batches(cfg, B, T, dev)
        m22 = mesh_of((2, 2))
        s22 = lm_spmd.state_shardings(model, opt, m22)
        st = init_train_state(model, opt, LM14_SEED + 3, dev, shardings=s22)
        st, _ = counted("lm_sharded", f"{arch} (2, 2) step",
                        lambda: make_train_step(model, opt)(st, batches(0)),
                        want=none)
        ck = Checkpointer(str(ckpt_root / "elastic"))
        t0 = time.perf_counter()
        ck.save(1, st, blocking=True)
        save_s = time.perf_counter() - t0
        want = on_host(st)
        del st
        lm_free()
        el = {"arch": arch, "n_layers": cfg.n_layers, "save_s": save_s,
              "restored": {}}
        for shape in ((4, 1), (1, 1)):
            shardings = lm_spmd.state_shardings(model, opt, mesh_of(shape))
            t0 = time.perf_counter()
            got, step = ck.restore(abstract_train_state(model, opt),
                                   shardings=shardings)
            restore_s = time.perf_counter() - t0
            check_blocks(got, shardings)
            got = on_host(got)
            same = step == 1 and sorted(got) == sorted(want) and all(
                torch.equal(got[k], want[k]) for k in want)
            el["restored"][str(shape)] = {"bitwise": same,
                                          "restore_s": restore_s}
            if not same:
                raise AssertionError(f"elastic restore onto {shape} differs")
        # the checkpoint read as the JAX package's reader reads its format
        ref_npz = ckpt_root / "gathered.npz"
        np.savez(ref_npz, **{
            k.replace("/", "|"): (v.view(torch.int16).numpy().view(np.uint16)
                                  if v.dtype == torch.bfloat16
                                  else v.numpy())
            for k, v in want.items()})
        reader = subprocess.run(
            [sys.executable, "-c", JAX_FORMAT_READER,
             str(ckpt_root / "elastic" / f"step_{1:012d}"), str(ref_npz)],
            capture_output=True, text=True, timeout=300)
        if reader.returncode != 0:
            raise AssertionError(f"the format reader: {reader.stdout} "
                                 f"{reader.stderr}")
        el["format_reader"] = reader.stdout.strip()
        ck.close()
        del want

        def trainer(name, fault_hook=None):
            return Trainer(model, AdamW(lr=LM14_LR), TrainerConfig(
                total_steps=LM14_TRAINER_STEPS, checkpoint_every=2,
                checkpoint_dir=str(ckpt_root / name), keep_checkpoints=1,
                log_every=10 ** 9), mesh=m22, state_shardings=s22,
                fault_hook=fault_hook, device=dev)

        pending = {LM13_FAULT}

        def fault(step):
            if step in pending:
                pending.discard(step)
                raise TransientError(f"injected at step {step}")
        clean = counted("lm_sharded", f"{arch} sharded Trainer",
                        lambda: trainer("clean").run(batches, LM14_SEED),
                        want=none)
        faulty = counted("lm_sharded", f"{arch} sharded Trainer, a fault",
                         lambda: trainer("fault", fault).run(batches,
                                                             LM14_SEED),
                         want=none)
        el["trainer"] = {"losses": clean.losses,
                         "replayed": faulty.losses,
                         "restarts": faulty.restarts}
        if faulty.restarts != 1 or faulty.losses != \
                clean.losses[:LM13_FAULT] + clean.losses[LM13_FAULT - 1:]:
            raise AssertionError(f"the sharded Trainer's replay: {el}")
        el["seconds"] = time.perf_counter() - t_el
        out["elastic"] = el
        lm_free()
        log(f"lm14 elastic: {arch} at {cfg.n_layers} layers, a (2, 2) state "
            f"saved ({save_s:.1f} s) restored onto (4, 1) and (1, 1) bit "
            f"for bit; the format reader: {el['format_reader']}; a (2, 2) "
            f"Trainer with a TransientError at step {LM13_FAULT} restored "
            f"step 2 onto its mesh and replayed the losses bit for bit "
            f"({', '.join(f'{v:.4f}' for v in clean.losses)}); "
            f"{el['seconds']:.1f} s")

        # ---- 14d. the GPipe schedule over 4 stages -----------------------
        arch, n_layers, stages, (B, T), micro = LM14_PIPE
        cfg = dataclasses.replace(configs.get_config(arch),
                                  compute_dtype="float32",
                                  param_dtype="float32", n_layers=n_layers)
        gen = torch.Generator(device=dev).manual_seed(LM14_SEED + 4)
        with torch.no_grad():
            blocks = build(cfg).init(gen, device=dev)["blocks"]
        x = torch.randn((B, T, cfg.d_model), generator=gen, device=dev)
        cot = torch.randn((B, T, cfg.d_model), generator=gen, device=dev)
        mesh = mesh_of((stages,), ("stage",))

        def stage_fn(sp, h):
            for i in range(tree_util.leaves(sp)[0].shape[0]):
                h = transformer.mamba_layer(transformer.layer(sp, i), cfg, h)
            return h

        def grads_of(fn):
            live = tree_util.tree_map(lambda a: a.detach().requires_grad_(),
                                      blocks)
            xl = x.detach().requires_grad_()
            with full_fp32_matmul():
                y = fn(live, xl)
            with full_fp32_backward():
                gs = torch.autograd.grad(
                    y, [xl] + tree_util.leaves(live), cot)
            return y.detach(), gs

        t0 = time.perf_counter()
        y_p, g_p = counted(
            "lm_sharded", "pipeline_apply",
            lambda: grads_of(lambda live, xl: pipeline_apply(
                stage_fn, stack_params_for_stages(live, stages), xl, micro,
                mesh)), want=none)
        synchronize()
        pipe_s = time.perf_counter() - t0
        mb = B // micro
        t0 = time.perf_counter()
        # the sequential stack on the same microbatches (the same products)
        y_m, g_m = counted("lm_sharded", "the sequential stack, by "
                           "microbatch", lambda: grads_of(
                               lambda live, xl: torch.cat(
                                   [stage_fn(live, xl[i * mb:(i + 1) * mb])
                                    for i in range(micro)])), want=none)
        synchronize()
        seq_s = time.perf_counter() - t0
        # and on the whole batch: other product shapes, other roundings
        y_s, g_s = counted("lm_sharded", "the sequential stack",
                           lambda: grads_of(stage_fn), want=none)
        pipe = {"arch": arch, "layers": n_layers, "stages": stages,
                "batch": [B, T], "microbatches": micro,
                "forward_rel": rel_l2(y_p, y_m),
                "grad_rel": max(rel_l2(a, b) for a, b in zip(g_p, g_m)),
                "whole_batch_forward_rel": rel_l2(y_p, y_s),
                "whole_batch_grad_rel": max(rel_l2(a, b)
                                            for a, b in zip(g_p, g_s)),
                "pipeline_s": pipe_s, "sequential_s": seq_s}
        out["pipeline"] = pipe
        del blocks, x, cot, y_p, g_p, y_m, g_m, y_s, g_s
        lm_free()
        if not (pipe["forward_rel"] <= LM14_PIPE_REL
                and pipe["grad_rel"] <= LM14_PIPE_REL
                and pipe["whole_batch_forward_rel"] <= LM13_REL
                and pipe["whole_batch_grad_rel"] <= LM13_REL):
            raise AssertionError(f"pipeline_apply: {pipe}")
        log(f"lm14 pipeline: {arch} {n_layers} full-width layers over "
            f"{stages} stages ({mesh}), {micro} microbatches of {mb} x {T}:"
            f" forward {pipe['forward_rel']:.1e}, worst gradient "
            f"{pipe['grad_rel']:.1e} rel L2 from the sequential stack on "
            f"the same microbatches; {pipe['whole_batch_forward_rel']:.1e} "
            f"and {pipe['whole_batch_grad_rel']:.1e} from it on the whole "
            f"batch; {pipe_s:.2f} s against {seq_s:.2f} s")

        # ---- 14e. full depth over four cards -----------------------------
        if cards < 4:
            out["big"] = {"ran": False,
                          "why": f"{cards} card(s) visible; 14e needs 4"}
            log(f"lm14 full depth: did not run: {cards} card(s) visible, "
                f"stablelm-3b and phi4-mini-3.8b at full depth need four")
        else:
            for arch, cut in LM14_BIG:
                out["big"][arch] = big_run(arch, cut)
    finally:
        act_sharding.clear()
        torch.use_deterministic_algorithms(deterministic[0],
                                           warn_only=deterministic[1])
        shutil.rmtree(ckpt_root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"lm14: phase 14 took {out['seconds']:.1f} s on {smi}; no kernel of "
        f"the port launched")
    return out


# the entries of a parameter tree a decode step reads, less the cross K/V
# projections (init_cache computes the cross cache from them)
LM15_DECODE_KEYS = ("embed", "final_norm", "lm_head", "blocks",
                    "dense_blocks", "cross_blocks", "shared_block")
LM15_INIT_ONLY = {("cross_blocks", "xattn", "wk"),
                  ("cross_blocks", "xattn", "wv")}


# the stacks a sharded train step rematerialises (their layers fetched
# again in the backward), and the entries a prefill reads
LM14_REMAT_STACKS = ("blocks", "dense_blocks", "cross_blocks")
LM15_PREFILL_KEYS = LM15_DECODE_KEYS + ("enc_blocks", "enc_norm")


def lm_data_gather(placed, mesh, batch, fetches, chunks=1) -> int:
    """The weight bytes a sharded step copies when each block computes
    where it lies: in each of ``chunks`` chunks of the batch each row that
    computes (every data row where they divide the chunk, else the first)
    gathers over the data axes (D - 1) / D of each leaf whose spec names
    'data', ``fetches(path)`` times; 0 on one data row."""
    from repro_torch import tree as tree_util
    D = mesh.shape["data"]
    rows = D if (batch // chunks) % D == 0 else 1
    total = 0
    for path, sh in tree_util.flatten_with_path(placed):
        if any("data" in (e if isinstance(e, tuple) else (e,))
               for e in sh.spec if e is not None):
            nbytes = math.prod(sh.shape) * sh.shards.flat[0].element_size()
            total += chunks * rows * fetches(path) * nbytes * (D - 1) // D
    return total


def lm15_reckoned(placed, mesh, batch) -> int:
    """A decode step's: the leaves it reads, less the cross K/V
    projections."""
    return lm_data_gather(
        placed, mesh, batch,
        lambda path: int(path[0] in LM15_DECODE_KEYS
                         and tuple(path[-3:]) not in LM15_INIT_ONLY))


def lm15_prefill_reckoned(placed, mesh, batch) -> int:
    """A prefill's: every leaf the forward reads, once."""
    return lm_data_gather(placed, mesh, batch,
                          lambda path: int(path[0] in LM15_PREFILL_KEYS))


def lm14_reckoned(params, mesh, batch, chunks=1) -> int:
    """A train step's: every leaf once, a rematerialised stack's layers
    twice (the backward's recomputation fetches them again)."""
    return lm_data_gather(
        params, mesh, batch,
        lambda path: 2 if path[0] in LM14_REMAT_STACKS else 1, chunks)


def host_waits(fn, cards: int) -> dict:
    """One ``fn`` call under ``torch.profiler`` (after a warm call): the
    CUDA runtime calls that make the host wait (a synchronize, a blocking
    memcpy) with their count and host µs, the trace's own synchronize of
    each card at the end among them, the peer copies on the cards,
    the host's time to enqueue the call against the wall time to its end
    on every card, and each card's busy µs; ``not_measured`` where the
    profiler does not trace the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def sync():
        for i in range(cards):
            torch.cuda.synchronize(i)
    fn()
    sync()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            enqueue_us = (time.perf_counter() - t0) * 1e6
            sync()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = list(prof.events())
    except Exception as e:     # the profiler may not trace this card
        return {"not_measured": f"{type(e).__name__}: {e}"[:200]}
    runtime, busy, copies = {}, {}, {}
    for e in events:
        dur = e.time_range.end - e.time_range.start
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy[e.device_index] = busy.get(e.device_index, 0.0) + dur
            if "memcpy" in e.name.lower():
                n, us = copies.get(e.name, (0, 0.0))
                copies[e.name] = (n + 1, us + dur)
        elif e.name.startswith("cuda"):
            n, us = runtime.get(e.name, (0, 0.0))
            runtime[e.name] = (n + 1, us + dur)
    if not busy:
        return {"not_measured": "the trace holds no device events"}
    waits = {k: {"count": n, "host_us": us} for k, (n, us) in
             runtime.items() if "Synchronize" in k
             or k in ("cudaMemcpy", "cudaMemcpyPeer", "cudaMemcpy2D")}
    return {"waits": waits,
            "runtime": {k: {"count": n, "host_us": us}
                        for k, (n, us) in sorted(runtime.items())},
            "device_copies": {k: {"count": n, "us": us}
                              for k, (n, us) in sorted(copies.items())},
            "busy_us": {str(k): v for k, v in sorted(busy.items())},
            "enqueue_us": enqueue_us, "wall_us": wall_us}


def lm_serve_sharded(dev, counted, smi) -> dict:
    """Phase 15: the sharded serve and prefill steps (A16's serving half):
    decode caches placed by cache_pspecs, attention merged over a
    sequence-sharded cache, SSM states over their heads; every step and
    prefill launching none of B1-B7 (the module's docstring, phase 15)."""
    import torch

    import repro_torch.configs as configs
    from repro_torch import tree as tree_util
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import (act_sharding, model_split,
                                         serve_spmd, sharding)
    from repro_torch.launch.mesh import make_forced_host_mesh
    from repro_torch.launch.serve import GreedyStep
    from repro_torch.models import build
    from repro_torch.serve import PromptStream, SlotLoop
    from repro_torch.train import make_prefill_step

    t_phase = time.perf_counter()
    none = only()
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    out = {"check": {}, "bf16": {}, "big": {}}

    def mesh_of(shape):
        """The visible GPUs where there are enough, else ``dev`` repeated,
        as phase 14 has its meshes."""
        if cards >= math.prod(shape):
            return make_forced_host_mesh(shape)
        return make_forced_host_mesh(shape, device=dev)

    def synchronize():
        if dev.type == "cuda":
            for i in range(max(cards, 1)):
                torch.cuda.synchronize(i)

    def memory_of(cfg, B, seed):
        """Seeded vision embeddings (vlm) or encoder frames (encdec)."""
        rng = np.random.RandomState(seed)
        if cfg.family == "vlm":
            shape = (B, cfg.n_vision_tokens, cfg.d_model)
        elif cfg.family == "encdec":
            shape = (B, 64, cfg.d_model)
        else:
            return None
        return torch.tensor(rng.randn(*shape), dtype=torch.float32,
                            device=dev)

    def seeded(shapes, seed):
        """Seeded N(0, 1) entries for every leaf but the cross K/V (what
        init_cache computes from the memory): (path, shape, dtype) ->
        tensor on ``dev`` or None."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        return [None if path[0] in ("cross_k", "cross_v") else
                torch.randn(shape, generator=gen, device=dev).to(dtype)
                for path, shape, dtype in shapes]

    def shapes_of(cache):
        return [(path, tuple(leaf.shape), leaf.dtype)
                for path, leaf in tree_util.flatten_with_path(cache)]

    def fill(cache, values):
        """The seeded entries into a cache: a plain one's leaves, or a
        placed one's blocks, each from its slice."""
        for leaf, v in zip(tree_util.leaves(cache), values):
            if v is None:
                continue
            if not isinstance(leaf, sharding.Sharded):
                leaf.copy_(v)
                continue
            for idx, coords in leaf.unique().items():
                blk = sharding.block_of(v, leaf.spec, leaf.mesh, idx)
                for c in coords:
                    leaf.shards[c].copy_(blk)

    def blocks_of(cache):
        return [(str(b.device), b.data_ptr())
                for sh in tree_util.leaves(cache) for b in sh.shards.flat]

    def decoded(model, params, cache, toks, pos0, what):
        """LM15_STEPS teacher-forced steps: (logits, wall ms a step)."""
        logits = []
        synchronize()
        t0 = time.perf_counter()
        for t in range(LM15_STEPS):
            lg, cache = counted(
                "lm_serve_sharded", f"{what} step {t}",
                lambda: model.decode_step(params, cache, toks[t], pos0 + t),
                want=none)
            logits.append(lg)
        synchronize()
        return logits, (time.perf_counter() - t0) * 1e3 / LM15_STEPS


    class FiniteStep(GreedyStep):
        """``GreedyStep`` that also counts the non-finite logits it makes
        (on the card, read once at the end) and the most memory each card
        holds after a step (the allocator's count, read on the host)."""
        bad = None
        held = None

        def logits(self, tok, pos):
            lg = super().logits(tok, pos)
            bad = (~torch.isfinite(lg)).sum()
            self.bad = bad if self.bad is None else self.bad + bad
            now = [torch.cuda.memory_allocated(i) / 1e9
                   for i in range(cards)]
            self.held = now if self.held is None \
                else [max(a, b) for a, b in zip(self.held, now)]
            return lg

    def big_serve(arch, cut, meshes, failures):
        """15b: ``arch`` at the depth ``cut`` leaves, bf16, served over
        four cards on each of ``meshes``; LM15_STEPS teacher-forced steps
        from one seeded cache on each, in fp32 (the meshes held to each
        other) and in bf16 (a finding); what fails goes to ``failures``."""
        cfg = dataclasses.replace(configs.get_config(arch),
                                  param_dtype="bfloat16",
                                  compute_dtype="bfloat16", **cut)
        model = build(cfg)
        n = sum(a.numel() for a in tree_util.leaves(model.init_abstract()))
        srv = LM15_SERVE
        B, L = srv["batch"], srv["max_len"]
        cache_shape = ShapeConfig("decode", L, B, "decode")
        toks = lm_tokens(cfg, (LM15_STEPS, B, 1), LM15_SEED + 8, dev)
        pos0 = torch.tensor(LM15_BIG_STARTS, dtype=torch.int32, device=dev)
        row = {"params": n, "n_layers": cfg.n_layers,
               "weights_gb": 2 * n / 1e9, "meshes": {}}
        check, check32 = {}, {}
        m32 = build(dataclasses.replace(cfg, param_dtype="float32",
                                        compute_dtype="float32"))
        for shape in meshes:
            mesh = make_forced_host_mesh(shape)
            if len(meshes) > 1:
                # the check in fp32: the same draws, the same seeded cache
                lm_free()
                placed = serve_spmd.init_params(
                    m32, LM15_SEED + 6, serve_spmd.param_shardings(m32, mesh),
                    dev)
                cache = m32.init_cache(
                    placed, B, L, shardings=sharding.cache_shardings(
                        m32, cache_shape, mesh))
                fill(cache, seeded(shapes_of(cache), LM15_SEED + 9))
                got, _ = decoded(m32, placed, cache, toks, pos0,
                                 f"{arch} {shape} fp32")
                check32[str(shape)] = [lg.cpu() for lg in got]
                del placed, cache, got
            lm_free()
            synchronize()
            for i in range(cards):
                torch.cuda.reset_peak_memory_stats(i)
            t0 = time.perf_counter()
            placed = serve_spmd.init_params(
                model, LM15_SEED + 6, serve_spmd.param_shardings(model, mesh),
                dev)
            synchronize()
            init_s = time.perf_counter() - t0
            # the peak while init_params draws a layer whole and places it,
            # then what the blocks hold
            placed_peaks = [torch.cuda.max_memory_allocated(i) / 1e9
                            for i in range(cards)]
            after_init = [torch.cuda.memory_allocated(i) / 1e9
                          for i in range(cards)]
            for i in range(cards):
                torch.cuda.reset_peak_memory_stats(i)
            held, seen = [0] * cards, set()
            for sh in tree_util.leaves(placed):
                for blk in sh.shards.flat:
                    if id(blk) not in seen:
                        seen.add(id(blk))
                        held[blk.device.index or 0] += blk.numel() \
                            * blk.element_size()
            shardings = sharding.cache_shardings(model, cache_shape, mesh)
            cache = model.init_cache(placed, B, L, shardings=shardings)
            fill(cache, seeded(shapes_of(cache), LM15_SEED + 9))
            model_split.reset_copied()
            got, check_ms = decoded(model, placed, cache, toks, pos0,
                                    f"{arch} {shape} bf16")
            check_moved = model_split.copied()
            step_peaks = [torch.cuda.max_memory_allocated(i) / 1e9
                          for i in range(cards)]
            check[str(shape)] = [lg.float().cpu() for lg in got]
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            # one step traced: does a cross-card copy make the host wait?
            at = pos0 + LM15_STEPS
            waits = host_waits(lambda: counted(
                "lm_serve_sharded", f"{arch} {shape} traced step",
                lambda: model.decode_step(placed, cache, toks[0], at),
                want=none), cards)
            del cache, got
            # the prefill over the placement: each block where it lies
            pre, pre_ms, pre_moved = timed_prefill(
                f"{arch} {shape}", model, placed,
                lm_tokens(cfg, LM15_BIG_PREFILL, LM15_SEED + 10, dev))
            pre_finite = bool(torch.isfinite(pre).all())
            pre_reckoned = lm15_prefill_reckoned(placed, mesh,
                                                 LM15_BIG_PREFILL[0])
            del pre
            for i in range(cards):
                torch.cuda.reset_peak_memory_stats(i)
            step = FiniteStep(model, placed,
                              model.init_cache(placed, B, L,
                                               shardings=shardings), dev)
            loop = SlotLoop(batch=B, gen=srv["gen"], max_len=L,
                            requests=srv["requests"],
                            prompts=PromptStream(cfg.vocab_size,
                                                 lengths=srv["prompts"],
                                                 seed=LM15_SEED + 7))
            model_split.reset_copied()
            stats = counted("lm_serve_sharded", f"{arch} {shape} served",
                            lambda: loop.run(step), want=none)
            synchronize()
            moved = model_split.copied()
            peaks = [torch.cuda.max_memory_allocated(i) / 1e9
                     for i in range(cards)]
            bad = int(step.bad)
            reckoned = lm15_reckoned(placed, mesh, B)
            lat = stats.latency_ms
            r = {"tok_per_s": stats.tok_per_s, "p50_ms": lat.percentile(50),
                 "p99_ms": lat.percentile(99), "steps": stats.steps,
                 "tokens": stats.tokens, "served": stats.served,
                 "wrapped": stats.wrapped, "elapsed_s": stats.elapsed_s,
                 "step_ms": stats.elapsed_s * 1e3 / stats.steps,
                 "check_step_ms": check_ms,
                 "copied_gb_a_step": {k: v / stats.steps / 1e9
                                      for k, v in moved.items()},
                 "weights_reckoned_gb_a_step": reckoned / 1e9,
                 "check_copied_gb_a_step": {k: v / LM15_STEPS / 1e9
                                            for k, v in check_moved.items()},
                 "peak_gb": peaks, "placed_peak_gb": placed_peaks,
                 "after_init_gb": after_init, "steps_peak_gb": step_peaks,
                 "blocks_gb": [h / 1e9 for h in held],
                 "held_after_a_step_gb": step.held,
                 "host_waits": waits,
                 "prefill": {"batch": list(LM15_BIG_PREFILL),
                             "ms": pre_ms, "finite": pre_finite,
                             "copied_gb": {k: v / 1e9
                                           for k, v in pre_moved.items()},
                             "weights_reckoned_gb": pre_reckoned / 1e9},
                 "init_s": init_s, "nonfinite_logits": bad,
                 "check_finite": finite}
            row["meshes"][str(shape)] = r
            log(f"lm15 serve record: {arch} {shape} " + json.dumps(r))
            del placed, step, loop
            lm_free()
            if bad or not finite or moved["cache"] \
                    or moved["weights"] != stats.steps * reckoned \
                    or check_moved["weights"] != LM15_STEPS * reckoned \
                    or not pre_finite \
                    or pre_moved["weights"] != pre_reckoned:
                failures.append(f"{arch} {shape} served: {r}")
            log(f"lm15 serve: {arch} ({n / 1e9:.3f} B parameters, "
                f"{cfg.n_layers} layers, bf16) on {shape} over {cards} "
                f"cards: {stats.served} requests, {stats.tokens} tokens in "
                f"{stats.steps} steps, {r['tok_per_s']:.2f} tok/s, request "
                f"p50 {r['p50_ms']:.0f} ms p99 {r['p99_ms']:.0f} ms, "
                f"{r['step_ms']:.1f} ms a step, "
                f"{r['copied_gb_a_step']['weights']:.2f} GB of weights and "
                f"{r['copied_gb_a_step']['activations'] * 1e3:.3f} MB of "
                f"activations copied a step (weights reckoned "
                f"{reckoned / 1e9:.2f} GB); peak a card "
                f"{', '.join(f'{v:.1f}' for v in placed_peaks)} GB placing, "
                f"{', '.join(f'{v:.1f}' for v in step_peaks)} over the first "
                f"{LM15_STEPS} steps, "
                f"{', '.join(f'{v:.1f}' for v in peaks)} serving "
                f"({', '.join(f'{v:.1f}' for v in r['held_after_a_step_gb'])}"
                f" held after a "
                f"step), against "
                f"blocks {', '.join(f'{v:.1f}' for v in r['blocks_gb'])}; "
                f"init {init_s:.1f} s; prefill of "
                f"{LM15_BIG_PREFILL[0]} x {LM15_BIG_PREFILL[1]} in "
                f"{pre_ms:.0f} ms, {pre_moved['weights'] / 1e9:.2f} GB of "
                f"weights copied (reckoned {pre_reckoned / 1e9:.2f}); a "
                f"traced step: "
                + (waits["not_measured"] if "not_measured" in waits else
                   f"host waits {waits['waits'] or 'none'}, enqueued in "
                   f"{waits['enqueue_us'] / 1e3:.1f} of "
                   f"{waits['wall_us'] / 1e3:.1f} ms, busy "
                   + ", ".join(f"{v / 1e3:.1f}"
                               for v in waits["busy_us"].values())
                   + " ms a card"))
        if len(meshes) > 1:
            rels = {name: [rel_l2(x.double(), y.double()) for x, y in zip(
                *(got[str(m)] for m in meshes[:2]))]
                for name, got in (("fp32", check32), ("bf16", check))}
            row["mesh_rel"] = rels
            log(f"lm15 serve: {arch} {meshes[0]} against {meshes[1]} over "
                f"{LM15_STEPS} steps from one seeded cache: fp32 worst "
                f"{max(rels['fp32']):.2e} rel L2 (bound {LM15_REL:.0e}); "
                f"bf16 " + ", ".join(f"{v:.2e}" for v in rels["bf16"]))
            if max(rels["fp32"]) > LM15_REL:
                failures.append(f"{arch}: the meshes' fp32 logits {rels}")
        return row

    def timed_prefill(what, model, placed, ptoks, memory=None):
        """The sharded prefill over ``ptoks``: its logits, the wall ms of a
        second call, and the bytes that call copied."""
        step = make_prefill_step(model)
        counted("lm_serve_sharded", f"{what} prefill",
                lambda: step(placed, ptoks, memory), want=none)
        synchronize()
        model_split.reset_copied()
        t0 = time.perf_counter()
        pre = counted("lm_serve_sharded", f"{what} prefill, timed",
                      lambda: step(placed, ptoks, memory), want=none)
        synchronize()
        return pre, (time.perf_counter() - t0) * 1e3, model_split.copied()

    def check_arch(arch, cut, meshes, big=False):
        """15a for one arch: the unsharded fp32 steps, then the same steps
        on each of ``meshes``; with ``big`` the placed blocks are views of
        the unsharded tree where a block is a contiguous slice, so a layer
        no card holds twice is held once, and there is no bf16 spread."""
        t_arch = time.perf_counter()
        cfg = dataclasses.replace(configs.get_config(arch),
                                  compute_dtype="float32",
                                  param_dtype="float32", **cut)
        model = build(cfg)
        B, L = LM15_BATCH, LM15_MAX_LEN.get(arch, LM15_LEN)
        lm_free()
        with torch.no_grad():
            params = model.init(torch.Generator(device=dev).manual_seed(
                LM15_SEED), device=dev)
            if cfg.family == "vlm":
                set_gates(params)
        memory = memory_of(cfg, B, LM15_SEED + 1)
        toks = lm_tokens(cfg, (LM15_STEPS, B, 1), LM15_SEED + 2, dev)
        pos0 = torch.tensor(LM15_STARTS.get(arch, LM15_START),
                            dtype=torch.int32, device=dev)
        cache_shape = ShapeConfig("decode", L, B, "decode")
        n = sum(a.numel() for a in tree_util.leaves(params))
        ref_cache = model.init_cache(params, B, L, memory)
        values = seeded(shapes_of(ref_cache), LM15_SEED + 3)
        fill(ref_cache, values)
        ref, _ = decoded(model, params, ref_cache, toks, pos0,
                         f"{arch} one device")
        fp32 = [lg.clone() for lg in ref]
        ref_final = [leaf.clone() for leaf in tree_util.leaves(ref_cache)]
        # the step's time, warm: LM15_STEPS more from where it ended
        _, ref_ms = decoded(model, params, ref_cache, toks,
                            pos0 + LM15_STEPS, f"{arch} one device, warm")
        ref_cache = None
        top2 = [lg[:, 0].topk(2, dim=-1) for lg in ref]
        row = {"params": n, "n_layers": cfg.n_layers,
               "depth_cut": cut or None, "batch": B, "cache_len": L,
               "starts": list(LM15_STARTS.get(arch, LM15_START)),
               "one_device_ms": ref_ms, "meshes": [list(m) for m in meshes]}
        forwards = {}
        for shape in meshes:
            mesh = mesh_of(shape)
            shardings = serve_spmd.param_shardings(model, mesh)
            placed = (sharding.tree_map_with_path(
                lambda _, a, s: sharding.Sharded.place(a, s.spec, s.mesh),
                params, shardings) if big
                else sharding.place(params, shardings))
            cache = model.init_cache(
                placed, B, L, memory, shardings=sharding.cache_shardings(
                    model, cache_shape, mesh))
            fill(cache, values)
            before = blocks_of(cache)
            model_split.reset_copied()
            got, ms = decoded(model, placed, cache, toks, pos0,
                              f"{arch} {shape}")
            moved = model_split.copied()
            reckoned = lm15_reckoned(placed, mesh, B)
            rels = [rel_l2(g, r) for g, r in zip(got, ref)]
            finals = [(sh.gather(dev), leaf) for sh, leaf in zip(
                tree_util.leaves(cache), ref_final)]
            greedy_bad = sum(int(((g[:, 0].argmax(-1) != t.indices[:, 0])
                                  & (t.values[:, 0] - t.values[:, 1]
                                     > LM15_MARGIN)).sum())
                             for g, t in zip(got, top2))
            err = {"logits_rel": max(rels),
                   "cache_rel": max(rel_l2(a, b) for a, b in finals),
                   "bitwise": all(torch.equal(g, r)
                                  for g, r in zip(got, ref))
                   and all(torch.equal(a, b) for a, b in finals),
                   "finite": all(bool(torch.isfinite(g).all())
                                 for g in got),
                   "greedy_mismatches": greedy_bad,
                   "in_place": blocks_of(cache) == before,
                   "step_ms": ms,
                   "copied_a_step": {k: v / LM15_STEPS
                                     for k, v in moved.items()},
                   "weights_reckoned_a_step": reckoned}
            del finals, got
            if arch in dict(LM15_PREFILL):
                T = dict(LM15_PREFILL)[arch]
                ptoks = lm_tokens(cfg, (B, T), LM15_SEED + 4, dev)
                rows = shape[0] if B % shape[0] == 0 else 1
                if rows not in forwards:
                    # the MoE dispatch in the data rows' chunks
                    with torch.no_grad(), act_sharding.local(rows):
                        forwards[rows] = counted(
                            "lm_serve_sharded", f"{arch} forward",
                            lambda: model.forward(params, ptoks, memory),
                            want=none)
                pre, pre_ms, pre_moved = timed_prefill(
                    f"{arch} {shape}", model, placed, ptoks, memory)
                err["prefill_rel"] = rel_l2(pre, forwards[rows])
                err["prefill_ms"] = pre_ms
                err["prefill_copied"] = pre_moved
                err["prefill_weights_reckoned"] = lm15_prefill_reckoned(
                    placed, mesh, B)
                del pre
            row[str(shape)] = err
            del placed, cache
            lm_free()
            if not (err["finite"] and err["in_place"]
                    and moved["cache"] == 0
                    and moved["weights"] == LM15_STEPS * reckoned
                    and (reckoned == 0 or shape[0] > 1)
                    and err["greedy_mismatches"] == 0
                    and (err["bitwise"] if shape == (1, 1)
                         else err["logits_rel"] <= LM15_REL
                         and err["cache_rel"] <= LM15_REL)
                    and err.get("prefill_rel", 0.0) <= LM15_REL
                    and err.get("prefill_copied", {}).get("weights", 0)
                    == err.get("prefill_weights_reckoned", 0)):
                raise AssertionError(f"{arch} {shape}: {err}")
        del ref, ref_final, top2, forwards
        lm_free()

        spread = {}
        if not big:
            # the same steps in bf16 compute: the spread sharding adds
            cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
            model16 = build(cfg16)
            ref_cache = model16.init_cache(params, B, L, memory)
            values = seeded(shapes_of(ref_cache), LM15_SEED + 3)
            fill(ref_cache, values)
            ref, _ = decoded(model16, params, ref_cache, toks, pos0,
                             f"{arch} bf16 one device")
            # the yardstick: one device's bf16 against its fp32 (the same
            # seeded entries, rounded to bf16)
            spread = {"one device, bf16 against fp32": max(
                rel_l2(g.double(), r.double()) for g, r in zip(ref, fp32))}
            for shape in LM15_BF16_MESHES:
                mesh = mesh_of(shape)
                placed = sharding.place(
                    params, serve_spmd.param_shardings(model16, mesh))
                cache = model16.init_cache(
                    placed, B, L, memory, shardings=sharding.cache_shardings(
                        model16, cache_shape, mesh))
                fill(cache, values)
                got, _ = decoded(model16, placed, cache, toks, pos0,
                                 f"{arch} bf16 {shape}")
                spread[str(shape)] = max(rel_l2(g.double(), r.double())
                                         for g, r in zip(got, ref))
                del placed, cache, got
                lm_free()
            del ref, ref_cache
        del params, memory, values, fp32
        lm_free()
        row["seconds"] = time.perf_counter() - t_arch
        log(f"lm15 check: {arch} fp32 at {cfg.n_layers} layers "
            f"({cfg.family}, {n / 1e9:.3f} B parameters), batch {B}, cache "
            f"{L}, {LM15_STEPS} steps from {row['starts']}, one device "
            f"{ref_ms:.1f} ms a step; "
            + "; ".join(
                f"{shape} " + ("bit for bit" if row[str(shape)]["bitwise"]
                               else f"logits {row[str(shape)]['logits_rel']:.1e}, "
                               f"cache {row[str(shape)]['cache_rel']:.1e}")
                + (f", prefill {row[str(shape)]['prefill_rel']:.1e} in "
                   f"{row[str(shape)]['prefill_ms']:.1f} ms, "
                   f"{row[str(shape)]['prefill_copied']['weights'] / 1e9:.3f}"
                   f" GB of weights copied (reckoned "
                   f"{row[str(shape)]['prefill_weights_reckoned'] / 1e9:.3f})"
                   if "prefill_rel" in row[str(shape)] else "")
                + f", {row[str(shape)]['step_ms']:.1f} ms, "
                f"{row[str(shape)]['copied_a_step']['weights'] / 1e9:.3f}"
                f" GB weights (reckoned "
                f"{row[str(shape)]['weights_reckoned_a_step'] / 1e9:.3f}) + "
                f"{row[str(shape)]['copied_a_step']['activations'] / 1e6:.3f}"
                f" MB activations a step"
                for shape in meshes)
            + ("; bf16 against one device's bf16: "
               + ", ".join(f"{k} {v:.2e}" for k, v in spread.items())
               if spread else "; no bf16 spread (the unsharded bf16 "
               "step's compute copy does not fit beside the fp32 tree)")
            + f"; {row['seconds']:.1f} s")
        return row, spread

    try:
        # ---- 15a. sharded fp32 decode against one device -----------------
        for arch, cut in LM15_ARCHS:
            out["check"][arch], out["bf16"][arch] = check_arch(
                arch, cut, LM15_MESHES)
        arch, cut, meshes = LM15_MOE
        out["check"][f"{arch} moe"], _ = check_arch(arch, cut, meshes,
                                                    big=True)
        out["check"][f"{arch} moe"]["not_run"] = LM15_MOE_NOT_RUN
        log(f"lm15 check: {arch}'s MoE layer not run on "
            f"{LM15_MOE_NOT_RUN['meshes']}: {LM15_MOE_NOT_RUN['why']}")
        worst = max(v for s in out["bf16"].values() for k, v in s.items()
                    if k.startswith("("))
        out["bf16_worst"] = worst
        log(f"lm15 bf16: the worst sharded-against-one-device spread "
            f"{worst:.2e} rel L2 over {LM15_STEPS} steps")

        # ---- 15b. full depth over four cards ------------------------------
        if cards < 4:
            out["big"] = {"ran": False,
                          "why": f"{cards} card(s) visible; 15b needs 4"}
            log(f"lm15 serve: did not run: {cards} card(s) visible, "
                f"mixtral-8x7b at full depth needs four")
        else:
            # every cell runs and is recorded; then its failures raise
            failures = []
            for arch, cut, meshes in LM15_BIG:
                out["big"][arch] = big_serve(arch, cut, meshes, failures)
            if failures:
                raise AssertionError("; ".join(failures))
    finally:
        lm_free()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"lm15: phase 15 took {out['seconds']:.1f} s on {smi}; no kernel of "
        f"the port launched")
    return out


def tf32_flags() -> dict:
    """cuBLAS's and cuDNN's float32 settings, by the API this PyTorch has."""
    import torch
    matmul = torch.backends.cuda.matmul
    conv = getattr(torch.backends.cudnn, "conv", None)
    if hasattr(matmul, "fp32_precision") and hasattr(conv, "fp32_precision"):
        return {"cuda.matmul.fp32_precision": matmul.fp32_precision,
                "cudnn.conv.fp32_precision": conv.fp32_precision}
    return {"cuda.matmul.allow_tf32": matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}


def b2_alt(g) -> dict:
    """B2's knobs for a geometry other than ``g`` in row tile, column tile
    (where the shape has a kernel for another), stages and row tiles a
    block (where the layer has more than one)."""
    knobs = {"block_m": 32 if g.bm != 32 else 64,
             "stages": 3 if g.stages != 3 else 2,
             "tiles": 2 if g.tiles != 2 else 1}
    if g.vec_a and g.vec_b:
        knobs["block_n"] = 64 if g.bn == 128 else 128
    return knobs


def int8_operands(rng, dev, x_shape, w_shape):
    """Random int8 X and W of these shapes, positive scales sx (P,) and sw
    (P, the last of w_shape)."""
    import torch
    P, n = x_shape[0], w_shape[-1]
    return (torch.tensor(rng.randint(-127, 128, x_shape), dtype=torch.int8,
                         device=dev),
            torch.tensor(rng.randint(-127, 128, w_shape), dtype=torch.int8,
                         device=dev),
            torch.tensor(rng.uniform(0.01, 0.1, P), dtype=torch.float32,
                         device=dev),
            torch.tensor(rng.uniform(1e-4, 1e-3, (P, n)), dtype=torch.float32,
                         device=dev))


def sweep_b2(dev, timed, smi) -> None:
    """B2's card time per VGG-16 layer and B6's per depthwise layer of
    ``DW_LAYERS``, at batch 1 and 4, over a set of geometries (``python3
    chip_smoke.py --sweep-b2``: ``tdmm_geometry``'s ``block_m``,
    ``block_n``, ``block_k``, ``stages`` and ``tiles``;
    ``dw_product_geometry``'s
    ``groups``, ``lanes`` and ``run``), each output held bit for bit to the
    per-layer default's; the rows go to ``chiprun_out/b2_sweep.json`` and
    the log."""
    import torch

    from repro_torch.api import registry
    from repro_torch.core import conv2d as c2d
    from repro_torch.kernels import sfc_tdmm

    algo = registry.get_algorithm(ALGO)
    P = algo.t ** 2
    layers, _ = vgg_layers()
    gemm_variants = [dict(block_m=bm, block_n=bn, block_k=bk, stages=st,
                          tiles=tc)
                     for bm in (16, 32, 64, 128) for bn in (64, 128)
                     for bk in (32, 64) for st, tc in (
                         (2, 1), (4, 1), (6, 1), (2, 4), (4, 4), (6, 4),
                         (4, 2), (4, 8))]
    dw_variants = [dict(groups=gx, lanes=ty, run=r)
                   for gx in (1, 2, 4, 8, 16, 32)
                   for ty in (2, 4, 8, 16, 32, 64)
                   for r in (1, 2, 4) if 32 <= gx * ty <= 512]
    rows_out, seen = [], set()

    def sweep(row, fn, variants, geometry):
        base = fn()
        row["default_ms"] = timed(fn)
        row["variants"] = []
        for v in variants:
            if geometry(v) is None:
                continue
            try:
                y = fn(**v)
            except (ValueError, RuntimeError) as e:
                row["variants"].append({**v, "refused": str(e)[:80]})
                continue
            if not torch.equal(y, base):
                raise AssertionError(f"{row['kernel']} at {v} differs from "
                                     f"the default geometry: {row}")
            row["variants"].append({**v, **geometry(v),
                                    "ms": timed(lambda: fn(**v))})
        best = min((r for r in row["variants"] if "ms" in r),
                   key=lambda r: r["ms"])
        log(f"sweep: {row['kernel']} batch {row['batch']} {row['layer']}: "
            f"default {row['default']} {row['default_ms']:.4f} ms; best "
            f"{json.dumps(best)}")
        rows_out.append(row)

    for batch in (1, 4):
        for lname, hw, cin, cout in layers:
            grid = c2d.tile_grid(hw, hw, algo.M, algo.R, "SAME")
            T = batch * grid.nH * grid.nW
            if (T, cin, cout) in seen:
                continue
            seen.add((T, cin, cout))
            X, W, sx, sw = int8_operands(np.random.RandomState(hw + cin),
                                         dev, (P, T, cin), (P, cin, cout))
            d = sfc_tdmm.tdmm_geometry(P, T, cin, cout)

            def gemm_geometry(v, T=T, cin=cin, cout=cout):
                try:
                    g = sfc_tdmm.tdmm_geometry(P, T, cin, cout, **v)
                except ValueError:
                    return None
                if g.tiles != v["tiles"]:   # cut to the layer's row tiles
                    return None
                return {"blocks": g.blocks, "smem": g.smem_bytes,
                        "resident": g.resident}

            sweep({"kernel": "tdmm_int8", "batch": batch,
                   "layer": f"{hw}x{hw}x{cin}->{cout}", "T": T,
                   "default": [d.bm, d.bn, d.bk, d.stages, d.tiles],
                   "default_blocks": d.blocks},
                  lambda **k: sfc_tdmm.tdmm_int8(X, W, sx, sw, **k),
                  gemm_variants, gemm_geometry)
        for lname, hw, c in DW_LAYERS:
            grid = c2d.tile_grid(hw, hw, algo.M, algo.R, "SAME")
            T = batch * grid.nH * grid.nW
            if (T, c) in seen:
                continue
            seen.add((T, c))
            X, W, sx, sw = int8_operands(np.random.RandomState(hw + c),
                                         dev, (P, T, c), (P, c))
            d = sfc_tdmm.dw_product_geometry(P, T, c)

            def dw_geometry(v, T=T, c=c):
                try:
                    g = sfc_tdmm.dw_product_geometry(P, T, c, **v)
                except ValueError:
                    return None
                return {"blocks": g.blocks, "threads": g.threads}

            sweep({"kernel": "tdmm_int8_depthwise", "batch": batch,
                   "layer": f"{lname} {hw}x{hw}x{c}", "T": T,
                   "default": [d.groups, d.lanes, d.run],
                   "default_blocks": d.blocks},
                  lambda **k: sfc_tdmm.tdmm_int8_depthwise(X, W, sx, sw,
                                                           **k),
                  dw_variants, dw_geometry)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "b2_sweep.json").write_text(json.dumps(
        {"device": smi, "rows": rows_out}, indent=1))
    log(f"sweep: {smi}; every geometry bit-identical to the default")


def sweep_b4(dev, timed, smi) -> None:
    """B4's card time per VGG-16 layer at batch 1 and 4 over a set of
    geometries (``python3 chip_smoke.py --sweep-b4``), each output held
    bit for bit to the per-layer default's; the rows go to
    ``chiprun_out/b4_sweep.json`` and the log."""
    import torch

    from repro_torch.api import registry
    from repro_torch.core import conv2d as c2d
    from repro_torch.kernels import sfc_fused

    algo = registry.get_algorithm(ALGO)
    t, P = algo.t, algo.t ** 2
    layers, _ = vgg_layers()
    variants = [dict(cout_block=cb, n_share=ns, k_split=ks)
                for cb in (8, 16) for ns in (2, 4, 8, 16)
                for ks in (1, 2, 4, 8) if ns * ks <= 16]
    variants += [dict(k_block=64)]
    rows_out = []
    seen = set()
    for batch in (1, 4):
        for lname, hw, cin, cout in layers:
            if (batch, hw, cin, cout) in seen:
                continue
            seen.add((batch, hw, cin, cout))
            rng = np.random.RandomState(hw + cin)
            x = torch.tensor(rng.randn(batch, hw, hw, cin),
                             dtype=torch.float32, device=dev)
            wq = torch.tensor(rng.randint(-127, 128, (P, cin, cout)),
                              dtype=torch.int8, device=dev)
            act = torch.full((t, t), 0.05, device=dev)
            ws = torch.full((t, t, cout), 1e-3, device=dev)
            grid = c2d.tile_grid(hw, hw, algo.M, algo.R, "SAME")
            T = batch * grid.nH * grid.nW
            args = (x, wq, act, ws, algo)
            base = sfc_fused.sfc_fused_conv2d(*args)
            dflt = sfc_fused.fused_geometry(algo, T, cin, cout)
            row = {"batch": batch, "hw": hw, "cin": cin, "cout": cout,
                   "default": [dflt.cb, dflt.n_share, dflt.k_split,
                               dflt.kb],
                   "default_ms": timed(lambda: sfc_fused.sfc_fused_conv2d(
                       *args)), "variants": []}
            for v in variants:
                knobs = {k: v.get(k, d) for k, d in (
                    ("k_block", sfc_fused.K_BLOCK), ("cout_block", None),
                    ("n_share", None), ("k_split", None))}
                try:
                    g = sfc_fused.fused_geometry(algo, T, cin, cout,
                                                 **knobs)
                    y = sfc_fused.sfc_fused_conv2d(*args, **knobs)
                except (ValueError, RuntimeError) as e:
                    row["variants"].append({**v, "refused": str(e)[:80]})
                    continue
                if not torch.equal(y, base):
                    raise AssertionError(f"B4 at {v} differs from the "
                                         f"default geometry: {row}")
                row["variants"].append({
                    **v, "cb": g.cb, "n_share": g.n_share,
                    "k_split": g.k_split, "blocks": g.blocks,
                    "smem": g.smem_bytes, "ms": timed(lambda: sfc_fused.sfc_fused_conv2d(
                        *args, **knobs))})
            ok = [r for r in row["variants"] if "ms" in r]
            best = min(ok, key=lambda r: r["ms"])
            log(f"sweep: batch {batch} {hw}x{hw}x{cin}->{cout}: default "
                f"{row['default']} {row['default_ms']:.4f} ms; best "
                f"{json.dumps(best)}")
            rows_out.append(row)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "b4_sweep.json").write_text(json.dumps(
        {"device": smi, "rows": rows_out}, indent=1))
    log(f"sweep: {smi}; every geometry bit-identical to the default")


def sweep_b7(dev, timed, smi) -> None:
    """B7's card time per depthwise layer of ``DW_LAYERS`` at batch 1 and
    4 over a set of geometries (``python3 chip_smoke.py --sweep-b7``:
    ``depthwise_geometry``'s ``cout_block``, ``tiles`` and ``splits``),
    each output held bit for bit to the per-layer default's; the rows go
    to ``chiprun_out/b7_sweep.json`` and the log."""
    import torch

    from repro_torch.api import registry
    from repro_torch.core import conv2d as c2d
    from repro_torch.kernels import sfc_fused

    algo = registry.get_algorithm(ALGO)
    t, P = algo.t, algo.t ** 2
    variants = [dict(cout_block=cb, tiles=tc, splits=s)
                for cb in (16, 32, 64) for tc in (1, 2, 4)
                for s in sfc_fused.DW_SPLITS]
    rows_out, seen = [], set()
    for batch in (1, 4):
        for lname, hw, c in DW_LAYERS:
            if (batch, hw, c) in seen:
                continue
            seen.add((batch, hw, c))
            rng = np.random.RandomState(hw + c)
            x = torch.tensor(rng.randn(batch, hw, hw, c), dtype=torch.float32,
                             device=dev)
            wq = torch.tensor(rng.randint(-127, 128, (P, 1, c)),
                              dtype=torch.int8, device=dev)
            act = torch.full((t, t), 0.05, device=dev)
            ws = torch.full((t, t, c), 1e-3, device=dev)
            args = (x, wq, act, ws, algo)
            grid = c2d.tile_grid(hw, hw, algo.M, algo.R, "SAME")
            tiles = (batch * grid.nH, grid.nW)
            base = sfc_fused.sfc_fused_conv2d_depthwise(*args)
            dflt = sfc_fused.depthwise_geometry(algo, tiles, c)
            row = {"batch": batch, "layer": lname, "hw": hw, "c": c,
                   "default": [dflt.cb, dflt.tiles, dflt.splits],
                   "default_blocks": dflt.blocks,
                   "default_ms": timed(lambda: sfc_fused.
                                       sfc_fused_conv2d_depthwise(*args)),
                   "variants": []}
            for v in variants:
                try:
                    g = sfc_fused.depthwise_geometry(algo, tiles, c, **v)
                    y = sfc_fused.sfc_fused_conv2d_depthwise(*args, **v)
                except (ValueError, RuntimeError) as e:
                    row["variants"].append({**v, "refused": str(e)[:80]})
                    continue
                if not torch.equal(y, base):
                    raise AssertionError(f"B7 at {v} differs from the "
                                         f"default geometry: {row}")
                row["variants"].append({
                    **v, "blocks": g.blocks, "threads": g.threads,
                    "smem": g.smem_bytes,
                    "ms": timed(lambda: sfc_fused.sfc_fused_conv2d_depthwise(
                        *args, **v))})
            best = min((r for r in row["variants"] if "ms" in r),
                       key=lambda r: r["ms"])
            log(f"sweep: batch {batch} {lname} {hw}x{hw}x{c}: default "
                f"{row['default']} {row['default_ms']:.4f} ms; best "
                f"{json.dumps(best)}")
            rows_out.append(row)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "b7_sweep.json").write_text(json.dumps(
        {"device": smi, "rows": rows_out}, indent=1))
    log(f"sweep: {smi}; every geometry bit-identical to the default")


def sweep_b1(dev, timed, smi) -> None:
    """B1's (its (P, T, C) entry, as the staged paths call it) and B5's card
    time per VGG-16 and depthwise layer shape at batch 1 and 4 over a set
    of geometries (``python3 chip_smoke.py --sweep-b1``:
    ``transform_geometry``'s ``channel_block``, ``tiles`` and ``splits``),
    each output held bit for bit to the per-layer default's; the rows go
    to ``chiprun_out/b1_sweep.json`` and the log."""
    import torch

    from repro_torch import kernels
    from repro_torch.api import registry
    from repro_torch.core import conv2d as c2d
    from repro_torch.kernels.sfc_transform import transform_geometry

    algo = registry.get_algorithm(ALGO)
    t, M = algo.t, algo.M
    bt = c2d.transform_matrices(algo, torch.float32, dev)[0]
    act = torch.full((t, t), 0.05, device=dev)
    vgg, _ = vgg_layers()
    shapes = [(f"vgg {hw}x{hw}x{cin}", hw, cin) for _, hw, cin, _ in vgg]
    shapes += [(name, hw, c) for name, hw, c in DW_LAYERS]
    rows_out, seen = [], set()
    for batch in (1, 4):
        for lname, hw, c in shapes:
            if (batch, hw, c) in seen:
                continue
            seen.add((batch, hw, c))
            x = torch.tensor(np.random.RandomState(hw + c).randn(
                batch, hw, hw, c), dtype=torch.float32, device=dev)
            grid = c2d.tile_grid(hw, hw, M, algo.R, "SAME")
            tiles = (batch * grid.nH, grid.nW)
            cbs = (c,) if c < 16 else (16, 32, 64)
            variants = [dict(channel_block=cb, tiles=tc, splits=sp)
                        for cb in cbs for tc in (1, 2, 4, 8)
                        for sp in (t, -(-t // 2), -(-t // 3), -(-t // 5))]
            dflt = transform_geometry(algo, tiles, c)
            for kname, fn in (
                    ("sfc_transform_quantize", lambda **k: kernels.
                     sfc_transform_quantize_pt(x, bt, act, M, **k)),
                    ("sfc_transform", lambda **k: kernels.sfc_transform(
                        x, bt, M, **k))):
                base = fn()
                row = {"kernel": kname, "batch": batch, "layer": lname,
                       "hw": hw, "c": c,
                       "default": [dflt.cb, dflt.tiles, dflt.splits],
                       "default_blocks": dflt.blocks,
                       "default_ms": timed(fn), "variants": []}
                for v in variants:
                    try:
                        g = transform_geometry(algo, tiles, c, **v)
                        y = fn(**v)
                    except (ValueError, RuntimeError) as e:
                        row["variants"].append({**v,
                                                "refused": str(e)[:80]})
                        continue
                    if not torch.equal(y, base):
                        raise AssertionError(f"{kname} at {v} differs from "
                                             f"the default geometry: {row}")
                    row["variants"].append({
                        **v, "blocks": g.blocks, "threads": g.threads,
                        "smem": g.smem_bytes,
                        "ms": timed(lambda: fn(**v))})
                best = min((r for r in row["variants"] if "ms" in r),
                           key=lambda r: r["ms"])
                log(f"sweep: {kname} batch {batch} {lname} {hw}x{hw}x{c}: "
                    f"default {row['default']} {row['default_ms']:.4f} ms; "
                    f"best {json.dumps(best)}")
                rows_out.append(row)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "b1_sweep.json").write_text(json.dumps(
        {"device": smi, "rows": rows_out}, indent=1))
    log(f"sweep: {smi}; every geometry bit-identical to the default")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; "
                         "torch.cuda.is_available() is False")
    import torch.nn.functional as F

    from repro_torch import kernels
    from repro_torch.api import (ConvSpec, costmodel, plan, registry,
                                 resilience, tuning)
    from repro_torch.core import conv2d as c2d
    from repro_torch.kernels import _build, ops, ref, sfc_fused, sfc_tdmm
    from repro_torch.models.cnn import max_pool_same
    from repro_torch.quant import FP32, INT4_FREQ, INT8_FREQ
    from repro_torch.testing import DEFAULT_TOL

    dev = torch.device("cuda", 0)
    report = {"phases": {}}
    # the run's own timing cache and cost-model store, emptied first: every
    # run tunes and fits afresh, no plan before phase 5e carries a measured
    # config and none before phase 7's fit a modelled one
    cache = ROOT / "build" / "chip_smoke_tuning.json"
    cache.unlink(missing_ok=True)
    tuning.set_cache_path(str(cache))
    coef_store = ROOT / "build" / "chip_smoke_costmodel.json"
    coef_store.unlink(missing_ok=True)
    costmodel.set_cache_path(str(coef_store))

    # ---- 1. probe -------------------------------------------------------
    cap = torch.cuda.get_device_capability(0)
    name = torch.cuda.get_device_name(0)
    log(f"probe: torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} capability {cap} count {torch.cuda.device_count()}")
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; {name} has "
                           f"capability {cap}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log("probe: nvcc", nvcc[-1])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"probe: PyTorch's default TF32 flags, none set by this run: "
        f"{tf32_flags()}")
    report["device"] = {"name": name, "nvidia_smi": smi,
                        "torch": torch.__version__,
                        "cuda": torch.version.cuda}

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds or 0.0:.1f} s, cached "
        f"{_build.build_seconds is None})")

    def timed(fn, runs=TIMED_RUNS):
        """Median device milliseconds of one ``fn`` call, over ``runs``.

        The calls are queued behind a spin kernel that keeps the card busy
        until the host has enqueued them all, so the CUDA events between
        consecutive calls measure the card's time and not the host's
        launch overhead (which would otherwise show as idle gaps).  The
        spin doubles until it outlasts the host's enqueueing (at most
        eight times, else the log says so).
        """
        fn()
        torch.cuda.synchronize()
        for doubling in range(8):
            cycles = SPIN_CYCLES << doubling
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(runs + 2)]
            ev[0].record()
            torch.cuda._sleep(cycles)
            ev[1].record()
            t0 = time.perf_counter()
            for e in ev[2:]:
                fn()
                e.record()
            enqueue_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            times = [ev[i].elapsed_time(ev[i + 1])
                     for i in range(1, runs + 1)]
            if enqueue_ms < ev[0].elapsed_time(ev[1]):
                return statistics.median(times)
        log(f"timing: the host outran every spin; {enqueue_ms:.1f} ms to "
            f"enqueue, times include host gaps")
        return statistics.median(times)

    launches = {k: 0 for k in REPLACES}   # summed over the paths' forwards
    path_launches = {}                    # path -> launches of its forwards
    path_kernels = {}                     # path -> the kernels it launches
    n_forwards = {}

    def counted(path, what, fn, times=1, want=None):
        """Run one forward of ``path`` (``times`` layers of a depthwise
        stack) with every launch count set to 0 just before it, and check
        just after it what it launched: ``want``, or ``EXPECTED[path]``."""
        if want is None:
            want = {k: n * times for k, n in EXPECTED[path].items()}
        kernels.reset_launch_counts()
        out = fn()
        got = kernels.launch_counts()
        if got != want:
            raise AssertionError(f"{what}: the {path} forward launched "
                                 f"{got}, not {want}")
        tally = path_launches.setdefault(path, {k: 0 for k in REPLACES})
        for k in launches:
            launches[k] += got[k]
            tally[k] += got[k]
        path_kernels.setdefault(path, set()).update(
            k for k, v in want.items() if v)
        n_forwards[path] = n_forwards.get(path, 0) + 1
        return out

    def plan_launches(p, fp=False):
        """What one forward of plan ``p`` launches: per fast (sub-)plan B4
        or B7 (the fused datapath), B1, B2 or B6, B3 (staged), B5, B3
        (``fp``: no calibrated int8 weights); a direct one none."""
        want, stack = only(), [p]
        while stack:
            q = stack.pop()
            if q.path == "lowered":
                stack.extend(q.sub_plans)
                continue
            if q.path != "fast":
                continue
            dw = q.spec.depthwise
            if fp:
                names = ("sfc_transform", "sfc_inverse")
            elif (q.config or tuning.DEFAULT_FUSED).datapath == "fused":
                names = ("sfc_fused_conv2d_depthwise" if dw
                         else "sfc_fused_conv2d",)
            else:
                names = ("sfc_transform_quantize", "sfc_inverse",
                         "tdmm_int8_depthwise" if dw else "tdmm_int8")
            for k in names:
                want[k] += 1
        return want

    if "--sharded" in sys.argv[1:]:
        # phases 10 and 10b alone, over the visible GPUs
        report = {"device": {"name": name, "nvidia_smi": smi,
                             "count": torch.cuda.device_count()},
                  "sharded": sharded_convs(dev, counted, plan_launches, smi),
                  "gate_and_psum": gate_and_psum(dev)}
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "sharded.json").write_text(json.dumps(report, indent=1))
        return

    if "--lm" in sys.argv[1:]:
        # phase 11 alone
        resilience.configure(dataclasses.replace(resilience.policy(),
                                                 enabled=False))
        report = {"device": {"name": name, "nvidia_smi": smi},
                  "lm_serving": lm_serving(dev, counted, timed, smi),
                  "lm_families": lm_families(dev, counted, smi)}
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "lm.json").write_text(json.dumps(report, indent=1))
        return

    if "--lm-train" in sys.argv[1:]:
        # phase 13 alone
        resilience.configure(dataclasses.replace(resilience.policy(),
                                                 enabled=False))
        report = {"device": {"name": name, "nvidia_smi": smi},
                  "lm_training": lm_training(dev, counted, smi)}
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "lm_train.json").write_text(json.dumps(report, indent=1))
        return

    if "--lm-sharded" in sys.argv[1:]:
        # phase 14 alone
        resilience.configure(dataclasses.replace(resilience.policy(),
                                                 enabled=False))
        report = {"device": {"name": name, "nvidia_smi": smi,
                             "count": torch.cuda.device_count()},
                  "lm_sharded": lm_sharded(dev, counted, smi)}
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "lm_sharded.json").write_text(json.dumps(report, indent=1))
        return

    if "--lm-serve-sharded" in sys.argv[1:]:
        # phase 15 alone
        resilience.configure(dataclasses.replace(resilience.policy(),
                                                 enabled=False))
        report = {"device": {"name": name, "nvidia_smi": smi,
                             "count": torch.cuda.device_count()},
                  "lm_serve_sharded": lm_serve_sharded(dev, counted, smi)}
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "lm_serve_sharded.json").write_text(json.dumps(report,
                                                              indent=1))
        return

    if "--b4-candidates" in sys.argv[1:]:
        # phase 3c alone
        resilience.configure(dataclasses.replace(resilience.policy(),
                                                 enabled=False))
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "b4_candidates.json").write_text(json.dumps(
            {"device": {"name": name, "nvidia_smi": smi},
             "b4_candidates": b4_candidates(dev, counted, timed, smi)},
            indent=1))
        return
    if "--sweep-b4" in sys.argv[1:]:
        sweep_b4(dev, timed, smi)
        return
    if "--sweep-b7" in sys.argv[1:]:
        sweep_b7(dev, timed, smi)
        return
    if "--sweep-b1" in sys.argv[1:]:
        sweep_b1(dev, timed, smi)
        return
    if "--sweep-b2" in sys.argv[1:]:
        sweep_b2(dev, timed, smi)
        return

    def snapped(rng, shape):
        return torch.tensor(np.round(rng.randn(*shape) * 16) / 16,
                            dtype=torch.float32, device=dev)

    def he_normal(rng, cin, cout, r=3):
        w = rng.randn(r, r, cin, cout) * math.sqrt(2.0 / (r * r * cin))
        return torch.tensor(w, dtype=torch.float32, device=dev)

    def prepared(x, w, algo_name, config=None, depthwise=False,
                 padding="SAME"):
        make = ConvSpec.for_conv2d_depthwise if depthwise \
            else ConvSpec.for_conv2d
        spec = make(x.shape, w.shape, padding=padding, quant=INT8_FREQ)
        p = plan(spec, backend="cuda", algo=algo_name)
        if p.algorithm is None or p.algo_name != algo_name:
            raise AssertionError(f"{algo_name} at {spec} planned "
                                 f"{p.algo_name}")
        if config is not None:
            p = p.with_config(config)
        act = tuning.calibrate_act_scale(x, p.algorithm, INT8_FREQ, padding)
        return p, p.prepare_weights(w, act_scale=act)

    def prepared_fp(x, w, algo_name, depthwise=False):
        make = ConvSpec.for_conv2d_depthwise if depthwise \
            else ConvSpec.for_conv2d
        p = plan(make(x.shape, w.shape, quant=FP32), backend="cuda",
                 algo=algo_name)
        return p, p.prepare_weights(w)

    def scaled_err(got, want):
        return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
                ).item()

    def geometry_of(x, prep, algo, padding="SAME"):
        """B4's geometry for this input and these weights."""
        B, H, W, cin = x.shape
        grid = c2d.tile_grid(H, W, algo.M, algo.R, padding)
        g = sfc_fused.fused_geometry(algo, B * grid.nH * grid.nW, cin,
                                     prep.wq.shape[2])
        return {"cb": g.cb, "n_share": g.n_share, "k_split": g.k_split,
                "kb": g.kb, "stages": g.stages, "pairs": g.pairs,
                "blocks": g.blocks, "smem": g.smem_bytes}

    def held(what, y, y_ref, kind):
        """rel L2 and scaled max error of y against y_ref, within BOUNDS."""
        rel_l2 = ((y - y_ref).norm() / y_ref.norm().clamp_min(1e-30)).item()
        scaled = scaled_err(y, y_ref)
        max_rel, max_scaled = BOUNDS[kind]
        if not (rel_l2 <= max_rel and scaled <= max_scaled
                and torch.isfinite(y).all()):
            raise AssertionError(
                f"{what}: rel L2 {rel_l2}, max |diff| / max |ref| {scaled} "
                f"against the reference (bounds {max_rel}, {max_scaled})")
        return rel_l2, scaled

    def xq_flips(x, p, prep):
        """int8 values where B1 and its plain version differ on x."""
        bt = c2d.transform_matrices(p.algorithm, torch.float32, dev)[0]
        xq = kernels.sfc_transform_quantize(x, bt, prep.act_scale,
                                            p.algorithm.M)
        xq_ref = ref.sfc_transform_quantize_nhwc_ref(x, bt, prep.act_scale,
                                                     p.algorithm.M)
        return int((xq != xq_ref).sum()), xq.numel()

    # ---- 3. each kernel against its plain version ------------------------
    # phases 3-6 hold kernels: the degradation chain is off, so a kernel
    # that fails raises (resilience.configured(enabled=False), kept on
    # until phase 7)
    chain_policy = resilience.policy()
    resilience.configure(dataclasses.replace(chain_policy, enabled=False))
    max_err = {k: 0.0 for k in REPLACES}

    def check_b5(case, x, xr, xq_raw, bt, scale, M, padding="SAME"):
        """B5 against its plain version: exact on snapped inputs x, within
        1e-6 of the output's scale on raw inputs xr; on xr exactly the
        value B1 quantized into xq_raw (one device function, one order);
        and at B1_ALT bit for bit the per-layer geometry's."""
        tx = kernels.sfc_transform(x, bt, M, padding=padding)
        tx_ref = ref.sfc_transform_nhwc_ref(x, bt, M, padding)
        case["b5_mismatch_snapped"] = int((tx != tx_ref).sum())
        txr = kernels.sfc_transform(xr, bt, M, padding=padding)
        txr_ref = ref.sfc_transform_nhwc_ref(xr, bt, M, padding)
        err = (txr - txr_ref).abs().max().item()
        case["b5_scaled_err_raw"] = err / txr_ref.abs().max().item()
        q = torch.clamp(torch.round(txr / scale[None, :, :, None]), -127,
                        127).to(torch.int8)
        case["b5_b1_grid_mismatch"] = int((q != xq_raw).sum())
        case["b5_alt_geometry_equal"] = bool(torch.equal(
            kernels.sfc_transform(xr, bt, M, padding=padding, **B1_ALT),
            txr))
        if case["b5_mismatch_snapped"] or case["b5_scaled_err_raw"] > 1e-6 \
                or case["b5_b1_grid_mismatch"] \
                or not case["b5_alt_geometry_equal"]:
            raise AssertionError(f"B5 differs from its plain version, from "
                                 f"what B1 quantizes or across geometries: "
                                 f"{case}")
        max_err["sfc_transform"] = max(max_err["sfc_transform"], err)

    def check_b1_pt(case, x, xr, xq, xq_raw, bt, scale, M, padding="SAME"):
        """B1's (P, T, C) entry, which the staged paths call: exact against
        its plain version on snapped inputs x, and bit for bit the tile
        entry's values xq (on x) and xq_raw (on raw inputs xr) written
        position-major; both entries at B1_ALT bit for bit the per-layer
        geometry's."""
        T, t, _, C = xq.shape

        def pt(q):
            return q.reshape(T, t * t, C).transpose(0, 1)
        xp = kernels.sfc_transform_quantize_pt(x, bt, scale, M,
                                               padding=padding)
        case["b1_pt_mismatch_snapped"] = int((
            xp != ref.sfc_transform_quantize_pt_ref(x, bt, scale, M,
                                                    padding)).sum())
        case["b1_pt_equals_tiles"] = bool(
            torch.equal(xp, pt(xq)) and torch.equal(
                kernels.sfc_transform_quantize_pt(xr, bt, scale, M,
                                                  padding=padding),
                pt(xq_raw)))
        case["b1_alt_geometry_equal"] = all(
            torch.equal(kernels.sfc_transform_quantize(
                xx, bt, scale, M, padding=padding, **B1_ALT), q)
            and torch.equal(kernels.sfc_transform_quantize_pt(
                xx, bt, scale, M, padding=padding, **B1_ALT), pt(q))
            for xx, q in ((x, xq), (xr, xq_raw)))
        if case["b1_pt_mismatch_snapped"] or not case["b1_pt_equals_tiles"] \
                or not case["b1_alt_geometry_equal"]:
            raise AssertionError(f"B1's (P, T, C) entry differs from its "
                                 f"plain version or from the tile entry, or "
                                 f"B1 differs across geometries: {case}")
    def kernel_times(x, p, prep, padding):
        """Card ms of each kernel the int8 and fp paths launch for plan
        ``p`` on ``x`` (B1 its (P, T, C) entry, B3 its NHWC entry)."""
        algo = p.algorithm
        M, P, C = algo.M, algo.t ** 2, x.shape[3]
        bt, _, at = c2d.transform_matrices(algo, torch.float32, dev)
        grid = c2d.tile_grid(x.shape[1], x.shape[2], M, algo.R, padding)
        sx = prep.act_scale.reshape(P).contiguous()
        args = (x, prep.wq, prep.act_scale, prep.w_scale, algo)
        X = kernels.sfc_transform_quantize_pt(x, bt, prep.act_scale, M,
                                              padding=padding)
        out = {"tiles": X.shape[1], "sfc_transform_quantize": timed(
            lambda: kernels.sfc_transform_quantize_pt(
                x, bt, prep.act_scale, M, padding=padding)),
            "sfc_transform": timed(
                lambda: kernels.sfc_transform(x, bt, M, padding=padding))}
        if p.spec.depthwise:
            wq2 = prep.wq.reshape(P, C)
            sw = prep.w_scale.reshape(P, C).contiguous()
            Y = kernels.tdmm_int8_depthwise(X, wq2, sx, sw)
            out["tdmm_int8_depthwise"] = timed(
                lambda: kernels.tdmm_int8_depthwise(X, wq2, sx, sw))
            out["sfc_fused_conv2d_depthwise"] = timed(
                lambda: kernels.sfc_fused_conv2d(*args, padding=padding,
                                                 depthwise=True))
        else:
            sw = prep.w_scale.reshape(P, -1).contiguous()
            Y = kernels.tdmm_int8(X, prep.wq, sx, sw)
            out["tdmm_int8"] = timed(
                lambda: kernels.tdmm_int8(X, prep.wq, sx, sw))
            out["sfc_fused_conv2d"] = timed(
                lambda: kernels.sfc_fused_conv2d(*args, padding=padding))
        out["sfc_inverse"] = timed(
            lambda: kernels.sfc_inverse_nhwc(Y, at, grid))
        return out

    tile_rows = []

    def time_tiles(case, x, p, prep, padding, w_shape):
        """The kernels at a lowered sub-conv's tile, beside the same
        kernels with TILE_PAIRS' compiled algorithm on the same input."""
        pair = TILE_PAIRS[case["algo"]]
        R = registry.get_algorithm(pair).R
        pw = he_normal(np.random.RandomState(7), w_shape[2], w_shape[3], R)
        pp, pprep = prepared(x, pw, pair, padding=padding,
                             depthwise=p.spec.depthwise)
        row = {"algo": case["algo"], "shape": list(x.shape),
               "padding": padding, "times": kernel_times(x, p, prep, padding),
               "pair": pair,
               "pair_times": kernel_times(x, pp, pprep, padding)}
        tile_rows.append(row)
        log("tiles:", json.dumps(row))

    checks = []
    rng = np.random.RandomState(11)
    for algo_name, hw, cin, cout, batch, padding in KERNEL_CHECKS:
        x = snapped(rng, (batch, hw, hw, cin))
        R = registry.get_algorithm(algo_name).R
        w = he_normal(rng, cin, cout, R)
        p, prep = prepared(x, w, algo_name, padding=padding)
        algo = p.algorithm
        t, P = algo.t, algo.t ** 2
        bt, _, at = c2d.transform_matrices(algo, torch.float32, dev)
        case = {"algo": algo_name, "hw": hw, "cin": cin, "cout": cout,
                "batch": batch, "padding": padding}
        # B1 on snapped inputs: B^T X B is exact in f32 in any order
        xq = kernels.sfc_transform_quantize(x, bt, prep.act_scale, algo.M,
                                            padding=padding)
        xq_ref = ref.sfc_transform_quantize_nhwc_ref(x, bt, prep.act_scale,
                                                     algo.M, padding)
        case["b1_mismatch_snapped"] = int((xq != xq_ref).sum())
        if case["b1_mismatch_snapped"]:
            raise AssertionError(f"B1 differs from its plain version on "
                                 f"snapped inputs: {case}")
        # B1 on raw inputs: summation order may flip a .5 tie by one LSB
        xr = torch.tensor(rng.randn(batch, hw, hw, cin), dtype=torch.float32,
                          device=dev)
        xq_raw = kernels.sfc_transform_quantize(xr, bt, prep.act_scale,
                                                algo.M, padding=padding)
        d = (xq_raw.int() - ref.sfc_transform_quantize_nhwc_ref(
            xr, bt, prep.act_scale, algo.M, padding).int()).abs()
        flips, worst = int((d != 0).sum()), int(d.max())
        case["b1_flips_raw"], case["b1_values"] = flips, d.numel()
        if worst > 1 or flips * 10000 > d.numel():
            raise AssertionError(f"B1 flips beyond 1 in 1e4 or by more than "
                                 f"one step: {case}, worst {worst}")
        max_err["sfc_transform_quantize"] = max(
            max_err["sfc_transform_quantize"], float(worst))
        # B5 on snapped inputs: exact; on raw inputs: max |diff| <= 1e-6 of
        # the output's scale, and exactly the value B1 quantizes (one
        # device function, one summation order)
        check_b5(case, x, xr, xq_raw, bt, prep.act_scale, algo.M, padding)
        check_b1_pt(case, x, xr, xq, xq_raw, bt, prep.act_scale, algo.M,
                    padding)
        # B2 on the same int8 operands: bit for bit its plain version (int32
        # exact, one dequant), with k_block None and 64 and at b2_alt
        X = xq.reshape(-1, P, cin).transpose(0, 1).contiguous()
        sx = prep.act_scale.reshape(P).contiguous()
        sw = prep.w_scale.reshape(P, -1).contiguous()
        Y_ref = ref.tdmm_int8_ref(X, prep.wq, sx, sw)
        alt = b2_alt(sfc_tdmm.tdmm_geometry(P, X.shape[1], cin, cout))
        for what, knobs in (("kblock_None", {}),
                            ("kblock_64", {"k_block": 64}), ("alt", alt)):
            Y = kernels.tdmm_int8(X, prep.wq, sx, sw, **knobs)
            case[f"b2_bit_equal_{what}"] = bool(torch.equal(Y, Y_ref))
            max_err["tdmm_int8"] = max(max_err["tdmm_int8"],
                                       (Y - Y_ref).abs().max().item())
        Y = kernels.tdmm_int8(X, prep.wq, sx, sw)
        if not all(v for k, v in case.items() if k.startswith("b2_bit")):
            raise AssertionError(f"B2 differs from its plain version: {case}")
        # B3: rtol 1e-5, atol 1e-5 of the output's scale
        ty = Y.transpose(0, 1).reshape(-1, t, t, cout).contiguous()
        yt, yt_ref = kernels.sfc_inverse(ty, at), ref.sfc_inverse_ref(ty, at)
        torch.testing.assert_close(yt, yt_ref, rtol=1e-5,
                                   atol=1e-5 * yt_ref.abs().max().item())
        max_err["sfc_inverse"] = max(max_err["sfc_inverse"],
                                     (yt - yt_ref).abs().max().item())
        # B3's NHWC entry: bit for bit sfc_inverse + untile, from B2's
        # (P, T, C_out) output in place and from the tile layout
        grid = c2d.tile_grid(hw, hw, algo.M, algo.R, padding)
        untiled = kernels.untile(yt, algo, (batch, grid.out_h, grid.out_w,
                                            grid.nH, grid.nW))
        case["b3_nhwc_equal"] = all(
            torch.equal(kernels.sfc_inverse_nhwc(yy, at, grid), untiled)
            for yy in (Y, ty))
        if not case["b3_nhwc_equal"]:
            raise AssertionError(f"B3's NHWC entry is not bit-identical to "
                                 f"sfc_inverse + untile: {case}")
        # B4 against its plain version within DEFAULT_TOL of the output's
        # scale on snapped inputs, and bit-identical to the staged CUDA path
        # (B1 -> B2 -> B3) on snapped and on raw inputs, at the per-layer
        # geometry and at B4_ALT
        args = (x, prep.wq, prep.act_scale, prep.w_scale, algo)
        yf = kernels.sfc_fused_conv2d(*args, padding=padding)
        ys = kernels.quantized_fastconv2d(*args, padding=padding)
        y_ref = ref.sfc_fused_conv2d_ref(*args, padding=padding)
        scale = y_ref.abs().max().item()
        torch.testing.assert_close(yf, y_ref, rtol=DEFAULT_TOL,
                                   atol=DEFAULT_TOL * scale)
        torch.testing.assert_close(yf, ys, rtol=DEFAULT_TOL,
                                   atol=DEFAULT_TOL * scale)
        case["b4_scaled_err"] = scaled_err(yf, y_ref)
        case["b4_fused_equals_staged"] = bool(torch.equal(yf, ys))
        rargs = (xr,) + args[1:]
        case["b4_fused_equals_staged_raw"] = bool(torch.equal(
            kernels.sfc_fused_conv2d(*rargs, padding=padding),
            kernels.quantized_fastconv2d(*rargs, padding=padding)))
        case["b4_alt_geometry_equal"] = bool(torch.equal(
            kernels.sfc_fused_conv2d(*args, padding=padding, **B4_ALT), yf))
        case["b4_geometry"] = geometry_of(x, prep, algo, padding)
        if not (case["b4_fused_equals_staged"]
                and case["b4_fused_equals_staged_raw"]
                and case["b4_alt_geometry_equal"]):
            raise AssertionError(f"B4 is not bit-identical to the staged "
                                 f"path or across geometries: {case}")
        max_err["sfc_fused_conv2d"] = max(max_err["sfc_fused_conv2d"],
                                          (yf - y_ref).abs().max().item())
        if algo_name in TILE_PAIRS and batch == 1:
            time_tiles(case, x, p, prep, padding, tuple(w.shape))
        torch.cuda.synchronize()
        log("kernels:", json.dumps(case))
        checks.append(case)

    for algo_name, hw, c, batch, padding in DW_CHECKS:
        x = snapped(rng, (batch, hw, hw, c))
        w = he_normal(rng, 1, c, registry.get_algorithm(algo_name).R)
        p, prep = prepared(x, w, algo_name, depthwise=True, padding=padding)
        algo = p.algorithm
        t, P = algo.t, algo.t ** 2
        bt = c2d.transform_matrices(algo, torch.float32, dev)[0]
        case = {"algo": algo_name, "hw": hw, "depthwise_c": c,
                "batch": batch, "padding": padding}
        xr = torch.tensor(rng.randn(batch, hw, hw, c), dtype=torch.float32,
                          device=dev)
        xq_raw = kernels.sfc_transform_quantize(xr, bt, prep.act_scale,
                                                algo.M, padding=padding)
        check_b5(case, x, xr, xq_raw, bt, prep.act_scale, algo.M, padding)
        # B1 on snapped inputs: exact; its (P, T, C) entry
        xq = kernels.sfc_transform_quantize(x, bt, prep.act_scale, algo.M,
                                            padding=padding)
        case["b1_mismatch_snapped"] = int((
            xq != ref.sfc_transform_quantize_nhwc_ref(
                x, bt, prep.act_scale, algo.M, padding)).sum())
        if case["b1_mismatch_snapped"]:
            raise AssertionError(f"B1 differs from its plain version on "
                                 f"snapped inputs: {case}")
        check_b1_pt(case, x, xr, xq, xq_raw, bt, prep.act_scale, algo.M,
                    padding)
        # B6 on the same int8 operands: exact (int32 products, one dequant),
        # at the per-layer geometry and at B6_ALT
        X = xq.reshape(-1, P, c).transpose(0, 1).contiguous()
        wq2 = prep.wq.reshape(P, c)
        sx = prep.act_scale.reshape(P).contiguous()
        sw = prep.w_scale.reshape(P, c).contiguous()
        Y = kernels.tdmm_int8_depthwise(X, wq2, sx, sw)
        Y_ref = ref.tdmm_int8_depthwise_ref(X, wq2, sx, sw)
        case["b6_bit_equal"] = bool(torch.equal(Y, Y_ref)) and bool(
            torch.equal(kernels.tdmm_int8_depthwise(X, wq2, sx, sw, **B6_ALT),
                        Y_ref))
        if not case["b6_bit_equal"]:
            raise AssertionError(f"B6 differs from its plain version: {case}")
        max_err["tdmm_int8_depthwise"] = max(
            max_err["tdmm_int8_depthwise"], (Y - Y_ref).abs().max().item())
        # B7 against its plain version within DEFAULT_TOL of the output's
        # scale on snapped inputs, and bit-identical to the staged CUDA
        # depthwise path (B1 -> B6 -> B3) on snapped and raw inputs, at the
        # per-layer geometry, at B7_ALT and at 24 channels a block
        args = (x, prep.wq, prep.act_scale, prep.w_scale, algo)
        yf = kernels.sfc_fused_conv2d(*args, depthwise=True, padding=padding)
        y_ref = ref.sfc_fused_conv2d_ref(*args, padding=padding,
                                         depthwise=True)
        scale = y_ref.abs().max().item()
        torch.testing.assert_close(yf, y_ref, rtol=DEFAULT_TOL,
                                   atol=DEFAULT_TOL * scale)
        case["b7_scaled_err"] = scaled_err(yf, y_ref)
        grid = c2d.tile_grid(hw, hw, algo.M, algo.R, padding)
        g = sfc_fused.depthwise_geometry(algo, (batch * grid.nH, grid.nW), c)
        case["b7_geometry"] = [g.cb, g.tiles, g.splits, g.blocks]
        for inputs, xx in (("snapped", x), ("raw", xr)):
            xargs = (xx,) + args[1:]
            ys = kernels.quantized_fastconv2d_depthwise(*xargs,
                                                        padding=padding)
            case[f"b7_fused_equals_staged_{inputs}"] = all(
                torch.equal(kernels.sfc_fused_conv2d_depthwise(
                    *xargs, padding=padding, **knobs), ys)
                for knobs in ({}, B7_ALT, {"cout_block": 24}))
        if not (case["b7_fused_equals_staged_snapped"]
                and case["b7_fused_equals_staged_raw"]):
            raise AssertionError(f"B7 is not bit-identical to the staged "
                                 f"depthwise path at every geometry: {case}")
        max_err["sfc_fused_conv2d_depthwise"] = max(
            max_err["sfc_fused_conv2d_depthwise"],
            (yf - y_ref).abs().max().item())
        if algo_name in TILE_PAIRS and batch == 1:
            time_tiles(case, x, p, prep, padding, tuple(w.shape))
        torch.cuda.synchronize()
        log("kernels:", json.dumps(case))
        checks.append(case)
    # INT4_FREQ: B1 (its (P, T, C) entry) exact against its plain version
    # on snapped inputs, B4 and B7 against their plain versions within
    # DEFAULT_TOL of the output's scale and bit for bit the staged paths on
    # snapped and raw inputs
    int4_rows = []
    for algo_name, hw, cin, cout, batch in INT4_CHECKS:
        dw = cout is None
        x = snapped(rng, (batch, hw, hw, cin))
        xr = torch.tensor(rng.randn(batch, hw, hw, cin), dtype=torch.float32,
                          device=dev)
        w = he_normal(rng, 1 if dw else cin, cin if dw else cout)
        make = ConvSpec.for_conv2d_depthwise if dw else ConvSpec.for_conv2d
        p = plan(make(x.shape, w.shape, quant=INT4_FREQ), backend="cuda",
                 algo=algo_name)
        algo = p.algorithm
        act = tuning.calibrate_act_scale(x, algo, INT4_FREQ)
        prep = p.prepare_weights(w, act_scale=act)
        if int(prep.wq.abs().max()) > 7:
            raise AssertionError("INT4_FREQ weights beyond 4 bits")
        bt = c2d.transform_matrices(algo, torch.float32, dev)[0]
        row = {"algo": algo_name, "hw": hw, "cin": cin, "cout": cout,
               "batch": batch}
        xq = kernels.sfc_transform_quantize_pt(x, bt, prep.act_scale,
                                               algo.M, bits=4)
        row["b1_mismatch_snapped"] = int((
            xq != ref.sfc_transform_quantize_pt_ref(
                x, bt, prep.act_scale, algo.M, bits=4)).sum())
        row["b1_max_abs_q"] = int(xq.abs().max())
        args = (x, prep.wq, prep.act_scale, prep.w_scale, algo)
        fused = kernels.sfc_fused_conv2d(*args, bits=4, depthwise=dw)
        y_ref = ref.sfc_fused_conv2d_ref(*args, bits=4, depthwise=dw)
        torch.testing.assert_close(fused, y_ref, rtol=DEFAULT_TOL,
                                   atol=DEFAULT_TOL * y_ref.abs().max().item())
        staged = kernels.quantized_fastconv2d_depthwise if dw \
            else kernels.quantized_fastconv2d
        row["fused_scaled_err"] = scaled_err(fused, y_ref)
        row["fused_equals_staged"] = all(
            torch.equal(kernels.sfc_fused_conv2d(xx, *args[1:], bits=4,
                                                 depthwise=dw),
                        staged(xx, *args[1:], bits=4)) for xx in (x, xr))
        k = "sfc_fused_conv2d_depthwise" if dw else "sfc_fused_conv2d"
        max_err[k] = max(max_err[k], (fused - y_ref).abs().max().item())
        if row["b1_mismatch_snapped"] or row["b1_max_abs_q"] > 7 \
                or not row["fused_equals_staged"]:
            raise AssertionError(f"INT4_FREQ: B1 differs from its plain "
                                 f"version, leaves 4 bits, or "
                                 f"{'B7' if dw else 'B4'} is not the staged "
                                 f"path bit for bit: {row}")
        torch.cuda.synchronize()
        log("int4:", json.dumps(row))
        int4_rows.append(row)
    report["phases"]["kernel_checks"] = checks
    report["phases"]["int4_checks"] = int4_rows
    report["phases"]["sub_algorithm_tiles"] = tile_rows

    # B2 bit for bit at every VGG-16 layer shape and at B2_CHECKS, B6 at
    # every depthwise layer and at B6_CHECKS, each at the per-layer
    # geometry and at a second one, on random int8 operands
    prng = np.random.RandomState(12)
    vgg, _ = vgg_layers()
    b2_shapes = [(math.ceil(hw / 6) ** 2, cin, cout)
                 for _, hw, cin, cout in vgg]
    b2_rows = []
    for T, K, N in b2_shapes + list(B2_CHECKS):
        X, W, sx, sw = int8_operands(prng, dev, (100, T, K), (100, K, N))
        Y_ref = ref.tdmm_int8_ref(X, W, sx, sw)
        g = sfc_tdmm.tdmm_geometry(100, T, K, N)
        alt = b2_alt(g)
        ga = sfc_tdmm.tdmm_geometry(100, T, K, N, **alt)
        row = {"T": T, "K": K, "N": N,
               "geometry": [g.bm, g.bn, g.bk, g.stages, g.tiles],
               "alt": [ga.bm, ga.bn, ga.bk, ga.stages, ga.tiles],
               "equal": bool(torch.equal(kernels.tdmm_int8(X, W, sx, sw),
                                         Y_ref)),
               "alt_equal": bool(torch.equal(
                   kernels.tdmm_int8(X, W, sx, sw, **alt), Y_ref))}
        b2_rows.append(row)
        if not (row["equal"] and row["alt_equal"]):
            raise AssertionError(f"B2 differs from its plain version: {row}")
    b6_shapes = [(math.ceil(hw / 6) ** 2, c) for _, hw, c in DW_LAYERS]
    b6_rows = []
    for T, C in b6_shapes + [(9, c) for c in B6_CHECKS]:
        X, W, sx, sw = int8_operands(prng, dev, (100, T, C), (100, C))
        Y_ref = ref.tdmm_int8_depthwise_ref(X, W, sx, sw)
        g = sfc_tdmm.dw_product_geometry(100, T, C)
        row = {"T": T, "C": C, "geometry": [g.groups, g.lanes, g.run],
               "equal": bool(torch.equal(
                   kernels.tdmm_int8_depthwise(X, W, sx, sw), Y_ref)),
               "alt_equal": bool(torch.equal(
                   kernels.tdmm_int8_depthwise(X, W, sx, sw, **B6_ALT),
                   Y_ref))}
        b6_rows.append(row)
        if not (row["equal"] and row["alt_equal"]):
            raise AssertionError(f"B6 differs from its plain version: {row}")
    torch.cuda.synchronize()
    log(f"kernels: B2 bit-identical to its plain version at {len(b2_rows)} "
        f"shapes, each at two geometries: "
        + json.dumps([[r["T"], r["K"], r["N"], r["geometry"], r["alt"]]
                      for r in b2_rows]))
    log(f"kernels: B6 bit-identical to its plain version at {len(b6_rows)} "
        f"shapes, each at two geometries: "
        + json.dumps([[r["T"], r["C"], r["geometry"]] for r in b6_rows]))
    report["phases"]["b2_b6_checks"] = {"b2": b2_rows, "b6": b6_rows}

    # ---- 3c. B4 at sfc6_7 with every default candidate (C12) -------------
    report["phases"]["b4_candidates"] = b4_candidates(dev, counted, timed,
                                                      smi)

    # ---- 4. the direct path under PyTorch's default TF32 flags -----------
    # the same "direct" plan on the card and on CPU copies of its inputs
    # (the CPU has no TF32); and with the port's cuDNN guard taken out,
    # what the default flags would give
    from repro_torch.core import conv2d as core_c2d
    direct_rows = []
    for label, shape, w_shape, stride, algo_name in DIRECT_CHECKS:
        drng = np.random.RandomState(shape[1] + w_shape[-1])
        x = torch.tensor(drng.randn(*shape), dtype=torch.float32, device=dev)
        w = torch.tensor(drng.randn(*w_shape) / math.sqrt(
            w_shape[0] * w_shape[1] * w_shape[2]), dtype=torch.float32,
            device=dev)
        p = plan(ConvSpec.for_conv2d(x.shape, w.shape, stride=stride,
                                     quant=FP32), backend="cuda",
                 algo=algo_name)
        if p.path != "direct":
            raise AssertionError(f"direct check {label}: the plan took the "
                                 f"{p.path} path")
        y_cpu = p.apply(x.cpu(), w.cpu())
        y = p.apply(x, w).cpu()
        guard = core_c2d.full_fp32_conv
        try:
            core_c2d.full_fp32_conv = contextlib.nullcontext
            y_unguarded = p.apply(x, w).cpu()
        finally:
            core_c2d.full_fp32_conv = guard
        row = {"plan": label, "flags": tf32_flags()}
        for what, yy in (("", y), ("unguarded_", y_unguarded)):
            row[f"{what}rel_l2"] = ((yy - y_cpu).norm()
                                    / y_cpu.norm().clamp_min(1e-30)).item()
            row[f"{what}scaled_max"] = scaled_err(yy, y_cpu)
        direct_rows.append(row)
        log("direct:", json.dumps(row))
        if not (row["rel_l2"] <= 1e-4 and row["scaled_max"] <= 1e-4
                and torch.isfinite(y).all()):
            raise AssertionError(f"direct plan {label} on the card misses "
                                 f"1e-4 against the CPU: {row}")
    report["phases"]["direct_default_flags"] = direct_rows

    # ---- 5. the paths ----------------------------------------------------
    def add_launches(*wants):
        return {k: sum(w[k] for w in wants) for k in REPLACES}

    def walls(path, what, fn, times=1, want=None):
        """Wall ms of SERVE_REPEATS counted forwards, and their median."""
        runs = []
        for _ in range(SERVE_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            counted(path, what, fn, times, want)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        return runs, statistics.median(runs)

    # -- 5a/5b. VGG-16, int8 (fused, staged) and fp ------------------------
    layers, stage_ends = vgg_layers()
    wrng = np.random.RandomState(0)
    weights = {n: he_normal(wrng, cin, cout) for n, _, cin, cout in layers}
    biases = {n: torch.zeros(cout, device=dev) for n, _, _, cout in layers}
    requests = [torch.tensor(np.random.RandomState(100 + i).randn(
        b, IMAGE, IMAGE, 3), dtype=torch.float32, device=dev)
        for i, b in enumerate(REQUEST_BATCHES)]
    fp_requests = [torch.tensor(np.random.RandomState(200 + i).randn(
        b, IMAGE, IMAGE, 3), dtype=torch.float32, device=dev)
        for i, b in enumerate(FP_REQUEST_BATCHES)]
    datapaths = {"fused": tuning.DEFAULT_FUSED,
                 "staged": tuning.DEFAULT_STAGED}
    saved = []                    # (request, datapath, layer, x, plan, prep)
    fused_out = {}                # (request, layer) -> the fused output
    vgg_equal = []                # (request, layer) where fused == staged
    tuned_equal = []              # (request, layer) where fused == tuned
    finals = {}                   # (request, datapath) -> the stack output
    per_layer, stacks, served = [], [], {}

    def forward(images, state):
        """The served forward: 13 convs with prepared weights."""
        h = images
        for li, (p, prep, bias) in enumerate(state):
            h = torch.relu(p.apply(h, prep, bias=bias))
            if li in stage_ends:
                h = max_pool_same(h, 2, 2)
        return h

    def check_pass(ri, images, dp):
        """One forward of a request, every layer checked on its way."""
        h, state = images, []
        kind = "fp" if dp == "fp" else "int8"
        for li, (lname, hw, cin, cout) in enumerate(layers):
            if dp == "fp":
                p, prep = prepared_fp(h, weights[lname], ALGO)
            else:
                p, prep = prepared(h, weights[lname], ALGO, datapaths[dp])
            y = p.apply(h, prep, bias=biases[lname])
            y_ref = plan(p.spec, backend="reference", algo=ALGO).apply(
                h, prep, bias=biases[lname])
            rel_l2, scaled = held(f"request {ri} {dp} {lname}", y, y_ref,
                                  kind)
            per_layer.append({"request": ri, "batch": h.shape[0],
                              "datapath": dp, "layer": lname, "hw": hw,
                              "cin": cin, "cout": cout, "rel_l2": rel_l2,
                              "scaled_max": scaled})
            saved.append((ri, dp, lname, h, p, prep))
            # the fused and the staged datapath of one request: bit-identical
            # at every layer (so every layer's input and calibration agree)
            if dp == "fused":
                fused_out[(ri, lname)] = y
            elif dp in ("staged", "tuned"):
                if not torch.equal(fused_out[(ri, lname)], y):
                    raise AssertionError(f"request {ri} {lname}: the fused "
                                         f"and the {dp} outputs differ")
                (vgg_equal if dp == "staged" else tuned_equal).append(
                    (ri, lname))
            state.append((p, prep, biases[lname]))
            h = torch.relu(y)
            if li in stage_ends:
                h = max_pool_same(h, 2, 2)
        return h, state

    vgg_runs = [(ri, images, dp) for ri, images in enumerate(requests)
                for dp in datapaths]
    vgg_runs += [(ri, images, "fp") for ri, images in enumerate(fp_requests)]

    def vgg_request(ri, images, dp):
        path = f"vgg_{dp}"
        # the checking pass: calibrate, prepare and apply every layer, each
        # held against the reference backend on the same input
        h, state = counted(path, f"request {ri} checked",
                           lambda: check_pass(ri, images, dp))
        finals[(ri, dp)] = h
        want = (images.shape[0], IMAGE // 32, IMAGE // 32, VGG_WIDTHS[-1])
        if h.shape != want or not torch.isfinite(h).all():
            raise AssertionError(f"request {ri} {dp}: stack output "
                                 f"{tuple(h.shape)} is not a finite {want}")
        # the served forward with these prepared weights, wall clock (host
        # and card); the card's own time is taken after the paths ran
        if not torch.equal(counted(path, f"request {ri} served",
                                   lambda: forward(images, state)), h):
            raise AssertionError(f"request {ri} {dp}: the served forward "
                                 f"differs from the checked one")
        runs, wall = walls(path, f"request {ri} timed",
                           lambda: forward(images, state))
        stacks.append({"request": ri, "batch": images.shape[0],
                       "datapath": dp, "wall_ms_runs": runs,
                       "wall_ms": wall})
        served[(ri, dp)] = (images, state)

    for ri, images, dp in vgg_runs:
        vgg_request(ri, images, dp)
    torch.cuda.synchronize()
    if len(vgg_equal) != N_VGG * len(REQUEST_BATCHES):
        raise AssertionError(f"fused and staged were compared on "
                             f"{len(vgg_equal)} layer requests, not "
                             f"{N_VGG * len(REQUEST_BATCHES)}")

    # -- 5b, TF32 on. The fp path's product runs in full float32 whatever
    # the caller allowed: one more forward of the batch-1 fp request with
    # the caller's TF32 on for cuBLAS, every layer held to the fp bounds
    # against the reference (TF32 off) and to bit equality with the same
    # forward under TF32 off; the caller's setting must be intact after it.
    # The same forward with the guard taken out shows what TF32 would give.
    matmul = torch.backends.cuda.matmul
    tf32_name, tf32_on = (("fp32_precision", "tf32")
                          if hasattr(matmul, "fp32_precision")
                          else ("allow_tf32", True))
    fp_saved = [(lname, x, p, prep) for ri, dp, lname, x, p, prep in saved
                if ri == 0 and dp == "fp"]

    def fp_layers():
        return [p.apply(x, prep, bias=biases[lname])
                for lname, x, p, prep in fp_saved]

    fp_refs = [plan(p.spec, backend="reference", algo=ALGO).apply(
        x, prep, bias=biases[lname]) for lname, x, p, prep in fp_saved]
    fp_off = fp_layers()
    caller = getattr(matmul, tf32_name)
    guard = ops.full_fp32_matmul
    try:
        setattr(matmul, tf32_name, tf32_on)
        fp_on = counted("vgg_fp", "request 0 with TF32 on", fp_layers)
        kept = getattr(matmul, tf32_name) == tf32_on
        ops.full_fp32_matmul = contextlib.nullcontext
        fp_unguarded = fp_layers()
    finally:
        ops.full_fp32_matmul = guard
        setattr(matmul, tf32_name, caller)
    if not kept:
        raise AssertionError("the fp path did not restore the caller's TF32 "
                             "setting")
    tf32_rows = []
    for (lname, *_), y, y_off, y_tf32, y_ref in zip(
            fp_saved, fp_on, fp_off, fp_unguarded, fp_refs):
        rel_l2, scaled = held(f"request 0 fp {lname} with TF32 on", y, y_ref,
                              "fp")
        if not torch.equal(y, y_off):
            raise AssertionError(f"request 0 fp {lname}: the output with the "
                                 f"caller's TF32 on differs from the one "
                                 f"with TF32 off")
        tf32_rows.append({
            "layer": lname, "rel_l2": rel_l2, "scaled_max": scaled,
            "unguarded_rel_l2": ((y_tf32 - y_ref).norm()
                                 / y_ref.norm().clamp_min(1e-30)).item(),
            "unguarded_scaled_max": scaled_err(y_tf32, y_ref)})
    log(f"vgg: fp request 0 with the caller's TF32 on ({tf32_name}="
        f"{tf32_on!r}): all {len(fp_saved)} layers bit-identical to TF32 "
        f"off, worst rel L2 {max(r['rel_l2'] for r in tf32_rows):.3e}, "
        f"setting restored; "
        f"without the guard, TF32 gives worst rel L2 "
        f"{max(r['unguarded_rel_l2'] for r in tf32_rows):.3e}, max |diff| / "
        f"max |ref| {max(r['unguarded_scaled_max'] for r in tf32_rows):.3e} "
        f"(bounds {BOUNDS['fp'][0]}, {BOUNDS['fp'][1]})")

    # -- 5c. depthwise: MobileNetV2's stride-1 depthwise convs and dw3x3 ---
    dw_weights = [he_normal(np.random.RandomState(300 + li), 1, c)
                  for li, (_, _, c) in enumerate(DW_LAYERS)]
    dw_rows, dw_stacks, dw_states = [], [], {}

    def dw_stack(state):
        """The served depthwise forward: every layer on its own input."""
        return [p.apply(x, prep) for _, p, prep, x in state]

    for bi, batch in enumerate(DW_BATCHES):
        states = {"fused": [], "staged": [], "fp": []}
        outputs = {"fused": [], "staged": [], "fp": []}
        for li, (lname, hw, c) in enumerate(DW_LAYERS):
            x = torch.tensor(np.random.RandomState(400 + 100 * bi + li).randn(
                batch, hw, hw, c), dtype=torch.float32, device=dev)
            w = dw_weights[li]
            p8, prep8 = prepared(x, w, ALGO, depthwise=True)
            pfp, prepfp = prepared_fp(x, w, ALGO, depthwise=True)
            plans = {"fused": (p8.with_config(tuning.DEFAULT_FUSED), prep8),
                     "staged": (p8.with_config(tuning.DEFAULT_STAGED), prep8),
                     "fp": (pfp, prepfp)}
            row = {"batch": batch, "layer": lname, "hw": hw, "c": c}
            for mode, (p, prep) in plans.items():
                y = counted(f"dw_{mode}", f"batch {batch} {lname} checked",
                            lambda: p.apply(x, prep))
                y_ref = plan(p.spec, backend="reference", algo=ALGO).apply(
                    x, prep)
                if y.shape != x.shape:
                    raise AssertionError(f"{lname} {mode}: output "
                                         f"{tuple(y.shape)}, not "
                                         f"{tuple(x.shape)}")
                row[f"{mode}_rel_l2"], row[f"{mode}_scaled_max"] = held(
                    f"depthwise batch {batch} {lname} {mode}", y, y_ref,
                    "fp" if mode == "fp" else "int8")
                states[mode].append((lname, p, prep, x))
                outputs[mode].append(y)
            row["fused_equals_staged"] = bool(torch.equal(
                outputs["fused"][-1], outputs["staged"][-1]))
            if not row["fused_equals_staged"]:
                raise AssertionError(f"depthwise batch {batch} {lname}: the "
                                     f"fused and the staged outputs differ")
            row["xq_flips"], row["xq_values"] = xq_flips(x, p8, prep8)
            dw_rows.append(row)
        for mode, state in states.items():
            got = counted(f"dw_{mode}", f"batch {batch} stack served",
                          lambda: dw_stack(state), times=len(DW_LAYERS))
            if not all(torch.equal(a, b) for a, b in zip(got, outputs[mode])):
                raise AssertionError(f"depthwise batch {batch} {mode}: the "
                                     f"served outputs differ from the "
                                     f"checked ones")
            runs, wall = walls(f"dw_{mode}", f"batch {batch} stack timed",
                               lambda: dw_stack(state), times=len(DW_LAYERS))
            dw_stacks.append({"batch": batch, "path": mode,
                              "wall_ms_runs": runs, "wall_ms": wall})
            dw_states[(batch, mode)] = state
    torch.cuda.synchronize()

    # -- 5d. the lowered convs at full width -------------------------------
    def prepare_any(p, x, w):
        """Prepared weights for plan ``p`` on ``x``: int8-calibrated wherever
        the plan has a transform domain (per sub-conv when lowered)."""
        if not p.spec.quant.enabled or p.path == "direct":
            return p.prepare_weights(w)
        if p.path == "lowered":
            return p.prepare_weights(w, act_scale=p.calibrate(x))
        return p.prepare_weights(w, act_scale=tuning.calibrate_act_scale(
            x, p.algorithm, p.spec.quant, p.spec.padding))

    def yardsticks(x, w, stride, groups):
        """Card ms of the same conv as one strided direct plan (cuDNN in
        full fp32) and as cuDNN's fp16 conv (a yardstick only)."""
        spec = ConvSpec.for_conv2d(x.shape, w.shape, stride=stride,
                                   groups=groups, quant=FP32)
        pd = plan(spec, backend="cuda", algo="direct")
        x16 = x.permute(0, 3, 1, 2).half().contiguous(
            memory_format=torch.channels_last)
        w16 = w.permute(3, 2, 0, 1).half().contiguous(
            memory_format=torch.channels_last)
        pad = w.shape[0] // 2
        return {"direct_fp32_ms": timed(lambda: pd.apply(x, w)),
                "cudnn_fp16_ms": timed(lambda: F.conv2d(
                    x16, w16, stride=stride, padding=pad, groups=groups))}

    def glue_times(p, x, prep):
        """Card ms of a lowered plan's glue (cutting the input into its
        sub-convs' operands, and summing or concatenating their outputs)
        and of each sub-conv alone."""
        xs = p._sub_inputs(x)
        ys = [sp.apply(xi, pr) for sp, xi, pr in
              zip(p.sub_plans, xs, prep.subs)]

        def combine():
            if p.kind == "grouped":
                return torch.cat(ys, dim=-1)
            y = ys[0]
            for yi in ys[1:]:
                y = y + yi
            return y
        return {"cut_ms": timed(lambda: p._sub_inputs(x)),
                "combine_ms": timed(combine),
                "sub_ms": [timed(lambda: sp.apply(xi, pr)) for sp, xi, pr
                           in zip(p.sub_plans, xs, prep.subs)]}

    lowered_rows = []

    def lowered_layer(lname, x, w, spec_of, modes, stride, groups=1):
        """One lowered conv on ``x``: each mode (label, quant, algo, config,
        path wanted) planned, prepared, applied with its launches asserted
        and held against the reference backend on the same plan; int8
        fused and staged bit-identical; card and wall ms beside the
        yardsticks, and the glue's share."""
        row = {"layer": lname, "batch": x.shape[0], "shape": list(x.shape),
               "modes": {}}
        outs = {}
        for label, quant, algo, cfg, path_wanted in modes:
            spec = spec_of(quant)
            p = plan(spec, backend="cuda", algo=algo)
            if cfg is not None:
                p = p.with_config(cfg)
            if p.path != path_wanted:
                raise AssertionError(f"{lname} {label}: planned {p.path} "
                                     f"({p.algo_name}), not {path_wanted}")
            prep = prepare_any(p, x, w)
            fp = quant is FP32
            want = plan_launches(p, fp)
            what = f"{lname} batch {x.shape[0]} {label}"
            y = counted(f"lowered_{label}", what, lambda: p.apply(x, prep),
                        want=want)
            y_ref = plan(spec, backend="reference", algo=algo).apply(x, prep)
            rel_l2, scaled = held(what, y, y_ref, "fp" if fp else "int8")
            runs, wall = walls(f"lowered_{label}", what,
                               lambda: p.apply(x, prep), want=want)
            m = {"plan": p.algo_name, "path": p.path, "rel_l2": rel_l2,
                 "scaled_max": scaled, "wall_ms": wall,
                 "card_ms": timed(lambda: p.apply(x, prep)),
                 "launches": {k: v for k, v in want.items() if v}}
            if p.path == "lowered":
                m.update(glue_times(p, x, prep))
                m["glue_share"] = (m["cut_ms"] + m["combine_ms"]) \
                    / m["card_ms"]
            row["modes"][label] = m
            outs[label] = y
        if "int8_fused" in outs:
            row["fused_equals_staged"] = bool(torch.equal(
                outs["int8_fused"], outs["int8_staged"]))
            if not row["fused_equals_staged"]:
                raise AssertionError(f"{lname} batch {x.shape[0]}: the fused "
                                     f"and the staged outputs differ")
        row.update(yardsticks(x, w, stride, groups))
        lowered_rows.append(row)
        log("lowered:", json.dumps(row))

    int8_dense = [("int8_fused", INT8_FREQ, ALGO, tuning.DEFAULT_FUSED,
                   "lowered"),
                  ("int8_staged", INT8_FREQ, ALGO, tuning.DEFAULT_STAGED,
                   "lowered")]
    for bi, batch in enumerate(LOWERED_BATCHES):
        lw = np.random.RandomState(700)
        for lname, hw, cin, cout, R in LOWERED_LAYERS:
            x = torch.tensor(np.random.RandomState(710 + 10 * bi + R).randn(
                batch, hw, hw, cin), dtype=torch.float32, device=dev)
            w = he_normal(lw, cin, cout, R)
            lowered_layer(
                lname, x, w, lambda q: ConvSpec.for_conv2d(
                    x.shape, w.shape, stride=2, quant=q),
                int8_dense + [("fp", FP32, ALGO, None, "lowered")], 2)
        for lname, hw, c in LOWERED_DW:
            x = torch.tensor(np.random.RandomState(730 + 10 * bi + c).randn(
                batch, hw, hw, c), dtype=torch.float32, device=dev)
            w = he_normal(lw, 1, c)
            fp_path = plan(ConvSpec.for_conv2d_depthwise(
                x.shape, w.shape, stride=2, quant=FP32), backend="cuda",
                algo=ALGO).path
            lowered_layer(
                lname, x, w, lambda q: ConvSpec.for_conv2d_depthwise(
                    x.shape, w.shape, stride=2, quant=q),
                [("int8_auto", INT8_FREQ, "auto", None, "direct"),
                 ("int8_fused", INT8_FREQ, DW_LOWERED_ALGO,
                  tuning.DEFAULT_FUSED, "lowered"),
                 ("int8_staged", INT8_FREQ, DW_LOWERED_ALGO,
                  tuning.DEFAULT_STAGED, "lowered"),
                 ("fp", FP32, ALGO, None, fp_path)], 2, groups=c)
        for lname, hw, cin, cout, g in LOWERED_GROUPED:
            x = torch.tensor(np.random.RandomState(750 + bi).randn(
                batch, hw, hw, cin), dtype=torch.float32, device=dev)
            w = he_normal(lw, cin // g, cout)
            lowered_layer(
                lname, x, w, lambda q: ConvSpec.for_conv2d(
                    x.shape, w.shape, groups=g, quant=q), int8_dense, 1,
                groups=g)
    torch.cuda.synchronize()
    report["phases"]["lowered_layers"] = lowered_rows

    # -- 5e. the measured tier: autotune at batch 1 -----------------------
    vgg_specs = {(hw, cin, cout): ConvSpec.for_conv2d(
        (1, hw, hw, cin), (3, 3, cin, cout), quant=INT8_FREQ)
        for _, hw, cin, cout in layers}
    resnet = resnet_convs()
    if len(resnet) != 20:
        raise AssertionError(f"ResNet-18 has 20 convs, not {len(resnet)}")
    resnet_specs = {(R, s, hw, cin, cout): ConvSpec.for_conv2d(
        (1, hw, hw, cin), (R, R, cin, cout), stride=s, quant=INT8_FREQ)
        for _, R, s, hw, cin, cout in resnet}
    tune_rows = []
    t_tune = time.perf_counter()
    for label, spec in [(f"vgg {k}", v) for k, v in vgg_specs.items()] \
            + [(f"resnet {k}", v) for k, v in resnet_specs.items()]:
        lines = []
        fast = plan(spec, backend="cuda", algo=ALGO).path != "direct"
        results = tuning.autotune(spec, "cuda", device=dev, algos=[ALGO],
                                  log=lines.append)
        row = {"spec": label, "results": results, "log": lines}
        if fast:
            if ALGO not in results \
                    or tuning.get_config(spec, "cuda", ALGO) is None:
                raise AssertionError(f"tune {label}: no winner recorded: "
                                     f"{results}")
            # the card time of each datapath on an input like autotune's
            trng = np.random.RandomState(800)
            x = torch.tensor(trng.randn(1, *spec.spatial, spec.in_channels),
                             dtype=torch.float32, device=dev)
            w = he_normal(trng, spec.in_channels, spec.out_channels,
                          spec.kernel_size)
            row["card_ms"] = {}
            for dp, cfg in (("fused", tuning.DEFAULT_FUSED),
                            ("staged", tuning.DEFAULT_STAGED)):
                p = plan(spec, backend="cuda", algo=ALGO).with_config(cfg)
                prep = prepare_any(p, x, w)
                row["card_ms"][dp] = timed(lambda: p.apply(x, prep))
            row["winner"] = results[ALGO]["config"]
        elif "direct" not in results:
            raise AssertionError(f"tune {label}: direct not timed")
        tune_rows.append(row)
        log(f"tune: {label}: winner {row.get('winner')}, wall ms "
            + json.dumps({k: round(v["time_s"] * 1e3, 4)
                          for k, v in results.items()})
            + f", card ms {json.dumps(row.get('card_ms'))}; "
            + "; ".join(lines))
    tune_seconds = time.perf_counter() - t_tune
    log(f"tune: {len(tune_rows)} specs in {tune_seconds:.1f} s, cache "
        f"{tuning.cache_path()}")

    # the tuned VGG-16 request: every layer planned without a config, so
    # each carries its measured winner; bit for bit the fused and staged
    EXPECTED["vgg_tuned"] = add_launches(*[
        plan_launches(plan(spec, backend="cuda", algo=ALGO))
        for spec in (vgg_specs[(hw, cin, cout)]
                     for _, hw, cin, cout in layers)])
    datapaths["tuned"] = None
    for ri in (0, len(requests) - 1):
        vgg_request(ri, requests[ri], "tuned")
        for dp in ("fused", "staged"):
            if not torch.equal(finals[(ri, "tuned")], finals[(ri, dp)]):
                raise AssertionError(f"request {ri}: the tuned VGG-16 "
                                     f"output differs from the {dp} one")
    if len(tuned_equal) != 2 * N_VGG:
        raise AssertionError(f"fused and tuned were compared on "
                             f"{len(tuned_equal)} layers, not {2 * N_VGG}")
    log(f"vgg: the tuned request launches "
        f"{json.dumps({k: v for k, v in EXPECTED['vgg_tuned'].items() if v})}"
        f"; bit for bit the fused and the staged at batch 1 and 4")
    report["phases"]["tuning"] = {"specs": tune_rows,
                                  "seconds": tune_seconds,
                                  "vgg_tuned_launches":
                                      EXPECTED["vgg_tuned"]}

    # -- 5f. ResNet-18's conv stack, the slice's main path -----------------
    by_name = {lname: (R, s, hw, cin, cout)
               for lname, R, s, hw, cin, cout in resnet}
    rw = {lname: he_normal(np.random.RandomState(900 + i), cin, cout, R)
          for i, (lname, R, _, _, cin, cout) in enumerate(resnet)}
    resnet_modes = {"fused": (INT8_FREQ, tuning.DEFAULT_FUSED),
                    "staged": (INT8_FREQ, tuning.DEFAULT_STAGED),
                    "tuned": (INT8_FREQ, None), "fp": (FP32, None)}
    resnet_rows, resnet_stacks, resnet_memory = [], [], {}
    for batch in RESNET_BATCHES:
        images = torch.tensor(np.random.RandomState(950 + batch).randn(
            batch, IMAGE, IMAGE, 3), dtype=torch.float32, device=dev)
        outs = {}
        for mode, (quant, cfg) in resnet_modes.items():
            plans = {}
            for lname, (R, s, hw, cin, cout) in by_name.items():
                p = plan(ConvSpec.for_conv2d((batch, hw, hw, cin),
                                             (R, R, cin, cout), stride=s,
                                             quant=quant),
                         backend="cuda", algo=ALGO)
                plans[lname] = p if cfg is None else p.with_config(cfg)
            want = add_launches(*[plan_launches(p, quant is FP32)
                                  for p in plans.values()])
            state, layer_out = {}, {}

            def check_conv(lname, h):
                p = plans[lname]
                prep = prepare_any(p, h, rw[lname])
                y = p.apply(h, prep)
                y_ref = plan(p.spec, backend="reference", algo=ALGO).apply(
                    h, prep)
                rel_l2, scaled = held(f"resnet batch {batch} {mode} {lname}",
                                      y, y_ref,
                                      "fp" if quant is FP32 else "int8")
                resnet_rows.append({"batch": batch, "mode": mode,
                                    "layer": lname, "plan": p.algo_name,
                                    "rel_l2": rel_l2, "scaled_max": scaled})
                state[lname] = (p, prep)
                layer_out[lname] = y
                return y

            def served_conv(lname, h):
                p, prep = state[lname]
                return p.apply(h, prep)

            path = f"resnet_{mode}"
            h = counted(path, f"batch {batch} checked",
                        lambda: resnet_forward(images, check_conv),
                        want=want)
            shape = (batch, IMAGE // 32, IMAGE // 32, RESNET_WIDTHS[-1])
            if h.shape != shape or not torch.isfinite(h).all():
                raise AssertionError(f"resnet batch {batch} {mode}: output "
                                     f"{tuple(h.shape)} is not a finite "
                                     f"{shape}")
            if not torch.equal(counted(path, f"batch {batch} served",
                                       lambda: resnet_forward(images,
                                                              served_conv),
                                       want=want), h):
                raise AssertionError(f"resnet batch {batch} {mode}: the "
                                     f"served forward differs")
            runs, wall = walls(path, f"batch {batch} timed",
                               lambda: resnet_forward(images, served_conv),
                               want=want)
            card = timed(lambda: resnet_forward(images, served_conv),
                         runs=SERVE_REPEATS)
            resnet_stacks.append({
                "batch": batch, "path": mode, "wall_ms_runs": runs,
                "wall_ms": wall, "card_ms": card,
                "plans": {n: p.algo_name for n, p in plans.items()
                          if p.path == "lowered"},
                "configs": {n: None if p.config is None
                            else p.config.to_json()
                            for n, p in plans.items()},
                "launches": {k: v for k, v in want.items() if v}})
            log(f"resnet: batch {batch} {mode}: 20 convs {wall:.3f} ms "
                f"wall, {card:.3f} ms on the card (medians of "
                f"{SERVE_REPEATS}); launches "
                f"{json.dumps(resnet_stacks[-1]['launches'])}")
            outs[mode] = layer_out
            if batch == RESNET_BATCHES[-1]:
                torch.cuda.synchronize()
                resident = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                resnet_forward(images, served_conv)
                torch.cuda.synchronize()
                resnet_memory[mode] = \
                    torch.cuda.max_memory_allocated() - resident
                log(f"memory: resnet batch {batch} {mode}: peak "
                    f"{resnet_memory[mode] / 2**20:.1f} MiB above resident")
        for mode in ("staged", "tuned"):
            for lname, y in outs["fused"].items():
                if not torch.equal(outs[mode][lname], y):
                    raise AssertionError(f"resnet batch {batch} {lname}: the "
                                         f"fused and the {mode} outputs "
                                         f"differ")
        log(f"resnet: batch {batch}: fused, staged and tuned bit-identical "
            f"at all 20 layers")
    torch.cuda.synchronize()
    for mode in resnet_modes:
        rows = [r for r in resnet_rows if r["mode"] == mode]
        worst = max(rows, key=lambda r: r["rel_l2"])
        log(f"resnet: {mode} worst layer vs reference rel L2 "
            f"{worst['rel_l2']:.3e} ({worst['layer']}, batch "
            f"{worst['batch']}), max |diff| / max |ref| "
            f"{max(r['scaled_max'] for r in rows):.3e}")
    report["phases"]["resnet18"] = {"per_layer": resnet_rows,
                                    "stacks": resnet_stacks,
                                    "memory_peak_above_resident_bytes":
                                        resnet_memory}

    for path, ran in sorted(path_kernels.items()):
        if any(path_launches[path][k] <= 0 for k in ran):
            raise AssertionError(f"a kernel of {path} never launched: "
                                 f"{path_launches[path]}")
    log("paths: forwards per path " + json.dumps(n_forwards))

    for path in EXPECTED:
        log(f"paths: each of {n_forwards[path]} {path} forwards launched "
            f"{json.dumps({k: v for k, v in EXPECTED[path].items() if v})}"
            f"{' per layer' if path.startswith('dw_') else ''}")
    log("paths: launches over all paths", json.dumps(launches))
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")

    for row in stacks:
        images, state = served[(row["request"], row["datapath"])]
        row["card_ms"] = timed(lambda: forward(images, state),
                               runs=SERVE_REPEATS)
        log(f"vgg: request {row['request']} batch {row['batch']} "
            f"{row['datapath']}: 13 convs {row['wall_ms']:.3f} ms wall, "
            f"{row['card_ms']:.3f} ms on the card (medians of "
            f"{SERVE_REPEATS})")
    def host_ms(fn, runs):
        """Host ms of one ``fn`` call: ``runs`` calls enqueued behind a
        spin kernel that outlasts them, so the host never waits for the
        card (the spin doubles until it does, as in ``timed``)."""
        fn()
        torch.cuda.synchronize()
        for doubling in range(8):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            torch.cuda._sleep(SPIN_CYCLES << doubling)
            ev[1].record()
            t0 = time.perf_counter()
            for _ in range(runs):
                fn()
            host = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            if host < ev[0].elapsed_time(ev[1]):
                return host / runs
        log(f"host_ms: the host outran every spin; {host:.1f} ms to "
            f"enqueue, the time includes waits for the card")
        return host / runs

    # the degradation chain's host cost: phases 3-6 run with it off, a
    # user's cuda plans with it on. The batch-1 fused and staged stacks,
    # chain off, on, on, off, twice: the host's enqueue time of a forward
    # (the chain's cost, free of the card), the wall clock and the card
    # time
    chain_cost = []
    for dp in ("fused", "staged"):
        images, state = served[(0, dp)]
        modes = {m: {"host_ms_runs": [], "wall_ms_runs": [],
                     "card_ms_runs": []} for m in ("off", "on")}
        for mode in ("off", "on", "on", "off") * 2:
            with resilience.configured(enabled=mode == "on"):
                m = modes[mode]
                # SERVE_REPEATS forwards a spin: more would fill the
                # card's launch queue and block the host on the spin
                m["host_ms_runs"] += [
                    host_ms(lambda: forward(images, state), SERVE_REPEATS)
                    for _ in range(CHAIN_REPEATS // SERVE_REPEATS)]
                for _ in range(CHAIN_REPEATS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    forward(images, state)
                    torch.cuda.synchronize()
                    m["wall_ms_runs"].append(
                        (time.perf_counter() - t0) * 1e3)
                m["card_ms_runs"].append(
                    timed(lambda: forward(images, state),
                          runs=SERVE_REPEATS))
                if resilience.stats():
                    raise AssertionError(f"chain cost {dp}: resilience "
                                         f"events {resilience.stats()}")
        row = {"datapath": dp, "batch": images.shape[0], "convs": len(state)}
        for mode, m in modes.items():
            m["host_ms"] = statistics.mean(m["host_ms_runs"])
            m["wall_ms"] = statistics.median(m["wall_ms_runs"])
            m["card_ms"] = statistics.median(m["card_ms_runs"])
            row[mode] = m
        row["host_us_per_apply"] = (row["on"]["host_ms"]
                                    - row["off"]["host_ms"]) * 1e3 \
            / len(state)
        chain_cost.append(row)
        log(f"chain: batch-1 {dp} VGG-16 stack, chain off / on (off, on, "
            f"on, off, twice): host {row['off']['host_ms']:.4f} / "
            f"{row['on']['host_ms']:.4f} ms a forward (means of "
            f"{4 * CHAIN_REPEATS} enqueued behind spins, "
            f"{SERVE_REPEATS} a spin; spread "
            f"{min(row['off']['host_ms_runs']):.4f}-"
            f"{max(row['off']['host_ms_runs']):.4f} / "
            f"{min(row['on']['host_ms_runs']):.4f}-"
            f"{max(row['on']['host_ms_runs']):.4f}), "
            f"{row['host_us_per_apply']:+.2f} us a conv; wall "
            f"{row['off']['wall_ms']:.3f} / {row['on']['wall_ms']:.3f} ms "
            f"(medians of {4 * CHAIN_REPEATS}); card "
            f"{row['off']['card_ms']:.3f} / {row['on']['card_ms']:.3f} ms; "
            f"on {smi}")
    for row in dw_stacks:
        state = dw_states[(row["batch"], row["path"])]
        row["card_ms"] = timed(lambda: dw_stack(state), runs=SERVE_REPEATS)
        log(f"depthwise: batch {row['batch']} {row['path']}: "
            f"{len(DW_LAYERS)} convs {row['wall_ms']:.3f} ms wall, "
            f"{row['card_ms']:.3f} ms on the card (medians of "
            f"{SERVE_REPEATS})")
    for kind in ("int8", "fp"):
        rows = [r for r in per_layer if (r["datapath"] == "fp") == (kind == "fp")]
        worst = max(rows, key=lambda r: r["rel_l2"])
        log(f"vgg: {kind} worst layer vs reference rel L2 "
            f"{worst['rel_l2']:.3e}, max |diff| / max |ref| "
            f"{max(r['scaled_max'] for r in rows):.3e} ({worst['layer']}, "
            f"{worst['datapath']})"
            + (f"; fused equals staged on all {len(vgg_equal)} layer "
               f"requests" if kind == "int8" else ""))
    for mode in ("fused", "staged", "fp"):
        worst = max(dw_rows, key=lambda r: r[f"{mode}_rel_l2"])
        log(f"depthwise: {mode} worst layer vs reference rel L2 "
            f"{worst[f'{mode}_rel_l2']:.3e}, max |diff| / max |ref| "
            f"{max(r[f'{mode}_scaled_max'] for r in dw_rows):.3e} "
            f"({worst['layer']}, batch {worst['batch']}); fused equals "
            f"staged on all {len(dw_rows)} layer requests")

    # xq grid flips between B1 and the reference's transform, per layer
    flips, n_values = [], 0
    for ri, dp, lname, x, p, prep in saved:
        if dp == "fp":
            continue
        f, n = xq_flips(x, p, prep)
        flips.append(f)
        n_values += n
    for row, f in zip((r for r in per_layer if r["datapath"] != "fp"), flips):
        row["xq_flips"] = f
    log(f"vgg: xq values that differ between B1 and its plain version "
        f"on the path's own inputs: {sum(flips)} of {n_values}, worst "
        f"layer {max(flips)}")
    log(f"depthwise: xq values that differ between B1 and its plain "
        f"version: {sum(r['xq_flips'] for r in dw_rows)} of "
        f"{sum(r['xq_values'] for r in dw_rows)}")

    # ---- 6. per-kernel times over the layers of a batch-1 request --------
    totals = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                  "bytes_ms": 0.0, "ops_ms": 0.0, "library_ms": None}
              for k in REPLACES}
    # B1, B5 and B3 over the depthwise layers at batch 1, as the staged and
    # fp depthwise paths run them
    dw_totals = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                     "bytes_ms": 0.0, "ops_ms": 0.0, "library_ms": None}
                 for k in ("sfc_transform_quantize", "sfc_transform",
                           "sfc_inverse")}
    glue = {"fp_contraction_ms": 0.0}
    fp_b3 = {"sfc_inverse_ms": 0.0}         # B3 on the fp request's inputs
    # B3's tile entry on the same values (the JAX kernel's contract, which
    # no path calls), its bound, and the copies the staged path made around
    # it before the NHWC entry
    b3_tile = {"tile_ms": 0.0, "tile_bound_ms": 0.0, "glue_ms": 0.0}
    layer_times = []
    # the card's time for one launch of nothing: a one-float fill
    one = torch.zeros(1, device=dev)
    launch_floor_ms = timed(lambda: one.zero_())

    def time_kernels(row, fns, work, sums=totals):
        """Time each kernel, its plain version and its library call; add
        them and the kernel's bound to ``sums`` and ``row``."""
        for k, (kern, plain, lib) in fns.items():
            nbytes, int8_ops, f32_ops = work[k]
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = (int8_ops / INT8_OPS_PER_S + f32_ops / F32_OPS_PER_S) \
                * 1e3
            ms, plain_ms = timed(kern), timed(plain)
            tot = sums[k]
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["bytes_ms"] += bytes_ms
            tot["ops_ms"] += ops_ms
            tot["bound_ms"] += max(bytes_ms, ops_ms)
            row[k] = {"ms": ms, "plain_ms": plain_ms,
                      "bound_ms": max(bytes_ms, ops_ms),
                      "bound_by": "bytes" if bytes_ms >= ops_ms
                      else "operations"}
            if lib is not None:
                lib_ms = timed(lib)
                tot["library_ms"] = (tot["library_ms"] or 0.0) + lib_ms
                row[k]["library_ms"] = lib_ms

    def transform_ops(algo, T, C, bt, quantize):
        """f32 operations of B^T X B for T tiles x C channels: B^T rows
        over L columns, then B^T over the t rows (an FMA is two), and for
        the quantizer a divide, round and clip per value."""
        t, L = algo.t, algo.L
        nnz_bt = int((bt != 0).sum())
        return T * C * (2 * nnz_bt * L + 2 * t * nnz_bt
                        + (3 * t * t if quantize else 0))

    def inverse_ops(algo, T, C, at):
        nnz_at = int((at != 0).sum())
        return T * C * (2 * nnz_at * algo.t + 2 * algo.M * nnz_at)

    for ri, dp, lname, x, p, prep in saved:
        if ri != 0 or dp not in ("fused", "fp"):
            continue
        algo = p.algorithm
        t, M, P = algo.t, algo.M, algo.t ** 2
        B, H, W, cin = x.shape
        bt, _, at = c2d.transform_matrices(algo, torch.float32, dev)
        grid = c2d.tile_grid(H, W, M, algo.R, "SAME")
        T = B * grid.nH * grid.nW
        row = {"layer": lname, "hw": H, "cin": cin, "path": f"vgg_{dp}"}
        if dp == "fp":
            # B5 over the fp path's inputs; the tiles for its library
            # yardstick, one einsum, are cut out beforehand
            tx = kernels.sfc_transform(x, bt, M)
            tiles, _ = kernels.extract_tiles(x, algo)
            cout = prep.tw.shape[-1]
            row["cout"] = cout
            time_kernels(row, {"sfc_transform": (
                lambda: kernels.sfc_transform(x, bt, M),
                lambda: ref.sfc_transform_nhwc_ref(x, bt, M),
                lambda: torch.einsum("ti,nijc,uj->ntuc", bt, tiles, bt))},
                {"sfc_transform": (4 * x.numel() + 4 * tx.numel(), 0,
                                   transform_ops(algo, T, cin, bt, False))})
            # glue, not a kernel: the P-batched f32 product between B5 and B3
            row["fp_contraction_ms"] = timed(
                lambda: ops.transform_domain_fp(tx, prep.tw))
            glue["fp_contraction_ms"] += row["fp_contraction_ms"]
            # B3 on the fp request's own transform-domain output
            Y = ops.transform_domain_fp(tx, prep.tw)
            row["fp_sfc_inverse_ms"] = timed(
                lambda: kernels.sfc_inverse_nhwc(Y, at, grid))
            fp_b3["sfc_inverse_ms"] += row["fp_sfc_inverse_ms"]
            layer_times.append(row)
            log("times:", json.dumps(row))
            continue
        cout = prep.wq.shape[2]
        row["cout"] = cout
        row["b4_geometry"] = geometry_of(x, prep, algo)
        sx = prep.act_scale.reshape(P).contiguous()
        sw = prep.w_scale.reshape(P, -1).contiguous()
        X = kernels.sfc_transform_quantize_pt(x, bt, prep.act_scale, M)
        Y = kernels.tdmm_int8(X, prep.wq, sx, sw)
        g2 = sfc_tdmm.tdmm_geometry(P, T, cin, cout)
        row["b2_geometry"] = [g2.bm, g2.bn, g2.bk, g2.stages, g2.tiles,
                              g2.blocks]
        ty = Y.transpose(0, 1).reshape(T, t, t, cout).contiguous()
        Y6 = Y.view(t, t, B, grid.nH, grid.nW, cout)
        args4 = (x, prep.wq, prep.act_scale, prep.w_scale, algo)
        # library yardsticks, timed here and called nowhere in the port: one
        # einsum computes B3's function (NHWC before the crop, a view);
        # cuDNN's fp16 conv of the same shapes stands beside B4
        x16 = x.permute(0, 3, 1, 2).half().contiguous(
            memory_format=torch.channels_last)
        w16 = prep.w.permute(3, 2, 0, 1).half().contiguous(
            memory_format=torch.channels_last)
        # least bytes and operations of each function on these inputs
        f32_b1 = transform_ops(algo, T, cin, bt, True)
        f32_b3 = inverse_ops(algo, T, cout, at)
        f32_dq = T * cout * 2 * t * t
        work = {
            "sfc_transform_quantize": (4 * x.numel() + X.numel(), 0, f32_b1),
            "tdmm_int8": (X.numel() + prep.wq.numel() + 4 * (P + sw.numel())
                          + 4 * Y.numel(), 2 * P * T * cin * cout, 0),
            "sfc_inverse": (4 * Y.numel() + 4 * B * grid.out_h * grid.out_w
                            * cout + 4 * at.numel(), 0, f32_b3),
            "sfc_fused_conv2d": (4 * x.numel() + prep.wq.numel()
                                 + 4 * (P + sw.numel())
                                 + 4 * B * H * W * cout,
                                 2 * P * T * cin * cout,
                                 f32_b1 + f32_dq + f32_b3),
        }
        fns = {
            "sfc_transform_quantize": (
                lambda: kernels.sfc_transform_quantize_pt(
                    x, bt, prep.act_scale, M),
                lambda: ref.sfc_transform_quantize_pt_ref(
                    x, bt, prep.act_scale, M), None),
            "tdmm_int8": (lambda: kernels.tdmm_int8(X, prep.wq, sx, sw),
                          lambda: ref.tdmm_int8_ref(X, prep.wq, sx, sw),
                          None),
            "sfc_inverse": (lambda: kernels.sfc_inverse_nhwc(Y, at, grid),
                            lambda: ref.sfc_inverse_nhwc_ref(Y, at, grid),
                            lambda: torch.einsum("mt,tubhwo,pu->bhmwpo", at,
                                                 Y6, at)),
            "sfc_fused_conv2d": (
                lambda: kernels.sfc_fused_conv2d(*args4),
                lambda: ref.sfc_fused_conv2d_ref(*args4),
                lambda: F.conv2d(x16, w16, padding=1)),
        }
        time_kernels(row, fns, work)
        row["sfc_inverse_tile_ms"] = timed(
            lambda: kernels.sfc_inverse(ty, at))
        geom = (B, grid.out_h, grid.out_w, grid.nH, grid.nW)
        yt = kernels.sfc_inverse(ty, at)
        row["b3_glue_ms"] = timed(lambda: (
            Y.transpose(0, 1).reshape(T, t, t, cout).contiguous(),
            ops.untile(yt, algo, geom)))
        b3_tile["tile_ms"] += row["sfc_inverse_tile_ms"]
        b3_tile["tile_bound_ms"] += max(
            (4 * ty.numel() + 4 * T * M * M * cout + 4 * at.numel())
            / HBM_BYTES_PER_S * 1e3, f32_b3 / F32_OPS_PER_S * 1e3)
        b3_tile["glue_ms"] += row["b3_glue_ms"]
        layer_times.append(row)
        log("times:", json.dumps(row))

    # B6 and B7 over the depthwise layers of the batch-1 requests, and B1,
    # B5 and B3 on the same inputs as the staged and fp depthwise paths run
    # them
    for lname, p, prep, x in dw_states[(1, "fused")]:
        algo = p.algorithm
        t, M, P = algo.t, algo.M, algo.t ** 2
        B, H, W, c = x.shape
        bt, _, at = c2d.transform_matrices(algo, torch.float32, dev)
        grid = c2d.tile_grid(H, W, M, algo.R, "SAME")
        T = B * grid.nH * grid.nW
        sx = prep.act_scale.reshape(P).contiguous()
        wq2 = prep.wq.reshape(P, c)
        sw = prep.w_scale.reshape(P, c).contiguous()
        X = kernels.sfc_transform_quantize_pt(x, bt, prep.act_scale, M)
        args7 = (x, prep.wq, prep.act_scale, prep.w_scale, algo)
        # cuDNN's fp16 depthwise conv of the same shape, a yardstick only
        x16 = x.permute(0, 3, 1, 2).half().contiguous(
            memory_format=torch.channels_last)
        w16 = prep.w.permute(3, 2, 0, 1).half().contiguous(
            memory_format=torch.channels_last)
        scales = 4 * (P + sw.numel())
        Y = kernels.tdmm_int8_depthwise(X, wq2, sx, sw)
        Y6 = Y.view(t, t, B, grid.nH, grid.nW, c)
        work = {
            "tdmm_int8_depthwise": (X.numel() + wq2.numel() + scales
                                    + 4 * X.numel(), 0, 2 * X.numel()),
            "sfc_fused_conv2d_depthwise": (
                4 * x.numel() + wq2.numel() + scales + 4 * x.numel(), 0,
                transform_ops(algo, T, c, bt, True) + 2 * T * c * P
                + inverse_ops(algo, T, c, at)),
        }
        fns = {
            "tdmm_int8_depthwise": (
                lambda: kernels.tdmm_int8_depthwise(X, wq2, sx, sw),
                lambda: ref.tdmm_int8_depthwise_ref(X, wq2, sx, sw), None),
            "sfc_fused_conv2d_depthwise": (
                lambda: kernels.sfc_fused_conv2d(*args7, depthwise=True),
                lambda: ref.sfc_fused_conv2d_ref(*args7, depthwise=True),
                lambda: F.conv2d(x16, w16, padding=1, groups=c)),
        }
        g6 = sfc_tdmm.dw_product_geometry(P, T, c)
        row = {"layer": lname, "hw": H, "c": c, "path": "dw_fused",
               "b6_geometry": [g6.groups, g6.lanes, g6.run, g6.blocks]}
        time_kernels(row, fns, work)
        tiles, _ = kernels.extract_tiles(x, algo)
        time_kernels(row, {
            "sfc_transform_quantize": (
                lambda: kernels.sfc_transform_quantize_pt(
                    x, bt, prep.act_scale, M),
                lambda: ref.sfc_transform_quantize_pt_ref(
                    x, bt, prep.act_scale, M), None),
            "sfc_transform": (
                lambda: kernels.sfc_transform(x, bt, M),
                lambda: ref.sfc_transform_nhwc_ref(x, bt, M),
                lambda: torch.einsum("ti,nijc,uj->ntuc", bt, tiles, bt)),
            "sfc_inverse": (
                lambda: kernels.sfc_inverse_nhwc(Y, at, grid),
                lambda: ref.sfc_inverse_nhwc_ref(Y, at, grid),
                lambda: torch.einsum("mt,tubhwo,pu->bhmwpo", at, Y6, at))}, {
            "sfc_transform_quantize": (4 * x.numel() + X.numel(), 0,
                                       transform_ops(algo, T, c, bt, True)),
            "sfc_transform": (4 * x.numel() + 4 * X.numel(), 0,
                              transform_ops(algo, T, c, bt, False)),
            "sfc_inverse": (4 * Y.numel() + 4 * x.numel() + 4 * at.numel(),
                            0, inverse_ops(algo, T, c, at))}, sums=dw_totals)
        layer_times.append(row)
        log("times:", json.dumps(row))

    # one batch-1 forward of the fp and the staged VGG-16 path under
    # torch.profiler: the card's kernels by name (whether anything runs
    # between the port's kernels and the product, a copy of an operand
    # say) and the card's busy share of the forward
    profiles = {}
    for dp in ("fp", "staged"):
        images, state = served[(0, dp)]
        profiles[dp] = profile_forward(lambda: forward(images, state))
        pf = profiles[dp]
        if "not_measured" in pf:
            log(f"profile: batch-1 {dp} VGG-16 forward not measured: "
                f"{pf['not_measured']}")
            continue
        log(f"profile: batch-1 {dp} VGG-16 forward: card busy "
            f"{pf['busy_us']:.1f} us of a {pf['device_span_us']:.1f} us "
            f"device span ({pf['busy_share_of_span']:.3f}) and "
            f"{pf['wall_us']:.1f} us wall ({pf['busy_share_of_wall']:.3f}), "
            f"the profiler's own cost included; kernels "
            + json.dumps({k[:60]: v["count"] for k, v in
                          pf["kernels"].items()}))

    # device memory of serving the batch-4 int8 request: the peak above
    # what was allocated before it (weights, inputs, everything resident)
    memory = {}
    for dp in datapaths:
        images, state = served[(len(requests) - 1, dp)]
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        forward(images, state)
        torch.cuda.synchronize()
        memory[dp] = {
            "peak_above_resident_bytes":
                torch.cuda.max_memory_allocated() - resident,
            "int8_weights_bytes": sum(
                pr.wq.numel() + 4 * (pr.w_scale.numel()
                                     + pr.act_scale.numel())
                for _, pr, _ in state),
            "f32_transformed_weights_bytes": sum(4 * pr.tw.numel()
                                                 for _, pr, _ in state)}
        log(f"memory: batch {images.shape[0]} {dp}: peak "
            f"{memory[dp]['peak_above_resident_bytes'] / 2**20:.1f} MiB "
            f"above resident; int8 weights and scales "
            f"{memory[dp]['int8_weights_bytes'] / 2**20:.1f} MiB; the f32 "
            f"transformed weights PreparedWeights also keeps "
            f"{memory[dp]['f32_transformed_weights_bytes'] / 2**20:.1f} MiB")
    report["phases"]["vgg_paths"] = {"per_layer": per_layer,
                                     "stacks": stacks, "memory": memory,
                                     "chain_cost": chain_cost,
                                     "fused_equals_staged_layers":
                                         len(vgg_equal)}
    report["phases"]["fp_with_caller_tf32"] = {"setting": tf32_name,
                                               "per_layer": tf32_rows}
    report["phases"]["depthwise_path"] = {"per_layer": dw_rows,
                                          "stacks": dw_stacks}
    report["phases"]["launches"] = {"total": launches,
                                    "per_path": path_launches,
                                    "forwards": n_forwards}
    report["phases"]["kernel_times"] = {
        "per_layer": layer_times, "totals": totals, "glue": glue,
        "fp_request": fp_b3, "depthwise_staged": dw_totals,
        "b3_tile": b3_tile, "launch_floor_ms": launch_floor_ms,
        "profiles": profiles}
    # ---- 7. the serving path: VGG-16's conv3 layer behind the engine ------
    from repro_torch import faults
    from repro_torch.serve import (BATCH, INTERACTIVE, BucketTable, Engine,
                                   SchedulerPolicy, ShapeMix,
                                   fold_rows_per_step, results, synthesize)
    # phases 3-6 ran with the chain off; from here it is on, and every
    # event it records must be one this phase armed
    if resilience.stats():
        raise AssertionError(f"resilience events in phases 3-6: "
                             f"{resilience.stats()}")
    resilience.configure(chain_policy)
    serve_w = he_normal(np.random.RandomState(1700), SERVE_C, SERVE_C)
    table = BucketTable.for_workload(SERVE_BUCKETS, kernel_size=3,
                                     in_channels=SERVE_C,
                                     out_channels=SERVE_C, quant=INT8_FREQ)
    b28, b42, b56 = table.buckets
    srng = np.random.RandomState(0)
    mix = ShapeMix(shapes=SERVE_MIX)
    serve_shapes = [mix.sample(srng) for _ in range(SERVE_REQUESTS)]
    serve_slos = [INTERACTIVE if srng.rand() < 0.5 else BATCH
                  for _ in range(SERVE_REQUESTS)]
    irng = np.random.RandomState(1701)
    serve_x = [irng.randn(h, w_, SERVE_C).astype(np.float32)
               for h, w_ in serve_shapes]
    serve_launches = {k: 0 for k in REPLACES}
    serve_report = {"buckets": [b.name for b in table.buckets],
                    "shapes": serve_shapes,
                    "slos": [s.name for s in serve_slos]}

    def make_engine(warm_compile=False):
        return Engine(serve_w, table, backend="cuda", algo=ALGO, device=dev,
                      max_batch=SERVE_MAX_BATCH, round_batches=True,
                      scheduler=SchedulerPolicy(kind="edf",
                                                max_hold_ms=SERVE_HOLD_MS),
                      retry_backoff_s=0.0, warm_compile=warm_compile)

    def state_of(eng, bucket):
        """The (plan, prepared weights) the engine serves ``bucket`` with."""
        return eng.cache.get(bucket.spec, eng.w, backend="cuda", algo=ALGO,
                             act_scale=eng._act_scales[bucket.name],
                             key=("serve", bucket.name, eng.device))

    def dispatch_launches(eng, bucket, n):
        """What one dispatch of ``n`` requests on ``bucket`` launches: B4
        once for the whole (rounded) batch, or B1, B2 and B3 once each
        where the bucket's config is staged."""
        p, _ = state_of(eng, bucket)
        if (p.config or tuning.DEFAULT_FUSED).datapath == "staged":
            return only(sfc_transform_quantize=1, tdmm_int8=1, sfc_inverse=1)
        if fold_rows_per_step(p, eng._round_batch(n)) is None:
            raise AssertionError(f"serve: a batch of {n} on {bucket.name} "
                                 f"does not fold into one B4 launch")
        return only(sfc_fused_conv2d=1)

    def add_serve(got):
        for k in serve_launches:
            serve_launches[k] += got[k]

    def drain_counted(eng, futs, what):
        """Step until every future resolved, the launch counts set to 0
        just before each dispatch and checked just after it."""
        rows, pending = [], set(range(len(futs)))
        while pending:
            kernels.reset_launch_counts()
            n = eng.step(timeout=1.0)
            got = kernels.launch_counts()
            done = sorted(i for i in pending if futs[i].done())
            if n != len(done):
                raise AssertionError(f"serve {what}: a step took {n} "
                                     f"requests and resolved {len(done)}")
            if not n:
                continue
            pending -= set(done)
            bucket = table.by_name(futs[done[0]].result().bucket_name)
            want = dispatch_launches(eng, bucket, n)
            if got != want:
                raise AssertionError(f"serve {what}: a dispatch of {n} on "
                                     f"{bucket.name} launched {got}, not "
                                     f"{want}")
            add_serve(got)
            rows.append({"bucket": bucket.name, "requests": n,
                         "launches": {k: v for k, v in got.items() if v}})
        return rows

    def same_outputs(rs, what):
        for r, want in zip(rs, res1):
            if not torch.equal(r.y, want.y):
                raise AssertionError(f"serve {what}: request "
                                     f"{r.request_id} differs from the "
                                     f"deterministic pass")

    # provenance, part 1: the 28x28 bucket tuned into the run's cache
    t_serve = time.perf_counter()
    tune28 = tuning.autotune(b28.spec, "cuda", device=dev, algos=[ALGO])
    eng = make_engine()
    sources1 = dict(eng.warm_sources)
    if sources1[b28.name] != "measured" or sources1[b42.name] != "default":
        raise AssertionError(f"serve: warm sources before the fit "
                             f"{sources1}")
    configs = {b.name: (state_of(eng, b)[0].config or tuning.DEFAULT_FUSED
                        ).to_json() for b in table.buckets}
    log(f"serve: buckets {serve_report['buckets']}, warm sources "
        f"{json.dumps(sources1)}, configs {json.dumps(configs)} (28x28 "
        f"tuned: {json.dumps(tune28.get(ALGO))})")

    # pass 1, deterministic: every request bit for bit its own plan.apply
    # on its bucket, and within the int8 bounds of the reference backend
    futs1 = [eng.submit(x, slo) for x, slo in zip(serve_x, serve_slos)]
    disp1 = drain_counted(eng, futs1, "pass 1")
    res1 = results(futs1)
    serve_rows = []
    for x, r in zip(serve_x, res1):
        b = table.by_name(r.bucket_name)
        h, w_ = x.shape[:2]
        if tuple(r.y.shape) != (h, w_, SERVE_C):
            raise AssertionError(f"serve: request {r.request_id} output "
                                 f"{tuple(r.y.shape)}")
        p, prep = state_of(eng, b)
        xb = BucketTable.pad_to(torch.from_numpy(x).to(dev), b)[None]
        own = BucketTable.crop_output(p.apply(xb, prep)[0], h, w_, b)
        if not torch.equal(own, r.y):
            raise AssertionError(f"serve: request {r.request_id} batched "
                                 f"({r.batch_size}) differs from its own "
                                 f"plan.apply")
        y_ref = BucketTable.crop_output(plan(b.spec, backend="reference",
                                             algo=ALGO).apply(xb, prep)[0],
                                        h, w_, b)
        rel_l2, scaled = held(f"serve request {r.request_id}", r.y, y_ref,
                              "int8")
        serve_rows.append({"shape": [h, w_], "bucket": b.name,
                           "batch": r.batch_size, "rel_l2": rel_l2,
                           "scaled_max": scaled})
    torch.cuda.synchronize()
    log(f"serve: pass 1: {SERVE_REQUESTS} requests in {len(disp1)} "
        f"dispatches " + json.dumps([[d["bucket"], d["requests"],
                                      d["launches"]] for d in disp1])
        + f"; batched = per-request bit for bit; worst rel L2 vs reference "
        f"{max(r['rel_l2'] for r in serve_rows):.3e}, max |diff| / max "
        f"|ref| {max(r['scaled_max'] for r in serve_rows):.3e}")

    @contextlib.contextmanager
    def gc_watch():
        """The interpreter's collections inside the block, as (generation,
        s into the block, ms): they place a tail's stalls."""
        events, start, t_in = [], [], time.perf_counter()

        def probe(phase, info):
            now = time.perf_counter()
            if phase == "start":
                start[:] = [now]
            elif start:
                events.append((info["generation"], start[0] - t_in,
                               (now - start[0]) * 1e3))

        gc.callbacks.append(probe)
        try:
            yield events
        finally:
            gc.callbacks.remove(probe)

    # pass 2, threaded: start / submit (a burst) / drain / stop. A check of
    # the threaded engine; its times are a smoke reading (32 requests)
    teng = make_engine()
    kernels.reset_launch_counts()
    teng.start()
    with gc_watch() as gc2:
        t0 = time.perf_counter()
        futs2 = [teng.submit(x, slo) for x, slo in zip(serve_x, serve_slos)]
        if not teng.drain(timeout=120):
            raise AssertionError("serve: the threaded pass did not drain")
        wall_s = time.perf_counter() - t0
    teng.stop(raise_on_error=True)
    got = kernels.launch_counts()
    res2 = results(futs2)
    same_outputs(res2, "pass 2")
    if any(got[k] for k in ("sfc_transform", "tdmm_int8_depthwise",
                            "sfc_fused_conv2d_depthwise")) \
            or not got["sfc_fused_conv2d"] + got["tdmm_int8"]:
        raise AssertionError(f"serve: the threaded pass launched {got}")
    add_serve(got)
    snap2 = teng.snapshot()
    threaded = {
        "wall_s": wall_s, "requests_per_s": SERVE_REQUESTS / wall_s,
        "e2e_ms": snap2["e2e_ms"], "service_ms": snap2["service_ms"],
        "queue_wait_ms": snap2["queue_wait_ms"],
        "occupancy": snap2["batch_occupancy"],
        "slo": snap2["slo"], "launches": {k: v for k, v in got.items() if v},
        "gc": gc2,
        "launches_per_dispatch": sum(got.values())
        / snap2["batch_occupancy"]["dispatches"]}
    log(f"serve: pass 2 (threaded, {SERVE_REQUESTS} requests at once): "
        f"{threaded['requests_per_s']:.1f} requests/s, e2e p50 "
        f"{snap2['e2e_ms']['p50_ms']:.3f} ms p99 "
        f"{snap2['e2e_ms']['p99_ms']:.3f} ms, service "
        f"{snap2['service_ms']['mean_ms']:.3f} ms a dispatch (p50 "
        f"{snap2['service_ms']['p50_ms']:.3f}), "
        f"{snap2['batch_occupancy']['dispatches']} dispatches, occupancy "
        f"{snap2['batch_occupancy']['mean']:.2f} (max "
        f"{snap2['batch_occupancy']['max']}), launches "
        f"{json.dumps(threaded['launches'])}, gc collections (generation, "
        f"s in, ms) {json.dumps([[g, round(a, 3), round(m, 1)] for g, a, m in gc2])}"
        f", on {smi}")
    # pass 2b, the measured windows: open-loop Poisson arrivals of
    # SERVE_WINDOW_REQUESTS requests at each offered rate, the same shape
    # and SLO mix, submitted from this thread while the engine's thread
    # dispatches; each engine warmed every (bucket, batch shape) first
    # (warm_compile). The images come from a seeded pool already on the
    # card, so a submit costs the client no host-to-card copy and the
    # figures are the engine's. requests/s and the e2e percentiles are
    # read here; the 32-request burst above is a check
    pool_rng = np.random.RandomState(1702)
    pool = {sh: [torch.from_numpy(pool_rng.randn(sh[0], sh[1], SERVE_C)
                                  .astype(np.float32)).to(dev)
                 for _ in range(SERVE_POOL)] for sh in SERVE_MIX}
    windows, weng_all = [], []
    for rate in SERVE_WINDOW_RATES:
        events = synthesize(SERVE_WINDOW_REQUESTS, process="poisson",
                            rate_hz=rate, mix=mix, seed=int(rate))
        weng = make_engine(warm_compile=True)
        weng_all.append(weng)
        kernels.reset_launch_counts()
        weng.start()
        late_ms, rows, rejects, kept = [], [], [], {}

        def on_done(f, j, sh, i, slo, at):
            """One row a request, written when its future resolves; the
            first SERVE_WINDOW_CHECKED answers are kept for the check,
            the rest dropped once their shape is read, as a server that
            has sent them would."""
            if f.exception() is not None:
                rejects.append(j)
                return
            r = f.result()
            rows.append((r.e2e_ms, r.queue_wait_ms, slo, at,
                         tuple(r.y.shape) == (sh[0], sh[1], SERVE_C)))
            if j < SERVE_WINDOW_CHECKED:
                kept[j] = (r, sh, i)

        # the interpreter's collections and the caching allocator's
        # segments during the window, to place the tail's stalls
        mem0 = torch.cuda.memory_stats(dev)
        with gc_watch() as gc_events:
            t0 = time.perf_counter()
            for j, ev in enumerate(events):
                wait = t0 + ev.t - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                at = time.perf_counter() - t0
                late_ms.append((at - ev.t) * 1e3)
                i = j % SERVE_POOL
                weng.submit(pool[ev.shape][i], ev.slo).add_done_callback(
                    functools.partial(on_done, j=j, sh=ev.shape, i=i,
                                      slo=ev.slo, at=at))
            if not weng.drain(timeout=300):
                raise AssertionError(f"serve: the {rate:g}/s window did "
                                     f"not drain")
            span_s = time.perf_counter() - t0
        mem1 = torch.cuda.memory_stats(dev)
        weng.stop(raise_on_error=True)
        got = kernels.launch_counts()
        snap = weng.snapshot()
        n_disp = snap["batch_occupancy"]["dispatches"]
        if got["sfc_fused_conv2d"] + got["tdmm_int8"] != n_disp \
                or not got["sfc_transform_quantize"] == got["tdmm_int8"] \
                == got["sfc_inverse"] \
                or any(got[k] for k in ("sfc_transform",
                                        "tdmm_int8_depthwise",
                                        "sfc_fused_conv2d_depthwise")):
            raise AssertionError(f"serve: the {rate:g}/s window launched "
                                 f"{got} over {n_disp} dispatches")
        add_serve(got)
        if len(rows) + len(rejects) != len(events) \
                or not all(row[4] for row in rows):
            raise AssertionError(f"serve: the {rate:g}/s window resolved "
                                 f"{len(rows)} + {len(rejects)} of "
                                 f"{len(events)}, or a shape was wrong")
        for j, (r, sh, i) in sorted(kept.items()):
            b = table.by_name(r.bucket_name)
            p, prep = state_of(weng, b)
            xb = BucketTable.pad_to(pool[sh][i], b)[None]
            own = BucketTable.crop_output(p.apply(xb, prep)[0], sh[0],
                                          sh[1], b)
            if not torch.equal(own, r.y) or not torch.isfinite(r.y).all():
                raise AssertionError(f"serve: window request {r.request_id} "
                                     f"differs from its own plan.apply")
        kept.clear()
        e2e = np.array([row[0] for row in rows])
        qw = np.array([row[1] for row in rows])
        by_class = {}
        for cls in (INTERACTIVE, BATCH):
            ce = np.array([row[0] for row in rows if row[2] is cls])
            if len(ce):
                by_class[cls.name] = {
                    "n": int(len(ce)),
                    "p50_ms": float(np.percentile(ce, 50)),
                    "p99_ms": float(np.percentile(ce, 99))}
        w = {"offered_per_s": rate, "requests": len(events),
             "served": len(rows), "rejected": len(rejects),
             "span_s": span_s, "served_per_s": len(rows) / span_s,
             "e2e_ms": {q: float(np.percentile(e2e, v)) for q, v in
                        (("p50", 50), ("p90", 90), ("p99", 99),
                         ("p99.9", 99.9), ("max", 100))},
             "queue_wait_ms": {"p50": float(np.percentile(qw, 50)),
                               "p99": float(np.percentile(qw, 99))},
             "e2e_by_class": by_class,
             "service_ms": snap["service_ms"], "dispatches": n_disp,
             "occupancy": snap["batch_occupancy"],
             "launches": {k: v for k, v in got.items() if v},
             "launches_per_dispatch": sum(got.values()) / n_disp,
             "submit_late_ms": {"p50": float(np.percentile(late_ms, 50)),
                                "p99": float(np.percentile(late_ms, 99))},
             "gc": {"collections": [sum(1 for g in gc_events if g[0] == k)
                                    for k in range(3)],
                    "ms": sum(g[2] for g in gc_events),
                    "longest": sorted(gc_events, key=lambda g: -g[2])[:3]},
             "allocator": {k: mem1.get(k, 0) - mem0.get(k, 0) for k in
                           ("segment.all.allocated", "num_alloc_retries",
                            "num_device_alloc", "num_device_free")},
             "worst_e2e": sorted(((row[0], row[3]) for row in rows),
                                 reverse=True)[:3]}
        windows.append(w)
        log(f"serve: window {rate:g}/s offered, {len(events)} Poisson "
            f"requests in {span_s:.3f} s: {w['served_per_s']:.1f} served/s, "
            f"{w['rejected']} rejected; e2e p50 {w['e2e_ms']['p50']:.3f} p90 "
            f"{w['e2e_ms']['p90']:.3f} p99 {w['e2e_ms']['p99']:.3f} p99.9 "
            f"{w['e2e_ms']['p99.9']:.3f} max {w['e2e_ms']['max']:.3f} ms; "
            f"queue wait p50 {w['queue_wait_ms']['p50']:.3f} p99 "
            f"{w['queue_wait_ms']['p99']:.3f} ms; service "
            f"{snap['service_ms']['mean_ms']:.3f} ms a dispatch (p50 "
            f"{snap['service_ms']['p50_ms']:.3f}, p99 "
            f"{snap['service_ms']['p99_ms']:.3f}); {n_disp} dispatches, "
            f"occupancy {snap['batch_occupancy']['mean']:.2f}; launches "
            f"{json.dumps(w['launches'])}; submits late p50 "
            f"{w['submit_late_ms']['p50']:.3f} p99 "
            f"{w['submit_late_ms']['p99']:.3f} ms; gc collections "
            f"{w['gc']['collections']} taking {w['gc']['ms']:.1f} ms, longest "
            + json.dumps([[g, round(at, 3), round(ms, 1)]
                          for g, at, ms in w['gc']['longest']])
            + " (generation, s into the window, ms); allocator "
            + json.dumps(w["allocator"]) + "; worst e2e "
            + json.dumps([[round(e, 1), round(at, 3)]
                          for e, at in w['worst_e2e']])
            + f" (ms, arrival s into the window); on {smi}")
    for e in [eng, teng] + weng_all:
        hid = {k: v for k, v in e.snapshot()["counters"].items()
               if k.startswith("resilience_")}
        if hid or resilience.stats():
            raise AssertionError(f"serve: unarmed resilience events "
                                 f"{hid} {resilience.stats()}")

    # pass 4, faults (before the fit, while the 42x42 bucket runs B4): an
    # armed fused failure is served by staged bit for bit and counted in
    # the engine's registry; repeated ones open the breaker; with the
    # chain off the same fault raises
    idx42 = [i for i, r in enumerate(res1) if r.bucket_name == b42.name]
    feng = make_engine()
    p42, prep42 = state_of(feng, b42)
    if (p42.config or tuning.DEFAULT_FUSED).datapath != "fused":
        raise AssertionError("serve: the 42x42 bucket is not fused")
    staged_once = only(sfc_transform_quantize=1, tdmm_int8=1, sfc_inverse=1)
    with faults.inject({faults.APPLY_FUSED: faults.FaultSpec(times=1)}) \
            as fp:
        futs4 = [feng.submit(serve_x[i]) for i in idx42[:4]]
        kernels.reset_launch_counts()
        while not all(f.done() for f in futs4):
            feng.step(timeout=1.0)
        got = kernels.launch_counts()
    c = feng.snapshot()["counters"]
    if fp.injected(faults.APPLY_FUSED) != 1 or got != staged_once \
            or c.get("resilience_fallback_staged") != 1:
        raise AssertionError(f"serve: the armed fused fault: injected "
                             f"{fp.injected()}, launches {got}, counters "
                             f"{c}")
    add_serve(got)
    for f, i in zip(futs4, idx42):
        if not torch.equal(f.result().y, res1[i].y):
            raise AssertionError("serve: the staged fallback differs from "
                                 "the fused answer")
    thr = resilience.policy().failure_threshold
    resilience.reset()        # the fused breaker counts from zero again
    disp4 = []
    with faults.inject({faults.APPLY_FUSED: faults.FaultSpec()}) as fp:
        kernels.reset_launch_counts()
        for i in idx42[:1] * (thr + 2):
            f = feng.submit(serve_x[i])
            while not f.done():
                feng.step(timeout=1.0)
            disp4.append(torch.equal(f.result().y, res1[i].y))
        got = kernels.launch_counts()
    board = {k.rsplit("|", 1)[1]: v for k, v in
             resilience.board_snapshot().items()
             if k.startswith(str(b42.spec))}
    c = feng.snapshot()["counters"]
    if not all(disp4) or fp.hits(faults.APPLY_FUSED) != thr \
            or board.get("fused", {}).get("state") != resilience.OPEN \
            or c.get("resilience_breaker_trip") != 1 \
            or c.get("resilience_breaker_skip") != 2 \
            or got != only(thr + 2, sfc_transform_quantize=1, tdmm_int8=1,
                           sfc_inverse=1):
        raise AssertionError(f"serve: repeated fused faults: hits "
                             f"{fp.hits(faults.APPLY_FUSED)}, board "
                             f"{board}, counters {c}, launches {got}")
    add_serve(got)
    xb42 = BucketTable.pad_to(torch.from_numpy(serve_x[idx42[0]]).to(dev),
                              b42)[None]
    with resilience.configured(enabled=False):
        with faults.inject({faults.APPLY_FUSED: faults.FaultSpec()}):
            try:
                p42.apply(xb42, prep42)
                raise AssertionError("serve: with the chain off the fused "
                                     "fault did not raise")
            except faults.InjectedFault:
                pass
    fault_counters = {k: v for k, v in c.items()
                      if k.startswith("resilience_")}
    log(f"serve: pass 4 (faults): one armed fused failure served by staged "
        f"bit for bit (B1, B2, B3 once, B4 none), {thr} repeated ones "
        f"opened the breaker ({thr + 2} requests served, bit for bit), "
        f"with the chain off the fault raised; the engine's counters "
        f"{json.dumps(fault_counters)}")
    resilience.reset()

    # pass 3, provenance: the cost model fitted on the card with VGG-16's
    # and ResNet-18's distinct specs as probes; a new engine warms the
    # 42x42 bucket, which has no timing entry, from the model
    fit_lines = []
    t0 = time.perf_counter()
    probes = list(vgg_specs.values()) + list(resnet_specs.values())
    fit = costmodel.fit_coefficients(probes, "cuda", device=dev,
                                     log=fit_lines.append)
    fit_s = time.perf_counter() - t0
    tuned = {r["spec"]: r for r in tune_rows}
    ranking = []
    for label, spec in [(f"vgg {k}", v) for k, v in vgg_specs.items()] \
            + [(f"resnet {k}", v) for k, v in resnet_specs.items()]:
        row = tuned[label]
        if "card_ms" not in row:
            continue
        model_cfg = costmodel.best_config(spec, "cuda", ALGO)
        if model_cfg is None:         # lowered: priced per sub-spec only
            continue
        card_best = min(row["card_ms"], key=row["card_ms"].get)
        ranking.append({
            "spec": label, "model": model_cfg.to_json(),
            "measured": row["winner"], "card_fastest": card_best,
            "card_ms": row["card_ms"],
            "model_datapath_is_measured": model_cfg.datapath
            == row["winner"]["datapath"],
            "model_datapath_is_card_fastest": model_cfg.datapath
            == card_best})
    eng2 = make_engine()
    sources2 = dict(eng2.warm_sources)
    if sources2[b28.name] != "measured" or sources2[b42.name] != "model":
        raise AssertionError(f"serve: warm sources after the fit "
                             f"{sources2}")
    futs3 = [eng2.submit(x, slo) for x, slo in zip(serve_x, serve_slos)]
    disp3 = drain_counted(eng2, futs3, "pass 3")
    same_outputs(results(futs3), "pass 3")
    seen = set(sources1.values()) | set(sources2.values())
    if not {"measured", "model", "default"} <= seen:
        raise AssertionError(f"serve: warm sources seen {seen}")
    hid = {k: v for k, v in eng2.snapshot()["counters"].items()
           if k.startswith("resilience_")}
    if hid or resilience.stats():
        raise AssertionError(f"serve: unarmed resilience events {hid} "
                             f"{resilience.stats()}")
    log(f"serve: cost model fitted on {len(probes)} probe specs in "
        f"{fit_s:.1f} s, samples {json.dumps(fit['samples'])}, fit error "
        + json.dumps({dp: {k: round(v, 4) for k, v in e.items()}
                      for dp, e in fit["fit_error"].items()})
        + f", coefficients {json.dumps(fit['coefficients'])}")
    for r in ranking:
        log(f"serve: model top-1 {r['spec']}: {r['model']['datapath']}"
            f"(k={r['model']['k_block']},co={r['model']['cout_block']}); "
            f"measured winner {r['measured']['datapath']}; card fastest "
            f"{r['card_fastest']} {json.dumps(r['card_ms'])}")
    log(f"serve: the model's datapath is the measured winner's at "
        f"{sum(r['model_datapath_is_measured'] for r in ranking)} of "
        f"{len(ranking)} specs and the card's fastest at "
        f"{sum(r['model_datapath_is_card_fastest'] for r in ranking)}; warm "
        f"sources after the fit {json.dumps(sources2)}; pass 3 "
        f"{len(disp3)} dispatches bit for bit pass 1; no unarmed resilience "
        f"event in phases 3-7")
    serve_seconds = time.perf_counter() - t_serve
    on_path = ("sfc_transform_quantize", "tdmm_int8", "sfc_inverse",
               "sfc_fused_conv2d")
    if any(serve_launches[k] <= 0 for k in on_path) \
            or any(v for k, v in serve_launches.items() if k not in on_path):
        raise AssertionError(f"serve: the path's kernels B1-B4, and only "
                             f"they, must launch: {serve_launches}")
    for k in launches:
        launches[k] += serve_launches[k]
    path_launches["serve"] = serve_launches
    log(f"serve: phase 7 launched {json.dumps({k: v for k, v in serve_launches.items() if v})} "
        f"in {serve_seconds:.1f} s")
    serve_report.update({
        "warm_sources": [sources1, sources2], "configs": configs,
        "tune_28x28": tune28, "pass1": {"dispatches": disp1,
                                        "requests": serve_rows},
        "threaded": threaded, "windows": windows, "faults": fault_counters,
        "fit": {k: v for k, v in fit.items()}, "fit_seconds": fit_s,
        "fit_log": fit_lines, "ranking": ranking,
        "pass3_dispatches": disp3, "launches": serve_launches,
        "seconds": serve_seconds})
    report["phases"]["serving"] = serve_report

    # ---- 8. the paper's CNNs ----------------------------------------------
    # with the chain off, as in phases 3-6: a kernel that fails raises
    resilience.configure(dataclasses.replace(chain_policy, enabled=False))
    t_cnn = time.perf_counter()
    cnn_report = paper_cnns(dev, counted, held)
    if resilience.stats():
        raise AssertionError(f"resilience events in phase 8: "
                             f"{resilience.stats()}")
    resilience.configure(chain_policy)
    for path in ("ptq_fused", "ptq_staged"):
        if any(path_launches[path][k] <= 0 for k in path_kernels[path]):
            raise AssertionError(f"a kernel of {path} never launched: "
                                 f"{path_launches[path]}")
    cnn_report["launches"] = {path: {k: v for k, v in
                                     path_launches[path].items() if v}
                              for path in ("ptq_fused", "ptq_staged")}
    cnn_report["seconds"] = time.perf_counter() - t_cnn
    log(f"cnn: phase 8 launched {json.dumps(cnn_report['launches'])} in "
        f"{cnn_report['seconds']:.1f} s")
    report["phases"]["paper_cnns"] = cnn_report

    # ---- 9. training on the card ------------------------------------------
    # the chain off again: a kernel of the deployment that fails raises
    resilience.configure(dataclasses.replace(chain_policy, enabled=False))
    # a resumed run replays the first bit for bit only where every kernel
    # is deterministic: cuDNN picks deterministic algorithms in this phase
    t_train = time.perf_counter()
    cudnn_deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        train_report = training(dev, counted)
    finally:
        torch.backends.cudnn.deterministic = cudnn_deterministic
    if resilience.stats():
        raise AssertionError(f"resilience events in phase 9: "
                             f"{resilience.stats()}")
    resilience.configure(chain_policy)
    train_paths = ("train_ptq_fused", "train_ptq_staged")
    for path in train_paths:
        if any(path_launches[path][k] <= 0 for k in path_kernels[path]):
            raise AssertionError(f"a kernel of {path} never launched: "
                                 f"{path_launches[path]}")
    train_report["launches"] = {path: {k: v for k, v in
                                       path_launches[path].items() if v}
                                for path in train_paths + ("training",)}
    train_report["seconds"] = time.perf_counter() - t_train
    log(f"train: phase 9 launched {json.dumps(train_report['launches'])} "
        f"in {train_report['seconds']:.1f} s")
    report["phases"]["training"] = train_report

    # ---- 10. the sharded conv backend ----------------------------------
    # the chain off, as in phases 3-6: cuda_spmd runs the cuda backend's
    # apply per shard, which no chain wraps; a kernel that fails raises
    resilience.configure(dataclasses.replace(chain_policy, enabled=False))
    shard_report = sharded_convs(dev, counted, plan_launches, smi)
    resilience.configure(chain_policy)
    shard_paths = sorted(p for p in path_launches if p.startswith("shard_"))
    for path in shard_paths:
        if any(path_launches[path][k] <= 0 for k in path_kernels[path]):
            raise AssertionError(f"a kernel of {path} never launched: "
                                 f"{path_launches[path]}")
    shard_report["launches"] = {path: {k: v for k, v in
                                       path_launches[path].items() if v}
                                for path in shard_paths}
    report["phases"]["sharded"] = shard_report
    # ---- 10b. the analysis gate and the NCCL all-reduce ------------------
    report["phases"]["gate_and_psum"] = gate_and_psum(dev)
    # ---- 11. the LM serving path ------------------------------------------
    # the chain off, as in phases 3-6: a failure raises
    resilience.configure(dataclasses.replace(chain_policy, enabled=False))
    report["phases"]["lm_serving"] = lm_serving(dev, counted, timed, smi)

    # ---- 12. the moe, vlm and encdec families ----------------------------
    report["phases"]["lm_families"] = lm_families(dev, counted, smi)
    # ---- 13. LM training ----------------------------------------------
    report["phases"]["lm_training"] = lm_training(dev, counted, smi)
    # ---- 14. the sharded LM train step, elastic restore ----------------
    report["phases"]["lm_sharded"] = lm_sharded(dev, counted, smi)
    # ---- 15. sharded LM serving -----------------------------------------
    report["phases"]["lm_serve_sharded"] = lm_serve_sharded(dev, counted,
                                                            smi)
    if resilience.stats():
        raise AssertionError(f"resilience events in phases 11-15: "
                             f"{resilience.stats()}")
    resilience.configure(chain_policy)

    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_report.json").write_text(json.dumps(report, indent=1))

    line = {"kernels": [{
        "name": k, "route": "cuda", "source": src, "replaces": rep,
        "launches": launches[k], "max_abs_err": max_err[k],
        "ms": totals[k]["ms"], "plain_ms": totals[k]["plain_ms"],
        "bound_ms": totals[k]["bound_ms"],
        "bound_by": "bytes" if totals[k]["bytes_ms"] >= totals[k]["ops_ms"]
        else "operations",
        "library_ms": totals[k]["library_ms"]}
        for k, (src, rep) in REPLACES.items()]}
    log(f"glue: the fp path's P-batched f32 product (torch.bmm, not a "
        f"kernel of the port) {glue['fp_contraction_ms']:.4f} ms over the "
        f"13 convs of the batch-1 fp request")
    log(f"fp path: B3 {fp_b3['sfc_inverse_ms']:.4f} ms over the 13 convs "
        f"of the batch-1 fp request")
    log(f"staged path: B3's NHWC entry {totals['sfc_inverse']['ms']:.4f} ms "
        f"(bound {totals['sfc_inverse']['bound_ms']:.4f}) over the 13 convs "
        f"of the batch-1 int8 request, against its tile entry "
        f"{b3_tile['tile_ms']:.4f} ms (bound {b3_tile['tile_bound_ms']:.4f}) "
        f"and the copies around the tile entry {b3_tile['glue_ms']:.4f} ms")
    log("depthwise staged and fp paths: " + "; ".join(
        f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f}, plain "
        f"{v['plain_ms']:.4f})" for k, v in dw_totals.items())
        + f" over the {len(DW_LAYERS)} depthwise convs at batch 1")
    log(f"launch floor: {launch_floor_ms:.4f} ms a timed call (a one-float "
        f"fill)")
    log(f"times above: sums, median of {TIMED_RUNS} runs each, on {smi}: "
        f"B1-B4 over the 13 convs of one batch-1 int8 VGG-16 request (B1 "
        f"its (P, T, C) entry, B3 its NHWC entry), B5 "
        f"over those of the batch-1 fp request, B6 and B7 over the "
        f"{len(DW_LAYERS)} depthwise convs at batch 1")
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))

if __name__ == "__main__":
    main()
