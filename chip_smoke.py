#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. card: the ``nvidia-smi`` name and power limit;
2. build: every CUDA source of the port, one nvcc per source, in parallel;
3. kernels: each of the sixteen kernel entries against its plain PyTorch
   version on the card, at the shapes of its main path and at ragged shapes (for the
   sparse kernels: pad entries, a pad row, an all-pad node, and a touched-
   block map one slot too short; for the serving kernel: tied classes, pad
   rows, k = 0 and a map one slot short), and against itself (two runs, bit
   for bit), with times of the kernel, the plain version and, where one
   exists, the one PyTorch call that computes the same function (timed here
   only; the port never calls it). The sparse kernels' main-path inputs are
   a minibatch of the CCAT partitions of phase 7, generated here, and a
   bucket batch of CCAT test queries with its calibrated map. The
   transformer kernels: ``flash_attention`` at RecurrentGemma-9B's prefill
   shape (2 x 4096 tokens, 16 heads of 256, MQA, causal, window 2048), at
   Llama-3-8B's (2048 tokens, 32 heads of 128, 8 kv heads), at S = 1000, with
   a window wider than S, non-causal, and in bf16 (2e-2, the reference
   test's tolerance, and each element within one bf16 ulp of the plain
   output), at head sizes 80 and 33 in f32 and bf16, at phase 26's
   examples' calls (train_100m's 8 x 256 tokens, 8 heads of 64, 4 kv
   heads, and a replica's half at G = 2; gossip_vs_allreduce's 16 x 64
   tokens, 4 heads of 32, 1 kv head, and a replica's quarter at G = 4,
   all causal, no window), its library call the
   fastest SDPA backend that takes the masked f32 call, its bound at the
   peak of its route (f32 split into three TF32 products: a third of 495
   TFLOP/s), and its bf16 time; ``dense_scores`` also at four classes and
   at serving batches of 8 and 64 rows beside ``torch.mm``, held at
   d = 70,001 with 20 classes (column slabs and class tiles), and with NaN
   rows (labelled ``nan_label(C)``, the reference's rule) at C 3, 4 and
   130, as ``ell_scores_prefetch`` is at C 4; ``margins`` for the fleet
   (10, 1, 8315) beside ``torch.bmm``, for one node (1, 8315) beside
   ``torch.mv``, at 2 x 1100 rows (a block a row) and by blocks a row;
   ``grad_update`` for the fleet (10, 1, 8315) beside ``torch.baddbmm`` and
   its ten one-node launches and stack, bit for bit those launches stacked
   and an X view off the 16-byte grid (also at B = 37 fleets of d 1001 and
   1004), for one node (1, 8315) beside ``torch.addmv``; ``ell_grad_update`` bit for bit its
   plain version at the real CCAT minibatch, at every blk_d and from a W
   off the 16-byte grid;
   ``ell_grad_update_prefetch_fold`` bit for bit the buckets kernel
   followed by ``fold_buckets``; ``ell_grad_update_fused`` bit for bit the
   touched-block map followed by ``ell_margins_prefetch_coeff`` and
   ``ell_grad_update_prefetch_fold`` (main, ragged, undersized), timed beside
   that route (torch.profiler) and at B 1 to 64 beside the route's whole
   call (host and device time of each), and at kdda's width (d =
   20,216,830, a block folding a run of tiles) bit for bit that route,
   within ``KERNEL_RTOL`` the map and the pair's plain versions, and
   timed beside its bound;
   ``ell_margins_prefetch_coeff``'s margins
   bit for bit the margins entry's and its coefficients bit for bit
   ``torch.where(margins < 1, y, 0)`` (main, ragged, undersized), timed
   beside the margins entry followed by that ``where``; the sweep's
   ``ell_margins_coeff`` likewise against ``ell_margins`` (main, ragged,
   k = 600 in waves), its margins also bit for bit the prefetch entry's at
   the sound map, timed beside ``ell_margins`` followed by the ``where``;
   ``ell_scores_prefetch`` also at C 20 (past a class tile) and at k = 600,
   each twice bit for bit; ``fleet_half_step`` at m 1,
   10 and 32, B 1 and 37 (rows masked), d 8315, 1001 and 70,001, and a B
   whose X slice overflows shared memory, with clusters of 8 and 16 timed;
   ``rglru_scan`` bit for bit its plain version at (2, 4096, 4096), at a
   D of 130 (4-byte copies) and 4100, and at S = 1; ``wkv_scan`` at
   RWKV6-3B's (2, 4096, 40, 64), at n 16, 24, 64, 80 and 256 with T 1, 33
   and 4097, and ragged shapes; then gradients through B10-B12: each
   operator's autograd formula (B11's backward the kernel on the
   time-flipped inputs, B10's and B12's the plain version's vector-Jacobian
   product written out; B10 also at the examples' four calls) against
   autograd through the plain version, relative
   1e-5 (B10 in bf16: 2e-2); then ``torch.library.opcheck`` of B10-B12's
   operators and their backward operators on CUDA tensors (the fake
   implementations against the kernels' outputs, the autograd
   registrations);
4. main path: GADGET on the paper's reuters dataset at full size with the
   paper's config (10 nodes, B=1, R=4, random topology, 4000 iterations,
   fused), then the test set scored with ``dense_predict``; held to test
   accuracy >= 0.72 and final objective <= 0.50, and every launch counted;
5. unfused path: the same data with ``fused=False`` for 400 iterations,
   ``margins`` and ``grad_update`` each launched once per iteration;
   device time and kernel launches an iteration from torch.profiler;
6. whole path against the CPU: 200 iterations of the phase 4 config on the
   card and with ``device="cpu"`` (the plain versions) on the same draws
   (the port's draws are the reference's Threefry streams keyed on the
   iteration, the same numbers on both devices), W within 1e-4 and the objective trace within 1e-5 relative;
7. sparse main path: GADGET on CCAT as ELL planes at full width
   (d = 47,236, k = 76; rows cut to scale 0.1) with the paper's CCAT config
   and ``sparse_schedule="auto"``, which must resolve to the prefetch
   schedule at blk_d = 128; ``ell_grad_update_fused`` launched once per
   iteration (no other sparse kernel) and the registry's ``kernel.launches``
   naming it alone, held to the quality limits below; device
   time and kernel launches an iteration from torch.profiler;
8. sweep path: the same data with ``sparse_schedule="sweep"`` for 400
   iterations, ``ell_margins_coeff`` and ``ell_grad_update`` once per
   iteration (the margins-only entry never), profiled as phase 7;
9. sparse parity: 200 iterations of the phase 7 config on the card against
   their CPU replay (W within 1e-4, objective 1e-5 relative), prefetch
   against sweep on the card on the same draws (W bit for bit: the fused
   half-step's margins run the margins kernel's rows and its fold the sweep
   grad's scatter, and the map is sound), and reuters' ELL planes
   against their dense form on the same draws (consensus within 1e-5);
10. serving: the phase 7 model as a ``Snapshot``, exported f32 and int8,
    loaded with ``SvmServer.load``, and all CCAT test queries served twice
    through buckets calibrated on training rows (whole, then the example's
    ragged traffic), ``ell_scores_prefetch`` launched once per batch;
    accuracy equal to phase 7's, scores within 1e-5 of the oracle, int8
    labels agreeing with f32 on >= 90%; a hot swap through ``watch`` /
    ``maybe_reload`` with the served shapes unchanged; and reuters served
    dense with phase 4's weights;
11. prefill, recurrentgemma-9b at full width and depth (38 layers, random
    weights from a seeded generator on the card): ``make_prefill_step`` over
    2 prompts x 4096 tokens, logits finite, ``flash_attention`` launched 12
    times and ``rglru_scan`` 26 times in the forward; tokens/s and the
    device's busy share from torch.profiler;
12. serve, recurrentgemma-9b at full width and depth: 4 requests, 32 prompt
    and 16 generated tokens through ``prefill_into_cache`` and the greedy
    loop of ``launch/serve.py``; tokens in the vocabulary, no kernel
    launched (decode is plain PyTorch); ms per token;
13. decode against prefill, recurrentgemma-9b at full width, one pattern
    cycle (3 layers) over 2176 tokens (past the 2048 window): every
    position's decode logits against the forward's, at the reference test's
    5e-4 abs / 1e-3 rel;
14. a reduced rwkv6 (d_model 96, heads of n = 24, 2 layers) prefilled on
    the card against the same weights on the CPU (1e-4), ``wkv_scan``
    launched once a layer; then rwkv6-3b at full width and depth (32
    layers): prefill over 2 x 4096 tokens (``wkv_scan`` launched 32
    times) and serving 4 requests of
    32 + 16 tokens; decode against prefill, held at full width over one
    cycle (one layer, 256 tokens) and only reported at full depth (64
    tokens), where random weights amplify f32 rounding beyond the tolerance
    (in the reference too: ``tools/decode_drift.py``);
15. the fused step above its minibatch cap: at B = ``hinge_subgrad.MAX_FLEET_B`` + 1
    (10 nodes, d = 64, X 74 MB) ``ops.fleet_half_step`` launches
    ``margins`` and ``grad_update`` once each, held against the plain fleet
    step at 1e-4 relative (one row of the minibatch moves W by about
    1e-3); then 5 fused iterations on that route, two launches an
    iteration, W against the CPU at 1e-4; the route timed beside the fused
    kernel and the plain step at B = 1 … 29,049;
16. faults at reuters' full size with the paper's config: link mode at drop
    probability 0.1 for 4000 iterations (quality limits from the reference
    under the same ``FaultPlan``, every ``mass_trace`` entry within 1e-6 of
    1, ``fleet_half_step`` once an iteration), message mode for 400 (every
    entry below 1), dead node 3 with ``TrainTelemetry(every=100,
    per_node=True)`` (its row bit for bit zero, its drop column 0, node drops
    summing to the ring's drops, the trajectory bit for bit the
    telemetry-off run's), the faulted unfused path (``margins`` and
    ``grad_update`` once an iteration), 200 faulted iterations on the card
    against the CPU (the draws equal, Threefry-2x32's published known
    answers computed on the card, W 1e-4), and device time and kernel
    launches an iteration from torch.profiler with faults and without;
17. the anytime export: a faulted reuters stream (1000 iterations in
    segments of 500) bit for bit ``gadget_train``; the CCAT stream of phase
    7's config in segments of 500 bit for bit ``gadget_train`` with
    ``check_every=500``, ``ell_grad_update_fused`` once an iteration; the
    run killed after
    two segments, its train state written with ``to_checkpoint`` and read
    back with ``train_state_from_checkpoint``, resumed bit for bit the
    uninterrupted run; ``snapshot_every=500, snapshot_slots=4``: the last four
    snapshots, each bit for bit the stream's consensus at its iteration;
18. the live publisher: ``TrainPublisher`` trains the CCAT run in a
    background thread into a temporary root while ``SvmServer.watch``
    serves CCAT's test queries through ``maybe_reload``; versions monotone,
    the last served accuracy the final consensus's, ``ell_scores_prefetch``
    once a batch; the publisher traces its segments, and its registry and
    the server's stream their span records into one JSONL file;
19. the serving control plane, on phase 7's model and phase 10's buckets:
    the CCAT test set written with ``dump_libsvm`` and read back with
    ``load_libsvm_csr`` and ``iter_libsvm_chunks``, bit for bit its planes;
    every test query through ``MicroBatcher.submit_csr`` and drained with
    ``srv.scorer_for()``, whole and ragged (one ``ell_scores_prefetch``
    launch a batch, scores within 1e-5 of the plain gather-dot, accuracy
    phase 7's, the ragged pass in more than one bucket, the counts
    reconciled), and the whole pass again with every request traced; an
    open loop of seeded Poisson arrivals from a submitter thread at twice
    the traced closed loop's capacity (20,000 requests) and then at half
    the rate it served in that burst, behind ``max_pending``,
    ``shed-oldest``, a ``default_timeout``, ``DegradeLadder(max_rung=2)``
    and ``RequestTracer(sample=1.0)`` (every request accounted for, the queue
    within its bound, the ladder down during the burst and back at rung 0
    by the end, no new shape but cap overflows, the traced fates the
    batcher's counts, delivered p99 within the deadline plus
    ``benchmarks/overload_bench.py``'s slack); and the lineage chains of
    phase 18's records, every installed version's complete and monotone,
    with ``format_chain`` of the last and one frame of the top console;
20. the remaining solvers on one card: ``gadget_train_reference`` (the
    host-loop oracle) on reuters at full size for 400 iterations, random
    and exponential topologies, each against ``gadget_train(fused=False)``
    (equal iterations, W and the consensus within 1e-5, the objective trace
    at 1e-5 relative, ``transfer_stats`` 400 uploads for exponential and 0
    for random with 2 syncs an ε-check, one ``margins`` and one
    ``grad_update`` launch an iteration); centralised Pegasos as Table 3
    runs it (reuters, B = 8, 1,200 iterations) against its CPU run (w within
    1e-4) and the reference's accuracy (within 0.005); one-vs-rest GADGET
    at LibSVM mnist's shape (60,000 × 780, C = 10, seeded numpy data) against
    its CPU run (W within 1e-4) and the reference's accuracy, then
    ``predict_multiclass`` through ``dense_scores`` at X (10,000, 780), W
    (10, 780), held to the plain version and timed beside ``torch.mm``;
21. the mesh: four ranks spawned on the one card (gloo, CUDA tensors staged
    through host buffers, ``file://`` rendezvous), each holding a quarter of
    reuters: 200 ``make_gadget_mesh_step`` steps with kernels (``margins``
    and ``grad_update`` a step a rank) against the plain step (W 1e-4); the
    four fault checks (inert plan bit-identical, a dead rank frozen at zero,
    message drops finite and different, an out-of-range id raising); the
    ELL planes through the prefetch schedule against the dense step (1e-5 after
    3 steps, 1e-4 after 200); ``make_mesh_scorer`` over reuters' test set
    (padded to 3,300) through ``dense_scores`` against one-process
    ``dense_predict``; ``gossip_mix`` keeping the mean and a full schedule
    reaching it; then the dense mesh at world = the card count over NCCL (a
    one-node mesh on a one-card machine). A rank's failure fails the run;
22. the MoE, VLM and audio families at full width, each model's bytes
    reckoned before it is drawn (depth cut, never width, if it does not
    fit; the cut printed): qwen2-moe-a2.7b (24 layers, 60 experts top-4,
    shared 5,632; 14.0 B f32 parameters) prefilled over 2 x 4096 tokens
    (``flash_attention`` once a layer), then decode against prefill at one
    layer with a capacity that drops nothing; llava-next-mistral-7b over
    576 patch embeddings and 3,520 text tokens a row; hubert-xlarge's
    encoder over 2 x 4096 frames (48 non-causal launches at head size 80);
23. training: (a) every family at its reduced config, all-reduce and
    gossip (G = 4), on the card against the same state and batches on the
    CPU: the first gradients (each leaf within 5e-5 of its own max), the
    loss of two SGD steps (1e-5 relative) and the parameters after them
    (1e-4 relative); (b) qwen2-moe-a2.7b at full width, 2 layers, AdamW, 4
    steps of 2 x 2048 ``Batcher`` tokens, and one step under remat "full"
    equal bit for bit to the step without it;
    (c) hubert-xlarge at full width and depth, 3 steps of 2 x 1024 masked
    frames; (d) rwkv6-3b at full width, 2 layers, gossip at G = 4, the
    replicas' spread shrinking at every mix (against the same step without
    its mix); (e) recurrentgemma-9b at full width over one cycle, and one
    step under remat "dots" equal bit for bit to the step without it (the
    remat steps' launches count each block's kernels twice). Each run
    checks that every parameter gets a finite gradient, requires finite
    losses and each step's launches and plain backward passes (B10, B12)
    equal to the expected ones, and prints loss, seconds per step and
    ``torch.cuda.max_memory_allocated``;
24. sharded on the card: llama3-8b, qwen2-moe-a2.7b (2 layers each),
    recurrentgemma-9b (one cycle), rwkv6-3b and hubert-xlarge (2 layers) at
    full width, the train state placed by ``param_specs`` (zero1, moments
    fsdp) and ``train_state_specs`` and the batch by ``batch_specs`` as
    DTensors on a (1, 1) ``DeviceMesh`` of one NCCL rank: two SGD steps and
    a prefill against the same on plain tensors on the card (losses,
    parameters and logits within 1e-6 relative, each step's B10-B12
    launches and plain backward passes equal), and the card's peak
    (``max_memory_allocated`` less what is resident beside the state and
    the batch) within 15% (or 256 MiB) of ``launch.dryrun.run_one``'s
    ``per_device_bytes`` at the same config, batch and mesh; then 16 tokens
    of llama3-8b's decode with the weights and the caches
    (``cache_spec_tree``) as DTensors, every step's logits within 1e-6
    relative of the plain decode's (the caches' masked write with real
    values);
25. the production dry-run at full width and depth on fake worlds of 256
    and 512 ranks (fake CUDA tensors), one ``python -m
    repro_torch.launch.dryrun`` process a combo, started with phase 24:
    rwkv6-3b x long_500k, llama3-8b x decode_32k, rwkv6-3b x train_4k on 2
    x 16 x 16 with gossip (collective-permutes on the pod axis required),
    llama3-8b, qwen2-moe-a2.7b and llama3-405b (fsdp) x train_4k, and
    llama3-405b again with ``--seq-shard``; every combo ``ok``, each
    record's per-device GiB, FLOPs, collective bytes and bottleneck printed,
    and llama3-405b's bytes with sequence sharding beside those without and
    whether they fit one card;
26. the five examples (``examples/torch_*.py``) through their own functions,
    the launch counters reset before each and read after it, and each one's
    seconds: quickstart (Pegasos and GADGET within 0.005 of the reference
    example's accuracies, their weights within 1e-4 of the same functions'
    CPU run, one ``fleet_half_step`` launch an iteration, and the script
    once as a process of its own), fault_tolerant_gossip (the
    three networks on CUDA values, each mean alive-node accuracy within
    0.01 of the reference example's, under link drops every round's
    Push-Sum mass within 1e-6 of conserved), serve_batched (the sparse
    pair ``auto`` picks once an iteration, every query delivered, one
    ``ell_scores_prefetch`` launch a batch and one ``dense_scores`` a dense
    call, shapes within the buckets, int8 agreement >= 0.9, the trained W
    within 1e-4 of the CPU run's, and the card's snapshot served again on
    the CPU: batched and dense scores within 1e-5 relative, labels equal),
    gossip_vs_allreduce (three runs, each loss falling, the disagreement
    finite, ``flash_attention`` launched), and train_100m at its defaults
    (300 steps of 8 x 256 tokens, all-reduce and gossip at G = 2: the loss
    of the last ten steps below the first ten's by more than 0.2, every
    step's ``flash_attention`` launches and plain backward passes as remat
    makes them, seconds a step, tokens/s, the peak, the checkpoint restored
    bit for bit);
27. a ``kernels`` JSON line (with ``serving``, ``transformer`` and the later
    phases' objects; each kernel's ``paths`` lists the later phases that
    run it, with their launches) and the final ``{"ok": true, ...}`` line.

It needs one CUDA card and the ``src/`` tree beside it, imports nothing of
JAX or of the JAX package, and exits non-zero without printing a result
when either is missing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12   # H100 SXM TF32 on the tensor cores (dense)
BF16_FLOPS_PER_S = 989e12   # H100 SXM bf16 on the tensor cores (dense)
# flash_attention's routes: f32 inputs split into TF32 hi + lo, three products
# each (a third of the TF32 rate); bf16 inputs exact in TF32, one product for
# q k^T and two for P v (P split): half the work at the TF32 rate, twice
ATTN_F32_SPLIT = ("tf32 x3 (f32 split)", TF32_FLOPS_PER_S / 3)
ATTN_BF16_ROUTE = ("tf32 x1.5 (bf16 exact, P split)", TF32_FLOPS_PER_S / 1.5)
KERNEL_RTOL = 1e-5          # max |kernel − plain| / max(1, max |plain|)
PATH_W_ATOL = 1e-4          # phase 6: card against CPU, 200 iterations
PATH_OBJ_RTOL = 1e-5
MIN_ACCURACY, MAX_OBJECTIVE = 0.72, 0.50
SPARSE_PARITY_ATOL = 1e-5   # phase 9: ELL against dense (prefetch against sweep: 0)
# phase 7 limits, from tools/reference_quality.py (the JAX reference on the
# CPU, same data and config, draw seeds 0 and 1): see PERF.md
CCAT_MIN_ACCURACY, CCAT_MAX_OBJECTIVE = 0.72, 0.70
CCAT_SCALE = 0.1
SERVE_ROWS, SERVE_MIN_K = 8, 19   # the bucket ladder of examples/serve_batched.py
SERVE_SAMPLE = 2000               # training rows the buckets are calibrated on
INT8_MIN_AGREEMENT = 0.9          # int8 against f32 labels, the example's bar
SOURCE_DIR = "src/repro_torch/kernels/hinge_subgrad/csrc"
REPLACES = {
    "fleet_half_step": "src/repro/kernels/hinge_subgrad/hinge_subgrad.py:106",
    "margins": "src/repro/kernels/hinge_subgrad/hinge_subgrad.py:63",
    "grad_update": "src/repro/kernels/hinge_subgrad/hinge_subgrad.py:151",
    "dense_scores": "src/repro/kernels/hinge_subgrad/predict.py:88",
    "ell_margins": "src/repro/kernels/hinge_subgrad/sparse.py:100",
    "ell_margins_coeff": "src/repro/kernels/hinge_subgrad/sparse.py:100",
    "ell_grad_update": "src/repro/kernels/hinge_subgrad/sparse.py:138",
    "ell_margins_prefetch": "src/repro/kernels/hinge_subgrad/sparse.py:210",
    "ell_margins_prefetch_coeff": "src/repro/kernels/hinge_subgrad/sparse.py:210",
    "ell_grad_update_prefetch": "src/repro/kernels/hinge_subgrad/sparse.py:259",
    "ell_grad_update_prefetch_fold": "src/repro/kernels/hinge_subgrad/sparse.py:259",
    "ell_grad_update_fused": "src/repro/kernels/hinge_subgrad/sparse.py:210 and :259 on the "
                             "prefetch path, with the block map before them (jnp in "
                             "src/repro/kernels/hinge_subgrad/ops.py)",
    "ell_scores_prefetch": "src/repro/kernels/hinge_subgrad/predict.py:169",
}
TRANSFORMER_REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:102",
    "rglru_scan": "src/repro/kernels/rglru_scan/rglru_scan.py:51",
    "wkv_scan": "src/repro/kernels/rwkv6_scan/rwkv6_scan.py:62",
}
REPLACES.update(TRANSFORMER_REPLACES)
KERNELS = tuple(REPLACES)
TRANSFORMER_SOURCES = {"flash_attention": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                       "rglru_scan": "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
                       "wkv_scan": "src/repro_torch/kernels/rwkv6_scan/csrc/wkv_scan.cu"}
BF16_ATOL = 2e-2              # flash_attention in bf16: tests/test_kernels.py's tolerance
BF16_ULP = 2.0 ** -7          # and elementwise within one bf16 unit in the last place of
                              # the plain output (plus KERNEL_RTOL): both round an f32 result
DECODE_ATOL, DECODE_RTOL = 5e-4, 1e-3   # tests/test_decode_consistency.py's
PREFILL_BATCH, PREFILL_LEN = 2, 4096    # twice RecurrentGemma's 2048 window
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 32, 16   # launch/serve.py's defaults
RG_DECODE_LEN = 2176          # past the 2048 window, so the ring cache wraps
RWKV_DECODE_LEN = 256
RWKV_DRIFT_LEN = 64           # the full-depth spread, reported: it peaks early
REDUCED_RWKV_LEN = 300        # phase 14's reduced rwkv6 (heads of 24) against the CPU,
REDUCED_RWKV_ATOL = 1e-4      # at tests/test_torch_transformer.py's rwkv6 forward bound
# rwkv6-3b's decode check is held at full width over one pattern cycle (one
# layer), as recurrentgemma-9b's: with random weights the f32 rounding that
# separates decode from forward grows about 2x a layer at this width, in the
# JAX reference as in the port (tools/decode_drift.py: the reference's own
# decode exceeds the tolerance at 8 layers), so at full depth the spread is
# measured and reported, not held
RWKV_CHECK_LAYERS = 1
# the paper's reuters and CCAT runs are repro_torch.configs.gadget_svm's
# PAPER_RUNS["reuters"] and ["ccat"] (Table 2 λ, k = 10 nodes, ε = 1e-3)
N_NODES = 10
C1_ROWS, C1_D, C1_ITERS = 2048, 64, 5   # phase 15: one row above the fused cap, a small d
# phase 15: the routed step against the plain float32 step, relative to
# max(1, max |W_half|). Both round 29,049-term sums in their own order (about
# 1.4e-5 apart on the card); one row of the minibatch moves an element of W by
# about α/B·|x| ≈ 1e-3, which this tolerance sees
C1_RTOL = 1e-4
C1_SWEEP_B = (1, 64, 1024, 8192)   # phase 15: the route against the fused step and plain
FAULT_DROP_PROB, DEAD_NODE = 0.1, 3
# Threefry-2x32 (20 rounds) known answers from Random123's tests, as JAX's own
# tests hold them: key words, counter words, output words
THREEFRY_KAT = ((0, 0, 0, 0, 0x6B200159, 0x99BA4EFE),
                (2 ** 32 - 1,) * 4 + (0x1CB996FC, 0xBB002BE7),
                (0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3, 0xC4923A9C, 0x483DF7A0))
# phase 16 limits, from tools/reference_quality.py reuters --drop-prob 0.1 (the JAX
# reference on the CPU under the same FaultPlan, draw seeds 0 and 1): see PERF.md
FAULT_MIN_ACCURACY, FAULT_MAX_OBJECTIVE = 0.72, 0.50
LINK_MASS_ATOL = 1e-6                   # link mode conserves Push-Sum mass
SEGMENT_ITERS, SNAPSHOT_SLOTS = 500, 4  # phases 17 and 18
STREAM_REUTERS_ITERS = 1000
SERVE_PAUSE_S = 0.01                    # phase 18: pause between bursts of 128 queries
LINEAGE_FILE = "lineage.jsonl"          # phase 18's span records, read in phase 19
# phase 19: the control plane. The open loop offers BURST_LOAD x the closed
# loop's capacity, then TAIL_LOAD x the rate it served in that burst for
# TAIL_S seconds; max_pending, the timeout and P99_SLACK_MS as
# benchmarks/overload_bench.py sets them
INGEST_CHUNK_ROWS = 500
OPEN_LOOP_REQUESTS, OPEN_LOOP_SEED = 20_000, 19
BURST_LOAD, TAIL_LOAD, TAIL_S = 2.0, 0.5, 1.5
# the submitter sleeps at least this long between wakes, then submits every
# arrival due, so it takes the interpreter lock from the drain at most 200
# times a second (on an NVIDIA H100 host 1 ms and 5 ms measured alike:
# tools/control_plane_probe.py)
SUBMIT_TICK_S = 5e-3
P99_SLACK_MS = 500.0
# phase 20: the remaining solvers. The host loop and gadget_train(fused=False)
# run the same step on the same draws, so bit-equal is expected: that checks
# the loop's bookkeeping. Its kernels are held against the host loop's CPU
# run (the plain versions) at PATH_W_ATOL
HOST_LOOP_ITERS, HOST_LOOP_ATOL = 400, 1e-5
# centralised Pegasos as benchmarks/table3_gadget_vs_pegasos.py runs it; the
# reference's test accuracy at draw seed 0, from tools/reference_quality.py
# reuters --mode pegasos (the JAX reference on the CPU): see PERF.md
PEGASOS_ITERS, PEGASOS_BATCH = 1200, 8
PEGASOS_REF_ACCURACY, QUALITY_SLACK = 0.7111245832070324, 0.005
# one-vs-rest GADGET at LibSVM mnist's shape, tests/test_multiclass.py's data
# generator; the reference's accuracy at draw seeds 0 and 1, from
# tools/reference_quality.py mnist --mode multiclass: see PERF.md
MULTICLASS_SHAPE = (60_000, 10_000, 780, 10)   # train rows, test rows, d, classes
MULTICLASS_NODES, MULTICLASS_ITERS, MULTICLASS_CHECK = 10, 1200, 300
MULTICLASS_REF_ACCURACY = 1.0
CUT_PREFIX = 5   # cutting-plane cuts over which w is held against the CPU
# phase 21: the mesh. Four ranks on the one card over gloo (host staging),
# then world = device_count over NCCL
MESH_WORLD, MESH_STEPS, MESH_FAULT_STEPS, MESH_SPARSE_CHECK_STEPS = 4, 200, 50, 3
MESH_TIMEOUT_S = 300
GOSSIP_MEAN_ATOL = 1e-6
# phase 22: the MoE, VLM and audio families; qwen2-moe's decode against
# prefill at one layer over this many tokens
MOE_DECODE_LEN = 256
# phase 23: training. (a) every family at its reduced config, card against
# CPU: the first batch's gradients, each leaf relative to its own largest
# (TRAIN_GRAD_RTOL: the CPU's own gradients move by up to 6.8e-6 of that when
# only its thread count changes, rwkv6's bonus_u; a backward that drops or
# mis-signs a term is off by O(1)), the loss of each step (TRAIN_LOSS_RTOL),
# and the parameters after two SGD steps (TRAIN_CHECK_RTOL; SGD passes no
# rounding through a per-element normalisation, as AdamW would)
TRAIN_CHECK_ARCHS = (("llama3-8b", 2), ("qwen2-moe-a2.7b", 2), ("mixtral-8x22b", 2),
                     ("recurrentgemma-9b", 3), ("rwkv6-3b", 2), ("llava-next-mistral-7b", 2),
                     ("hubert-xlarge", 2))
TRAIN_CHECK_SEQ, TRAIN_CHECK_RTOL, TRAIN_REPLICAS = 64, 1e-4, 4
TRAIN_GRAD_RTOL, TRAIN_LOSS_RTOL = 5e-5, 1e-5
# (b)-(e) at full width: (batch, tokens) of each step
TRAIN_MOE_LAYERS, TRAIN_MOE_BATCH, TRAIN_MOE_STEPS = 2, (2, 2048), 4
TRAIN_HUBERT_BATCH = (2, 1024)
TRAIN_RWKV_LAYERS, TRAIN_RWKV_BATCH = 2, (2, 512)   # per replica
TRAIN_RG_BATCH = (1, 2048)
# one step with remat on against the same step with it off, bit for bit:
# (b) under "full", (e) under "dots"
TRAIN_REMAT = {"qwen2-moe-a2.7b": "full", "recurrentgemma-9b": "dots"}
# phase 24: sharded steps on a (1, 1) mesh of one NCCL rank, against the same steps on plain tensors
SHARDED_ARCHS = (("llama3-8b", 2), ("qwen2-moe-a2.7b", 2), ("recurrentgemma-9b", 3),
                 ("rwkv6-3b", 2), ("hubert-xlarge", 2))
SHARDED_BATCH = (2, 256)
SHARDED_RTOL = 1e-6
MEMORY_RTOL, MEMORY_ATOL = 0.15, 256 * 2 ** 20   # the card's peak against the dry-run's bytes
# phase 25: the production dry-run, full width and depth, each combo a process of its own
DRYRUN_COMBOS = (("rwkv6-3b", "long_500k", ()), ("llama3-8b", "decode_32k", ()),
                 ("rwkv6-3b", "train_4k", ("--multi-pod", "--consensus", "gossip")),
                 ("llama3-8b", "train_4k", ()), ("qwen2-moe-a2.7b", "train_4k", ()),
                 ("llama3-405b", "train_4k", ("--param-mode", "fsdp")),
                 ("llama3-405b", "train_4k", ("--param-mode", "fsdp", "--seq-shard")))
CARD_BYTES = 80e9                  # one H100's device memory
DRYRUN_TIMEOUT_S = 600
SHARDED_DECODE = (2, 16)           # phase 24's decode: rows, tokens through a DTensor cache
EXAMPLES = ROOT / "examples"
# the attention calls of phase 26's examples, (B, S, H, Hkv, dh, causal,
# window, dtype) as the models give them; phase 3 holds their forward and
# their gradients against the plain version
EXAMPLE_ATTN = {"train_100m": (8, 256, 8, 4, 64, True, 0, "float32"),
                "train_100m_g2": (4, 256, 8, 4, 64, True, 0, "float32"),
                "gossip_example": (16, 64, 4, 1, 32, True, 0, "float32"),
                "gossip_example_g4": (4, 64, 4, 1, 32, True, 0, "float32")}
EXAMPLE_TIMEOUT_S = 300
# the reference's examples on the CPU (examples/quickstart.py and
# examples/fault_tolerant_gossip.py, JAX 0.9.0, seed 0): quickstart's test
# accuracies unrounded, fault_tolerant_gossip's printed mean alive-node ones
QUICKSTART_REF = {"pegasos": 0.6764408349990845, "gadget": 0.6632962822914124}
FAULTS_REF = {"clean": 0.659, "20% link drops": 0.663, "2 dead nodes": 0.648}
EXAMPLE_ACC_ATOL, FAULT_ACC_ATOL = 0.005, 0.01
TRAIN_100M = (300, 8, 256)         # examples/train_100m.py's defaults: steps, batch, sequence
TRAIN_100M_MIN_DROP = 0.2          # its "IMPROVED": the last ten losses' mean below the first ten's
# phase 24's prediction of the card's peak: run_one at the same config, batch and (1, 1) mesh
PREDICT_CODE = """
import dataclasses, json, sys
import torch
from repro_torch.configs.shapes import InputShape
from repro_torch.launch.dryrun import run_one
spec = json.loads(sys.argv[1])
res = run_one(spec["arch"], "train_4k", n_layers=spec["layers"], mesh_shape=(1, 1),
              shape=InputShape("train_4k", spec["seq"], spec["batch"], "train"),
              dtype=torch.float32, optimizer="sgd", verbose=False)
with open(sys.argv[2], "w") as fh:
    json.dump(dataclasses.asdict(res), fh)
"""


def log(msg: str) -> None:
    """Print one progress line at once."""
    print(msg, flush=True)


class Failed(Exception):
    """A phase's check did not hold."""


def require(ok: bool, what: str) -> None:
    """Fail the run with ``what`` unless ``ok``."""
    if not ok:
        raise Failed(what)


def device_ms(torch, fn, n: int) -> float:
    """Mean device time of one ``fn()`` over n back-to-back calls. A sleep
    kernel, twice as long as queueing the n calls took the host, holds the
    stream while they are queued, so the events time the device work and
    not the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * max(0.05, 2 * host_s)))  # cycles: >= 2 GHz clock
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound(cost: dict, flops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    """Least time in ms for a ``launch_cost`` on the card, and what bounds it:
    the operations at ``flops_per_s``, the peak of the kernel's route (the
    f32 rate outside the tensor cores unless given)."""
    t_bytes = cost["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = cost["flops"] / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_resources(log_text: str) -> dict:
    """{kernel<template args>: "R registers, S bytes spill stores, M bytes
    smem"} from an ``nvcc -Xptxas -v`` log (static shared memory only; the
    kernels' dynamic shared memory is sized at launch)."""
    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            base = re.findall(r"\d+([a-z_]+_kernel)", mangled)
            args = re.search(r"_kernelI(\w*?)EE?v", mangled)
            tokens = re.findall(r"Li(\d+)|Lb(\d)|(13__nv_bfloat16)|^(f)",
                                args.group(1) if args else "")
            name = (base[-1] if base else mangled) + (
                "<" + ", ".join("bf16" if t[2] else "f32" if t[3] else t[0] or ("true" if t[1] == "1"
                                                                            else "false")
                                for t in tokens) + ">" if tokens else "")
            out[name] = {}
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out[name]["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            out[name].update(registers=int(m.group(1)), smem=int(m.group(2) or 0))
    return out


def launched(c: dict) -> dict:
    """The kernels of a count that launched."""
    return {name: n for name, n in c.items() if n}


def require_launches(c: dict, kinds, iters: int, what: str) -> None:
    """Each of ``kinds`` (a route of ``ops.HALF_STEP_KINDS``) launched once
    an iteration, and no other kernel of the count."""
    require(launched(c) == {name: iters for name in kinds},
            f"{what} launched {launched(c)} in {iters} iterations, want {kinds} once each")


def accounted(before: dict | None = None) -> dict:
    """The default registry's ``kernel.launches`` of every kernel, less
    ``before``'s: the launches the trainer accounted."""
    from repro_torch import telemetry
    reg = telemetry.default_registry()
    return {kind: reg.value("kernel.launches", kernel=kind) - (before or {}).get(kind, 0)
            for kind in KERNELS}


def rel_err(a, b) -> tuple[float, float]:
    """Max |a − b|, absolute and relative to max(1, max |b|)."""
    err = float((a - b).abs().max())
    return err, err / max(1.0, float(b.abs().max()))


def phase_kernels(torch, K, P, ops, lam, gen, dev) -> dict:
    """Every kernel against its plain version at the main path's shape and a
    ragged one; times at the main path's shape (step scalars of the reuters
    run's ``lam``)."""
    d = 8315  # reuters
    out = {}

    def rows(*shape):
        x = torch.randn(*shape, generator=gen, device=dev)
        return (x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)).contiguous()

    def labels(*shape):
        return torch.where(torch.rand(*shape, generator=gen, device=dev) < 0.5, -1.0, 1.0)

    scal = ops.step_scalars(lam, 1000, 1)

    # fleet_half_step: (m, B, d) = (10, 1, 8315) on the main path
    def fleet_case(m, B, dd):
        X, y = rows(m, B, dd), labels(m, B)
        W = 10 * torch.randn(m, dd, generator=gen, device=dev)
        mask = torch.ones(B, device=dev)
        s = ops.step_scalars(lam, 1000, B)
        return (X, W, y, mask, s)
    ragged = fleet_case(3, 37, 1001)
    ragged[3][::3] = 0.0  # some rows masked out
    out["fleet_half_step"] = dict(
        main=fleet_case(N_NODES, 1, d), ragged=ragged, kernel=K.fleet_half_step, plain=K.fleet_half_step_plain,
        library=None, cost=ops.launch_cost("fleet_half_step", m=N_NODES, B=1, d=d),
        shape=f"X ({N_NODES}, 1, {d})")

    # margins and grad_update: the fleet's (m, B, d) = (10, 1, 8315), each
    # once an unfused iteration
    out["margins"] = dict(
        main=fleet_case(N_NODES, 1, d)[:3], ragged=fleet_case(3, 37, 1001)[:3], kernel=K.margins,
        plain=K.margins_plain, library=lambda X, W, y: torch.bmm(X, W[:, :, None]),
        cost=ops.launch_cost("margins", m=N_NODES, B=1, d=d), shape=f"X ({N_NODES}, 1, {d})")

    def grad_case(m, B, dd):  # the violators: every other row of each node
        X, W, y, _, s = fleet_case(m, B, dd)
        return X, W, torch.where(torch.arange(B, device=dev) % 2 == 0, y, 0.0), s

    def one_minus(s):
        return float(np.float32(1) - np.float32(s[0]))
    out["grad_update"] = dict(
        main=grad_case(N_NODES, 1, d), ragged=grad_case(3, 37, 1001), kernel=K.grad_update,
        plain=K.grad_update_plain,
        library=lambda X, W, c, s: torch.baddbmm(W[:, None, :], c[:, None, :], X,
                                                 beta=one_minus(s), alpha=s[1]),
        cost=ops.launch_cost("grad_update", m=N_NODES, B=1, d=d), shape=f"X ({N_NODES}, 1, {d})")

    # dense_scores: the reuters test set (3299, 8315) against one weight row
    Xq = rows(3299, d)
    Wq = torch.randn(1, d, generator=gen, device=dev)
    Xqr = rows(37, 1001)
    Wqr = torch.randn(3, 1001, generator=gen, device=dev)
    Wqr[2] = Wqr[0]  # classes 0 and 2 tie on every row: first occurrence wins
    out["dense_scores"] = dict(
        main=(Xq, Wq), ragged=(Xqr, Wqr), kernel=lambda X, W: P.dense_scores(X, W, n_classes=W.shape[0]),
        plain=lambda X, W: P.dense_scores_plain(X, W, n_classes=W.shape[0]),
        library=lambda X, W: torch.mm(X, W.t()),
        cost=ops.launch_cost("dense_predict", B=3299, d=d, C=1), shape=f"X (3299, {d}), W (1, {d})")

    results = {}
    for name, case in out.items():
        errs = {}
        for which in ("main", "ragged"):
            got = case["kernel"](*case[which])
            want = case["plain"](*case[which])
            torch.cuda.synchronize()
            if name == "dense_scores":
                (got, got_l), (want, _) = got, want
                require(got.shape == want.shape and got_l.dtype == torch.int32,
                        f"dense_scores shapes {tuple(got.shape)} {got_l.dtype}")
                # the in-kernel argmax is exact on the kernel's own scores
                require(torch.equal(got_l.long(), torch.argmax(got, dim=1)),
                        f"dense_scores argmax disagrees ({which})")
                if which == "ragged":
                    require(not torch.any(got_l == 2), "dense_scores tie not first occurrence")
            require(got.shape == want.shape, f"{name} shape {tuple(got.shape)}")
            require(bool(torch.isfinite(got).all()), f"{name} non-finite ({which})")
            errs[which] = rel_err(got, want)
            require(errs[which][1] <= KERNEL_RTOL,
                    f"{name} {which}: kernel against plain rel err {errs[which][1]:.3e}")
        args = case["main"]
        first, again = case["kernel"](*args), case["kernel"](*args)
        if name == "dense_scores":
            first, again = torch.cat([first[0].flatten(), first[1].float()]), \
                torch.cat([again[0].flatten(), again[1].float()])
        require(torch.equal(first, again), f"{name}: two runs on the same inputs differ")
        n = 50 if name == "dense_scores" else 200
        ms = device_ms(torch, lambda: case["kernel"](*args), n)
        plain_ms = device_ms(torch, lambda: case["plain"](*args), n)
        lib_ms = (None if case["library"] is None
                  else device_ms(torch, lambda: case["library"](*args), n))
        bound_ms, bound_by = bound(case["cost"])
        results[name] = dict(max_abs_err=errs["main"][0], ragged_max_abs_err=errs["ragged"][0],
                             ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bound_ms, bound_by=bound_by, shape=case["shape"])
        log(f"  {name:16s} {case['shape']}: err {errs['main'][0]:.3e} (ragged "
            f"{errs['ragged'][0]:.3e}), kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
            f"library {'-' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'}, "
            f"bound {bound_ms * 1e3:.2f} us ({bound_by})")

    # fleet_half_step at m of 1, 10 and 32 nodes, B of 1 and 37 (every third
    # row masked), d of reuters, ragged and wide, and a B whose X slice
    # overflows shared memory (phase 2 streams X from L2); held to the plain
    # version, reruns bit for bit; then the cluster sizes 8 and 16 timed at
    # the main shape (the wrapper picks fleet_cluster's)
    shapes = [(m, B, dd) for m in (1, N_NODES, 32) for B in (1, 37) for dd in (d, 1001, 70001)]
    shapes.append((2, 512, d))
    worst = 0.0
    for m, B, dd in shapes:
        X, W, y, mask, s = fleet_case(m, B, dd)
        if B > 1:
            mask[::3] = 0.0
        got = K.fleet_half_step(X, W, y, mask, s)
        err = rel_err(got, K.fleet_half_step_plain(X, W, y, mask, s))
        require(err[1] <= KERNEL_RTOL, f"fleet_half_step at (m, B, d) = ({m}, {B}, {dd}): kernel "
                f"against plain rel err {err[1]:.3e}")
        require(torch.equal(got, K.fleet_half_step(X, W, y, mask, s)),
                f"fleet_half_step at ({m}, {B}, {dd}): two runs on the same inputs differ")
        worst = max(worst, err[0])
        del X, W, got
    main_fleet = out["fleet_half_step"]["main"]
    cluster_ms = {}
    for cl in (8, 16):
        err = rel_err(K._launch_fleet(*main_fleet, cl), K.fleet_half_step_plain(*main_fleet))
        require(err[1] <= KERNEL_RTOL, f"fleet_half_step with clusters of {cl}: rel err {err[1]:.3e}")
        cluster_ms[cl] = device_ms(torch, lambda cl=cl: K._launch_fleet(*main_fleet, cl), 200)
    chosen = K.fleet_cluster(N_NODES, torch.cuda.get_device_properties(0).multi_processor_count)
    log(f"  {'fleet_half_step':16s} {len(shapes)} more shapes (m 1/10/32, B 1/37, d 8315/1001/70001; "
        f"B 512 streamed): max err {worst:.3e}; clusters of 8: {cluster_ms[8] * 1e3:.2f} us, of 16: "
        f"{cluster_ms[16] * 1e3:.2f} us (the wrapper takes {chosen} at m = {N_NODES})")
    results["fleet_half_step"].update(other_shapes_max_abs_err=worst, cluster=chosen,
                                      cluster_ms={str(k): v for k, v in cluster_ms.items()})

    # margins: one node's (1, 8315) (the m = 1 case) beside torch.mv, and a
    # block a row at 2 x 1100 rows; held, reruns bit for bit; then the
    # cluster sizes timed at the main shape (the wrapper picks margins_cluster's)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    X1m, W1m, y1m = (a[0] for a in fleet_case(1, 1, d)[:3])
    Xwm, Wwm, ywm = fleet_case(2, 1100, 1001)[:3]
    require(K.margins_cluster(2 * 1100, n_sm) == 1, "2 x 1100 rows do not take a block a row")
    errs = []
    for args in ((X1m, W1m, y1m), (Xwm, Wwm, ywm)):
        got = K.margins(*args)
        errs.append(rel_err(got, K.margins_plain(*args)))
        require(errs[-1][1] <= KERNEL_RTOL and torch.equal(got, K.margins(*args)),
                f"margins at X {tuple(args[0].shape)}: rel err {errs[-1][1]:.3e}, or reruns differ")
    t = device_ms(torch, lambda: K.margins(X1m, W1m, y1m), 200)
    t_mv = device_ms(torch, lambda: torch.mv(X1m, W1m), 200)
    b_ms, b_by = bound(ops.launch_cost("margins", B=1, d=d))
    results["margins"]["one_node"] = dict(
        shape=f"X (1, {d})", max_abs_err=errs[0][0], ms=t, library_ms=t_mv, bound_ms=b_ms,
        bound_by=b_by, cluster=K.margins_cluster(1, n_sm))
    log(f"  {'margins':16s} X (1, {d}): err {errs[0][0]:.3e}, kernel {t * 1e3:.2f} us, torch.mv "
        f"{t_mv * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us ({b_by}); X (2, 1100, 1001), a block a "
        f"row: err {errs[1][0]:.3e}")
    main_m = out["margins"]["main"]
    margins_ms = {}
    for cl in (1, 4, 8, 16):
        err = rel_err(K._launch_margins(*main_m, cl), K.margins_plain(*main_m))
        require(err[1] <= KERNEL_RTOL, f"margins with clusters of {cl}: rel err {err[1]:.3e}")
        margins_ms[cl] = device_ms(torch, lambda cl=cl: K._launch_margins(*main_m, cl), 200)
    chosen = K.margins_cluster(N_NODES, n_sm)
    log(f"  {'margins':16s} X ({N_NODES}, 1, {d}) by blocks a row: "
        + ", ".join(f"{cl}: {t * 1e3:.2f} us" for cl, t in margins_ms.items())
        + f" (the wrapper takes {chosen})")
    results["margins"].update(cluster=chosen,
                              cluster_ms={str(k): v for k, v in margins_ms.items()})

    # grad_update: the fleet launch bit for bit the one-node launches stacked
    # and the same bits from a view of X off the 16-byte grid, at the main
    # shape, the ragged one and a B = 37 fleet of d % 4 == 0, torch.baddbmm held to the plain version; then one node (1, 8315)
    # beside torch.addmv, and what the fleet launch replaces on the unfused
    # path, ten one-node launches and a torch.stack, timed
    def stacked(X, W, c, s):
        return torch.stack([K.grad_update(X[i], W[i], c[i], s) for i in range(X.shape[0])])
    wide = grad_case(3, 37, 1004)
    require(rel_err(K.grad_update(*wide), K.grad_update_plain(*wide))[1] <= KERNEL_RTOL,
            "grad_update at (3, 37, 1004): kernel against plain")
    for which, (X_, W_, c_, s_) in (("main", out["grad_update"]["main"]),
                                    ("ragged", out["grad_update"]["ragged"]), ("wide", wide)):
        got = K.grad_update(X_, W_, c_, s_)
        X_off = torch.empty(X_.numel() + 1, device=dev)[1:].view(X_.shape)
        X_off.copy_(X_)
        require(torch.equal(got, stacked(X_, W_, c_, s_))
                and torch.equal(got, K.grad_update(X_off, W_, c_, s_)),
                f"grad_update {which}: the one-node launches stacked or an X off the 16-byte "
                "grid give other bits")
    Xg, Wg, cg, _ = main_g = out["grad_update"]["main"]
    lib_g = out["grad_update"]["library"](*main_g)[:, 0]
    require(rel_err(lib_g, K.grad_update_plain(*main_g))[1] <= KERNEL_RTOL,
            "torch.baddbmm does not compute grad_update")
    X1g, w1g, c1g = (a[0].clone() for a in (Xg, Wg, cg))
    err1 = rel_err(K.grad_update(X1g, w1g, c1g, scal), K.grad_update_plain(X1g, w1g, c1g, scal))
    require(err1[1] <= KERNEL_RTOL, f"grad_update one node: rel err {err1[1]:.3e}")
    t = device_ms(torch, lambda: K.grad_update(X1g, w1g, c1g, scal), 200)
    t_mv = device_ms(torch, lambda: torch.addmv(w1g, X1g.t(), c1g, beta=one_minus(scal),
                                                alpha=scal[1]), 200)
    t_loop = device_ms(torch, lambda: stacked(*main_g), 50)  # 11 launches a call: 50 calls fit the queue
    b_ms, b_by = bound(ops.launch_cost("grad_update", B=1, d=d))
    results["grad_update"]["one_node"] = dict(
        shape=f"X (1, {d})", max_abs_err=err1[0], ms=t, library_ms=t_mv, bound_ms=b_ms,
        bound_by=b_by)
    results["grad_update"]["replaced_ms"] = t_loop
    log(f"  {'grad_update':16s} the fleet launch equals the one-node launches stacked and an X "
        f"view off the 16-byte grid, bit for bit (main, ragged, (3, 37, 1004)); {N_NODES} "
        f"launches and the stack {t_loop * 1e3:.2f} us; X (1, {d}): err {err1[0]:.3e}, kernel "
        f"{t * 1e3:.2f} us, torch.addmv {t_mv * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us ({b_by})")

    # NaN rows (ROADMAP C1): a row with a NaN among its ranked scores gets
    # nan_label(C) from kernel and plain version alike; a NaN only in a
    # class past n_classes changes nothing
    for C, n_cls in ((3, 3), (130, 130), (4, 3)):
        Xn, Wn = rows(37, 1001), torch.randn(C, 1001, generator=gen, device=dev)
        Xn[5] = float("nan")                     # every class NaN
        Xn[9, 3], Wn[1, 3] = float("inf"), 0.0  # class 1 NaN (inf x 0), the others +-inf
        if n_cls < C:
            Wn[C - 1, 7] = float("nan")          # the unranked class NaN on every row
        check_nan_labels(torch, "dense_scores", P.dense_scores(Xn, Wn, n_classes=n_cls),
                         P.dense_scores_plain(Xn, Wn, n_classes=n_cls), [5, 9], P.nan_label(C),
                         n_cls)
    log(f"  {'dense_scores':16s} NaN rows labelled {P.nan_label(3)} at C 3 and 4, "
        f"{P.nan_label(130)} at C 130; a NaN past n_classes ignored")

    # dense_scores beside torch.mm at four classes (X read once; W 133 KB)
    # and at serving batches, each held to the plain version first
    extra = {}
    for which, (B, C) in {"C4": (3299, 4), "B8": (8, 1), "B64": (64, 1)}.items():
        Xe = Xq[:B].contiguous()
        We = torch.randn(C, d, generator=gen, device=dev)
        (got, got_l), (want, _) = (P.dense_scores(Xe, We, n_classes=C),
                                   P.dense_scores_plain(Xe, We, n_classes=C))
        err = rel_err(got, want)
        require(err[1] <= KERNEL_RTOL and torch.equal(got_l.long(), torch.argmax(got, dim=1)),
                f"dense_scores {which}: rel err {err[1]:.3e} or labels off")
        t = device_ms(torch, lambda: P.dense_scores(Xe, We, n_classes=C), 200)
        t_mm = device_ms(torch, lambda: torch.mm(Xe, We.t()), 200)
        b_ms, b_by = bound(ops.launch_cost("dense_predict", B=B, d=d, C=C))
        extra[which] = dict(shape=f"X ({B}, {d}), W ({C}, {d})", max_abs_err=err[0], ms=t,
                            library_ms=t_mm, bound_ms=b_ms, bound_by=b_by)
        log(f"  {'dense_scores':16s} X ({B}, {d}), W ({C}, {d}): err {err[0]:.3e}, kernel "
            f"{t * 1e3:.2f} us, torch.mm {t_mm * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us ({b_by})")
    # rows wider than one class row of shared memory (column slabs) and more
    # classes than one tile: two launches each way, held, not timed
    Xw, Ww = rows(33, 70001), torch.randn(20, 70001, generator=gen, device=dev)
    (got, got_l), (want, _) = (P.dense_scores(Xw, Ww, n_classes=17),
                               P.dense_scores_plain(Xw, Ww, n_classes=17))
    err = rel_err(got, want)
    require(err[1] <= KERNEL_RTOL and torch.equal(got_l.long(), torch.argmax(got[:, :17], dim=1)),
            f"dense_scores at d 70001, C 20: rel err {err[1]:.3e} or labels off")
    log(f"  {'dense_scores':16s} X (33, 70001), W (20, 70001), 17 classes ranked: err {err[0]:.3e}")
    results["dense_scores"]["other_shapes"] = extra
    return results


def check_nan_labels(torch, name, got, want, nan_rows, label, n_classes) -> None:
    """Scores with NaNs against the plain version's (NaN where it has NaN,
    the rest within ``KERNEL_RTOL``), and labels: ``label`` on ``nan_rows``
    in both, the kernel's first-occurrence argmax of its own ranked scores on
    every other row."""
    (s, lbl), (s_p, lbl_p) = got, want
    torch.cuda.synchronize()
    require(torch.equal(torch.isnan(s), torch.isnan(s_p)), f"{name}: NaN scores differ")
    fin = torch.isfinite(s_p)
    require(torch.equal(torch.isfinite(s), fin), f"{name}: infinite scores differ")
    require(rel_err(s[fin], s_p[fin])[1] <= KERNEL_RTOL, f"{name}: NaN case scores off")
    nan_rows = torch.tensor(nan_rows, device=s.device)
    require(bool((lbl[nan_rows] == label).all()) and bool((lbl_p[nan_rows] == label).all()),
            f"{name}: NaN rows labelled {lbl[nan_rows].tolist()} (kernel), "
            f"{lbl_p[nan_rows].tolist()} (plain), want {label}")
    rest = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    rest[nan_rows] = False
    require(torch.equal(lbl[rest].long(), torch.argmax(s[rest, :n_classes], dim=1)),
            f"{name}: labels of the rows without NaN are not the argmax")


def ccat_minibatch(torch, parts, y_parts, n_counts, dev, seed=0, B=1):
    """One CCAT minibatch as ``gadget_train`` draws it: B uniform valid rows
    of every node, as (cols, vals, y) of shapes (m, B, k) and (m, B)."""
    rng = np.random.default_rng(seed)
    m = parts.cols.shape[0]
    rows = np.array([rng.integers(0, c, size=B) for c in n_counts])
    node = np.arange(m)[:, None]
    return (torch.from_numpy(parts.cols[node, rows]).to(dev),
            torch.from_numpy(parts.vals[node, rows]).to(dev),
            torch.from_numpy(y_parts[node, rows]).to(dev))


def phase_sparse_kernels(torch, S, ops, ccat, lam, gen, dev) -> dict:
    """The sparse kernels' eight entries against their plain versions at the
    CCAT main path's shape (a real minibatch, its touched-block map at the
    data's bound) and at a ragged shape with pad entries, a pad row, an
    all-pad node, and the map at the sound cap and one slot short (the sweep
    margins also at k = 600, in waves); times at the main path's shape
    (step scalars of the CCAT run's ``lam``)."""
    parts, y_parts, n_counts = ccat
    cols, vals, y = ccat_minibatch(torch, parts, y_parts, n_counts, dev)
    m, B, k = cols.shape
    d = parts.d
    W = 3 * torch.randn(m, d, generator=gen, device=dev)  # some rows violate, some not
    sched, blk_pf, n_blocks_max = ops.resolve_ell_schedule(
        "auto", B=B, k=k, d=d, n_blocks_max=parts.block_bound(B))
    _, blk_sw, _ = ops.resolve_ell_schedule("sweep", B=B, k=k, d=d)
    require((sched, blk_pf) == ("prefetch", 128), f"CCAT resolves to {sched}, blk_d {blk_pf}")
    nd = -(-d // blk_pf)
    bids = ops.ell_block_map(cols, vals, blk_d=blk_pf, n_d_blocks=nd, n_blocks_max=n_blocks_max)
    scal = ops.step_scalars(lam, 1000, B)

    # ragged: (m, B, k, d) = (3, 5, 13, 1001), 25% pad entries, row 2 a pad
    # row, node 1 all pads (its map all sentinel), rows 0 and 1 of node 0
    # sharing a column (two entries on one lane: the grad kernels' ordered walk)
    rm, rB, rk, rd = 3, 5, 13, 1001
    rcols = torch.randint(0, rd, (rm, rB, rk), generator=gen, device=dev, dtype=torch.int32)
    rvals = torch.rand(rm, rB, rk, generator=gen, device=dev)
    pad = torch.rand(rm, rB, rk, generator=gen, device=dev) < 0.25
    rcols[pad], rvals[pad] = 0, 0.0
    rcols[0, :2, 0], rvals[0, :2, 0] = 17, 0.5
    ry = torch.where(torch.rand(rm, rB, generator=gen, device=dev) < 0.5, -1.0, 1.0)
    rcols[:, 2], rvals[:, 2], ry[:, 2] = 0, 0.0, 0.0
    rcols[1], rvals[1], ry[1] = 0, 0.0, 0.0
    rvals = rvals / torch.clamp(torch.linalg.vector_norm(rvals, dim=-1, keepdim=True), min=1e-8)
    rW = 3 * torch.randn(rm, rd, generator=gen, device=dev)
    rnd = -(-rd // blk_pf)
    live = max(len(torch.unique(c[v != 0] // blk_pf)) for c, v in zip(rcols, rvals))
    rbids = ops.ell_block_map(rcols, rvals, blk_d=blk_pf, n_d_blocks=rnd, n_blocks_max=live)
    rcut = ops.ell_block_map(rcols, rvals, blk_d=blk_pf, n_d_blocks=rnd, n_blocks_max=live - 1)
    rscal = ops.step_scalars(lam, 1000, rB)
    # waves: (m, B, k) = (2, 3, 600) at CCAT's width, 20% pad entries, the
    # map every block of d (370 slots)
    wcols = torch.randint(0, d, (2, 3, 600), generator=gen, device=dev, dtype=torch.int32)
    wvals = torch.rand(2, 3, 600, generator=gen, device=dev)
    pad = torch.rand(2, 3, 600, generator=gen, device=dev) < 0.2
    wcols[pad], wvals[pad] = 0, 0.0
    wvals = wvals / torch.linalg.vector_norm(wvals, dim=-1, keepdim=True)
    wy = torch.where(torch.rand(2, 3, generator=gen, device=dev) < 0.5, -1.0, 1.0)
    wW = 3 * torch.randn(2, d, generator=gen, device=dev)
    wbids = ops.ell_block_map(wcols, wvals, blk_d=blk_pf, n_d_blocks=nd, n_blocks_max=nd)

    def coeff_of(W_, cols_, vals_, y_):
        mg = S.ell_margins_plain(cols_, vals_, W_, y_)
        return torch.where(mg < 1.0, y_, torch.zeros_like(y_))
    coeff, rcoeff = coeff_of(W, cols, vals, y), coeff_of(rW, rcols, rvals, ry)

    def coeff_sw(stack=True):  # stacked (margins; coefficients): one tensor to compare
        join = torch.stack if stack else tuple
        return (lambda c, v, w, yy: join(S.ell_margins_coeff(c, v, w, yy)),
                lambda c, v, w, yy: join(S.ell_margins_coeff_plain(c, v, w, yy)))

    def margins_pf(blk, n_d):
        return (lambda c, v, w, yy, b: S.ell_margins_prefetch(c, v, w, yy, b, blk_d=blk, n_d_blocks=n_d),
                lambda c, v, w, yy, b: S.ell_margins_prefetch_plain(c, v, w, yy, b, blk_d=blk,
                                                                    n_d_blocks=n_d))

    def coeff_pf(blk, n_d, stack=True):  # stacked (margins; coefficients): one tensor to compare
        join = torch.stack if stack else tuple
        return (lambda c, v, w, yy, b: join(S.ell_margins_prefetch_coeff(
                    c, v, w, yy, b, blk_d=blk, n_d_blocks=n_d)),
                lambda c, v, w, yy, b: join(S.ell_margins_prefetch_coeff_plain(
                    c, v, w, yy, b, blk_d=blk, n_d_blocks=n_d)))

    def grad_pf(blk, n_d):
        return (lambda c, v, cf, b: S.ell_grad_update_prefetch(c, v, cf, b, blk_d=blk, n_d_blocks=n_d),
                lambda c, v, cf, b: S.ell_grad_update_prefetch_plain(c, v, cf, b, blk_d=blk,
                                                                     n_d_blocks=n_d))

    def fold_pf(blk, n_d):
        return (lambda c, v, cf, b, w, sc: S.ell_grad_update_prefetch_fold(
                    c, v, cf, b, w, sc, blk_d=blk, n_d_blocks=n_d),
                lambda c, v, cf, b, w, sc: S.ell_grad_update_prefetch_fold_plain(
                    c, v, cf, b, w, sc, blk_d=blk, n_d_blocks=n_d))
    # the library yardstick of both margins kernels: one embedding_bag over
    # the planes as they are, each node's columns offset into a flattened W
    # (made here, outside the timed call); it returns the unsigned margins
    cols_flat = (cols.long() + d * torch.arange(m, device=dev)[:, None, None]).reshape(m * B, k)
    vals_flat, W_flat = vals.reshape(m * B, k), W.reshape(m * d, 1)

    def margins_library():
        return torch.nn.functional.embedding_bag(cols_flat, W_flat, per_sample_weights=vals_flat,
                                                 mode="sum")
    main_shape = f"cols ({m}, {B}, {k}), W ({m}, {d})"
    cases = {
        "ell_margins": dict(
            run=(S.ell_margins, S.ell_margins_plain), inputs={
                "main": (cols, vals, W, y), "ragged": (rcols, rvals, rW, ry),
                "k600": (wcols, wvals, wW, wy)},
            library=margins_library,
            cost=ops.launch_cost("ell_margins", m=m, B=B, k=k), shape=main_shape),
        "ell_margins_coeff": dict(
            run=coeff_sw(), inputs={
                "main": (cols, vals, W, y), "ragged": (rcols, rvals, rW, ry),
                "k600": (wcols, wvals, wW, wy)},
            timed=coeff_sw(stack=False),
            cost=ops.launch_cost("ell_margins_coeff", m=m, B=B, k=k), shape=main_shape),
        "ell_grad_update": dict(
            run=(lambda *a: S.ell_grad_update(*a, blk_d=blk_sw), S.ell_grad_update_plain), inputs={
                "main": (cols, vals, W, coeff, scal), "ragged": (rcols, rvals, rW, rcoeff, rscal)},
            cost=ops.launch_cost("ell_grad_update", m=m, B=B, k=k, d=d),
            shape=f"{main_shape}, blk_d {blk_sw} (checked; the kernel's tile 1024)"),
        "ell_margins_prefetch": dict(
            run=margins_pf(blk_pf, nd), inputs={
                "main": (cols, vals, W, y, bids), "ragged": (rcols, rvals, rW, ry, rbids),
                "undersized": (rcols, rvals, rW, ry, rcut)},
            ragged_run=margins_pf(blk_pf, rnd), library=margins_library,
            cost=ops.launch_cost("ell_margins_prefetch", m=m, B=B, k=k, n_blocks_max=n_blocks_max),
            shape=f"{main_shape}, map ({m}, {n_blocks_max})"),
        "ell_margins_prefetch_coeff": dict(
            run=coeff_pf(blk_pf, nd), inputs={
                "main": (cols, vals, W, y, bids), "ragged": (rcols, rvals, rW, ry, rbids),
                "undersized": (rcols, rvals, rW, ry, rcut)},
            ragged_run=coeff_pf(blk_pf, rnd), timed=coeff_pf(blk_pf, nd, stack=False),
            cost=ops.launch_cost("ell_margins_prefetch_coeff", m=m, B=B, k=k,
                                 n_blocks_max=n_blocks_max),
            shape=f"{main_shape}, map ({m}, {n_blocks_max})"),
        "ell_grad_update_prefetch": dict(
            run=grad_pf(blk_pf, nd), inputs={
                "main": (cols, vals, coeff, bids), "ragged": (rcols, rvals, rcoeff, rbids),
                "undersized": (rcols, rvals, rcoeff, rcut)},
            ragged_run=grad_pf(blk_pf, rnd),
            cost=ops.launch_cost("ell_grad_update_prefetch", m=m, B=B, k=k,
                                 n_blocks_max=n_blocks_max, blk_d=blk_pf),
            shape=f"{main_shape}, map ({m}, {n_blocks_max}), G ({m}, {n_blocks_max}, {blk_pf})"),
        "ell_grad_update_prefetch_fold": dict(
            run=fold_pf(blk_pf, nd), inputs={
                "main": (cols, vals, coeff, bids, W, scal),
                "ragged": (rcols, rvals, rcoeff, rbids, rW, rscal),
                "undersized": (rcols, rvals, rcoeff, rcut, rW, rscal)},
            ragged_run=fold_pf(blk_pf, rnd),
            cost=ops.launch_cost("ell_grad_update_prefetch_fold", m=m, B=B, k=k, d=d,
                                 n_blocks_max=n_blocks_max, blk_d=blk_pf),
            shape=f"{main_shape}, map ({m}, {n_blocks_max})"),
    }

    def fused_pf(n_d):
        def plain(c, v, w, yy, sc, cap):  # the map, then the plain pair
            b_ = ops.ell_block_map(c, v, blk_d=blk_pf, n_d_blocks=n_d, n_blocks_max=cap)
            _, cf_ = S.ell_margins_prefetch_coeff_plain(c, v, w, yy, b_, blk_d=blk_pf,
                                                        n_d_blocks=n_d)
            return S.ell_grad_update_prefetch_fold_plain(c, v, cf_, b_, w, sc, blk_d=blk_pf,
                                                         n_d_blocks=n_d)
        return (lambda c, v, w, yy, sc, cap: S.ell_grad_update_fused(
                    c, v, w, yy, sc, blk_d=blk_pf, n_d_blocks=n_d, n_blocks_max=cap), plain)
    cases["ell_grad_update_fused"] = dict(
        run=fused_pf(nd), inputs={
            "main": (cols, vals, W, y, scal, n_blocks_max),
            "ragged": (rcols, rvals, rW, ry, rscal, live),
            "undersized": (rcols, rvals, rW, ry, rscal, live - 1)},
        ragged_run=fused_pf(rnd),
        cost=ops.launch_cost("ell_grad_update_fused", m=m, B=B, k=k, d=d),
        shape=f"{main_shape}, map of {n_blocks_max} blocks in shared memory")

    def chain(c_, v_, w_, y_, sc_, cap, n_d):  # the route the fused entry replaces
        b_ = ops.ell_block_map(c_, v_, blk_d=blk_pf, n_d_blocks=n_d, n_blocks_max=cap)
        _, cf_ = S.ell_margins_prefetch_coeff(c_, v_, w_, y_, b_, blk_d=blk_pf, n_d_blocks=n_d)
        return S.ell_grad_update_prefetch_fold(c_, v_, cf_, b_, w_, sc_, blk_d=blk_pf,
                                               n_d_blocks=n_d)
    # the fused half-step is the map, the coefficient entry and the fold, bit for bit
    for which, n_d in (("main", nd), ("ragged", rnd), ("undersized", rnd)):
        args = cases["ell_grad_update_fused"]["inputs"][which]
        got = cases["ell_grad_update_fused"]["run" if which == "main" else "ragged_run"][0](*args)
        want = chain(*args, n_d)
        require(torch.equal(got, want),
                f"ell_grad_update_fused {which}: not the map + ell_margins_prefetch_coeff + "
                f"ell_grad_update_prefetch_fold bit for bit (max diff "
                f"{float((got - want).abs().max()):.3e})")
    # kernel time of the route it replaces and of the fused entry, torch.profiler
    # over 20 calls of each (the map's launches would overflow the launch queue)
    main_args = cases["ell_grad_update_fused"]["inputs"]["main"]
    fused_main = cases["ell_grad_update_fused"]["run"][0]
    route = profile_iterations(torch, lambda: [chain(*main_args, nd) for _ in range(20)])
    fused_one = profile_iterations(torch, lambda: [fused_main(*main_args) for _ in range(20)])
    log("  ell_grad_update_fused equals the map + ell_margins_prefetch_coeff + "
        "ell_grad_update_prefetch_fold bit for bit (main, ragged, undersized); kernel time a "
        f"call (torch.profiler): the route's {route['kernel_launches'] / 20:.0f} launches "
        f"{route['kernel_us'] / 20:.2f} us, the fused entry's "
        f"{fused_one['kernel_launches'] / 20:.0f} {fused_one['kernel_us'] / 20:.2f} us")
    crossover = fused_crossover(torch, S, ops, ccat, lam, dev)
    wide = fused_at_kdda_width(torch, S, ops, lam, gen, dev)
    # the short map really loses entries, or the undersized case tests nothing
    cut = S.ell_margins_prefetch_plain(rcols, rvals, rW, ry, rcut, blk_d=blk_pf, n_d_blocks=rnd)
    require(not torch.allclose(cut, S.ell_margins_plain(rcols, rvals, rW, ry)),
            "the undersized map dropped no entry")
    require(bool((rbids[1] == rnd).all()), "the all-pad node's map is not all sentinel")
    # the fused prefetch grad is the G kernel folded by fold_buckets, bit for bit
    for which, (c_, v_, cf_, b_, w_, sc_), n_d in (
            ("main", (cols, vals, coeff, bids, W, scal), nd),
            ("ragged", (rcols, rvals, rcoeff, rbids, rW, rscal), rnd),
            ("undersized", (rcols, rvals, rcoeff, rcut, rW, rscal), rnd)):
        fused = S.ell_grad_update_prefetch_fold(c_, v_, cf_, b_, w_, sc_, blk_d=blk_pf,
                                                n_d_blocks=n_d)
        G_ = S.ell_grad_update_prefetch(c_, v_, cf_, b_, blk_d=blk_pf, n_d_blocks=n_d)
        s0_, s1_ = (float(np.float32(x)) for x in sc_)
        folded = S.fold_buckets(w_, G_, b_, blk_pf, float(np.float32(1) - np.float32(s0_)), s1_)
        require(torch.equal(fused, folded),
                f"ell_grad_update_prefetch_fold {which}: not the G kernel + fold_buckets bit for "
                f"bit (max diff {float((fused - folded).abs().max()):.3e})")
    # the sweep grad: bit for bit its plain version at the real minibatch (at
    # B = 1 a node's columns are distinct, so each lane's sum is one
    # product), the same bits at every blk_d the reference takes and from a W
    # off the 16-byte grid (4-byte copies)
    sweep = S.ell_grad_update(cols, vals, W, coeff, scal, blk_d=blk_sw)
    plain_sweep = S.ell_grad_update_plain(cols, vals, W, coeff, scal)
    require(torch.equal(sweep, plain_sweep), "ell_grad_update main: not its plain version bit for "
            f"bit (max diff {float((sweep - plain_sweep).abs().max()):.3e})")
    W_off = torch.empty(W.numel() + 1, device=dev)[1:].view(W.shape)
    W_off.copy_(W)
    require(all(torch.equal(S.ell_grad_update(cols, vals, w_, coeff, scal, blk_d=b_), sweep)
                for w_, b_ in ((W, 128), (W, 1000), (W_off, blk_sw))),
            "ell_grad_update: another blk_d or a W off the 16-byte grid gives other bits")
    log("  ell_grad_update equals its plain version bit for bit (main), at blk_d 128, "
        f"{blk_sw} and 1000 and from a W off the 16-byte grid")
    # the coefficient entry: its margins are the margins entry's, and its
    # coefficients torch.where of them, bit for bit
    for which, (c_, v_, w_, y_, b_), n_d in (("main", (cols, vals, W, y, bids), nd),
                                             ("ragged", (rcols, rvals, rW, ry, rbids), rnd),
                                             ("undersized", (rcols, rvals, rW, ry, rcut), rnd)):
        mg, cf = S.ell_margins_prefetch_coeff(c_, v_, w_, y_, b_, blk_d=blk_pf, n_d_blocks=n_d)
        alone = S.ell_margins_prefetch(c_, v_, w_, y_, b_, blk_d=blk_pf, n_d_blocks=n_d)
        require(torch.equal(mg, alone), f"ell_margins_prefetch_coeff {which}: margins differ from "
                f"the margins entry's (max diff {float((mg - alone).abs().max()):.3e})")
        require(torch.equal(cf, torch.where(mg < 1.0, y_, torch.zeros_like(y_))),
                f"ell_margins_prefetch_coeff {which}: coefficients are not torch.where of its "
                "margins bit for bit")
    # what the coefficient entry replaces on the path: the margins entry, then
    # the comparison, fill and where
    margins_then_where_ms = device_ms(torch, lambda: torch.where(S.ell_margins_prefetch(
        cols, vals, W, y, bids, blk_d=blk_pf, n_d_blocks=nd) < 1.0, y, torch.zeros_like(y)), 200)
    log("  ell_margins_prefetch_coeff equals ell_margins_prefetch + torch.where bit for bit (main, "
        f"ragged, undersized); the margins entry and the 3 launches of the where take "
        f"{margins_then_where_ms * 1e3:.2f} us")
    # the sweep's coefficient entry: its margins are ell_margins' and, at a
    # sound map, the prefetch coefficient entry's (one kernel body), and its
    # coefficients torch.where of them, bit for bit
    for which, (c_, v_, w_, y_), b_ in (("main", (cols, vals, W, y), bids),
                                        ("ragged", (rcols, rvals, rW, ry), rbids),
                                        ("k600", (wcols, wvals, wW, wy), wbids)):
        mg, cf = S.ell_margins_coeff(c_, v_, w_, y_)
        require(torch.equal(mg, S.ell_margins(c_, v_, w_, y_)),
                f"ell_margins_coeff {which}: margins differ from ell_margins'")
        require(torch.equal(cf, torch.where(mg < 1.0, y_, torch.zeros_like(y_))),
                f"ell_margins_coeff {which}: coefficients are not torch.where of its margins")
        mg_pf, cf_pf = S.ell_margins_prefetch_coeff(c_, v_, w_, y_, b_, blk_d=blk_pf,
                                                    n_d_blocks=-(-w_.shape[1] // blk_pf))
        require(torch.equal(mg, mg_pf) and torch.equal(cf, cf_pf),
                f"ell_margins_coeff {which}: not the prefetch entry's at the sound map bit for bit "
                f"(max diff {float((mg - mg_pf).abs().max()):.3e})")
    sweep_then_where_ms = device_ms(torch, lambda: torch.where(
        S.ell_margins(cols, vals, W, y) < 1.0, y, torch.zeros_like(y)), 200)
    log("  ell_margins_coeff equals ell_margins + torch.where and, at the sound map, "
        "ell_margins_prefetch_coeff bit for bit (main, ragged, k600); ell_margins and the 3 "
        f"launches of the where take {sweep_then_where_ms * 1e3:.2f} us")
    # what the fused entry replaces on the path: the G kernel, then fold_buckets
    one_minus = float(np.float32(1) - np.float32(scal[0]))

    def buckets_then_fold():
        G_ = S.ell_grad_update_prefetch(cols, vals, coeff, bids, blk_d=blk_pf, n_d_blocks=nd)
        return S.fold_buckets(W, G_, bids, blk_pf, one_minus, scal[1])

    def fused():
        return S.ell_grad_update_prefetch_fold(cols, vals, coeff, bids, W, scal, blk_d=blk_pf,
                                               n_d_blocks=nd)
    # kernel time from torch.profiler over 20 calls of each: device_ms would
    # queue 200 x 14 launches, more than the launch queue holds, and time the host
    n_calls = 20
    pair, one = (profile_iterations(torch, lambda f=f: [f() for _ in range(n_calls)])
                 for f in (buckets_then_fold, fused))
    replaced = pair["kernel_launches"] / n_calls
    replaced_us, fused_us = pair["kernel_us"] / n_calls, one["kernel_us"] / n_calls
    log("  ell_grad_update_prefetch_fold equals ell_grad_update_prefetch + fold_buckets bit for "
        f"bit (main, ragged, undersized); kernel time a call (torch.profiler): the two "
        f"{replaced:.0f} launches {replaced_us:.2f} us, the fused entry {fused_us:.2f} us")
    lib_margins = margins_library().reshape(m, B) * y
    require(rel_err(lib_margins, S.ell_margins_plain(cols, vals, W, y))[1] <= KERNEL_RTOL,
            "embedding_bag does not compute the margins")

    results = {}
    for name, case in cases.items():
        errs = {}
        for which, args in case["inputs"].items():
            kernel, plain = case["run"] if which == "main" else case.get("ragged_run", case["run"])
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            require(got.shape == want.shape, f"{name} {which}: shape {tuple(got.shape)}")
            require(bool(torch.isfinite(got).all()), f"{name} non-finite ({which})")
            errs[which] = rel_err(got, want)
            require(errs[which][1] <= KERNEL_RTOL,
                    f"{name} {which}: kernel against plain rel err {errs[which][1]:.3e}")
        kernel, plain = case["run"]
        args = case["inputs"]["main"]
        require(torch.equal(kernel(*args), kernel(*args)),
                f"{name}: two runs on the same inputs differ")
        kernel, plain = case.get("timed", case["run"])  # the entries as the path calls them
        ms = device_ms(torch, lambda: kernel(*args), 200)
        plain_ms = device_ms(torch, lambda: plain(*args), 200)
        lib_ms = None if "library" not in case else device_ms(torch, case["library"], 200)
        bound_ms, bound_by = bound(case["cost"])
        results[name] = dict(max_abs_err=errs["main"][0],
                             ragged_max_abs_err=max(e[0] for w, e in errs.items() if w != "main"),
                             ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bound_ms, bound_by=bound_by, shape=case["shape"])
        log(f"  {name:24s} {case['shape']}: err {errs['main'][0]:.3e} ("
            + ", ".join(f"{w} {e[0]:.3e}" for w, e in errs.items() if w != "main")
            + f"), kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, library "
            f"{'-' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'}, "
            f"bound {bound_ms * 1e3:.3f} us ({bound_by})")
    results["ell_grad_update_prefetch_fold"].update(
        replaced_launches=replaced, replaced_kernel_ms=replaced_us * 1e-3,
        profiled_kernel_ms=fused_us * 1e-3)
    results["ell_grad_update_fused"].update(
        replaced_launches=route["kernel_launches"] / 20,
        replaced_kernel_ms=route["kernel_us"] / 20 * 1e-3,
        profiled_kernel_ms=fused_one["kernel_us"] / 20 * 1e-3, crossover=crossover,
        kdda_width=wide)
    results["ell_margins_prefetch_coeff"].update(replaced_launches=4,
                                                 replaced_ms=margins_then_where_ms)
    results["ell_margins_coeff"].update(replaced_launches=4, replaced_ms=sweep_then_where_ms)
    return results


def fused_at_kdda_width(torch, S, ops, lam, gen, dev, m=10, k=36, d=20216830) -> dict:
    """The fused half-step at kdda's shape (ten nodes of one 36-entry row,
    d = 20,216,830, columns Zipf-skewed at 1.25, repeats kept), where each
    block folds a run of tiles: at the minibatch's bound and 3 under it, bit
    for bit the map + ell_margins_prefetch_coeff + ell_grad_update_prefetch_
    fold chain, and within ``KERNEL_RTOL`` the map + the plain versions of
    that pair (which hold the two CUDA entries at this width too); and its
    device time a call (CUDA events) beside its bound, W read and W_half
    written once at 3.35 TB/s (482.8 us)."""
    blk_d = 128
    n_d = -(-d // blk_d)
    u = torch.rand(m, 1, k, generator=gen, device=dev, dtype=torch.float64)
    cols = torch.clamp(u.pow(-4.0) - 1, max=d - 1).to(torch.int32)  # P(col >= r) ~ r^-0.25
    vals = torch.rand(m, 1, k, generator=gen, device=dev)
    vals = vals / torch.linalg.vector_norm(vals, dim=-1, keepdim=True)
    y = torch.where(torch.rand(m, 1, generator=gen, device=dev) < 0.5, -1.0, 1.0)
    W = 3 * torch.randn(m, d, generator=gen, device=dev)  # some rows violate, some not
    scal = ops.step_scalars(lam, 1000, 1)
    bound_blocks = max(len(torch.unique(c // blk_d)) for c in cols)
    require(bound_blocks > 3, f"kdda-width minibatch spans {bound_blocks} blocks only")

    def fused(cap):
        return S.ell_grad_update_fused(cols, vals, W, y, scal, blk_d=blk_d, n_d_blocks=n_d,
                                       n_blocks_max=cap)

    def chain(cap):
        b_ = ops.ell_block_map(cols, vals, blk_d=blk_d, n_d_blocks=n_d, n_blocks_max=cap)
        _, cf_ = S.ell_margins_prefetch_coeff(cols, vals, W, y, b_, blk_d=blk_d, n_d_blocks=n_d)
        return S.ell_grad_update_prefetch_fold(cols, vals, cf_, b_, W, scal, blk_d=blk_d,
                                               n_d_blocks=n_d)

    def plain(cap):
        b_ = ops.ell_block_map(cols, vals, blk_d=blk_d, n_d_blocks=n_d, n_blocks_max=cap)
        _, cf_ = S.ell_margins_prefetch_coeff_plain(cols, vals, W, y, b_, blk_d=blk_d,
                                                    n_d_blocks=n_d)
        return S.ell_grad_update_prefetch_fold_plain(cols, vals, cf_, b_, W, scal, blk_d=blk_d,
                                                     n_d_blocks=n_d)
    plain_err = 0.0
    for cap in (bound_blocks, bound_blocks - 3):
        got = fused(cap)
        require(S.ell_grad_update_fused.tiles_per_block > 1,
                f"ell_grad_update_fused at d = {d} folds one tile a block")
        require(torch.equal(got, chain(cap)), f"ell_grad_update_fused at d = {d}, cap {cap}: not "
                "the map + ell_margins_prefetch_coeff + ell_grad_update_prefetch_fold bit for bit")
        err = rel_err(got, plain(cap))[1]
        require(err <= KERNEL_RTOL, f"ell_grad_update_fused at d = {d}, cap {cap}: rel err "
                f"{err:.3e} against the map + the plain pair (> {KERNEL_RTOL})")
        plain_err = max(plain_err, err)
        del got
    ms = device_ms(torch, lambda: fused(bound_blocks), 30)
    bound_ms, bound_by = bound(ops.launch_cost("ell_grad_update_fused", m=m, B=1, k=k, d=d))
    row = dict(shape=f"cols ({m}, 1, {k}), W ({m}, {d}), map of {bound_blocks} blocks", ms=ms,
               bound_ms=bound_ms, bound_by=bound_by,
               tiles_per_block=S.ell_grad_update_fused.tiles_per_block, plain_rel_err=plain_err)
    log(f"  ell_grad_update_fused at kdda's width, {row['shape']}: the chain's bits at the bound "
        f"and 3 under it, the plain pair's within {plain_err:.3e}, "
        f"{row['tiles_per_block']} tiles a block, kernel {ms * 1e3:.1f} us, "
        f"bound {bound_ms * 1e3:.1f} us ({bound_by})")
    return row


def fused_crossover(torch, S, ops, ccat, lam, dev, Bs=(1, 2, 4, 8, 16, 32, 64)) -> list:
    """The prefetch half-step (no projection) as ``ops.ell_fleet_half_step``
    calls it, the fused entry, and as the map and pair it replaces, at CCAT
    minibatches of B in ``Bs``: wall us a call (200 calls, then a sync: what
    a host-paced loop pays) and kernel us a call (torch.profiler, 20 calls).
    Each block's redundant map and margins grow with B, so the fused
    entry's kernel time passes the pair's at some B; its wall time, what the
    paper's runs pay, need not."""
    parts, y_parts, n_counts = ccat
    rows = []
    for B in Bs:
        cols, vals, y = ccat_minibatch(torch, parts, y_parts, n_counts, dev, seed=B, B=B)
        W = 0.01 * torch.randn(cols.shape[0], parts.d, device=dev)
        bound = parts.block_bound(B)
        _, blk_d, cap = ops.resolve_ell_schedule("prefetch", B=B, k=cols.shape[-1], d=parts.d,
                                                 n_blocks_max=bound)
        n_d = -(-parts.d // blk_d)
        scal = ops.step_scalars(lam, 1000, B)
        row = {"B": B, "entries": B * cols.shape[-1], "n_blocks_max": bound}
        outs = {}

        def fused():
            return S.ell_grad_update_fused(cols, vals, W, y, scal, blk_d=blk_d, n_d_blocks=n_d,
                                           n_blocks_max=cap)

        def pair():
            b_ = ops.ell_block_map(cols, vals, blk_d=blk_d, n_d_blocks=n_d, n_blocks_max=cap)
            _, cf_ = S.ell_margins_prefetch_coeff(cols, vals, W, y, b_, blk_d=blk_d,
                                                  n_d_blocks=n_d)
            return S.ell_grad_update_prefetch_fold(cols, vals, cf_, b_, W, scal, blk_d=blk_d,
                                                   n_d_blocks=n_d)
        for name, call in (("fused", fused), ("pair", pair)):
            for _ in range(5):
                call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                call()
            torch.cuda.synchronize()
            row[f"{name}_wall_us"] = (time.perf_counter() - t0) / 200 * 1e6
            prof = profile_iterations(torch, lambda: [call() for _ in range(20)])
            row[f"{name}_kernel_us"] = prof["kernel_us"] / 20
            row[f"{name}_launches"] = prof["kernel_launches"] / 20
            outs[name] = call()
        row["same_bits"] = bool(torch.equal(outs["fused"], outs["pair"]))
        log(f"    B {B:3d} ({row['entries']} entries, map {bound}): fused "
            f"{row['fused_wall_us']:.1f} us wall, {row['fused_kernel_us']:.2f} us kernels "
            f"in {row['fused_launches']:.0f} launches; map + pair {row['pair_wall_us']:.1f} "
            f"us wall, {row['pair_kernel_us']:.2f} us in {row['pair_launches']:.0f}; "
            f"same bits {row['same_bits']}")
        require(row["same_bits"], f"the fused entry and the map + pair differ at B = {B}")
        rows.append(row)
    return rows


def ccat_queries(X_te, ragged: bool) -> list:
    """The CCAT test rows as (cols, vals) queries of their live entries;
    ``ragged`` cuts the even ones to a third of their features, the ragged
    traffic of ``examples/serve_batched.py``."""
    out = []
    for i in range(X_te.shape[0]):
        live = X_te.vals[i] != 0
        nnz = int(live.sum())
        if ragged and i % 2 == 0:
            nnz = max(1, nnz // 3)
        out.append((X_te.cols[i][live][:nnz], X_te.vals[i][live][:nnz]))
    return out


def serve_queries(srv, buckets, queries, pad_query_planes) -> dict:
    """Route every query to the smallest bucket with k >= its nnz, pad each
    batch of ``rows`` with ``pad_query_planes`` and score it through
    ``srv.scorer_for()``, timing each batch on the host clock (the scores
    come back as numpy, so each batch ends in a device sync). Returns the
    scores and labels in query order, the batches, the buckets served and
    the host seconds."""
    score_fn = srv.scorer_for()
    routed = {}
    for qi, (c, _) in enumerate(queries):
        routed.setdefault(next(b for b in buckets if b.k >= len(c)), []).append(qi)
    scores = np.zeros(len(queries), np.float32)
    labels = np.zeros(len(queries), np.float32)
    batch_s = []
    for b, ids in routed.items():
        for start in range(0, len(ids), b.rows):
            chunk = ids[start:start + b.rows]
            t0 = time.perf_counter()
            cols, vals = pad_query_planes([queries[i] for i in chunk], b.rows, b.k)
            sc, lb = score_fn(b, cols, vals)
            batch_s.append(time.perf_counter() - t0)
            scores[chunk], labels[chunk] = sc[:len(chunk)], lb[:len(chunk)]
    return {"scores": scores, "labels": labels, "batches": len(batch_s),
            "buckets": sorted(b.k for b in routed), "seconds": sum(batch_s),
            "batch_ms": 1e3 * sum(batch_s) / len(batch_s)}


def phase_serving_kernel(torch, P, ops, serve, formats, ds_c, parts_c, gen, dev) -> dict:
    """``ell_scores_prefetch`` against its plain version at the sparse
    serving path's shape (a bucket batch of real CCAT test queries with the
    bucket's calibrated map), at C = 4 with tied classes and pad rows, at
    C = 20 (past a tile of 4 classes), at k = 600 (in waves, the map every
    block of d), with k = 0 widened through ``ops.ell_predict``, with a
    device map one slot short and with NaN rows; twice on the same inputs,
    bit for bit; times at the main shape, beside one ``embedding_bag`` call
    on the same planes. Returns the kernel's row and the calibrated
    buckets."""
    d, blk = ds_c.X_test.shape[1], formats.DEFAULT_BUCKET_BLK_D
    nd = -(-d // blk)
    k_max = ds_c.X_test.k_max
    buckets = serve.calibrate_buckets(
        serve.bucket_ladder(k_max, rows=SERVE_ROWS, min_k=SERVE_MIN_K, d=d),
        parts_c.cols.reshape(-1, k_max)[:SERVE_SAMPLE], parts_c.vals.reshape(-1, k_max)[:SERVE_SAMPLE], d)
    top = buckets[-1]
    queries = ccat_queries(ds_c.X_test, ragged=False)[:top.rows]
    cols_np, vals_np = formats.pad_query_planes(queries, top.rows, top.k)
    bm = formats.block_map(cols_np[None], vals_np[None], blk, nd, top.n_blocks_max)[0]
    cols, vals = torch.from_numpy(cols_np).to(dev), torch.from_numpy(vals_np).to(dev)
    bids = torch.from_numpy(bm).to(dev)
    W1 = torch.randn(1, d, generator=gen, device=dev)
    W4 = torch.randn(4, d, generator=gen, device=dev)
    W4[3] = W4[0]  # classes 0 and 3 tie on every row: first occurrence wins
    cols_pad, vals_pad = cols.clone(), vals.clone()
    cols_pad[-2:], vals_pad[-2:] = 0, 0.0  # two pad rows
    W20 = torch.randn(20, d, generator=gen, device=dev)
    W20[19] = W20[0]  # classes 0 and 19 tie, in different class tiles
    # waves: 3 rows of 600 entries, pad entries past row 1's first wave
    kcols = torch.randint(0, d, (3, 600), generator=gen, device=dev, dtype=torch.int32)
    kvals = torch.randn(3, 600, generator=gen, device=dev) / 600 ** 0.5
    kcols[1, 520:], kvals[1, 520:] = 0, 0.0
    kbids = ops.ell_block_map(kcols[None], kvals[None], blk_d=blk, n_d_blocks=nd,
                              n_blocks_max=nd)[0]
    live = int((bids < nd).sum())
    short = ops.ell_block_map(cols[None], vals[None], blk_d=blk, n_d_blocks=nd,
                              n_blocks_max=live - 1)[0]

    def kernel(c, v, W, b):
        return P.ell_scores_prefetch(c, v, W, b, blk_d=blk, n_d_blocks=nd, n_classes=W.shape[0])

    def plain(c, v, W, b):
        return P.ell_scores_prefetch_plain(c, v, W, b, blk_d=blk, n_d_blocks=nd,
                                           n_classes=W.shape[0])
    inputs = {"main": (cols, vals, W1, bids), "tied_pad": (cols_pad, vals_pad, W4, bids),
              "classes20": (cols_pad, vals_pad, W20, bids), "k600": (kcols, kvals, W4, kbids),
              "undersized": (cols, vals, W4, short)}
    errs = {}
    for which, args in inputs.items():
        (got, got_l), (want, want_l) = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        require(got.shape == want.shape and got_l.dtype == torch.int32,
                f"ell_scores_prefetch {which}: shapes {tuple(got.shape)} {got_l.dtype}")
        require(bool(torch.isfinite(got).all()), f"ell_scores_prefetch non-finite ({which})")
        errs[which] = rel_err(got, want)
        require(errs[which][1] <= KERNEL_RTOL,
                f"ell_scores_prefetch {which}: kernel against plain rel err {errs[which][1]:.3e}")
        require(torch.equal(got_l.long(), torch.argmax(got, dim=1)),
                f"ell_scores_prefetch argmax disagrees ({which})")
    for which, last in (("tied_pad", 3), ("classes20", 19)):
        _, l_tp = kernel(*inputs[which])
        require(not torch.any(l_tp == last), f"ell_scores_prefetch {which}: tie not first occurrence")
        require(bool((l_tp[-2:] == 0).all()), f"ell_scores_prefetch {which}: pad rows not class 0")
    full = plain(cols, vals, W4, bids)[0]
    require(not torch.allclose(full, plain(*inputs["undersized"])[0]),
            "the undersized serving map dropped no entry")
    # k = 0 through the dispatch layer: widened to one inert entry, scores 0, labels +1
    empty = torch.zeros((top.rows, 0), dtype=torch.int32, device=dev)
    s0, l0 = ops.ell_predict(W1[0], empty, empty.float())
    s0_cpu, l0_cpu = ops.ell_predict(W1[0].cpu(), empty.cpu(), empty.float().cpu())
    require(torch.equal(s0.cpu(), s0_cpu) and torch.equal(l0.cpu(), l0_cpu)
            and not bool(s0.any()) and bool((l0 == 1.0).all()), "ell_predict at k = 0")
    # NaN rows: a NaN value (every class NaN) and an infinite value against a
    # zero weight of class 1 (class 1 NaN), each at a live entry
    live_rows = torch.nonzero(vals[:, 0] != 0).flatten()[:2].tolist()
    require(len(live_rows) == 2, "fewer than two queries with a live first entry")
    vals_n, W4n = vals.clone(), W4.clone()
    vals_n[live_rows[0], 0] = float("nan")
    vals_n[live_rows[1], 0] = float("inf")
    W4n[1, cols[live_rows[1], 0]] = 0.0
    check_nan_labels(torch, "ell_scores_prefetch", kernel(cols, vals_n, W4n, bids),
                     plain(cols, vals_n, W4n, bids), live_rows, P.nan_label(4), 4)
    for which in ("main", "classes20", "k600"):
        first, again = kernel(*inputs[which]), kernel(*inputs[which])
        require(torch.equal(first[0], again[0]) and torch.equal(first[1], again[1]),
                f"ell_scores_prefetch {which}: two runs on the same inputs differ")
    W_t = W1.t().contiguous()  # the library call's (d, C) weight, made outside the timing

    def library():
        return torch.nn.functional.embedding_bag(cols, W_t, per_sample_weights=vals, mode="sum")
    require(rel_err(library(), plain(*inputs["main"])[0])[1] <= KERNEL_RTOL,
            "embedding_bag does not compute the scores")
    args = inputs["main"]
    ms = device_ms(torch, lambda: kernel(*args), 200)
    plain_ms = device_ms(torch, lambda: plain(*args), 200)
    lib_ms = device_ms(torch, library, 200)
    cost = ops.launch_cost("ell_predict", B=top.rows, k=top.k, C=1, n_blocks_max=top.n_blocks_max,
                           blk_d=blk)
    bound_ms, bound_by = bound(cost)
    shape = f"cols ({top.rows}, {top.k}), W (1, {d}), map ({top.n_blocks_max},)"
    log(f"  {'ell_scores_prefetch':24s} {shape}: err {errs['main'][0]:.3e} ("
        + ", ".join(f"{w} {e[0]:.3e}" for w, e in errs.items() if w != "main")
        + f"; NaN rows labelled {P.nan_label(4)}), kernel {ms * 1e3:.2f} us, plain "
        f"{plain_ms * 1e3:.2f} us, library "
        f"{lib_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.4f} us ({bound_by}); buckets "
        + ", ".join(f"(rows {b.rows}, k {b.k}, cap {b.n_blocks_max})" for b in buckets))
    return {"ell_scores_prefetch": dict(
        max_abs_err=errs["main"][0], ragged_max_abs_err=max(e[0] for w, e in errs.items() if w != "main"),
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
        shape=shape)}, buckets


def phase_transformer_kernels(torch, FA, FO, RG, RO, WK, WO, gen, dev) -> dict:
    """``flash_attention``, ``rglru_scan`` and ``wkv_scan`` against their
    plain versions at the transformer path's shapes and at ragged ones,
    twice on the same inputs (bit for bit), with the times of the kernel,
    the plain version and, for attention, one
    ``scaled_dot_product_attention`` call (timed here only; the port never
    calls it)."""
    F = torch.nn.functional
    results = {}

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=dev)

    # flash_attention: (B, S, H, Hkv, dh, causal, window, dtype)
    attn_cases = {
        "main": (PREFILL_BATCH, PREFILL_LEN, 16, 1, 256, True, 2048, torch.float32),
        "llama3_8b": (1, 2048, 32, 8, 128, True, 0, torch.float32),
        "s1000": (2, 1000, 16, 1, 256, True, 256, torch.float32),
        "wide_window": (1, 1000, 16, 1, 256, True, 2048, torch.float32),
        "non_causal": (1, 1000, 8, 2, 128, False, 0, torch.float32),
        "bf16": (PREFILL_BATCH, PREFILL_LEN, 16, 1, 256, True, 2048, torch.bfloat16),
        # head sizes between the instantiations (padded to 96 and 64): hubert-
        # xlarge's 80, and 33, which fills no 16-byte chunk (element loads)
        "dh80": (2, 300, 4, 2, 80, True, 0, torch.float32),
        "dh80_bf16": (2, 300, 4, 2, 80, True, 0, torch.bfloat16),
        "dh33": (1, 300, 4, 1, 33, True, 64, torch.float32),
        "dh33_bf16": (1, 300, 4, 1, 33, False, 0, torch.bfloat16),
        # phase 26's examples as they call it: train_100m (all-reduce, and a
        # replica's half of the batch under gossip at G = 2) and
        # gossip_vs_allreduce (all-reduce, and a replica's quarter at G = 4)
        **EXAMPLE_ATTN,
    }
    errs, main = {}, None
    for which, (b, s, h, hkv, dh, causal, window, dt) in attn_cases.items():
        dt = getattr(torch, dt) if isinstance(dt, str) else dt
        q = randn(b, s, h, dh).to(dt)
        k, v = randn(b, s, hkv, dh).to(dt), randn(b, s, hkv, dh).to(dt)
        got = FA.flash_attention(q, k, v, causal=causal, window=window)
        want = FA.flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        require(got.shape == want.shape and got.dtype == dt, f"flash_attention {which}: shape")
        require(bool(torch.isfinite(got).all()), f"flash_attention non-finite ({which})")
        errs[which] = rel_err(got.float(), want.float())
        limit = BF16_ATOL if dt == torch.bfloat16 else KERNEL_RTOL
        err = errs[which][0] if dt == torch.bfloat16 else errs[which][1]
        require(err <= limit, f"flash_attention {which}: kernel against plain err {err:.3e}")
        if dt == torch.bfloat16:
            # outputs average about 2k unit values, so 2e-2 alone is half a
            # typical output; hold each element to its own scale as well
            excess = float(((got.float() - want.float()).abs()
                            - BF16_ULP * want.float().abs()).max())
            require(excess <= KERNEL_RTOL, f"flash_attention {which}: kernel against plain "
                    f"exceeds one bf16 ulp by {excess:.3e}")
        require(torch.equal(got, FA.flash_attention(q, k, v, causal=causal, window=window)),
                f"flash_attention {which}: two runs on the same inputs differ")
        if which == "main":
            main = (q, k, v, causal, window)
    q, k, v, causal, window = main
    b, s, h, dh = q.shape
    # the library call: SDPA in its (B, H, S, dh) layout with the band as a
    # boolean mask, made outside the timing
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    band = FA.band_mask(s, s, causal=causal, window=window, device=dev)

    # every SDPA backend that takes this masked f32 call, timed; the fastest
    # is the library call
    from torch.nn.attention import SDPBackend, sdpa_kernel
    plain_out = FA.flash_attention_plain(q, k, v, causal=causal, window=window)
    backends = {}
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def sdpa(be=be):
            with sdpa_kernel([be]):
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band, enable_gqa=True)
        try:
            out = sdpa()
        except RuntimeError as e:  # the backend refuses the call's dtype, mask or heads
            log(f"  sdpa {be.name}: refused ({str(e).splitlines()[0][:100]})")
            continue
        require(rel_err(out.transpose(1, 2), plain_out)[1] <= KERNEL_RTOL,
                f"scaled_dot_product_attention ({be.name}) does not compute the attention")
        del out
        backends[be.name] = device_ms(torch, sdpa, 3)
        log(f"  sdpa {be.name}: {backends[be.name]:.4f} ms")
    require(bool(backends), "no SDPA backend takes the masked f32 call")
    lib_name = min(backends, key=backends.get)
    del plain_out
    cost = FO.launch_cost(B=b, S=s, H=h, Hkv=k.shape[2], dh=dh, causal=causal, window=window)
    rows = {"flash_attention": dict(
        errs=errs, cost=cost, n=(20, 3, 0), shape=f"q ({b}, {s}, {h}, {dh}), kv heads "
        f"{k.shape[2]}, causal, window {window}", library=None,
        library_ms=backends[lib_name], library_backend=lib_name, route=ATTN_F32_SPLIT,
        kernel=lambda: FA.flash_attention(q, k, v, causal=causal, window=window),
        plain=lambda: FA.flash_attention_plain(q, k, v, causal=causal, window=window))}
    qb, kb_, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    bf16_ms = device_ms(torch, lambda: FA.flash_attention(qb, kb_, vb, causal=causal,
                                                          window=window), 20)
    bf16_bound_ms = bound(cost, ATTN_BF16_ROUTE[1])[0]
    bf16_mma_bound_ms = bound(cost, BF16_FLOPS_PER_S)[0]
    log(f"  flash_attention bf16 at the path shape: kernel {bf16_ms:.4f} ms, bound "
        f"{bf16_bound_ms:.4f} ms ({ATTN_BF16_ROUTE[0]}; {bf16_mma_bound_ms:.4f} ms on bf16 MMA)")
    del qb, kb_, vb

    # rglru_scan: a in (0.8, 0.999) as the gates give it near 1, b normal;
    # bit for bit the plain version (the same carry order, each step a
    # multiply then an add), at the path shape, D = 130 (rows of 520 bytes:
    # 4-byte copies), D = 4100 with S off the stage size, and S = 1
    scan_errs, main = {}, None
    for which, (B, S, D) in {"main": (PREFILL_BATCH, PREFILL_LEN, 4096), "tiny": (1, 17, 130),
                             "ragged": (3, 100, 4100), "s1": (2, 1, 4096),
                             "s1_tiny": (1, 1, 130)}.items():
        a = 0.8 + 0.199 * torch.rand(B, S, D, generator=gen, device=dev)
        bb = randn(B, S, D)
        got, want = RG.rglru_scan(a, bb), RG.rglru_scan_plain(a, bb)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got).all()), f"rglru_scan non-finite ({which})")
        scan_errs[which] = rel_err(got, want)
        require(torch.equal(got, want), f"rglru_scan {which}: not the plain version bit for bit "
                f"(max diff {scan_errs[which][0]:.3e})")
        require(torch.equal(got, RG.rglru_scan(a, bb)), f"rglru_scan {which}: reruns differ")
        if which == "main":
            main = (a, bb)
    a, bb = main
    rows["rglru_scan"] = dict(
        errs=scan_errs, cost=RO.launch_cost(B=a.shape[0], S=a.shape[1], D=a.shape[2]),
        n=(50, 1, 0), shape=f"a, b ({a.shape[0]}, {a.shape[1]}, {a.shape[2]})", library=None,
        kernel=lambda: RG.rglru_scan(a, bb), plain=lambda: RG.rglru_scan_plain(a, bb))

    # wkv_scan: r, k, v as 0.3 N(0, 1), w in (0.8, 0.999), u 0.1 N(0, 1); the
    # path shape, head sizes n 16 .. 256 (24: reduced rwkv6 configs; 30: no
    # whole 16-byte chunks, element loads) at T of 1, 33 and 4097 with one
    # head, and a few heads and batches
    wkv_cases = {"main": (PREFILL_BATCH, PREFILL_LEN, 40, 64), "tiny": (1, 33, 3, 16),
                 "ragged": (2, 50, 2, 32), "n30": (2, 33, 3, 30)}
    wkv_cases.update({f"n{n}_t{T}": (1, T, 1, n) for n in (16, 24, 64, 80, 256)
                      for T in (1, 33, PREFILL_LEN + 1)})
    wkv_errs, main = {}, None
    for which, (B, S, H, n) in wkv_cases.items():
        r, kk, vv = (randn(B, S, H, n, scale=0.3) for _ in range(3))
        w = 0.8 + 0.199 * torch.rand(B, S, H, n, generator=gen, device=dev)
        u = randn(H, n, scale=0.1)
        got, want = WK.wkv_scan(r, kk, vv, w, u), WK.wkv_scan_plain(r, kk, vv, w, u)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got).all()), f"wkv_scan non-finite ({which})")
        wkv_errs[which] = rel_err(got, want)
        require(wkv_errs[which][1] <= KERNEL_RTOL,
                f"wkv_scan {which}: kernel against plain rel err {wkv_errs[which][1]:.3e}")
        require(torch.equal(got, WK.wkv_scan(r, kk, vv, w, u)), f"wkv_scan {which}: reruns differ")
        if which == "main":
            main = (r, kk, vv, w, u)
    r, kk, vv, w, u = main
    rows["wkv_scan"] = dict(
        errs=wkv_errs, cost=WO.launch_cost(B=r.shape[0], S=r.shape[1], H=r.shape[2], n=r.shape[3]),
        n=(20, 1, 0), shape=f"r, k, v, w ({', '.join(map(str, r.shape))}), u ({r.shape[2]}, "
        f"{r.shape[3]})", library=None,
        kernel=lambda: WK.wkv_scan(r, kk, vv, w, u), plain=lambda: WK.wkv_scan_plain(r, kk, vv, w, u))

    for name, row in rows.items():
        n_kernel, n_plain, n_lib = row["n"]
        ms = device_ms(torch, row["kernel"], n_kernel)
        plain_ms = device_ms(torch, row["plain"], n_plain)
        lib_ms = (row.get("library_ms") if row["library"] is None
                  else device_ms(torch, row["library"], n_lib))
        route = row.get("route")
        bound_ms, bound_by = bound(row["cost"], *([] if route is None else [route[1]]))
        e = row["errs"]
        results[name] = dict(max_abs_err=e["main"][0],
                             ragged_max_abs_err=max(v[0] for w_, v in e.items()
                                                    if w_ != "main" and "bf16" not in w_),
                             ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                             bound_by=bound_by, shape=row["shape"])
        if route is not None:
            results[name].update(bound_route=route[0], library_backend=row["library_backend"],
                                 bf16_ms=bf16_ms, bf16_bound_ms=bf16_bound_ms,
                                 bf16_bound_route=ATTN_BF16_ROUTE[0],
                                 bf16_mma_bound_ms=bf16_mma_bound_ms)
        if "bf16" in e:
            results[name]["bf16_max_abs_err"] = max(v[0] for w_, v in e.items() if "bf16" in w_)
        log(f"  {name:16s} {row['shape']}: err "
            + ", ".join(f"{w_} {v[0]:.3e}" for w_, v in e.items())
            + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound {bound_ms:.4f} ms ({bound_by}"
            + ("" if route is None else f", {route[0]}") + ")")
    return results


def free_cuda(torch) -> None:
    """Return the caching allocator's free blocks to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def prefill_phase(torch, model, prefill, tokens, X, expect: dict, K, P, S) -> dict:
    """One warm-up forward over a short prefix, then ``prefill`` over
    ``tokens`` with every launch counted (each kernel of ``expect`` launched
    that many times, every other kernel never), the logits finite, and a
    profiled second forward for the device's busy share."""
    V = model.cfg.vocab_size
    prefill({"tokens": tokens[:, :64]})  # warm-up: cuBLAS, the kernels' libraries
    torch.cuda.synchronize()
    reset_counts(K, P, S, X)
    t0 = time.perf_counter()
    logits = prefill({"tokens": tokens})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    got = counts(K, P, S, X)
    require(tuple(logits.shape) == (*tokens.shape, V) and logits.dtype == torch.float32,
            f"prefill logits shape {tuple(logits.shape)} {logits.dtype}")
    require(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    del logits
    for name, n in got.items():
        want = expect.get(name, 0)
        require(n == want, f"{name} launched {n} times in one {model.cfg.name} forward, want {want}")
    prof = profile_iterations(torch, lambda: prefill({"tokens": tokens}))
    busy = prof["device_us"] / (prefill_s * 1e6)
    n_tok = tokens.numel()
    log(f"  {model.cfg.name}: prefill {tuple(tokens.shape)} in {prefill_s:.3f} s "
        f"({n_tok / prefill_s:.1f} tokens/s), launches {got}; profile: device "
        f"{prof['device_us'] / 1e3:.1f} ms against {prefill_s * 1e3:.1f} ms unprofiled: busy {busy:.3f}")
    for key, count, us in prof["top_device"]:
        log(f"    device {us / 1e3:9.2f} ms  x{count:<6d} {key}")
    return {"prefill_s": prefill_s, "tokens": n_tok, "tokens_per_s": n_tok / prefill_s,
            "device_ms": prof["device_us"] / 1e3, "device_busy_share": busy,
            "launches": {k: v for k, v in got.items() if k in expect}}


def serve_phase(torch, model, step, gen, X, K, P, S, serve_mod) -> dict:
    """``SERVE_BATCH`` requests of ``SERVE_PROMPT`` tokens, prefilled into
    the cache token by token and decoded greedily for ``SERVE_GEN`` tokens
    through ``launch/serve.py``; tokens in the vocabulary, no kernel
    launched."""
    V = model.cfg.vocab_size
    dev = model.device
    prompt = torch.randint(0, V, (SERVE_BATCH, SERVE_PROMPT), generator=gen, device=dev)
    serve_mod.greedy_generate(model, prompt[:, :2], 1, step)  # warm-up
    reset_counts(K, P, S, X)
    out = serve_mod.greedy_generate(model, prompt, SERVE_GEN, step)
    got = counts(K, P, S, X)
    toks = out["tokens"]
    require(tuple(toks.shape) == (SERVE_BATCH, SERVE_GEN), f"served tokens {tuple(toks.shape)}")
    require(bool(((toks >= 0) & (toks < V)).all()), "a served token lies outside the vocabulary")
    require(not any(got.values()), f"serving launched kernels: {got}")
    ms_tok = 1e3 * out["decode_s"] / SERVE_GEN
    ms_prompt = 1e3 * out["prefill_s"] / SERVE_PROMPT
    # the device's share of a decode step: 4 profiled steps of the same
    # requests (2 prompt tokens, 2 generated) against the unprofiled rate
    steps = 4
    prof = profile_iterations(torch, lambda: serve_mod.greedy_generate(model, prompt[:, :2], 2,
                                                                       step))
    device_ms = prof["device_us"] / 1e3 / steps
    busy = device_ms / ms_tok
    log(f"  {model.cfg.name}: {SERVE_BATCH} requests, prompt {SERVE_PROMPT} fed in "
        f"{out['prefill_s']:.3f} s ({ms_prompt:.2f} ms/step), {SERVE_GEN} tokens in "
        f"{out['decode_s']:.3f} s ({ms_tok:.2f} ms/token, "
        f"{SERVE_BATCH * SERVE_GEN / out['decode_s']:.1f} tokens/s); device {device_ms:.2f} "
        f"ms/step, busy {busy:.3f}; row 0 {toks[0].tolist()}")
    for key, count, us in prof["top_device"][:5]:
        log(f"    device {us / 1e3 / steps:9.3f} ms/step  x{count:<6d} {key}")
    for key, count, us in prof["top_host"][:5]:
        log(f"    host   {us / 1e3 / steps:9.3f} ms/step  x{count:<6d} {key}")
    return {"requests": SERVE_BATCH, "prompt": SERVE_PROMPT, "generated": SERVE_GEN,
            "prompt_ms_per_step": ms_prompt, "decode_ms_per_token": ms_tok,
            "decode_tokens_per_s": SERVE_BATCH * SERVE_GEN / out["decode_s"],
            "device_ms_per_step": device_ms, "device_busy_share": busy}


def decode_against_prefill(torch, model, prefill, step, tokens, hold: bool = True) -> dict:
    """The forward's logits (through the kernels) against the decode step's
    (plain), every position, one step at a time, the worst excess over
    ``DECODE_ATOL + DECODE_RTOL |forward|`` kept on the card; held to
    ``DECODE_ATOL`` unless ``hold`` is false (then only reported)."""
    full = prefill({"tokens": tokens})
    cache = model.init_cache(tokens.shape[0], tokens.shape[1], torch.float32)
    excess = torch.zeros((), device=tokens.device)
    worst = torch.zeros((), device=tokens.device)
    t0 = time.perf_counter()
    for t in range(tokens.shape[1]):
        logits, cache = step(tokens[:, t:t + 1], cache, t)
        diff = (logits[:, 0] - full[:, t]).abs()
        excess = torch.maximum(excess, (diff - DECODE_RTOL * full[:, t].abs()).max())
        worst = torch.maximum(worst, diff.max())
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    excess, worst = float(excess), float(worst)
    log(f"  {model.cfg.name} ({model.cfg.n_layers} layers): decode against prefill over "
        f"{tuple(tokens.shape)}: max abs err {worst:.3e}, worst excess over rel {DECODE_RTOL} "
        f"{excess:.3e} ({f'<= {DECODE_ATOL}' if hold else 'reported, not held'}); "
        f"{tokens.shape[1]} steps in {decode_s:.2f} s ({1e3 * decode_s / tokens.shape[1]:.2f} ms/step)")
    require(not hold or excess <= DECODE_ATOL, f"{model.cfg.name}: decode differs from prefill "
            f"by {excess:.3e} beyond {DECODE_RTOL} relative")
    return {"tokens": list(tokens.shape), "layers": model.cfg.n_layers, "max_abs_err": worst,
            "excess_over_rtol": excess, "ms_per_step": 1e3 * decode_s / tokens.shape[1]}


def phase_models(torch, get_config, Model, make_prefill_step, make_serve_step, serve_lm,
                 X, K, P, S, dev) -> dict:
    """Phases 11-14: recurrentgemma-9b and rwkv6-3b at full width, each
    model freed before the next is drawn."""
    phase_s, t0_phase = {}, time.perf_counter()

    def lap(name):
        nonlocal t0_phase
        phase_s[name] = time.perf_counter() - t0_phase
        t0_phase = time.perf_counter()

    log("phase 11: prefill, recurrentgemma-9b at full width and depth")
    rg_cfg = get_config("recurrentgemma-9b")
    gen_m = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    model = Model(rg_cfg, device=dev).init(gen_m)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {rg_cfg.name}: {rg_cfg.n_layers} layers, d_model {rg_cfg.d_model}, {n_params:,} "
        f"parameters ({4 * n_params / 1e9:.1f} GB f32) drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    rg_tokens = torch.randint(0, rg_cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN), generator=gen_m,
                              device=dev)
    prefill = make_prefill_step(model)
    n_attn = sum(blk.kind == "local_attn" for blk in model.blocks)
    n_rglru = sum(blk.kind == "rglru" for blk in model.blocks)
    require((n_attn, n_rglru) == (12, 26), f"recurrentgemma-9b has {n_attn} attention and "
            f"{n_rglru} RG-LRU layers")
    rg_prefill = prefill_phase(torch, model, prefill, rg_tokens, X,
                               {"flash_attention": 12, "rglru_scan": 26}, K, P, S)
    rg_prefill["parameters"] = n_params

    lap("11")
    log("phase 12: serve, recurrentgemma-9b at full width and depth")
    step = make_serve_step(model)
    rg_serve = serve_phase(torch, model, step, gen_m, X, K, P, S, serve_lm)
    del model, prefill, step
    free_cuda(torch)

    lap("12")
    log("phase 13: decode against prefill, recurrentgemma-9b at full width, one cycle")
    model = Model(dataclasses.replace(rg_cfg, n_layers=len(rg_cfg.block_pattern)),
                  device=dev).init(gen_m)
    toks = torch.randint(0, rg_cfg.vocab_size, (PREFILL_BATCH, RG_DECODE_LEN), generator=gen_m,
                         device=dev)
    reset_counts(K, P, S, X)
    rg_decode = decode_against_prefill(torch, model, make_prefill_step(model),
                                       make_serve_step(model), toks)
    got = counts(K, P, S, X)
    require(got["flash_attention"] == 1 and got["rglru_scan"] == 2,
            f"one cycle's forward launched {got}")
    del model
    free_cuda(torch)

    lap("13")
    log("phase 14: rwkv6-3b at full width and depth: prefill, serve, decode against prefill")
    rw_cfg = get_config("rwkv6-3b")
    # a reduced rwkv6 first (d_model 96: heads of n = 24, which models/config.py
    # gives reduced configs) on the card against the same weights on the CPU
    red_cfg = rw_cfg.reduced(n_layers=2, d_model=96)
    model = Model(red_cfg, device=dev).init(gen_m)
    cpu_model = Model(red_cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    toks = torch.randint(0, red_cfg.vocab_size, (PREFILL_BATCH, REDUCED_RWKV_LEN), generator=gen_m,
                         device=dev)
    reset_counts(K, P, S, X)
    got = make_prefill_step(model)({"tokens": toks})
    torch.cuda.synchronize()
    red_counts = counts(K, P, S, X)
    red_err = float((got.cpu() - make_prefill_step(cpu_model)({"tokens": toks.cpu()})).abs().max())
    log(f"  {red_cfg.name} (d_model {red_cfg.d_model}, heads of {red_cfg.rwkv_head_dim}, "
        f"{red_cfg.n_layers} layers): prefill {tuple(toks.shape)} on the card against the CPU, "
        f"max abs err {red_err:.3e} (<= {REDUCED_RWKV_ATOL}), launches {red_counts}")
    require(red_cfg.rwkv_head_dim == 24, f"reduced rwkv6 heads of {red_cfg.rwkv_head_dim}")
    require(red_counts["wkv_scan"] == red_cfg.n_layers and
            sum(red_counts.values()) == red_cfg.n_layers,
            f"the reduced rwkv6 prefill launched {red_counts}")
    require(bool(torch.isfinite(got).all()) and red_err <= REDUCED_RWKV_ATOL,
            f"reduced rwkv6 prefill differs from the CPU by {red_err:.3e}")
    rw_reduced = {"d_model": red_cfg.d_model, "head_size": red_cfg.rwkv_head_dim,
                  "layers": red_cfg.n_layers, "tokens": list(toks.shape), "max_abs_err": red_err,
                  "wkv_scan_launches": red_counts["wkv_scan"]}
    del model, cpu_model, got
    t0 = time.perf_counter()
    model = Model(rw_cfg, device=dev).init(gen_m)
    torch.cuda.synchronize()
    n_params_rw = sum(p.numel() for p in model.parameters())
    log(f"  {rw_cfg.name}: {rw_cfg.n_layers} layers, d_model {rw_cfg.d_model}, {n_params_rw:,} "
        f"parameters drawn in {time.perf_counter() - t0:.1f} s")
    prefill, step = make_prefill_step(model), make_serve_step(model)
    rw_tokens = torch.randint(0, rw_cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN), generator=gen_m,
                              device=dev)
    rw_prefill = prefill_phase(torch, model, prefill, rw_tokens, X, {"wkv_scan": 32}, K, P, S)
    rw_prefill["parameters"] = n_params_rw
    rw_serve = serve_phase(torch, model, step, gen_m, X, K, P, S, serve_lm)
    rw_drift = decode_against_prefill(torch, model, prefill, step,
                                      rw_tokens[:, :RWKV_DRIFT_LEN].contiguous(), hold=False)
    del model, prefill, step
    free_cuda(torch)
    model = Model(dataclasses.replace(rw_cfg, n_layers=RWKV_CHECK_LAYERS), device=dev).init(gen_m)
    reset_counts(K, P, S, X)
    rw_decode = decode_against_prefill(torch, model, make_prefill_step(model),
                                       make_serve_step(model),
                                       rw_tokens[:, :RWKV_DECODE_LEN].contiguous())
    require(counts(K, P, S, X)["wkv_scan"] == RWKV_CHECK_LAYERS,
            "the decode check's forward did not run wkv_scan once a layer")
    del model
    free_cuda(torch)

    lap("14")
    log(f"  seconds per phase: {', '.join(f'{k}: {v:.1f}' for k, v in phase_s.items())}")
    return {"phase_s": phase_s,
            "recurrentgemma-9b": {"prefill": rg_prefill, "serve": rg_serve,
                                  "decode_vs_prefill": rg_decode},
            "rwkv6-3b": {"prefill": rw_prefill, "serve": rw_serve, "decode_vs_prefill": rw_decode,
                         "full_depth_drift": rw_drift, "reduced_prefill": rw_reduced},
            "decode_tolerance": {"atol": DECODE_ATOL, "rtol": DECODE_RTOL}}


def phase_c1_route(torch, ops, K, gadget_train, GadgetConfig, dev, reset, counts_of) -> dict:
    """Phase 15: the fused dense step one row above the fleet kernel's
    minibatch cap runs ``margins`` and ``grad_update``, one launch each for
    the fleet, held against the plain fleet step at ``C1_RTOL``; a short
    training run on that route held against the CPU at ``PATH_W_ATOL``; and
    the route timed beside the fused kernel and the plain step at smaller
    minibatches (where it crosses the plain step)."""
    B = K.MAX_FLEET_B + 1
    gen = torch.Generator(device=dev).manual_seed(15)
    Xc = torch.randn((N_NODES, C1_ROWS, C1_D), generator=gen, device=dev) / C1_D ** 0.5
    yc = torch.where(Xc @ torch.randn(C1_D, generator=gen, device=dev) >= 0, 1.0, -1.0)
    ids = torch.randint(0, C1_ROWS, (N_NODES, B), generator=gen, device=dev)
    rows = torch.arange(N_NODES, device=dev)[:, None]
    Xb, yb = Xc[rows, ids].contiguous(), yc[rows, ids].contiguous()
    W0 = 0.1 * torch.randn((N_NODES, C1_D), generator=gen, device=dev)
    lam, t = 1e-3, 3
    reset()
    got = ops.fleet_half_step(W0, Xb, yb, lam=lam, t=t, project=False)
    torch.cuda.synchronize()
    direct = counts_of()
    scal = ops.step_scalars(lam, t, B)
    want = K.fleet_half_step_plain(Xb, W0, yb, torch.ones(B, device=dev), scal)
    err, rel = rel_err(got, want)
    # reported: both float32 orders against the float64 step
    X64, W64, y64 = Xb.double(), W0.double(), yb.double()
    coeff64 = torch.where(y64 * torch.einsum("mbd,md->mb", X64, W64) < 1.0, y64, 0.0)
    want64 = (1.0 - scal[0]) * W64 + scal[1] * torch.einsum("mb,mbd->md", coeff64, X64)
    err64 = float((got.double() - want64).abs().max())
    plain_err64 = float((want.double() - want64).abs().max())
    one_row = float(scal[1] * Xb.abs().max())
    ms = device_ms(torch, lambda: ops.fleet_half_step(W0, Xb, yb, lam=lam, t=t, project=False),
                   20)
    plain_ms = device_ms(torch, lambda: K.fleet_half_step_plain(
        Xb, W0, yb, torch.ones(B, device=dev), ops.step_scalars(lam, t, B)), 20)
    cost = ops.launch_cost("fleet_half_step", m=N_NODES, B=B, d=C1_D)
    bound_ms, bound_by = bound(cost)
    log(f"  B = {B} (cap {K.MAX_FLEET_B}), X {tuple(Xb.shape)} ({Xb.numel() * 4 / 1e6:.1f} MB): "
        f"launches {launched(direct)}, against the plain version max abs err {err:.3e} (rel "
        f"{rel:.3e} <= {C1_RTOL}; one row moves W by up to {one_row:.3e}); against float64 "
        f"{err64:.3e} (the plain version {plain_err64:.3e}); {ms * 1e3:.2f} us "
        f"(plain {plain_ms * 1e3:.2f}, bound {bound_ms * 1e3:.2f} by {bound_by})")
    require_launches(direct, ops.HALF_STEP_KINDS["unfused"], 1, "the step above the cap")
    require(rel <= C1_RTOL, f"the routed step is {rel:.3e} from the plain version (rel)")
    cfg = GadgetConfig(lam=lam, batch_size=B, gossip_rounds=4, topology="random", epsilon=0.0,
                       check_every=C1_ITERS, max_iters=C1_ITERS, seed=0)
    reset()
    res = gadget_train(Xc, yc, cfg, device=dev)
    torch.cuda.synchronize()
    run = counts_of()
    res_cpu = gadget_train(Xc.cpu(), yc.cpu(), cfg, device="cpu")
    w_err = float((res.W.cpu() - res_cpu.W).abs().max())
    log(f"  {res.iters} fused iterations at B = {B}: launches {launched(run)}, W against the CPU "
        f"{w_err:.3e} (<= {PATH_W_ATOL})")
    require_launches(run, ops.HALF_STEP_KINDS["unfused"], C1_ITERS, "the routed training")
    require(w_err <= PATH_W_ATOL, f"the routed training's W is {w_err:.3e} from the CPU's")
    # where the route crosses the plain step: the same fleet at smaller B
    sweep = []
    for b in C1_SWEEP_B + (K.MAX_FLEET_B, B):
        Xs, ys, mask = Xb[:, :b].contiguous(), yb[:, :b].contiguous(), torch.ones(b, device=dev)
        sc = ops.step_scalars(lam, t, b)
        row = {"B": b, "route_ms": device_ms(
                   torch, lambda: ops.unfused_fleet_half_step(W0, Xs, ys, lam=lam, t=t,
                                                              project=False), 20),
               "plain_ms": device_ms(torch, lambda: K.fleet_half_step_plain(
                   Xs, W0, ys, mask, sc), 20),
               "fused_ms": (device_ms(torch, lambda: K.fleet_half_step(Xs, W0, ys, mask, sc), 20)
                            if b <= K.MAX_FLEET_B else None)}
        sweep.append(row)
        log(f"    B = {b}: route {row['route_ms'] * 1e3:.2f} us, plain "
            f"{row['plain_ms'] * 1e3:.2f}, fused "
            + ("-" if row["fused_ms"] is None else f"{row['fused_ms'] * 1e3:.2f}"))
    slower = [r["B"] for r in sweep if r["route_ms"] > r["plain_ms"]]
    log(f"  the route is slower than the plain step from B = "
        f"{min(slower) if slower else 'none of these'} on")
    return {"B": B, "cap": K.MAX_FLEET_B, "X_shape": list(Xb.shape), "max_abs_err": err,
            "rel_err": rel, "f64_err": err64, "plain_f64_err": plain_err64,
            "tolerance": {"rel": C1_RTOL, "train_w_atol": PATH_W_ATOL}, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "step_launches": {"margins": direct["margins"],
                                                    "grad_update": direct["grad_update"]},
            "train_iters": res.iters, "train_launches": {"margins": run["margins"],
                                                         "grad_update": run["grad_update"]},
            "cpu_w_err": w_err, "sweep": sweep,
            "route_slower_from_B": min(slower) if slower else None}


def phase_faults(torch, ops, core, gadget_train, cfg, data, dev, reset, counts_of) -> dict:
    """Phase 16: fault injection at reuters' full size with the paper's
    config: link mode through the whole run (quality, mass), message mode
    (mass leaks), a dead node with the per-node telemetry ring (frozen row,
    drop counts, telemetry on = off bit for bit), the faulted unfused path,
    the card against the CPU, and the profile with faults and without."""
    Xp, yp, n_counts, ds = data
    X_dev, y_dev = torch.from_numpy(Xp).to(dev), torch.from_numpy(yp).to(dev)
    Xte, yte = torch.from_numpy(ds.X_test).to(dev), torch.from_numpy(ds.y_test).to(dev)
    FaultPlan, TrainTelemetry = core.FaultPlan, core.TrainTelemetry
    kw = dict(n_counts=n_counts, device=dev)
    cfg_l = cfg._replace(faults=FaultPlan(drop_prob=FAULT_DROP_PROB, drop="link"))
    gadget_train(X_dev, y_dev, cfg_l._replace(max_iters=20, check_every=10), **kw)  # warm-up
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    res_l = gadget_train(X_dev, y_dev, cfg_l, **kw)
    torch.cuda.synchronize()
    link_s = time.perf_counter() - t0
    c_l = counts_of()
    _, pred = ops.dense_predict(res_l.w_consensus, Xte)
    acc = int((pred == yte).sum()) / len(yte)
    obj_l = float(res_l.objective_trace[-1])
    mass_dev = float(np.max(np.abs(res_l.mass_trace.astype(np.float64) - 1.0)))
    log(f"  link, drop_prob {FAULT_DROP_PROB}: {res_l.iters} iterations in {link_s:.3f} s "
        f"({res_l.iters / link_s:.1f} it/s), objective {obj_l:.4f}, test accuracy {acc:.4f}, "
        f"mass within {mass_dev:.3e} of 1, launches {launched(c_l)}")
    require(acc >= FAULT_MIN_ACCURACY, f"faulted accuracy {acc:.4f} < {FAULT_MIN_ACCURACY}")
    require(obj_l <= FAULT_MAX_OBJECTIVE, f"faulted objective {obj_l:.4f} > {FAULT_MAX_OBJECTIVE}")
    require(mass_dev <= LINK_MASS_ATOL, f"link-mode mass off 1 by {mass_dev:.3e}")
    require_launches(c_l, ops.HALF_STEP_KINDS["fused"], res_l.iters, "faulted fused training")

    res_m = gadget_train(X_dev, y_dev, cfg._replace(
        max_iters=400, faults=FaultPlan(drop_prob=FAULT_DROP_PROB, drop="message")), **kw)
    log(f"  message: {res_m.iters} iterations, mass trace {np.round(res_m.mass_trace, 6).tolist()}")
    require(bool(np.all(res_m.mass_trace < 1.0)), "message mode leaked no mass")

    plan_d = FaultPlan(drop_prob=FAULT_DROP_PROB, drop="link", dead_nodes=(DEAD_NODE,))
    cfg_d = cfg._replace(max_iters=400, faults=plan_d)
    off = gadget_train(X_dev, y_dev, cfg_d, **kw)
    reset()
    on = gadget_train(X_dev, y_dev, cfg_d, telemetry=TrainTelemetry(every=100, per_node=True),
                      **kw)
    torch.cuda.synchronize()
    c_d = counts_of()
    tr = on.telemetry
    log(f"  dead node {DEAD_NODE} with TrainTelemetry(every=100, per_node=True): records "
        f"{tr.iterations.tolist()}, drops {tr.drops.tolist()}, node drops "
        f"{tr.node_drops.sum(axis=0).tolist()}, node mass {np.round(tr.node_mass[-1], 6).tolist()}, "
        f"launches {launched(c_d)}")
    require(torch.equal(on.W, off.W) and torch.equal(on.W_avg, off.W_avg),
            "telemetry changed the faulted trajectory")
    require(not bool(on.W[DEAD_NODE].any()), f"dead node {DEAD_NODE}'s row moved")
    require(tr.count == 4 and np.array_equal(tr.node_drops.sum(axis=1), tr.drops)
            and int(tr.drops.sum()) > 0, "per-node drops do not sum to the ring's drops")
    require(not tr.node_drops[:, DEAD_NODE].any(), "the dead node dropped messages")
    require_launches(c_d, ops.HALF_STEP_KINDS["fused"], on.iters, "faulted telemetry run")

    reset()
    res_u = gadget_train(X_dev, y_dev, cfg_d._replace(fused=False), **kw)
    torch.cuda.synchronize()
    c_u = counts_of()
    log(f"  unfused under faults: {res_u.iters} iterations, launches {launched(c_u)}")
    require_launches(c_u, ops.HALF_STEP_KINDS["unfused"], res_u.iters, "faulted unfused training")
    require(not bool(res_u.W[DEAD_NODE].any()), "the dead row moved on the unfused path")

    cfg_6 = cfg_d._replace(max_iters=200)
    plan_of = {d: core.DrawPlan(N_NODES, cfg.batch_size, cfg.gossip_rounds, cfg.topology, True,
                                torch.from_numpy(n_counts).to(d), plan_d) for d in (dev, "cpu")}
    draws = {d: core.GeneratorDraws(cfg.seed) for d in plan_of}
    got = {d: (*draws[d].take(1, 200, plan_of[d]), draws[d].fails(1, 200, plan_of[d]))
           for d in plan_of}
    same_draws = all(torch.equal(a.cpu(), b) for a, b in zip(got[dev], got["cpu"]))
    res_g = gadget_train(X_dev, y_dev, cfg_6, **kw)
    res_c = gadget_train(Xp, yp, cfg_6, n_counts=n_counts, device="cpu")
    w_err = float((res_g.W.cpu() - res_c.W).abs().max())
    log(f"  200 faulted iterations, card against CPU: draws equal {same_draws}, W max abs err "
        f"{w_err:.3e} (<= {PATH_W_ATOL})")
    require(same_draws, "GeneratorDraws differ between the card and the CPU")
    # Threefry-2x32's published known answers (Random123), computed on the card
    words = torch.tensor(THREEFRY_KAT, dtype=torch.int64, device=dev)
    kat = torch.stack(core.threefry2x32(*words[:, :4].T), dim=1)
    kat_ok = torch.equal(kat.cpu(), words[:, 4:].cpu())
    log(f"  Threefry-2x32 known answers on the card: {kat_ok}")
    require(kat_ok, "Threefry-2x32 on the card misses its known answers")
    require(w_err <= PATH_W_ATOL, f"faulted W differs from its CPU run by {w_err:.3e}")

    n_prof = 200
    profiles = {}
    for name, c in (("clean", cfg), ("link", cfg_l)):
        c = c._replace(max_iters=n_prof)
        t0 = time.perf_counter()
        gadget_train(X_dev, y_dev, c, **kw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) / n_prof * 1e6
        prof = profile_iterations(torch, lambda: gadget_train(X_dev, y_dev, c, **kw))
        profiles[name] = {"device_us_per_iter": prof["device_us"] / n_prof,
                          "kernel_us_per_iter": prof["kernel_us"] / n_prof,
                          "kernel_launches_per_iter": prof["kernel_launches"] / n_prof,
                          "wall_us_per_iter": wall_us,
                          "device_busy_share": prof["device_us"] / n_prof / wall_us}
        log(f"  profile {name}: device {profiles[name]['device_us_per_iter']:.1f} us/iteration "
            f"(kernels {profiles[name]['kernel_us_per_iter']:.1f}), "
            f"{profiles[name]['kernel_launches_per_iter']:.2f} kernel launches an iteration, "
            f"{wall_us:.1f} us/iteration of wall time unprofiled")
        for key, count, us in prof["top_device"]:
            log(f"    device {us / n_prof:9.2f} us/it  x{count:<6d} {key}")
        require(prof["device_us"] > 0, "the profiled window ran nothing on the device")
    return {"link": {"iters": res_l.iters, "train_s": link_s, "iters_per_s": res_l.iters / link_s,
                     "test_accuracy": acc, "objective": obj_l, "mass_max_dev": mass_dev,
                     "launches": c_l["fleet_half_step"]},
            "message": {"iters": res_m.iters, "mass_trace": res_m.mass_trace.tolist()},
            "dead": {"node": DEAD_NODE, "drops": tr.drops.tolist(),
                     "node_drops": tr.node_drops.sum(axis=0).tolist(),
                     "launches": c_d["fleet_half_step"]},
            "unfused": {"iters": res_u.iters, "margins": c_u["margins"],
                        "grad_update": c_u["grad_update"]},
            "cpu_w_err": w_err, "profile": profiles}


def phase_anytime(torch, serve, core, gadget_train, cfg, cfg_c, data, ccat, dev, tmp, reset,
                  counts_of, kinds) -> dict:
    """Phase 17: the anytime export. A faulted reuters stream (the fused
    kernel) and the CCAT stream at full width (the prefetch schedule) bit for bit
    ``gadget_train`` at the segment length; the CCAT run killed after two
    segments, its train state checkpointed, read back and resumed, bit for
    bit the uninterrupted run; the snapshot ring's last four snapshots bit
    for bit the stream's consensus at their iterations."""
    Xp, yp, n_counts, _ = data
    parts_c, y_c, n_c = ccat
    stream = core.gadget_train_stream
    X_dev, y_dev = torch.from_numpy(Xp).to(dev), torch.from_numpy(yp).to(dev)
    cfg_r = cfg._replace(max_iters=STREAM_REUTERS_ITERS,
                         faults=core.FaultPlan(drop_prob=FAULT_DROP_PROB, drop="link"))
    reset()
    segs_r = list(stream(X_dev, y_dev, cfg_r, segment_iters=SEGMENT_ITERS, n_counts=n_counts,
                         device=dev))
    c_r = counts_of()
    mono_r = gadget_train(X_dev, y_dev, cfg_r._replace(check_every=SEGMENT_ITERS),
                          n_counts=n_counts, device=dev)
    log(f"  reuters, faulted, fused: stream of {len(segs_r)} segments to iteration "
        f"{segs_r[-1].iteration}, W bit for bit gadget_train: "
        f"{torch.equal(segs_r[-1].W, mono_r.W)}, launches {launched(c_r)}")
    require(torch.equal(segs_r[-1].W, mono_r.W), "the reuters stream differs from gadget_train")
    require(c_r["fleet_half_step"] == segs_r[-1].iteration,
            f"the reuters stream launched {launched(c_r)}")

    kw = dict(segment_iters=SEGMENT_ITERS, n_counts=n_c, device=dev)
    list(stream(parts_c, y_c, cfg_c._replace(max_iters=20), **dict(kw, segment_iters=10)))
    torch.cuda.synchronize()  # warm-up
    reset()
    t0 = time.perf_counter()
    segs = list(stream(parts_c, y_c, cfg_c, **kw))
    stream_s = time.perf_counter() - t0
    c = counts_of()
    iters = segs[-1].iteration
    log(f"  CCAT stream: {len(segs)} segments to iteration {iters} in {stream_s:.3f} s "
        f"({iters / stream_s:.1f} it/s), objective {segs[-1].objective:.4f}, launches {launched(c)}")
    require_launches(c, kinds, iters, "the CCAT stream")
    mono = gadget_train(parts_c, y_c, cfg_c._replace(check_every=SEGMENT_ITERS), n_counts=n_c,
                        device=dev, snapshot_every=SEGMENT_ITERS, snapshot_slots=SNAPSHOT_SLOTS)
    require(mono.iters == iters and torch.equal(mono.W, segs[-1].W)
            and np.array_equal(mono.w_consensus.cpu().numpy(), segs[-1].w_consensus),
            "the CCAT stream differs from gadget_train")
    snaps = serve.snapshots_from(mono)
    want_its = [SEGMENT_ITERS * k for k in range(1, iters // SEGMENT_ITERS + 1)][-SNAPSHOT_SLOTS:]
    if not want_its or want_its[-1] != iters:
        want_its.append(iters)
    by_it = {s.iteration: s for s in segs}
    snap_same = [np.array_equal(s.w, by_it[s.iteration].w_consensus) for s in snaps]
    log(f"  snapshot ring (every {SEGMENT_ITERS}, {SNAPSHOT_SLOTS} slots): iterations "
        f"{[s.iteration for s in snaps]}, each bit for bit the stream's consensus: {snap_same}")
    require([s.iteration for s in snaps] == want_its, f"snapshots at {[s.iteration for s in snaps]}")
    require(all(snap_same), "a snapshot differs from the stream's consensus")

    killed = stream(parts_c, y_c, cfg_c, **kw)
    seg2 = [next(killed), next(killed)][-1]
    killed.close()
    root = str(tmp / "resume")
    serve.to_checkpoint(serve.Snapshot(seg2.iteration, seg2.w_consensus, seg2.objective), root,
                        lam=cfg_c.lam,
                        train_state=core.TrainState(seg2.iteration, seg2.W, seg2.W_sum))
    state = serve.train_state_from_checkpoint(root)
    resumed = list(stream(parts_c, y_c, cfg_c, resume=state, **kw))
    same = torch.equal(resumed[-1].W, segs[-1].W)
    log(f"  killed at iteration {seg2.iteration}, resumed from its checkpoint to "
        f"{resumed[-1].iteration}: W bit for bit the uninterrupted run: {same}")
    require([s.iteration for s in resumed] == [s.iteration for s in segs[2:]],
            "the resumed stream's segments differ")
    require(same, "the resumed run differs from the uninterrupted one")
    return {"reuters_stream": {"iters": segs_r[-1].iteration, "segments": len(segs_r),
                               "fleet_half_step": c_r["fleet_half_step"]},
            "ccat_stream": {"iters": iters, "segments": len(segs), "stream_s": stream_s,
                            "iters_per_s": iters / stream_s, "objective": segs[-1].objective,
                            **{name: c[name] for name in kinds}},
            "snapshot_iterations": [s.iteration for s in snaps],
            "resumed_from": seg2.iteration}


def phase_publisher(torch, serve, formats, telemetry, R, cfg_c, ccat, ds_c, buckets, queries,
                    dev, tmp, reset, counts_of, kinds) -> dict:
    """Phase 18: ``TrainPublisher`` trains CCAT in a background thread and
    publishes a checkpoint a segment while an ``SvmServer`` watches the root
    and serves CCAT's test queries through ``ell_scores_prefetch``. The
    publisher traces its segments, and its registry and the server's stream
    their span records into ``tmp / LINEAGE_FILE``, which phase 19 reads."""
    parts_c, y_c, n_c = ccat
    root = str(tmp / "live")
    reg_pub, reg_srv = telemetry.Registry(), telemetry.Registry()
    with telemetry.JsonlSink(str(tmp / LINEAGE_FILE)) as sink_pub, \
            telemetry.JsonlSink(str(tmp / LINEAGE_FILE)) as sink_srv:
        reg_pub.attach_sink(sink_pub)
        reg_srv.attach_sink(sink_srv)
        try:
            return publisher_run(torch, serve, formats, R, cfg_c, parts_c, y_c, n_c, ds_c,
                                 buckets, queries, dev, root, reg_pub, reg_srv, reset, counts_of,
                                 kinds)
        finally:
            reg_pub.detach_sink()
            reg_srv.detach_sink()


def publisher_run(torch, serve, formats, R, cfg_c, parts_c, y_c, n_c, ds_c, buckets, queries,
                  dev, root, reg_pub, reg_srv, reset, counts_of, kinds) -> dict:
    """The body of phase 18, on the given registries."""
    pub = serve.TrainPublisher(parts_c, y_c, cfg_c, root=root, segment_iters=SEGMENT_ITERS,
                               n_counts=n_c, device=dev, save_train_state=True,
                               registry=reg_pub, trace=True)
    reset()
    t0 = time.perf_counter()
    pub.start()
    try:
        deadline = time.monotonic() + 300
        while not pub.published and pub.running and time.monotonic() < deadline:
            time.sleep(0.005)
        require(bool(pub.published), f"no version published ({pub.error!r})")
        srv = serve.SvmServer.watch(root, device=dev, registry=reg_srv)
        seen, batches, passes = [srv.meta["iteration"]], 0, 0
        while pub.running:
            step = srv.maybe_reload()
            if step is not None:
                seen.append(step)
            batches += serve_queries(srv, buckets, queries[:16 * SERVE_ROWS],
                                     formats.pad_query_planes)["batches"]
            passes += 1
            time.sleep(SERVE_PAUSE_S)  # traffic in bursts: the trainer's host loop shares the GIL
        final = pub.join()
    except BaseException:
        with contextlib.suppress(Exception):  # let the training thread end first
            pub.wait(timeout=600)
        raise
    train_s = time.perf_counter() - t0
    step = srv.maybe_reload()
    if step is not None:
        seen.append(step)
    last = serve_queries(srv, buckets, queries, formats.pad_query_planes)
    batches += last["batches"]
    c = counts_of()
    w_final = torch.from_numpy(final.w_consensus).to(dev)
    cols_te = torch.from_numpy(ds_c.X_test.cols).to(dev)
    vals_te = torch.from_numpy(ds_c.X_test.vals).to(dev)
    want_lbl = torch.where(R.ell_matvec_flat(w_final, cols_te, vals_te) >= 0.0, 1.0, -1.0)
    n_final = int((want_lbl.cpu().numpy() == ds_c.y_test).sum())
    n_served = int(np.sum(last["labels"] == ds_c.y_test))
    state = serve.latest_train_state(root)
    log(f"  published {pub.published} in {train_s:.3f} s; the server installed {seen} while "
        f"serving {passes} partial passes; last pass accuracy {n_served / len(queries):.4f} "
        f"(final consensus {n_final / len(queries):.4f}); {batches} batches, launches {launched(c)}")
    require(all(a < b for a, b in zip(pub.published, pub.published[1:])),
            f"published versions {pub.published} not monotone")
    require(all(a < b for a, b in zip(seen, seen[1:])) and seen[-1] == final.iteration
            == pub.published[-1], f"the server installed {seen}")
    require(n_served == n_final, "the last served accuracy differs from the final consensus's")
    require(c["ell_scores_prefetch"] == batches,
            f"ell_scores_prefetch launched {c['ell_scores_prefetch']} times for {batches} batches")
    require(all(c[name] == final.iteration for name in kinds),
            f"the publisher's training launched {launched(c)}")
    require(state is not None and state.iteration == final.iteration,
            "the last checkpoint carries no train state")
    return {"published": pub.published, "installed": seen, "train_s": train_s,
            "serving_passes": passes, "batches": batches,
            "test_accuracy": n_served / len(queries),
            "ell_scores_prefetch": c["ell_scores_prefetch"],
            **{name: c[name] for name in kinds}}


def queries_csr(queries, d: int, CSR):
    """A list of (cols, vals) queries as one CSR of ``len(queries)`` rows."""
    indptr = np.zeros(len(queries) + 1, np.int64)
    np.cumsum([len(c) for c, _ in queries], out=indptr[1:])
    return CSR(np.concatenate([v for _, v in queries]), np.concatenate([c for c, _ in queries]),
               indptr, (len(queries), d))


def closed_loop(serve, srv, buckets, chunks, tracer=None) -> dict:
    """Each CSR chunk submitted whole (``submit_csr``) to an unbounded
    ``MicroBatcher`` (traced by ``tracer`` when one is given) and drained
    through ``srv.scorer_for()``: the results in row order, the batcher's
    stats and the host seconds of the pass."""
    mb = serve.MicroBatcher(buckets, tracer=tracer)
    score_fn = srv.scorer_for()
    rids, out = [], {}
    t0 = time.perf_counter()
    for chunk in chunks:
        rids += mb.submit_csr(chunk)
        out.update(mb.drain(score_fn))
    seconds = time.perf_counter() - t0
    results = [out[r] for r in rids]
    require(all(isinstance(r, tuple) for r in results), "an unbounded queue lost a request")
    st = mb.stats()
    require(st["submitted"] == st["delivered"] + st["shed"] + st["deadline_missed"]
            + st["pending"] == len(rids), f"the closed loop does not reconcile: {st}")
    return {"scores": np.array([float(s) for s, _ in results], np.float32),
            "labels": np.array([float(lb) for _, lb in results], np.float32),
            "stats": st, "seconds": seconds}


def open_loop(serve, tmtr, srv, buckets, queries, capacity, registry, reset, counts_of) -> dict:
    """Seeded Poisson arrivals from a submitter thread at ``BURST_LOAD`` ×
    ``capacity`` (the traced closed loop's queries/s; the test queries
    repeated to ``OPEN_LOOP_REQUESTS``), then for ``TAIL_S`` seconds at
    ``TAIL_LOAD`` × the rate the open loop served during that burst, while
    this thread steps the ``DegradeLadder`` and drains, behind
    ``max_pending``, ``shed-oldest``, a ``default_timeout`` and a
    ``RequestTracer`` of every request. The knobs are derived from capacity
    as ``benchmarks/overload_bench.py`` derives them."""
    max_pending = max(64, int(capacity * 0.05))
    timeout_s = max(0.1, 4 * max_pending / capacity)
    tracer = tmtr.RequestTracer(registry, sample=1.0, seed=OPEN_LOOP_SEED)
    mb = serve.MicroBatcher(buckets, registry=registry, max_pending=max_pending,
                            admission="shed-oldest", default_timeout=timeout_s, tracer=tracer)
    ladder = serve.DegradeLadder(srv, mb, high=0.75, low=0.25, patience=2, max_rung=2)
    ladder.prepare()
    st_srv = srv.stats()
    shapes0, overflows0 = st_srv["distinct_shapes"], st_srv["cap_overflows"]
    rng = np.random.default_rng(OPEN_LOOP_SEED)
    burst = np.cumsum(rng.exponential(1.0 / (BURST_LOAD * capacity), OPEN_LOOP_REQUESTS))
    burst_done, done = threading.Event(), threading.Event()
    errors, rejected, seg_s, tail = [], [0], [], {}
    served = [0]  # requests submitted so far, for the query each arrival sends

    def submit_segment(arrivals):
        """Submit each arrival at its time, on a clock of the segment's own."""
        t0, j = time.monotonic(), 0
        while j < len(arrivals):
            # every arrival due by now, then sleep to the next one, at least
            # SUBMIT_TICK_S: each wake takes the interpreter lock from the drain
            due = int(np.searchsorted(arrivals, time.monotonic() - t0, side="right"))
            for _ in range(j, due):
                try:
                    mb.submit(*queries[served[0] % len(queries)])
                except serve.QueryRejected:
                    rejected[0] += 1
                served[0] += 1
            j = max(j, due)
            if j < len(arrivals):
                time.sleep(max(arrivals[j] - (time.monotonic() - t0), SUBMIT_TICK_S))
        seg_s.append(time.monotonic() - t0)

    def submitter():
        try:
            submit_segment(burst)
            burst_done.set()
            # the tail's load is a share of what the open loop served in the
            # saturated burst: the two threads share the interpreter lock, and
            # a tail at a share of the closed loop's capacity did not always
            # drain (tools/control_plane_probe.py)
            tail["goodput_qps"] = max(1.0, registry.value("serve.delivered") / seg_s[0])
            rate = TAIL_LOAD * tail["goodput_qps"]
            tail["qps"], tail["n"] = rate, max(len(buckets) * 64, int(rate * TAIL_S))
            submit_segment(np.cumsum(rng.exponential(1.0 / rate, tail["n"])))
        except BaseException as e:  # re-raised by the draining thread
            errors.append(e)
        finally:
            burst_done.set()
            done.set()

    score_fn = srv.scorer_for()
    th = threading.Thread(target=submitter, daemon=True, name="chip-smoke-submitter")
    max_rung_burst = 0
    reset()
    t_start = time.perf_counter()
    th.start()
    try:
        while not done.is_set() or mb.pending:
            rung = ladder.observe()
            if not burst_done.is_set():
                max_rung_burst = max(max_rung_burst, rung)
            if mb.pending:
                mb.drain(score_fn)
            else:
                time.sleep(0.0005)
    finally:
        th.join(timeout=600)
    require(not th.is_alive(), "the submitter thread did not end")
    if errors:
        raise errors[0]
    mb.drain(score_fn)  # flush the typed Shed / DeadlineExceeded results
    wall = time.perf_counter() - t_start
    n_tail = tail["n"]
    n = OPEN_LOOP_REQUESTS + n_tail
    rung_end = ladder.rung
    c = counts_of()
    srv.set_plane("f32")
    mb.degrade_to(None)
    st = mb.stats()
    st_srv = srv.stats()
    fates = tracer.fate_counts()
    want_fates = {k: v for k, v in (("delivered", st["delivered"]), ("shed", st["shed"]),
                                    ("deadline", st["deadline_missed"]),
                                    ("rejected", st["rejected"])) if v}
    steps = {d: int(srv.registry.value("serve.degrade_steps", direction=d)) for d in ("down", "up")}
    p99_bound_ms = timeout_s * 1e3 + P99_SLACK_MS
    out = {"offered": n, "burst_requests": OPEN_LOOP_REQUESTS, "tail_requests": n_tail,
           "burst_qps": BURST_LOAD * capacity, "burst_goodput_qps": tail["goodput_qps"],
           "tail_qps": tail["qps"],
           "burst_s": seg_s[0], "tail_s": seg_s[1],
           "burst_submitted_qps": OPEN_LOOP_REQUESTS / seg_s[0],
           "max_pending": max_pending, "timeout_ms": timeout_s * 1e3, "wall_s": wall,
           "goodput_qps": st["delivered"] / wall, "shed_rate": st["shed"] / n,
           "deadline_miss_rate": st["deadline_missed"] / n, "rejected": st["rejected"],
           "truncated": st["truncated"], "queue_peak": st["queue_peak"],
           "p50_ms": st["latency_p50_ms"], "p99_ms": st["latency_p99_ms"],
           "p99_bound_ms": p99_bound_ms, "batches": st["batches"],
           "ell_scores_prefetch": c["ell_scores_prefetch"], "max_rung_burst": max_rung_burst,
           "rung_end": rung_end, "degrade_steps": steps, "trace_fates": fates,
           "distinct_shapes": [shapes0, st_srv["distinct_shapes"]],
           "cap_overflows": [overflows0, st_srv["cap_overflows"]]}
    log(f"  open loop: {n} offered ({OPEN_LOOP_REQUESTS} at {BURST_LOAD:g}x capacity, "
        f"{BURST_LOAD * capacity:.0f} q/s, submitted in {seg_s[0]:.3f} s, "
        f"{OPEN_LOOP_REQUESTS / seg_s[0]:.0f} q/s, served {tail['goodput_qps']:.0f} q/s; then "
        f"{n_tail} at {TAIL_LOAD:g}x that, {tail['qps']:.0f} q/s, in {seg_s[1]:.3f} s) in "
        f"{wall:.3f} s; "
        f"max_pending {max_pending}, timeout {timeout_s * 1e3:.1f} ms; goodput "
        f"{out['goodput_qps']:.1f} q/s, shed rate {out['shed_rate']:.4f}, deadline rate "
        f"{out['deadline_miss_rate']:.4f}, rejected {st['rejected']}, truncated {st['truncated']}; "
        f"p50 {st['latency_p50_ms']:.3f} ms, p99 {st['latency_p99_ms']:.3f} ms (<= "
        f"{p99_bound_ms:.1f}); queue peak {st['queue_peak']}; rung steps {steps}, max rung in "
        f"the burst {max_rung_burst}, rung at the end {rung_end}; {st['batches']} batches, "
        f"ell_scores_prefetch {c['ell_scores_prefetch']}; shapes {shapes0} -> "
        f"{st_srv['distinct_shapes']}, cap overflows {overflows0} -> {st_srv['cap_overflows']}; "
        f"traced fates {fates}")
    require(st["submitted"] + st["rejected"] == n and rejected[0] == st["rejected"],
            f"offered {n} != submitted {st['submitted']} + rejected {st['rejected']}")
    require(st["pending"] == 0 and st["submitted"] == st["delivered"] + st["shed"]
            + st["deadline_missed"], f"the open loop does not reconcile: {st}")
    require(st["queue_peak"] <= max_pending, f"queue peak {st['queue_peak']} > {max_pending}")
    require(max_rung_burst >= 1, "the ladder did not step down during the burst")
    require(rung_end == 0, f"the ladder ended the tail on rung {rung_end}")
    require(st_srv["distinct_shapes"] - shapes0 <= st_srv["cap_overflows"] - overflows0,
            f"the ladder moved the served shapes {shapes0} -> {st_srv['distinct_shapes']}")
    require(c["ell_scores_prefetch"] == st["batches"],
            f"ell_scores_prefetch launched {c['ell_scores_prefetch']} times for "
            f"{st['batches']} batches")
    require(fates == want_fates, f"traced fates {fates} != the batcher's {want_fates}")
    require(registry.value("trace.requests") == n, "not every offered request was traced")
    require(st["latency_p99_ms"] <= p99_bound_ms,
            f"delivered p99 {st['latency_p99_ms']:.1f} ms > {p99_bound_ms:.1f} ms")
    return out


def phase_control_plane(torch, serve, formats, libsvm, telemetry, tmtr, top, R, ds_c, w_c,
                        n_correct_c, buckets, installed, dev, tmp, reset, counts_of) -> dict:
    """Phase 19: the serving control plane in front of ``SvmServer`` on phase
    7's CCAT model and phase 10's calibrated buckets: LibSVM ingest, the
    closed loop through ``MicroBatcher.submit_csr`` (whole, ragged, traced), the
    open loop under overload (``open_loop``), and the lineage chains of
    phase 18's span records with one frame of the top console."""
    X_te, y_te = ds_c.X_test, ds_c.y_test
    d, k_max = X_te.shape[1], X_te.k_max
    path = str(tmp / "ccat_test.svm")
    t0 = time.perf_counter()
    libsvm.dump_libsvm(path, X_te.to_csr(), y_te)
    csr, y_read = libsvm.load_libsvm_csr(path, d)
    chunks = list(libsvm.iter_libsvm_chunks(path, d, chunk_rows=INGEST_CHUNK_ROWS))
    ingest_s = time.perf_counter() - t0
    ell = csr.to_ell(k_max)
    chunk_ells = [c.to_ell(k_max) for c, _ in chunks]
    same = (np.array_equal(ell.cols, X_te.cols) and np.array_equal(ell.vals, X_te.vals)
            and np.array_equal(np.concatenate([e.cols for e in chunk_ells]), X_te.cols)
            and np.array_equal(np.concatenate([e.vals for e in chunk_ells]), X_te.vals))
    labels_same = (np.array_equal(y_read, y_te)
                   and np.array_equal(np.concatenate([lab for _, lab in chunks]), y_te))
    log(f"  ingest: {X_te.shape[0]} rows, {csr.nnz} entries written with dump_libsvm "
        f"({Path(path).stat().st_size} bytes) and read back whole and in {len(chunks)} chunks "
        f"in {ingest_s:.3f} s; planes bit for bit: {same}, labels equal: {labels_same}")
    require(same, "the LibSVM round trip changed the CCAT test planes")
    require(labels_same, "the LibSVM round trip changed the CCAT test labels")
    require(len(chunks) > 1, "the chunked read gave one chunk")

    registry = telemetry.Registry()
    srv = serve.SvmServer(w_c, device=dev, registry=registry)
    for b in buckets:  # every bucket's shape served once before anything is counted
        srv.score_sparse(np.zeros((b.rows, b.k), np.int32), np.zeros((b.rows, b.k), np.float32),
                         n_blocks_max=b.n_blocks_max)
    torch.cuda.synchronize()
    w_dev = torch.from_numpy(w_c).to(dev)
    ragged = ccat_queries(X_te, ragged=True)
    passes = {}
    # the traced whole pass runs the open loop's per-request work (a
    # RequestTracer of every request): its rate is the capacity the open
    # loop's loads are multiples of
    for name, chunks_of, traced in (("whole", [c for c, _ in chunks], False),
                                    ("ragged", [queries_csr(ragged, d, formats.CSR)], False),
                                    ("whole, traced", [c for c, _ in chunks], True)):
        reset()
        res = closed_loop(serve, srv, buckets, chunks_of,
                          tmtr.RequestTracer(telemetry.Registry(), sample=1.0) if traced else None)
        launches = counts_of()["ell_scores_prefetch"]
        st = res["stats"]
        q = ragged if name == "ragged" else ccat_queries(X_te, ragged=False)
        cols_all, vals_all = formats.pad_query_planes(q, len(q), k_max)
        cols_all, vals_all = torch.from_numpy(cols_all).to(dev), torch.from_numpy(vals_all).to(dev)
        want = R.ell_predict_scores_ref(w_dev[None], cols_all, vals_all)[:, 0]
        err = rel_err(torch.from_numpy(res["scores"]).to(dev), want)[1]
        plain_lbl = torch.where(R.ell_matvec_flat(w_dev, cols_all, vals_all) >= 0, 1.0, -1.0)
        sure = want.abs() > 1e-5
        labels_ok = torch.equal(torch.from_numpy(res["labels"]).to(dev)[sure], plain_lbl[sure])
        n_q = len(q)
        passes[name] = {"queries": n_q, "batches": st["batches"], "ell_scores_prefetch": launches,
                        "seconds": res["seconds"], "queries_per_s": n_q / res["seconds"],
                        "host_ms_per_batch": 1e3 * res["seconds"] / st["batches"],
                        "drain_ms_per_batch": 1e3 * st["drain_seconds"] / st["batches"],
                        "p50_ms": st["latency_p50_ms"], "p99_ms": st["latency_p99_ms"],
                        "buckets": sorted(st["per_bucket_latency_ms"]), "scores_rel_err": err,
                        "pad_fraction": st["pad_fraction"]}
        if name == "whole":
            passes[name]["test_accuracy"] = float(np.mean(res["labels"] == y_te))
            n_correct = int(np.sum(res["labels"] == y_te))
        log(f"  closed loop, {name}: {n_q} queries in {st['batches']} batches (buckets "
            f"{passes[name]['buckets']}) in {res['seconds']:.3f} s: {n_q / res['seconds']:.1f} "
            f"queries/s, {passes[name]['host_ms_per_batch']:.3f} ms host time per batch "
            f"({passes[name]['drain_ms_per_batch']:.3f} ms of it draining), p50 "
            f"{st['latency_p50_ms']:.3f} ms, p99 {st['latency_p99_ms']:.3f} ms, scores rel err "
            f"{err:.3e}, ell_scores_prefetch {launches}")
        require(launches == st["batches"],
                f"{name}: ell_scores_prefetch launched {launches} times for {st['batches']} batches")
        require(err <= KERNEL_RTOL, f"{name}: served scores differ from the plain gather-dot by {err:.3e}")
        require(labels_ok, f"{name}: labels differ from the plain gather-dot's")
    require(n_correct == n_correct_c,
            f"closed-loop accuracy {passes['whole']['test_accuracy']:.4f} != phase 7's")
    require(len(passes["ragged"]["buckets"]) > 1,
            f"the ragged pass used buckets {passes['ragged']['buckets']} only")
    capacity = passes["whole, traced"]["queries_per_s"]

    queries = ccat_queries(X_te, ragged=False)
    loop = open_loop(serve, tmtr, srv, buckets, queries, capacity, registry, reset, counts_of)
    st_srv = srv.stats()
    require(st_srv["distinct_shapes"] <= len(buckets) + st_srv["cap_overflows"],
            f"{st_srv['distinct_shapes']} shapes served for {len(buckets)} buckets and "
            f"{st_srv['cap_overflows']} cap overflows")

    records = telemetry.read_jsonl(str(tmp / LINEAGE_FILE))
    chains = tmtr.lineage_chains(records)
    broken = [v for v in installed
              if not (v in chains and chains[v]["complete"] and chains[v]["monotone"])]
    log(f"  lineage: {len(records)} records from phase 18, {len(chains)} chains, "
        f"{sum(c['complete'] for c in chains.values())} complete; the server installed "
        f"{installed}, each complete and monotone: {not broken}")
    require(not broken, f"installed versions {broken} have no complete, monotone chain")
    for line in tmtr.format_chain(installed[-1], chains[installed[-1]]).splitlines():
        log(f"    {line}")
    for line in top.render_registry(registry, records).splitlines():
        log(f"    {line}")
    return {"ingest_s": ingest_s, "ingest_chunks": len(chunks), "closed_loop": passes,
            "capacity_qps": capacity, "open_loop": loop, "distinct_shapes": st_srv["distinct_shapes"],
            "cap_overflows": st_srv["cap_overflows"], "lineage_chains": len(chains),
            "installed": list(installed)}


def make_multiclass(n: int, d: int, C: int, seed: int = 0):
    """tests/test_multiclass.py's generator (Gaussian class centres ×3 plus
    unit noise), as tools/reference_quality.py --mode multiclass draws it."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(C, d)) * 3.0
    y = rng.integers(0, C, size=n)
    X = centers[y] + rng.normal(size=(n, d))
    return X.astype(np.float32), y.astype(np.int32)


def phase_solvers(torch, gadget, pegasos, cutting_plane, multiclass, P, ops, cfg, data,
                  kernels, dev, reset, counts_of) -> dict:
    """Phase 20: the host loop against its CPU run (the plain versions) and
    against the unfused device loop, centralised Pegasos, Table 4's
    cutting-plane SVM and SVM-SGD on one node's partition, and one-vs-rest
    GADGET, each on the card against its CPU run (and Pegasos and
    multiclass against the reference's quality); B8 at the multiclass
    shape."""
    Xp, yp, n_counts, ds = data
    X_dev, y_dev = torch.from_numpy(Xp).to(dev), torch.from_numpy(yp).to(dev)
    out = {"host_loop": {}}
    for topology in ("random", "exponential"):
        c = cfg._replace(topology=topology, max_iters=HOST_LOOP_ITERS, fused=False)
        gadget.gadget_train_reference(X_dev, y_dev, c._replace(max_iters=10, check_every=5),
                                      n_counts=n_counts, device=dev)  # warm-up
        torch.cuda.synchronize()
        reset()
        gadget.reset_transfer_stats()
        t0 = time.perf_counter()
        res_h = gadget.gadget_train_reference(X_dev, y_dev, c, n_counts=n_counts, device=dev)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        stats, launches = dict(gadget.transfer_stats), counts_of()
        t0 = time.perf_counter()
        res_u = gadget.gadget_train(X_dev, y_dev, c, n_counts=n_counts, device=dev)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res_c = gadget.gadget_train_reference(Xp, yp, c, n_counts=n_counts, device="cpu")
        cpu_s = time.perf_counter() - t0
        cpu_err = float((res_h.W.cpu() - res_c.W).abs().max())
        cpu_obj_err = float(np.max(np.abs(res_h.objective_trace - res_c.objective_trace)
                                   / np.abs(res_c.objective_trace)))
        w_err = float((res_h.W - res_u.W).abs().max())
        cons_err = float((res_h.w_consensus - res_u.w_consensus).abs().max())
        obj_err = float(np.max(np.abs(res_h.objective_trace - res_u.objective_trace)
                               / np.abs(res_u.objective_trace)))
        n_checks = len(res_h.objective_trace)
        log(f"  host loop, {topology}: {res_h.iters} iterations in {host_s:.3f} s "
            f"({res_h.iters / host_s:.1f} it/s; gadget_train(fused=False) {res_u.iters / dev_s:.1f}; "
            f"CPU {cpu_s:.1f} s); against its CPU run: W {cpu_err:.3e}, objective rel "
            f"{cpu_obj_err:.3e}; against gadget_train(fused=False): W {w_err:.3e}, consensus "
            f"{cons_err:.3e}, objective rel {obj_err:.3e}; transfer_stats {stats} over "
            f"{n_checks} ε-checks; launches {launched(launches)}")
        require(res_h.iters == res_u.iters == res_c.iters == HOST_LOOP_ITERS,
                "host loop iteration counts differ")
        require(cpu_err <= PATH_W_ATOL, f"host loop W differs from its CPU run by {cpu_err:.3e}")
        require(cpu_obj_err <= PATH_OBJ_RTOL,
                f"host loop objective trace differs from its CPU run by {cpu_obj_err:.3e}")
        require(w_err <= HOST_LOOP_ATOL and cons_err <= HOST_LOOP_ATOL,
                f"host loop W differs from gadget_train(fused=False) by {w_err:.3e}")
        require(obj_err <= PATH_OBJ_RTOL, f"host loop objective trace differs by {obj_err:.3e}")
        want_up = HOST_LOOP_ITERS if topology == "exponential" else 0
        require(stats == {"matrix_uploads": want_up, "host_syncs": 2 * n_checks},
                f"host loop transfer_stats {stats}")
        require_launches(launches, ops.HALF_STEP_KINDS["unfused"], res_h.iters, "host loop")
        out["host_loop"][topology] = dict(iters=res_h.iters, seconds=host_s,
                                          iters_per_s=res_h.iters / host_s,
                                          unfused_iters_per_s=res_u.iters / dev_s,
                                          cpu_w_err=cpu_err, cpu_objective_rel_err=cpu_obj_err,
                                          w_err=w_err, consensus_err=cons_err,
                                          objective_rel_err=obj_err, transfer_stats=stats,
                                          margins=launches["margins"],
                                          grad_update=launches["grad_update"])

    # centralised Pegasos, Table 3's run: the whole training set on one card
    Xtr, ytr = torch.from_numpy(ds.X_train).to(dev), torch.from_numpy(ds.y_train).to(dev)
    Xte, yte = torch.from_numpy(ds.X_test).to(dev), torch.from_numpy(ds.y_test).to(dev)
    pegasos.pegasos_train(Xtr, ytr, ds.lam, 10, batch_size=PEGASOS_BATCH, device=dev)  # warm-up
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    peg = pegasos.pegasos_train(Xtr, ytr, ds.lam, PEGASOS_ITERS, batch_size=PEGASOS_BATCH,
                                device=dev)
    torch.cuda.synchronize()
    peg_s = time.perf_counter() - t0
    peg_launches = counts_of()
    t0 = time.perf_counter()
    peg_cpu = pegasos.pegasos_train(ds.X_train, ds.y_train, ds.lam, PEGASOS_ITERS,
                                    batch_size=PEGASOS_BATCH, device="cpu")
    peg_cpu_s = time.perf_counter() - t0
    peg_err = float((peg.w.cpu() - peg_cpu.w).abs().max())
    peg_acc = float((torch.where(Xte @ peg.w >= 0, 1.0, -1.0) == yte).float().mean())
    log(f"  pegasos: {PEGASOS_ITERS} iterations of B = {PEGASOS_BATCH} in {peg_s:.3f} s "
        f"({PEGASOS_ITERS / peg_s:.1f} it/s; CPU {peg_cpu_s:.1f} s), objective "
        f"{float(peg.objective):.4f}, test accuracy {peg_acc:.4f} (reference "
        f"{PEGASOS_REF_ACCURACY:.4f}), w against the CPU {peg_err:.3e}")
    require(peg_err <= PATH_W_ATOL, f"pegasos w differs from its CPU run by {peg_err:.3e}")
    require(abs(peg_acc - PEGASOS_REF_ACCURACY) <= QUALITY_SLACK,
            f"pegasos accuracy {peg_acc:.4f} against the reference's {PEGASOS_REF_ACCURACY:.4f}")
    require(not launched(peg_launches), f"pegasos launched {launched(peg_launches)}")
    out["pegasos"] = dict(iters=PEGASOS_ITERS, batch_size=PEGASOS_BATCH, seconds=peg_s,
                          iters_per_s=PEGASOS_ITERS / peg_s, test_accuracy=peg_acc,
                          objective=float(peg.objective), cpu_w_err=peg_err)

    # Table 4's online baselines, as benchmarks/table4_online_baselines.py runs
    # them on each node's partition: node 0's, on the card against the CPU.
    # A row whose margin sits at 1 joins one run's cut and not the other's,
    # so past the first cuts the two runs part (the reference's own float32
    # and float64 runs do): w is held over CUT_PREFIX cuts, and the full run's
    # objective by the method's certificate (each objective lies within its
    # gap above the optimum)
    n0 = int(n_counts[0])
    X0, y0 = Xp[0, :n0], yp[0, :n0]
    X0_dev, y0_dev = torch.from_numpy(X0).to(dev), torch.from_numpy(y0).to(dev)
    cutting_plane.svm_sgd(X0_dev[:8], y0_dev[:8], ds.lam, n_epochs=1, device=dev)  # warm-up
    torch.cuda.synchronize()
    reset()
    cp5 = cutting_plane.cutting_plane_svm(X0_dev, y0_dev, ds.lam, max_cuts=CUT_PREFIX,
                                          device=dev)
    t0 = time.perf_counter()
    cp = cutting_plane.cutting_plane_svm(X0_dev, y0_dev, ds.lam, device=dev)
    torch.cuda.synchronize()
    cp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sgd = cutting_plane.svm_sgd(X0_dev, y0_dev, ds.lam, device=dev)
    torch.cuda.synchronize()
    sgd_s = time.perf_counter() - t0
    base_launches = counts_of()
    t0 = time.perf_counter()
    cp_cpu = cutting_plane.cutting_plane_svm(X0, y0, ds.lam, device="cpu")
    sgd_cpu = cutting_plane.svm_sgd(X0, y0, ds.lam, device="cpu")
    base_cpu_s = time.perf_counter() - t0
    cp5_cpu = cutting_plane.cutting_plane_svm(X0, y0, ds.lam, max_cuts=CUT_PREFIX, device="cpu")
    cp5_err = float((cp5.w.cpu() - cp5_cpu.w).abs().max())
    cp_err = float((cp.w.cpu() - cp_cpu.w).abs().max())
    cp_obj_diff = abs(cp.objective - cp_cpu.objective)
    sgd_err = float((sgd.cpu() - sgd_cpu).abs().max())
    cp_acc = float((torch.where(Xte @ cp.w >= 0, 1.0, -1.0) == yte).float().mean())
    sgd_acc = float((torch.where(Xte @ sgd >= 0, 1.0, -1.0) == yte).float().mean())
    log(f"  online baselines on node 0's {n0} rows: cutting plane, {CUT_PREFIX} cuts: w "
        f"against the CPU {cp5_err:.3e}; {cp.n_cuts} cuts in {cp_s:.3f} s (CPU "
        f"{cp_cpu.n_cuts} cuts), gap {cp.gap:.3e} (CPU {cp_cpu.gap:.3e}), objective "
        f"{cp.objective:.6f} (CPU {cp_cpu.objective:.6f}), test accuracy {cp_acc:.4f}, w "
        f"against the CPU {cp_err:.3e}; "
        f"SVM-SGD {2 * n0} steps in {sgd_s:.3f} s, test accuracy {sgd_acc:.4f}, w against "
        f"the CPU {sgd_err:.3e}; CPU both {base_cpu_s:.1f} s")
    require(cp5.n_cuts == cp5_cpu.n_cuts == CUT_PREFIX and cp5_err <= PATH_W_ATOL,
            f"cutting plane w over {CUT_PREFIX} cuts differs from its CPU run by {cp5_err:.3e}")
    require(bool(torch.isfinite(cp.w).all())
            and cp_obj_diff <= max(cp.gap, cp_cpu.gap),
            f"cutting plane objective {cp.objective} against the CPU's {cp_cpu.objective}, "
            f"beyond the gaps {cp.gap:.3e} / {cp_cpu.gap:.3e}")
    require(sgd_err <= PATH_W_ATOL, f"SVM-SGD w differs from its CPU run by {sgd_err:.3e}")
    require(not launched(base_launches), f"the baselines launched {launched(base_launches)}")
    out["online_baselines"] = dict(rows=n0, cutting_plane=dict(
        n_cuts=cp.n_cuts, seconds=cp_s, gap=cp.gap, objective=cp.objective,
        cpu_objective=cp_cpu.objective, test_accuracy=cp_acc, cpu_w_err=cp_err,
        prefix_cpu_w_err=cp5_err), svm_sgd=dict(
        steps=2 * n0, seconds=sgd_s, test_accuracy=sgd_acc, cpu_w_err=sgd_err))

    # one-vs-rest GADGET at mnist's shape
    n, n_te, d, C = MULTICLASS_SHAPE
    t0 = time.perf_counter()
    Xall, yall = make_multiclass(n + n_te, d, C, seed=0)
    n_i = n // MULTICLASS_NODES
    Xp_m = Xall[:n].reshape(MULTICLASS_NODES, n_i, d)
    yp_m = yall[:n].reshape(MULTICLASS_NODES, n_i)
    gen_s = time.perf_counter() - t0
    cfg_m = gadget.GadgetConfig(lam=1e-3, batch_size=8, gossip_rounds=4, topology="random",
                                max_iters=MULTICLASS_ITERS, check_every=MULTICLASS_CHECK)
    Xm_dev, ym_dev = torch.from_numpy(Xp_m).to(dev), torch.from_numpy(yp_m).to(dev)
    multiclass.gadget_train_multiclass(Xm_dev, ym_dev, C, cfg_m._replace(max_iters=10),
                                       device=dev)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mc = multiclass.gadget_train_multiclass(Xm_dev, ym_dev, C, cfg_m, device=dev)
    torch.cuda.synchronize()
    mc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mc_cpu = multiclass.gadget_train_multiclass(Xp_m, yp_m, C, cfg_m, device="cpu")
    mc_cpu_s = time.perf_counter() - t0
    mc_err = float((mc.W.cpu() - mc_cpu.W).abs().max())
    Xq = torch.from_numpy(Xall[n:]).to(dev)
    yq = torch.from_numpy(yall[n:]).to(dev)
    W_c = mc.w_consensus.contiguous()
    reset()
    pred = multiclass.predict_multiclass(W_c, Xq)
    mc_launches = counts_of()
    mc_acc = float((pred.long() == yq.long()).float().mean())
    log(f"  multiclass at mnist's shape (train {n} x {d}, {C} classes, data {gen_s:.1f} s): "
        f"{mc.iters} iterations in {mc_s:.3f} s ({mc.iters / mc_s:.1f} it/s; CPU "
        f"{mc_cpu_s:.1f} s), W against the CPU {mc_err:.3e}, test accuracy {mc_acc:.4f} "
        f"(reference {MULTICLASS_REF_ACCURACY:.4f}), predict launches {launched(mc_launches)}")
    require(mc.iters == mc_cpu.iters, "multiclass iteration counts differ")
    require(mc_err <= PATH_W_ATOL, f"multiclass W differs from its CPU run by {mc_err:.3e}")
    require(abs(mc_acc - MULTICLASS_REF_ACCURACY) <= QUALITY_SLACK,
            f"multiclass accuracy {mc_acc:.4f} against {MULTICLASS_REF_ACCURACY:.4f}")
    require(mc_launches["dense_scores"] == 1, f"predict_multiclass launched {launched(mc_launches)}")
    (got, got_l), (want, want_l) = (P.dense_scores(Xq, W_c, n_classes=C),
                                    P.dense_scores_plain(Xq, W_c, n_classes=C))
    err = rel_err(got, want)
    require(err[1] <= KERNEL_RTOL and torch.equal(got_l, want_l),
            f"dense_scores at the multiclass shape: rel err {err[1]:.3e} or labels off")
    t = device_ms(torch, lambda: P.dense_scores(Xq, W_c, n_classes=C), 200)
    t_plain = device_ms(torch, lambda: P.dense_scores_plain(Xq, W_c, n_classes=C), 200)
    t_mm = device_ms(torch, lambda: torch.mm(Xq, W_c.t()), 200)
    b_ms, b_by = bound(ops.launch_cost("dense_predict", B=n_te, d=d, C=C))
    log(f"  {'dense_scores':16s} X ({n_te}, {d}), W ({C}, {d}): err {err[0]:.3e} (rel "
        f"{err[1]:.3e}, scores up to {float(want.abs().max()):.1f}), kernel "
        f"{t * 1e3:.2f} us, plain {t_plain * 1e3:.2f} us, torch.mm {t_mm * 1e3:.2f} us, bound "
        f"{b_ms * 1e3:.2f} us ({b_by})")
    kernels["dense_scores"]["other_shapes"]["multiclass"] = dict(
        shape=f"X ({n_te}, {d}), W ({C}, {d})", max_abs_err=err[0], ms=t, plain_ms=t_plain,
        library_ms=t_mm, bound_ms=b_ms, bound_by=b_by)
    out["multiclass"] = dict(shape=[n, n_te, d, C], iters=mc.iters, seconds=mc_s,
                             iters_per_s=mc.iters / mc_s, test_accuracy=mc_acc,
                             cpu_w_err=mc_err, dense_scores=mc_launches["dense_scores"])
    return out


def mesh_rank(rank: int, world: int, backend: str, rdv: str, work: str,
              device_type: str = "cuda") -> None:
    """One rank of phase 21, in a process of its own (spawned): it joins the
    group, trains its shard on ``device_type`` and writes what it measured
    to ``work``. Any exception exits non-zero, which fails the phase."""
    try:
        _mesh_rank(rank, world, backend, rdv, Path(work), device_type)
    except BaseException:
        import traceback
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        raise SystemExit(1)


def _mesh_rank(rank, world, backend, rdv, work, device_type) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.core import counter_rng as crng
    from repro_torch.core.consensus import gossip_mix
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.gadget import make_gadget_mesh_step
    from repro_torch.core.mesh import Mesh
    from repro_torch.configs.gadget_svm import PAPER_RUNS
    from repro_torch.kernels.hinge_subgrad import hinge_subgrad as K
    from repro_torch.kernels.hinge_subgrad import ops
    from repro_torch.kernels.hinge_subgrad import predict as P
    from repro_torch.kernels.hinge_subgrad import sparse as S
    from repro_torch.serve import make_mesh_scorer

    torch.set_num_threads(1)  # ranks share the host's cores
    if device_type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:  # a rehearsal of the rank's code on the CPU
        dev = torch.device(device_type)
    dist.init_process_group(backend, init_method=f"file://{rdv}", rank=rank, world_size=world)
    mesh = Mesh({"nodes": world})
    axes = {"nodes": world}
    data = np.load(work / f"data_{world}.npz")
    n_r, d = int(data["counts"][rank]), int(data["d"])
    cols = torch.from_numpy(data["cols"][rank, :n_r]).to(dev)
    vals = torch.from_numpy(data["vals"][rank, :n_r]).to(dev)
    y = torch.from_numpy(data["y"][rank, :n_r]).to(dev)
    X = torch.zeros((n_r, d), dtype=torch.float32, device=dev).scatter_add_(1, cols.long(), vals)
    cfg = PAPER_RUNS["reuters"].gadget
    mesh_fns = wrappers(K, P, S, ())

    def counts() -> dict:
        return {fn.__name__: fn.launches for fn in mesh_fns}

    def reset() -> None:
        for fn in mesh_fns:
            fn.launches = 0

    def train(step, X_local, steps):
        w = torch.zeros((d,), dtype=torch.float32, device=dev)
        for t in range(1, steps + 1):
            key = crng.fold_in(crng.fold_in(crng.prng_key(0), t), rank)
            w = step(w, X_local, y, t, key)
        return w

    res = {"rank": rank, "rows": n_r, "backend": mesh.backend}
    step_k = make_gadget_mesh_step(cfg, axes, mesh=mesh)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    train(step_k, X, 3)  # warm-up
    sync()
    dist.barrier()
    reset()
    mesh.reset_stats()
    t0 = time.perf_counter()
    w_k = train(step_k, X, MESH_STEPS)
    sync()
    step_s = time.perf_counter() - t0
    st = mesh.stats()
    res.update(dense_launches=counts(), us_per_step=1e6 * step_s / MESH_STEPS,
               exchange_share=st["exchange_s"] / step_s, exchanges=st["exchanges"],
               host_staged_bytes=st["host_staged_bytes"])
    w_p = train(make_gadget_mesh_step(cfg, axes, mesh=mesh, use_kernels=False), X, MESH_STEPS)
    res["kernel_vs_plain"] = float((w_k - w_p).abs().max())
    res["finite"] = bool(torch.isfinite(w_k).all())

    if world > 1:
        def faulted(**kw):
            return train(make_gadget_mesh_step(cfg._replace(faults=FaultPlan(**kw)), axes,
                                               mesh=mesh), X, MESH_FAULT_STEPS)
        w_clean = train(step_k, X, MESH_FAULT_STEPS)
        w_inert = faulted(drop_prob=0.0, seed=7)
        w_dead = faulted(dead_nodes=(2,), seed=7)
        w_drop = faulted(drop_prob=0.5, drop="message", seed=7)
        try:
            make_gadget_mesh_step(cfg._replace(faults=FaultPlan(dead_nodes=(world,))), axes,
                                  mesh=mesh)
            raised = False
        except ValueError:
            raised = True
        res["faults"] = dict(inert_equal=bool(torch.equal(w_inert, w_clean)),
                             dead_max=float(w_dead.abs().max()),
                             drop_finite=bool(torch.isfinite(w_drop).all()),
                             drop_max=float(w_drop.abs().max()),
                             drop_differs=not bool(torch.equal(w_drop, w_clean)),
                             out_of_range_raised=raised)

        bound_s = int(data["block_bound"])
        step_s_ = make_gadget_mesh_step(cfg._replace(sparse_schedule="prefetch"), axes, bound_s,
                                        mesh=mesh)
        ell = (cols, vals)
        reset()
        w_s3 = train(step_s_, ell, MESH_SPARSE_CHECK_STEPS)
        w_d3 = train(step_k, X, MESH_SPARSE_CHECK_STEPS)
        w_s = train(step_s_, ell, MESH_STEPS)
        c = counts()
        # the same ELL step on the plain half-step: what holds B2/B3 at this shape
        step_sp = make_gadget_mesh_step(cfg._replace(sparse_schedule="prefetch"), axes,
                                        bound_s, mesh=mesh, use_kernels=False)
        w_p3 = train(step_sp, ell, MESH_SPARSE_CHECK_STEPS)
        w_p = train(step_sp, ell, MESH_STEPS)
        res["sparse"] = dict(plain_3=float((w_s3 - w_p3).abs().max()),
                             plain_200=float((w_s - w_p).abs().max()),
                             err_3=float((w_s3 - w_d3).abs().max()),
                             err_200=float((w_s - w_k).abs().max()),
                             launches={k: n for k, n in c.items() if k.startswith("ell_")},
                             steps=MESH_SPARSE_CHECK_STEPS + MESH_STEPS)

        g = torch.Generator(device=dev).manual_seed(100 + rank)
        v = torch.randn(d, generator=g, device=dev)
        mean = torch.stack(mesh.all_gather(v)).mean(dim=0)
        one = torch.stack(mesh.all_gather(gossip_mix(v, 1, axis_sizes=axes, rounds=1,
                                                     mesh=mesh))).mean(dim=0)
        full = gossip_mix(v, 0, axis_sizes=axes, rounds=world.bit_length() - 1,
                          mesh=mesh)  # log2(world) rounds: the whole schedule
        res["gossip"] = dict(mean_kept=float((one - mean).abs().max()),
                             full_to_mean=float((full - mean).abs().max()))

    # the mesh scorer: the consensus of the kernel run over the test set
    w_mean = mesh.all_reduce_sum(w_k) / world
    Xte = torch.zeros((int(data["test_rows"]), d), dtype=torch.float32, device=dev)
    Xte.scatter_add_(1, torch.from_numpy(data["test_cols"]).to(dev).long(),
                     torch.from_numpy(data["test_vals"]).to(dev))
    reset()
    scores, labels = make_mesh_scorer(w_mean, mesh=mesh, device=dev)(Xte)
    c = counts()
    # B8 on each rank's rows against the plain scores on the same rows
    plain_s, plain_l = make_mesh_scorer(w_mean, mesh=mesh, use_kernels=False, device=dev)(Xte)
    # and the whole batch on one process
    want_s, want_l = ops.dense_predict(w_mean, Xte)
    res["scorer"] = dict(err=float((scores - plain_s).abs().max())
                         / max(1.0, float(plain_s.abs().max())),
                         labels_equal=bool(torch.equal(labels, plain_l)),
                         one_process_err=float((scores - want_s).abs().max())
                         / max(1.0, float(want_s.abs().max())),
                         one_process_labels_equal=bool(torch.equal(labels, want_l)),
                         dense_scores=c["dense_scores"], rows=int(Xte.shape[0]))
    (work / f"rank{rank}_{backend}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


def run_mesh(world: int, backend: str, work: Path, device_type: str = "cuda") -> list[dict]:
    """Spawn ``world`` ranks of :func:`mesh_rank` and wait for them; any rank
    that fails or hangs fails the phase (the rest are killed)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    rdv = work / f"rdv_{backend}_{world}_{time.monotonic_ns()}"  # a fresh file each run
    procs = [ctx.Process(target=mesh_rank, args=(r, world, backend, str(rdv), str(work),
                                                 device_type))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + MESH_TIMEOUT_S
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
            if p.exitcode not in (None, 0):
                break  # a rank failed: the others would wait on it
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    require(codes == [0] * world, f"mesh ranks ({backend}, world {world}) exited {codes}")
    return [json.loads((work / f"rank{r}_{backend}.json").read_text()) for r in range(world)]


def phase_mesh(torch, partition, ds_r, work: Path, routes) -> dict:
    """Phase 21: the mesh step, its faults, the sparse mesh step, the mesh
    scorer and gossip_mix on four gloo ranks sharing the card, then the
    dense mesh at world = the card count over NCCL; the steps' launches are
    their routes' (``routes``: ``ops.HALF_STEP_KINDS``). The kernels are
    already built (phase 2), so no rank runs nvcc."""
    X_te = ds_r.X_test
    pad = -X_te.shape[0] % MESH_WORLD
    for world in sorted({MESH_WORLD, torch.cuda.device_count()}):
        parts, y_parts, counts = partition(ds_r.X_train, ds_r.y_train, world, seed=0)
        np.savez(work / f"data_{world}.npz", cols=parts.cols, vals=parts.vals, y=y_parts,
                 counts=counts, d=parts.d, block_bound=parts.block_bound(1),
                 test_cols=np.pad(X_te.cols, ((0, pad), (0, 0))),
                 test_vals=np.pad(X_te.vals, ((0, pad), (0, 0))),
                 test_rows=X_te.shape[0] + pad)
    out = {}
    t0 = time.perf_counter()
    ranks = run_mesh(MESH_WORLD, "gloo", work)
    gloo_s = time.perf_counter() - t0
    staged = sum(r["host_staged_bytes"] for r in ranks)
    log(f"  backend {ranks[0]['backend']}, world {MESH_WORLD}, host_staged_bytes {staged} "
        f"(ranks {[r['host_staged_bytes'] for r in ranks]}), {gloo_s:.1f} s with start-up")
    for r in ranks:
        log(f"    rank {r['rank']}: {r['rows']} rows, {r['us_per_step']:.1f} us a step, "
            f"{r['exchange_share']:.3f} of it exchanging ({r['exchanges']} exchanges in "
            f"{MESH_STEPS} steps), kernels against plain {r['kernel_vs_plain']:.3e}, "
            f"launches {launched(r['dense_launches'])}")
        require(r["backend"] == "gloo" and r["finite"], f"rank {r['rank']}: backend or W")
        require(r["kernel_vs_plain"] <= PATH_W_ATOL,
                f"rank {r['rank']}: kernel step differs from the plain by {r['kernel_vs_plain']:.3e}")
        require_launches(r["dense_launches"], routes["unfused"], MESH_STEPS,
                         f"rank {r['rank']}'s dense step")
        f = r["faults"]
        require(f["inert_equal"], f"rank {r['rank']}: an inert plan moved the step")
        require((f["dead_max"] == 0.0) == (r["rank"] == 2),
                f"rank {r['rank']}: dead-rank check (max |w| {f['dead_max']})")
        require(f["drop_finite"] and f["drop_max"] > 0 and f["drop_differs"],
                f"rank {r['rank']}: message drops {f}")
        require(f["out_of_range_raised"], f"rank {r['rank']}: out-of-range dead id accepted")
        sp = r["sparse"]
        require(sp["plain_3"] <= SPARSE_PARITY_ATOL and sp["plain_200"] <= PATH_W_ATOL,
                f"rank {r['rank']}: sparse mesh step against its plain version {sp}")
        require(sp["err_3"] <= SPARSE_PARITY_ATOL and sp["err_200"] <= PATH_W_ATOL,
                f"rank {r['rank']}: sparse mesh step against dense {sp}")
        require_launches(sp["launches"], routes["prefetch"], sp["steps"],
                         f"rank {r['rank']}'s sparse step")
        sc = r["scorer"]
        require(sc["err"] <= KERNEL_RTOL and sc["labels_equal"] and sc["dense_scores"] == 1
                and sc["one_process_err"] <= KERNEL_RTOL and sc["one_process_labels_equal"],
                f"rank {r['rank']}: mesh scorer {sc}")
        g = r["gossip"]
        require(g["mean_kept"] <= GOSSIP_MEAN_ATOL and g["full_to_mean"] <= GOSSIP_MEAN_ATOL,
                f"rank {r['rank']}: gossip_mix {g}")
    log(f"  faults: inert plan bit-identical, rank 2 dead at zero, message drops finite and "
        f"different, id {MESH_WORLD} refused; sparse against its plain version: "
        f"{max(r['sparse']['plain_3'] for r in ranks):.3e} after {MESH_SPARSE_CHECK_STEPS} "
        f"steps, {max(r['sparse']['plain_200'] for r in ranks):.3e} after {MESH_STEPS}; "
        f"against dense: {max(r['sparse']['err_3'] for r in ranks):.3e} and "
        f"{max(r['sparse']['err_200'] for r in ranks):.3e}; scorer over "
        f"{ranks[0]['scorer']['rows']} rows against plain "
        f"{max(r['scorer']['err'] for r in ranks):.3e}, against one process "
        f"{max(r['scorer']['one_process_err'] for r in ranks):.3e}; "
        f"gossip_mix mean kept {max(r['gossip']['mean_kept'] for r in ranks):.3e}, full "
        f"schedule {max(r['gossip']['full_to_mean'] for r in ranks):.3e} from the mean")
    out["gloo"] = dict(world=MESH_WORLD, seconds=gloo_s, host_staged_bytes=staged,
                       ranks=ranks,
                       margins=sum(r["dense_launches"]["margins"] for r in ranks),
                       grad_update=sum(r["dense_launches"]["grad_update"] for r in ranks),
                       dense_scores=sum(r["scorer"]["dense_scores"] for r in ranks),
                       **{name: sum(r["sparse"]["launches"][name] for r in ranks)
                          for name in ranks[0]["sparse"]["launches"]})

    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    ranks = run_mesh(world, "nccl", work)
    nccl_s = time.perf_counter() - t0
    for r in ranks:
        log(f"  backend {r['backend']}, world {world}, rank {r['rank']}: {r['rows']} rows, "
            f"{r['us_per_step']:.1f} us a step, {r['exchange_share']:.3f} exchanging, "
            f"host_staged_bytes {r['host_staged_bytes']}, kernels against plain "
            f"{r['kernel_vs_plain']:.3e}, launches {launched(r['dense_launches'])}, scorer "
            f"{r['scorer']['err']:.3e}")
        require(r["backend"] == "nccl" and r["finite"] and r["host_staged_bytes"] == 0,
                f"rank {r['rank']}: NCCL run {r['backend']}, staged {r['host_staged_bytes']}")
        require(r["kernel_vs_plain"] <= PATH_W_ATOL, f"NCCL rank {r['rank']}: kernels off plain")
        require_launches(r["dense_launches"], routes["unfused"], MESH_STEPS,
                         f"NCCL rank {r['rank']}'s dense step")
        sc = r["scorer"]
        require(sc["err"] <= KERNEL_RTOL and sc["labels_equal"]
                and sc["one_process_err"] <= KERNEL_RTOL and sc["one_process_labels_equal"],
                f"NCCL rank {r['rank']}: mesh scorer {sc}")
    out["nccl"] = dict(world=world, seconds=nccl_s, ranks=ranks,
                       margins=sum(r["dense_launches"]["margins"] for r in ranks),
                       grad_update=sum(r["dense_launches"]["grad_update"] for r in ranks),
                       dense_scores=sum(r["scorer"]["dense_scores"] for r in ranks))
    return out


def phase_kernel_grads(torch, FA, RG, WK, gen, dev) -> dict:
    """Gradients through B10-B12 on the card: each operator's autograd
    formula (B11's backward the kernel on the time-flipped inputs, B10's
    and B12's backward operators the plain version's vector-Jacobian
    product written out) against autograd through the plain version on the
    same inputs, relative ``KERNEL_RTOL`` (B10 in bf16: ``BF16_ATOL``)."""
    out = {}

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=dev)

    def check(name, fn, plain, inputs, rtol=KERNEL_RTOL, atol=None):
        leaves = [t.detach().requires_grad_() for t in inputs]
        y = fn(*leaves)
        d_out = randn(*y.shape).to(y.dtype)
        require(y.grad_fn is not None, f"{name}: the kernel's output carries no gradient")
        got = torch.autograd.grad(y, leaves, d_out, materialize_grads=True)
        want = torch.autograd.grad(plain(*leaves), leaves, d_out, materialize_grads=True)
        errs = [rel_err(g.float(), w.float()) for g, w in zip(got, want)]
        worst = max(e[0] if atol is not None else e[1] for e in errs)
        require(all(bool(torch.isfinite(g).all()) for g in got), f"{name}: gradient not finite")
        require(worst <= (atol if atol is not None else rtol),
                f"{name}: gradient against autograd through the plain version {worst:.3e}")
        out[name] = max(e[1] for e in errs)
        log(f"  grad {name}: worst {'abs' if atol is not None else 'rel'} err {worst:.3e}")

    for which, (b, s, h, hkv, dh, causal, window, dt) in {
            "attn": (2, 200, 4, 2, 64, True, 0, torch.float32),
            "attn_window": (1, 300, 4, 1, 80, True, 64, torch.float32),
            "attn_encoder": (2, 150, 4, 4, 80, False, 0, torch.float32),
            "attn_bf16": (2, 200, 4, 2, 64, True, 0, torch.bfloat16),
            **{f"attn_{k}": c for k, c in EXAMPLE_ATTN.items()}}.items():
        dt = getattr(torch, dt) if isinstance(dt, str) else dt
        q, k, v = randn(b, s, h, dh).to(dt), randn(b, s, hkv, dh).to(dt), randn(b, s, hkv, dh).to(dt)
        check(f"flash_attention {which}",
              lambda q, k, v: FA.flash_attention(q, k, v, causal=causal, window=window),
              lambda q, k, v: FA.flash_attention_plain(q, k, v, causal=causal, window=window),
              (q, k, v), atol=BF16_ATOL if dt == torch.bfloat16 else None)
    for which, (B, S, D) in {"rglru": (2, 300, 130), "rglru_s1": (1, 1, 64),
                             "rglru_wide": (1, 257, 4096)}.items():
        a = 0.8 + 0.199 * torch.rand(B, S, D, generator=gen, device=dev)
        check(f"rglru_scan {which}", RG.rglru_scan, RG.rglru_scan_plain, (a, randn(B, S, D)))
    for which, (B, S, H, n) in {"wkv": (2, 65, 3, 64), "wkv_t1": (1, 1, 2, 24),
                                "wkv_n80": (1, 33, 2, 80)}.items():
        w = 0.8 + 0.199 * torch.rand(B, S, H, n, generator=gen, device=dev)
        check(f"wkv_scan {which}", WK.wkv_scan, WK.wkv_scan_plain,
              (randn(B, S, H, n, scale=0.3), randn(B, S, H, n, scale=0.3),
               randn(B, S, H, n, scale=0.3), w, randn(H, n, scale=0.1)))
    return out


def plain_backward_counts(FA, WK) -> dict:
    return {"flash_attention": FA.flash_attention.plain_backwards,
            "wkv_scan": WK.wkv_scan.plain_backwards}


def reset_plain_backwards(FA, WK) -> None:
    FA.flash_attention.plain_backwards = 0
    WK.wkv_scan.plain_backwards = 0


def fit_depth(torch, Model, cfg, label: str, copies: float, extra_bytes: int):
    """``cfg`` cut in depth (never in width) until ``copies`` float32 copies
    of its parameters plus ``extra_bytes`` fit in the card's free memory;
    prints the reckoning and any cut."""
    free, _ = torch.cuda.mem_get_info()
    n_layers = cfg.n_layers
    while True:
        c = dataclasses.replace(cfg, n_layers=n_layers)
        n = sum(p.numel() for p in Model(c, device="meta").parameters())
        need = 4 * n * copies + extra_bytes
        if need <= 0.92 * free or n_layers == 1:
            break
        n_layers -= 1
    log(f"  {label}: {n:,} parameters, {copies} f32 copies + {extra_bytes / 1e9:.1f} GB = "
        f"{need / 1e9:.1f} GB of {free / 1e9:.1f} GB free"
        + ("" if n_layers == cfg.n_layers else f"; CUT from {cfg.n_layers} to {n_layers} layers"))
    require(need <= free, f"{label} does not fit at one layer")
    return c, n


def batch_prefix(batch: dict, n: int) -> dict:
    return {k: v[:, :n] for k, v in batch.items()}


def forward_phase(torch, model, batch: dict, expect: dict, K, P, S, X) -> dict:
    """One warm-up forward over a prefix, then the prefill step over
    ``batch`` with every launch counted (each kernel of ``expect`` that many
    times, every other never), the logits finite and of the batch's shape."""
    from repro_torch.launch.steps import make_prefill_step
    prefill = make_prefill_step(model)
    prefill(batch_prefix(batch, 64))
    torch.cuda.synchronize()
    reset_counts(K, P, S, X)
    t0 = time.perf_counter()
    logits = prefill(batch)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    got = counts(K, P, S, X)
    seq = sum(v.shape[1] for k, v in batch.items() if k in ("tokens", "patch_embeds", "frames"))
    B = next(iter(batch.values())).shape[0]
    require(tuple(logits.shape) == (B, seq, model.cfg.vocab_size), f"logits {tuple(logits.shape)}")
    require(bool(torch.isfinite(logits).all()), f"{model.cfg.name}: logits not finite")
    del logits
    for name, n in got.items():
        require(n == expect.get(name, 0), f"{name} launched {n} times in one {model.cfg.name} "
                f"forward, want {expect.get(name, 0)}")
    log(f"  {model.cfg.name} ({model.cfg.n_layers} layers): forward {B} x {seq} positions in "
        f"{s:.3f} s ({B * seq / s:.1f} tokens/s), launches {launched(got)}, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    return {"layers": model.cfg.n_layers, "batch": B, "positions": seq, "forward_s": s,
            "tokens_per_s": B * seq / s, "launches": launched(got),
            "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_new_families(torch, get_config, Model, make_host_batch, make_prefill_step,
                       make_serve_step, K, P, S, X, dev) -> dict:
    """Phase 22: the MoE, VLM and audio families at full width on the card,
    each model freed before the next is drawn."""
    out = {}
    gen = torch.Generator(device=dev).manual_seed(22)

    log("  qwen2-moe-a2.7b: prefill at full width and depth")
    cfg = get_config("qwen2-moe-a2.7b")
    logits_bytes = 4 * PREFILL_BATCH * PREFILL_LEN * cfg.vocab_size
    cfg, n = fit_depth(torch, Model, cfg, cfg.name, 1, 3 * logits_bytes)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=dev).init(gen)
    toks = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN), generator=gen, device=dev)
    out["qwen2-moe-a2.7b"] = forward_phase(torch, model, {"tokens": toks},
                                           {"flash_attention": cfg.n_layers}, K, P, S, X)
    out["qwen2-moe-a2.7b"]["parameters"] = n
    del model, toks
    free_cuda(torch)
    # decode against prefill at one layer: every choice must fit its expert
    # in the prefill as in decode (capacity top_k at one token), so the
    # capacity factor is n_experts / top_k: capacity S, nothing dropped
    moe = dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)
    model = Model(dataclasses.replace(cfg, n_layers=1, moe=moe), device=dev).init(gen)
    toks = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, MOE_DECODE_LEN), generator=gen,
                         device=dev)
    out["qwen2-moe-a2.7b"]["decode_vs_prefill"] = decode_against_prefill(
        torch, model, make_prefill_step(model), make_serve_step(model), toks)
    del model, toks
    free_cuda(torch)

    log("  llava-next-mistral-7b: prefill with its patch prefix at full width and depth")
    cfg = get_config("llava-next-mistral-7b")
    cfg, n = fit_depth(torch, Model, cfg, cfg.name, 1, 3 * 4 * PREFILL_BATCH * PREFILL_LEN
                       * cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=dev).init(gen)
    batch = make_host_batch(cfg, PREFILL_BATCH, PREFILL_LEN, seed=22, device=dev)
    require(batch["patch_embeds"].shape[1] == cfg.n_prefix_embeds == 576,
            f"patch prefix {tuple(batch['patch_embeds'].shape)}")
    out["llava-next-mistral-7b"] = forward_phase(torch, model, batch,
                                                 {"flash_attention": cfg.n_layers}, K, P, S, X)
    out["llava-next-mistral-7b"].update(parameters=n, patches=cfg.n_prefix_embeds)
    del model, batch
    free_cuda(torch)

    log("  hubert-xlarge: encoder forward over frames at full width and depth")
    cfg = get_config("hubert-xlarge")
    cfg, n = fit_depth(torch, Model, cfg, cfg.name, 1, 0)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=dev).init(gen)
    require(not hasattr(model, "embed") and hasattr(model, "head") and cfg.head_dim == 80,
            "hubert-xlarge: an embedding table, or no head, or heads not of 80")
    batch = make_host_batch(cfg, PREFILL_BATCH, PREFILL_LEN, seed=23, device=dev)
    out["hubert-xlarge"] = forward_phase(torch, model, {"frames": batch["frames"]},
                                         {"flash_attention": cfg.n_layers}, K, P, S, X)
    out["hubert-xlarge"]["parameters"] = n
    del model, batch
    free_cuda(torch)
    return out


def state_to(optim, state, device) -> dict:
    return optim.tree_map(lambda t: t.to(device), state)


def replica_spread(params: dict) -> float:
    """sqrt of the summed squared distances of the replicas from their mean."""
    return math.sqrt(sum(float(((v - v.mean(dim=0, keepdim=True)) ** 2).sum())
                         for v in params.values()))


def grad_check(torch, steps, model, params: dict, batch: dict) -> tuple[float, dict, float]:
    """One forward and backward of ``model.loss`` with ``params`` swapped in:
    every parameter must get a gradient (not None: the kernels' outputs
    carry theirs), and each must be finite. Returns the global norm, the
    gradients and the loss."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with steps.swapped_params(model, leaves):
        loss, _ = model.loss(batch)
        loss.backward(inputs=list(leaves.values()))
    missing = [k for k, v in leaves.items() if v.grad is None]
    require(not missing, f"{model.cfg.name}: no gradient reached {missing[:5]}")
    bad = [k for k, v in leaves.items() if not bool(torch.isfinite(v.grad).all())]
    require(not bad, f"{model.cfg.name}: gradient not finite at {bad[:5]}")
    require(bool(torch.isfinite(loss)), f"{model.cfg.name}: loss not finite")
    norm = math.sqrt(sum(float((v.grad.float() ** 2).sum()) for v in leaves.values()))
    return norm, {k: v.grad for k, v in leaves.items()}, float(loss.detach())


def leaf_rel_err(got: dict, want: dict) -> tuple[float, str]:
    """The worst leaf's max |got − want| over its own max |want|, and its name."""
    worst = (0.0, "")
    for k, w in want.items():
        err, top = float((got[k].cpu() - w).abs().max()), float(w.abs().max())
        worst = max(worst, (err / top if top else (0.0 if err == 0 else math.inf), k))
    return worst


def expected_step_launches(cfg, replicas: int = 1, remat: bool = False) -> tuple[dict, dict]:
    """(kernel launches, plain backward passes) of one train step of ``cfg``:
    a forward launch a layer of its kind and replica (two under ``remat``:
    the backward recomputes each block's forward), one more B11 launch a
    layer for the reverse scan, and one plain backward a B10 and B12 layer."""
    from repro_torch.models.transformer import layer_kinds
    kinds = layer_kinds(cfg)
    n_attn = sum(k in ("attn", "swa", "local_attn") for k in kinds)
    n_rg, n_rw = kinds.count("rglru"), kinds.count("rwkv6")
    fwd = 2 if remat else 1
    launches = {"flash_attention": fwd * n_attn * replicas,
                "rglru_scan": (fwd + 1) * n_rg * replicas, "wkv_scan": fwd * n_rw * replicas}
    plain = {"flash_attention": n_attn * replicas, "wkv_scan": n_rw * replicas}
    return ({k: v for k, v in launches.items() if v}, plain)


def train_run(torch, steps, optim, model, tcfg, batches, FA, WK, K, P, S, X, label: str,
              spread: bool = False) -> dict:
    """``len(batches)`` train steps of ``model`` under ``tcfg`` on the card:
    loss, seconds and launches per step, the peak memory; a gradient check
    on the first batch; with ``spread``, the gossip replicas' spread after
    each step against the same step without its mix."""
    cfg = model.cfg
    G = tcfg.n_replicas if tcfg.consensus == "gossip" else 1
    state = steps.make_train_state(model, tcfg, torch.Generator(device=model.device).manual_seed(23))
    first = batches[0] if G == 1 else {k: v[0] for k, v in batches[0].items()}
    grad_norm = grad_check(torch, steps, model, state["params"] if G == 1 else
                           {k: v[0] for k, v in state["params"].items()}, first)[0]
    step = steps.make_train_step(model, tcfg)
    step(state, batch_prefix(batches[0], 16) if G == 1 else
         {k: v[:, :, :16] for k, v in batches[0].items()})  # warm-up: cuBLAS, the libraries
    no_mix = steps.make_train_step(model, dataclasses.replace(tcfg, gossip_rounds=0))
    want, want_plain = expected_step_launches(cfg, G)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for i, b in enumerate(batches):
        pre_spread = (replica_spread(no_mix(state, b)[0]["params"])
                      if spread and tcfg.n_replicas > 1 else None)
        torch.cuda.synchronize()
        reset_counts(K, P, S, X)
        reset_plain_backwards(FA, WK)
        t0 = time.perf_counter()
        state, m = step(state, b)
        loss = float(m["loss"])
        sec = time.perf_counter() - t0
        got, plain = launched(counts(K, P, S, X)), plain_backward_counts(FA, WK)
        require(math.isfinite(loss), f"{label}: step {i} loss {loss}")
        require(got == want, f"{label}: step {i} launched {got}, want {want}")
        require(plain == want_plain,
                f"{label}: step {i} ran plain backward passes {plain}, want {want_plain}")
        row = {"step": i, "loss": loss, "s": sec, "launches": got, "plain_backwards": plain}
        if pre_spread is not None:
            post = replica_spread(state["params"])
            row.update(spread_before_mix=pre_spread, spread_after_mix=post)
            require(post < pre_spread, f"{label}: the mix did not shrink the replicas' spread "
                    f"({pre_spread:.4e} -> {post:.4e})")
        rows.append(row)
        log(f"  {label} step {i}: loss {loss:.4f}, {sec:.3f} s, launches {got}, plain "
            f"backwards {plain}" + ("" if pre_spread is None else
                                    f", spread {pre_spread:.4e} -> {row['spread_after_mix']:.4e}"))
    for v in optim.tree_leaves(state["params"]):
        require(bool(torch.isfinite(v).all()), f"{label}: parameters not finite after training")
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  {label}: max_memory_allocated {peak:.1f} GB, gradient norm at the first batch "
        f"{grad_norm:.4e}")
    return {"steps": rows, "max_memory_gb": peak, "grad_norm": grad_norm,
            "parameters": sum(v.numel() for v in state["params"].values()),
            "s_per_step": sum(r["s"] for r in rows) / len(rows),
            "launches_per_step": want, "plain_backwards_per_step": want_plain}


def remat_check(torch, steps, model, tcfg, batch, policy: str, FA, WK, K, P, S, X,
                label: str) -> dict:
    """One train step with ``remat`` under ``policy`` against the same step
    with it off, from one state: the parameters bit for bit, the remat
    step's launches those of ``expected_step_launches(remat=True)`` (the
    recompute launches each block's kernels again), and each step's
    seconds and peak memory above what was allocated before it. The step
    without remat runs twice first: equal results show the step itself
    reproducible on the card, so a difference under remat is the remat's."""
    state = steps.make_train_state(model, tcfg, torch.Generator(device=model.device).manual_seed(23))
    rows, params = {}, {}
    for run, remat in (("no_remat", False), ("no_remat_again", False), ("remat", True)):
        step = steps.make_train_step(model, dataclasses.replace(tcfg, remat=remat,
                                                                remat_policy=policy))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(K, P, S, X)
        reset_plain_backwards(FA, WK)
        t0 = time.perf_counter()
        new, m = step(state, batch)
        loss = float(m["loss"])
        sec = time.perf_counter() - t0
        got, plain = launched(counts(K, P, S, X)), plain_backward_counts(FA, WK)
        want, want_plain = expected_step_launches(model.cfg, remat=remat)
        require(got == want and plain == want_plain,
                f"{label} remat={remat}: launched {got} with plain backwards {plain}, want "
                f"{want} and {want_plain}")
        if run == "no_remat_again":
            repeat = [k for k, v in params["no_remat"].items() if not torch.equal(v, new["params"][k])]
            require(not repeat, f"{label}: the step without remat is not reproducible on the card "
                    f"({len(repeat)} parameters differ between two runs: {repeat[:5]})")
        else:
            params[run] = new["params"]
        del new, m
        rows[run] = {
            "loss": loss, "s": sec, "step_peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
            "launches": got, "plain_backwards": plain}
    differ = [k for k, v in params["no_remat"].items() if not torch.equal(v, params["remat"][k])]
    log(f"  {label} remat {policy!r}: {len(differ)} of {len(params['remat'])} parameters differ "
        f"from the step without remat (which repeats bit for bit); " + "; ".join(
            f"{k} {r['s']:.3f} s, step peak {r['step_peak_gb']:.1f} GB, launches {r['launches']}"
            for k, r in rows.items()))
    require(not differ, f"{label}: remat {policy!r} changed {differ[:5]}")
    return {"policy": policy, **rows}


def backward_costs(torch, FA, RG, WK, gen, dev) -> dict:
    """Device ms of each kernel's forward and of forward plus backward at the
    shapes of phase 23's full-width runs; the backward is the difference.
    B10's and B12's backward is the plain version recomputed under
    autograd, B11's one more launch of the kernel on flipped inputs."""
    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device=dev)).requires_grad_()

    cases = {}
    for label, (b, s, h, hkv, dh, causal, window) in {
            "flash_attention, qwen2-moe (b)": (2, 2048, 16, 16, 128, True, 0),
            "flash_attention, hubert (c)": (2, 1024, 16, 16, 80, False, 0),
            "flash_attention, recurrentgemma (e)": (1, 2048, 16, 1, 256, True, 2048)}.items():
        q, k, v = randn(b, s, h, dh), randn(b, s, hkv, dh), randn(b, s, hkv, dh)
        cases[label] = (lambda q=q, k=k, v=v, c=causal, w=window:
                        FA.flash_attention(q, k, v, causal=c, window=w), (q, k, v))
    a = (0.8 + 0.199 * torch.rand(1, 2048, 4096, generator=gen, device=dev)).requires_grad_()
    bb = randn(1, 2048, 4096)
    cases["rglru_scan, recurrentgemma (e)"] = (lambda: RG.rglru_scan(a, bb), (a, bb))
    r, k, v = (randn(2, 512, 40, 64, scale=0.3) for _ in range(3))
    w = (0.8 + 0.199 * torch.rand(2, 512, 40, 64, generator=gen, device=dev)).requires_grad_()
    u = randn(40, 64, scale=0.1)
    cases["wkv_scan, rwkv6 (d)"] = (lambda: WK.wkv_scan(r, k, v, w, u), (r, k, v, w, u))
    out = {}
    for label, (fwd, inputs) in cases.items():
        y = fwd()
        d_out = torch.randn(y.shape, generator=gen, device=dev)
        n = 3 if label.startswith("wkv") else 10
        fwd_ms = device_ms(torch, fwd, n)
        both_ms = device_ms(torch, lambda: torch.autograd.grad(fwd(), inputs, d_out), n)
        out[label] = {"forward_ms": fwd_ms, "backward_ms": both_ms - fwd_ms}
        log(f"  {label}: forward {fwd_ms:.3f} ms, backward {both_ms - fwd_ms:.3f} ms")
    return out


def phase_training(torch, get_config, Model, make_host_batch, steps, optim, Batcher,
                   TokenStreamConfig, FA, RG, WK, K, P, S, X, dev) -> dict:
    """Phase 23: transformer training on the card."""
    from repro_torch.models.transformer import layer_kinds
    out = {"card_vs_cpu": {}}
    # (a) every family at its reduced config: the first gradients and two
    # steps on the card against the same state and batches on the CPU
    for arch, n_layers in TRAIN_CHECK_ARCHS:
        cfg = get_config(arch).reduced(n_layers=n_layers)
        for consensus in ("allreduce", "gossip"):
            G = TRAIN_REPLICAS if consensus == "gossip" else 1
            tcfg = steps.TrainerConfig(optimizer="sgd", lr=3e-3, warmup_steps=1, total_steps=4,
                                       consensus=consensus, n_replicas=G)
            model, cpu_model = Model(cfg, device=dev), Model(cfg, device="cpu")
            state = steps.make_train_state(model, tcfg, torch.Generator(device=dev).manual_seed(1))
            cpu_state = state_to(optim, state, "cpu")
            first = {k: v if G == 1 else v[0] for k, v in cpu_state["params"].items()}
            b0 = make_host_batch(cfg, 2, TRAIN_CHECK_SEQ, seed=5, device="cpu")
            grad_norm, grads, _ = grad_check(torch, steps, model,
                                             {k: v.to(dev) for k, v in first.items()},
                                             {k: v.to(dev) for k, v in b0.items()})
            grad_err, grad_leaf = leaf_rel_err(grads, grad_check(torch, steps, cpu_model, first,
                                                                 b0)[1])
            del grads
            step, cpu_step = steps.make_train_step(model, tcfg), steps.make_train_step(cpu_model, tcfg)
            want, want_plain = expected_step_launches(cfg, G)
            losses = []
            for i in range(2):
                b = make_host_batch(cfg, 2 * G, TRAIN_CHECK_SEQ, seed=10 + i,
                                    n_replicas=G if G > 1 else 0, device="cpu")
                reset_counts(K, P, S, X)
                reset_plain_backwards(FA, WK)
                state, m = step(state, {k: v.to(dev) for k, v in b.items()})
                torch.cuda.synchronize()
                got, plain = launched(counts(K, P, S, X)), plain_backward_counts(FA, WK)
                require(got == want, f"{arch} {consensus}: step {i} launched {got}, want {want}")
                require(plain == want_plain,
                        f"{arch} {consensus}: plain backwards {plain}, want {want_plain}")
                cpu_state, cm = cpu_step(cpu_state, b)
                losses.append((float(m["loss"]), float(cm["loss"])))
                require(math.isfinite(losses[-1][0]), f"{arch}: loss not finite")
            loss_err = max(abs(a - b) / abs(b) for a, b in losses)
            err = max(rel_err(state["params"][k].cpu(), v)[1]
                      for k, v in cpu_state["params"].items())
            log(f"  (a) {cfg.name} {consensus}: on the card against the CPU, first gradients "
                f"{grad_err:.3e} of their leaf's max (<= {TRAIN_GRAD_RTOL}; {grad_leaf}), "
                f"losses {', '.join(f'{a:.6f} / {b:.6f}' for a, b in losses)} "
                f"({loss_err:.3e} <= {TRAIN_LOSS_RTOL}), params after 2 steps rel err "
                f"{err:.3e} (<= {TRAIN_CHECK_RTOL}), launches a step {got}, plain backwards "
                f"{plain}, gradient norm {grad_norm:.3e}")
            require(grad_err <= TRAIN_GRAD_RTOL,
                    f"{arch} {consensus}: gradients card against CPU {grad_err:.3e} at {grad_leaf}")
            require(loss_err <= TRAIN_LOSS_RTOL,
                    f"{arch} {consensus}: losses card against CPU {loss_err:.3e}")
            require(err <= TRAIN_CHECK_RTOL, f"{arch} {consensus}: card against CPU {err:.3e}")
            out["card_vs_cpu"][f"{arch} {consensus}"] = {
                "layers": cfg.n_layers, "kinds": sorted(set(layer_kinds(cfg))),
                "grad_rel_err": grad_err, "grad_worst_leaf": grad_leaf, "loss_rel_err": loss_err,
                "params_rel_err": err, "launches_per_step": got, "plain_backwards_per_step": plain}
            del model, cpu_model, state, cpu_state
    free_cuda(torch)

    # (b) qwen2-moe-a2.7b at full width, 2 layers, all-reduce AdamW, Batcher tokens
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"), n_layers=TRAIN_MOE_LAYERS)
    B, T = TRAIN_MOE_BATCH
    cfg, _ = fit_depth(torch, Model, cfg, f"(b) {cfg.name}", 9, 3 * 4 * B * T * cfg.vocab_size)
    model = Model(cfg, device=dev)
    tcfg = steps.TrainerConfig(optimizer="adamw", lr=3e-4, warmup_steps=1, total_steps=10)
    batcher = Batcher(TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=T, global_batch=B,
                                        seed=0))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in batcher.global_batch(i).items()}
               for i in range(TRAIN_MOE_STEPS)]
    out["qwen2-moe-a2.7b"] = train_run(torch, steps, optim, model, tcfg, batches, FA, WK, K, P,
                                       S, X, f"(b) {cfg.name} {cfg.n_layers} layers all-reduce")
    out["qwen2-moe-a2.7b"]["remat"] = remat_check(
        torch, steps, model, tcfg, batches[0], TRAIN_REMAT["qwen2-moe-a2.7b"], FA, WK, K, P, S, X,
        f"(b) {cfg.name}")
    del model, batches
    free_cuda(torch)

    # (c) hubert-xlarge at full width and depth, frames with a mask
    cfg = get_config("hubert-xlarge")
    B, T = TRAIN_HUBERT_BATCH
    cfg, _ = fit_depth(torch, Model, cfg, f"(c) {cfg.name}", 8, 0)
    model = Model(cfg, device=dev)
    tcfg = steps.TrainerConfig(optimizer="adamw", lr=3e-4, warmup_steps=1, total_steps=10)
    batches = [make_host_batch(cfg, B, T, seed=30 + i, device=dev) for i in range(3)]
    require(0 < float(batches[0]["mask"].float().mean()) < 1, "the frame mask is not partial")
    out["hubert-xlarge"] = train_run(torch, steps, optim, model, tcfg, batches, FA, WK, K, P, S,
                                     X, f"(c) {cfg.name} {cfg.n_layers} layers all-reduce")
    del model, batches
    free_cuda(torch)

    # (d) rwkv6-3b at full width, 2 layers, gossip at G = 4
    cfg = dataclasses.replace(get_config("rwkv6-3b"), n_layers=TRAIN_RWKV_LAYERS)
    G, (B, T) = TRAIN_REPLICAS, TRAIN_RWKV_BATCH
    cfg, _ = fit_depth(torch, Model, cfg, f"(d) {cfg.name}", 8 * G, 0)
    model = Model(cfg, device=dev)
    tcfg = steps.TrainerConfig(optimizer="adamw", lr=3e-4, warmup_steps=1, total_steps=10,
                               consensus="gossip", n_replicas=G)
    batcher = Batcher(TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=T,
                                        global_batch=B * G, seed=1))
    batches = [{k: torch.from_numpy(v).to(dev).reshape(G, B, T)
                for k, v in batcher.global_batch(i).items()} for i in range(3)]
    out["rwkv6-3b"] = train_run(torch, steps, optim, model, tcfg, batches, FA, WK, K, P, S, X,
                                f"(d) {cfg.name} {cfg.n_layers} layers gossip G={G}", spread=True)
    del model, batches
    free_cuda(torch)

    # (e) recurrentgemma-9b at full width over one cycle, all-reduce
    base = get_config("recurrentgemma-9b")
    cfg = dataclasses.replace(base, n_layers=len(base.block_pattern))
    B, T = TRAIN_RG_BATCH
    cfg, _ = fit_depth(torch, Model, cfg, f"(e) {cfg.name}", 7, 3 * 4 * B * T * cfg.vocab_size)
    model = Model(cfg, device=dev)
    tcfg = steps.TrainerConfig(optimizer="sgd", lr=3e-4, warmup_steps=1, total_steps=10)
    batcher = Batcher(TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=T, global_batch=B,
                                        seed=2))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in batcher.global_batch(i).items()}
               for i in range(3)]
    out["recurrentgemma-9b"] = train_run(torch, steps, optim, model, tcfg, batches, FA, WK, K, P,
                                         S, X, f"(e) {cfg.name} {cfg.n_layers} layers all-reduce")
    out["recurrentgemma-9b"]["remat"] = remat_check(
        torch, steps, model, tcfg, batches[0], TRAIN_REMAT["recurrentgemma-9b"], FA, WK, K, P, S,
        X, f"(e) {cfg.name}")
    del model, batches
    free_cuda(torch)
    out["backward_costs"] = backward_costs(torch, FA, RG, WK,
                                           torch.Generator(device=dev).manual_seed(24), dev)
    return out


def phase_op_checks(torch, dev) -> dict:
    """``torch.library.opcheck`` of B10-B12's operators and their backward
    operators on CUDA tensors at small shapes: the fake implementations give
    the kernels' output metadata, and the autograd registrations are sound."""
    from torch.library import opcheck

    g = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, grad=False, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device=dev)).requires_grad_(grad)

    def decay(*shape, grad=False):
        return (0.8 + 0.199 * torch.rand(*shape, generator=g, device=dev)).requires_grad_(grad)

    ops = torch.ops.repro_torch
    cases = {
        "flash_attention": (ops.flash_attention, (randn(2, 70, 4, 64, grad=True),
                                                  randn(2, 70, 2, 64, grad=True),
                                                  randn(2, 70, 2, 64, grad=True), True, 16)),
        "flash_attention_backward": (ops.flash_attention_backward,
                                     (randn(2, 70, 4, 64), randn(2, 70, 2, 64),
                                      randn(2, 70, 2, 64), randn(2, 70, 4, 64), True, 16)),
        "rglru_scan": (ops.rglru_scan, (decay(2, 33, 130, grad=True), randn(2, 33, 130, grad=True))),
        "wkv_scan": (ops.wkv_scan, (*(randn(1, 17, 2, 64, grad=True, scale=0.3) for _ in range(3)),
                                    decay(1, 17, 2, 64, grad=True), randn(2, 64, grad=True, scale=0.1))),
        "wkv_scan_backward": (ops.wkv_scan_backward,
                              (*(randn(1, 17, 2, 64, scale=0.3) for _ in range(3)),
                               decay(1, 17, 2, 64), randn(2, 64, scale=0.1), randn(1, 17, 2, 64)))}
    out = {}
    for name, (op, args) in cases.items():
        t0 = time.perf_counter()
        opcheck(op, args)
        out[name] = time.perf_counter() - t0
        log(f"  opcheck {name} on CUDA: passed ({out[name]:.1f} s)")
    return out


def start_dryruns(work: Path) -> list:
    """Phase 25's combos (``python -m repro_torch.launch.dryrun``) and phase
    24's predictions (``run_one`` at each sharded run's config, batch and
    (1, 1) mesh), each in a process of its own, all started together; they
    hold no card memory but a CUDA context (fake CUDA tensors)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    jobs = []
    for i, (arch, shape, flags) in enumerate(DRYRUN_COMBOS):
        out = work / f"dryrun-{i}-{arch}-{shape}.jsonl"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
               *flags, "--out", str(out)]
        jobs.append((("combo", arch, shape, " ".join(flags)), out, cmd))
    batch, seq = SHARDED_BATCH
    for arch, layers in SHARDED_ARCHS:
        out = work / f"predict-{arch}.json"
        spec = json.dumps({"arch": arch, "layers": layers, "batch": batch, "seq": seq})
        jobs.append((("memory", arch), out, [sys.executable, "-c", PREDICT_CODE, spec, str(out)]))
    started = []
    for key, out, cmd in jobs:
        logf = open(out.with_suffix(".log"), "w")
        started.append((key, out, logf, subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT,
                                                         env=env, cwd=ROOT)))
    return started


def finish_dryruns(started: list, t_start: float) -> dict:
    """Wait for every job of :func:`start_dryruns` (each within what is left
    of ``DRYRUN_TIMEOUT_S``); ``{key: record}``. A job that fails or is cut
    fails the run, after every other job is stopped."""
    records = {}
    try:
        for key, out, logf, p in started:
            left = max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t_start))
            try:
                rc = p.wait(timeout=left)
            except subprocess.TimeoutExpired:
                raise Failed(f"dry-run job {key} did not end within {DRYRUN_TIMEOUT_S} s")
            logf.close()
            tail = out.with_suffix(".log").read_text()[-3000:]
            if key[0] == "combo":
                require(rc == 0 and out.exists(), f"dry-run {key} exited {rc}:\n{tail}")
                records[key] = json.loads(out.read_text().splitlines()[-1])
            else:
                require(rc == 0 and out.exists(), f"prediction {key} exited {rc}:\n{tail}")
                records[key] = json.loads(out.read_text())
    finally:
        for _, _, logf, p in started:
            if p.poll() is None:
                p.kill()
                p.wait()
            logf.close()
    return records


def _free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def sharded_decode(torch, model, steps, shard, api, mesh, rules, dev) -> dict:
    """``SHARDED_DECODE`` tokens through ``model``'s serve step with its
    weights (zero1) and its caches (``cache_spec_tree``) as DTensors, against
    the same steps on plain tensors: every step's logits. The DTensor cache
    takes the masked write of ``models/attention.py`` (each shard writing its
    own slots) with real values."""
    from torch.distributed.tensor import DTensor
    rows, n = SHARDED_DECODE
    gen = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(0, model.cfg.vocab_size, (rows, n), generator=gen, device=dev)
    serve = steps.make_serve_step(model)
    cache, plain = model.init_cache(rows, n, torch.float32), []
    for t in range(n):
        logits, cache = serve(tokens[:, t:t + 1], cache, t)
        plain.append(logits)
    plain = torch.cat(plain, dim=1)
    del cache
    t0 = time.perf_counter()
    params = {k: v.detach() for k, v in model.state_dict().items()}
    caches = model.init_cache(rows, n, torch.float32)
    got = []
    with api.activate(rules):
        dparams = shard.distribute(mesh, params, shard.param_specs(mesh, params, mode="zero1"))
        dcaches = shard.distribute(mesh, caches, shard.cache_spec_tree(mesh, caches))
        with steps.swapped_params(model, dparams):
            for t in range(n):
                tok = shard.distribute(mesh, tokens[:, t:t + 1], api.PartitionSpec("data", None))
                logits, dcaches = serve(tok, dcaches, t)
                got.append(_full(logits))
    got = torch.cat(got, dim=1)
    kv = [c for c in dcaches if hasattr(c, "k")]
    require(kv and all(isinstance(c.k, DTensor) for c in kv), "the decode caches are not DTensors")
    return {"rows": rows, "tokens": n, "logit_rel_err": rel_err(got, plain)[1],
            "finite": bool(torch.isfinite(got).all()), "s": time.perf_counter() - t0}


def phase_sharded(torch, get_config, Model, make_host_batch, steps, optim, mesh_mod, shard, api,
                  SHAPES, FA, WK, K, P, S, X, dev, prediction) -> dict:
    """Phase 24: each sharded run's two train steps and one prefill on DTensor
    state placed by ``param_specs`` / ``train_state_specs`` and
    ``batch_specs`` on a (1, 1) mesh of one NCCL rank, against the same
    steps on plain tensors: losses, parameters and logits within
    ``SHARDED_RTOL``, each step's launches and plain backward passes equal
    (the sharding rules reach the kernels), and the card's peak of the
    first sharded step against the dry-run's ``per_device_bytes``
    (``prediction(arch)``: ``run_one``'s record at the same config, batch and
    mesh)."""
    import torch.distributed as dist

    out = {}
    batch, seq = SHARDED_BATCH
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = mesh_mod.make_host_mesh(1, 1, device_type="cuda")
        rules = api.AxisRules(mesh, {"batch": ("data",), "seq": None, "embed": None,
                                     "vocab": "model", "mlp": "model", "expert": None,
                                     "capacity": None, "heads_dec": None, "cache_seq": "model"})
        for arch, layers in SHARDED_ARCHS:
            t0 = time.perf_counter()
            cfg = dataclasses.replace(get_config(arch), n_layers=layers)
            tcfg = steps.TrainerConfig(optimizer="sgd", lr=3e-3, warmup_steps=1, total_steps=4)
            model = Model(cfg, device=dev)
            state = steps.make_train_state(model, tcfg, torch.Generator(device=dev).manual_seed(2))
            batches = [make_host_batch(cfg, batch, seq, seed=40 + i, device=dev) for i in range(2)]
            step = steps.make_train_step(model, tcfg)

            def run(st, bs):
                losses, launches, plains = [], [], []
                for b in bs:
                    reset_counts(K, P, S, X)
                    reset_plain_backwards(FA, WK)
                    st, m = step(st, b)
                    torch.cuda.synchronize()
                    losses.append(float(_full(m["loss"])))
                    launches.append(launched(counts(K, P, S, X)))
                    plains.append(plain_backward_counts(FA, WK))
                return st, losses, launches, plains

            plain_state, plain_losses, plain_launches, plain_plains = run(state, batches)
            plain_params = {k: v.cpu() for k, v in plain_state["params"].items()}
            del plain_state
            with torch.no_grad():
                plain_logits = steps.make_prefill_step(model)(batches[0]).cpu()
            pspecs = shard.param_specs(mesh, state["params"], mode="zero1")
            mspecs = shard.param_specs(mesh, state["params"], mode="fsdp")
            sspecs = steps.train_state_specs(pspecs, tcfg, moment_specs=mspecs)
            bspecs = shard.batch_specs(mesh, cfg, SHAPES["train_4k"])
            with api.activate(rules):
                dstate = shard.distribute(mesh, state, sspecs)
                dbatches = [shard.distribute(mesh, b, bspecs) for b in batches]
                del state
                free_cuda(torch)
                args = shard.local_bytes(dstate) + shard.local_bytes(dbatches[0])
                resident = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                first, losses, launches, plains = run(dstate, dbatches[:1])
                card_bytes = torch.cuda.max_memory_allocated() - (resident - args)
                new, more, l2, p2 = run(first, dbatches[1:])
                losses, launches, plains = losses + more, launches + l2, plains + p2
                with steps.swapped_params(model, dstate["params"]):
                    logits = _full(steps.make_prefill_step(model)(dbatches[0])).cpu()
                params = {k: _full(v).cpu() for k, v in new["params"].items()}
            del dstate, dbatches, first, new
            decode = (sharded_decode(torch, model, steps, shard, api, mesh, rules, dev)
                      if arch == "llama3-8b" else None)
            if decode is not None:
                log(f"  {arch} decode, {decode['rows']} rows x {decode['tokens']} tokens through "
                    f"DTensor caches against plain tensors: logits rel err "
                    f"{decode['logit_rel_err']:.3e} (<= {SHARDED_RTOL}), {decode['s']:.1f} s")
                require(decode["finite"] and decode["logit_rel_err"] <= SHARDED_RTOL,
                        f"{arch}: sharded decode off the plain one by {decode['logit_rel_err']:.3e}")
            loss_err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(losses, plain_losses))
            param_err = max(rel_err(params[k], v)[1] for k, v in plain_params.items())
            logit_err = rel_err(logits, plain_logits)[1]
            pred = prediction(arch)
            require(pred["status"] == "ok", f"{arch}: the dry-run's prediction {pred['reason']}")
            predicted = pred["per_device_bytes"]
            ratio = card_bytes / predicted
            limit = max(MEMORY_RTOL * predicted, MEMORY_ATOL)
            log(f"  {arch}, {layers} layers, {batch} x {seq} tokens: sharded against plain: losses "
                f"{', '.join(f'{a:.6f} / {b:.6f}' for a, b in zip(losses, plain_losses))} "
                f"(rel {loss_err:.3e}), params {param_err:.3e}, prefill logits {logit_err:.3e} "
                f"(<= {SHARDED_RTOL}); launches a step {launches} (plain {plain_launches}), plain "
                f"backwards {plains}; card peak {card_bytes / 2**30:.3f} GiB, dry-run "
                f"{predicted / 2**30:.3f} GiB, ratio {ratio:.4f}; {time.perf_counter() - t0:.1f} s")
            require(all(math.isfinite(x) for x in losses), f"{arch}: sharded loss not finite")
            require(max(loss_err, param_err, logit_err) <= SHARDED_RTOL,
                    f"{arch}: sharded steps off the plain ones (losses {loss_err:.3e}, params "
                    f"{param_err:.3e}, logits {logit_err:.3e})")
            require(launches == plain_launches and plains == plain_plains,
                    f"{arch}: sharded launches {launches} / {plains}, plain {plain_launches} / "
                    f"{plain_plains}")
            require(abs(card_bytes - predicted) <= limit,
                    f"{arch}: card peak {card_bytes} B against the dry-run's {predicted} B")
            out[arch] = {"layers": layers, "batch": [batch, seq], "loss_rel_err": loss_err,
                         "param_rel_err": param_err, "logit_rel_err": logit_err,
                         "launches_per_step": launches[0],
                         "plain_backwards_per_step": plains[0], "card_peak_bytes": card_bytes,
                         "dryrun_bytes": predicted, "memory_ratio": ratio,
                         "decode": decode, "s": time.perf_counter() - t0}
            del model, params, plain_params
            free_cuda(torch)
    finally:
        dist.destroy_process_group()
    return out


def phase_dryrun(records: dict) -> dict:
    """Phase 25: every production combo ``ok``; the gossip combo permutes on
    the pod axis; per-device GiB, FLOPs, collective bytes and bottleneck."""
    out = {}
    for key, rec in records.items():
        if key[0] != "combo":
            continue
        _, arch, shape, flags = key
        label = f"{arch} x {shape} ({rec['mesh']}, {rec['consensus']}{', ' + flags if flags else ''})"
        require(rec["status"] == "ok", f"dry-run {label}: {rec['status']} {rec['reason']}")
        perms = rec["collectives"]["count_by_op"].get("collective-permute", 0)
        log(f"  {label}: {rec['per_device_bytes'] / 2**30:.2f} GiB a device (args "
            f"{rec['arg_bytes'] / 2**30:.2f}), {rec['hlo_flops']:.3e} FLOPs, "
            f"{rec['collective_bytes']:.3e} collective bytes {rec['collectives']['count_by_op']}, "
            f"{rec['bottleneck']}-bound (compute {rec['compute_s'] * 1e3:.2f} ms, memory "
            f"{rec['memory_s'] * 1e3:.2f} ms, collective {rec['collective_s'] * 1e3:.2f} ms), "
            f"useful-flop ratio {rec['useful_flop_ratio']:.3f}, traced in {rec['compile_secs']:.1f} s")
        if rec["consensus"] == "gossip":
            require(rec["mesh"].startswith("2x16x16") and perms >= 1,
                    f"dry-run {label}: no collective-permute on the pod axis")
        if "--seq-shard" in flags:
            base = next((r for k, r in records.items() if k[0] == "combo" and k[1:3] == (arch, shape)
                         and k[3] == flags.replace(" --seq-shard", "")), None)
            fits = rec["per_device_bytes"] <= CARD_BYTES
            log(f"  {arch} x {shape}: {rec['per_device_bytes'] / 2**30:.2f} GiB a device with "
                f"--seq-shard against "
                + (f"{base['per_device_bytes'] / 2**30:.2f} GiB" if base else "(not run)")
                + f" without; {'fits' if fits else 'does not fit'} one card's "
                f"{CARD_BYTES / 2**30:.2f} GiB")
            rec = dict(rec, fits_one_card=fits)
        out[label] = {k: rec[k] for k in ("per_device_bytes", "arg_bytes", "temp_bytes",
                                          "hlo_flops", "hlo_bytes", "collective_bytes",
                                          "collectives", "bottleneck", "compute_s", "memory_s",
                                          "collective_s", "useful_flop_ratio", "n_params",
                                          "model_flops_global", "compile_secs")}
        if "fits_one_card" in rec:
            out[label]["fits_one_card"] = rec["fits_one_card"]
    return out


def phases_sharded_and_dryrun(torch, get_config, Model, make_host_batch, steps, optim, mesh_mod,
                              shard, api, SHAPES, FA, WK, K, P, S, X, dev):
    """Phases 24 and 25: the dry-run's jobs start first, phase 24 runs on the
    card meanwhile (waiting for each prediction it needs), then phase 25
    reads the combos' records. Returns (phase 24's and 25's objects and
    seconds)."""
    log("phase 24: sharded on the card, a (1, 1) mesh of one NCCL rank, against plain tensors")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as dry_tmp:
        t_dry = time.perf_counter()
        jobs = start_dryruns(Path(dry_tmp))
        try:
            def prediction(arch: str) -> dict:
                """The dry-run's record for a sharded run (its job waited for)."""
                for key, outp, _, proc in jobs:
                    if key == ("memory", arch):
                        left = max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t_dry))
                        require(proc.wait(timeout=left) == 0 and outp.exists(),
                                f"prediction {key}: "
                                + outp.with_suffix(".log").read_text()[-3000:])
                        return json.loads(outp.read_text())
                raise Failed(f"no prediction job for {arch}")

            sharded = phase_sharded(torch, get_config, Model, make_host_batch, steps, optim,
                                    mesh_mod, shard, api, SHAPES, FA, WK, K, P, S, X, dev,
                                    prediction)
            s24 = time.perf_counter() - t_dry
            log(f"  {s24:.1f} s")
            log("phase 25: the production dry-run, fake worlds of 256 and 512 ranks")
            dryrun_out = phase_dryrun(finish_dryruns(jobs, t_dry))
        finally:
            for _, _, logf, proc in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                logf.close()
    s25 = time.perf_counter() - t_dry - s24
    log(f"  {s25:.1f} s after phase 24 (its jobs started with phase 24; both "
        f"{s24 + s25:.1f} s)")
    return sharded, dryrun_out, s24, s25


def load_example(name: str):
    """``examples/<name>.py`` as a module of its own (the examples are
    scripts, not a package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_quickstart(torch, K, P, S, X, dev) -> dict:
    """quickstart: Pegasos and GADGET at the example's sizes through its
    functions, the accuracies against the reference example's; GADGET's
    fused half-step is one ``fleet_half_step`` launch an iteration and
    Pegasos launches no kernel (the reference's reaches none); then the
    script alone in a process of its own."""
    q = load_example("torch_quickstart")
    ds = q.make_dataset("reuters", scale=q.SCALE, seed=0)
    Xte, yte = torch.from_numpy(ds.X_test).to(dev), torch.from_numpy(ds.y_test).to(dev)
    reset_counts(K, P, S, X)
    t0 = time.perf_counter()
    cen = q.centralized(ds, device=dev)
    torch.cuda.synchronize()
    peg_launches = launched(counts(K, P, S, X))
    res = q.gadget(ds, device=dev)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    got = launched(counts(K, P, S, X))
    acc = {"pegasos": float(q.obj.accuracy(cen.w, Xte, yte)),
           "gadget": float(q.obj.accuracy(res.w_consensus, Xte, yte))}
    log(f"  quickstart: Pegasos accuracy {acc['pegasos']:.4f} (reference "
        f"{QUICKSTART_REF['pegasos']:.4f}), GADGET {acc['gadget']:.4f} (reference "
        f"{QUICKSTART_REF['gadget']:.4f}) after {res.iters} iterations, launches {got} "
        f"(Pegasos {peg_launches}), {sec:.1f} s")
    # the same functions on the CPU (the plain versions): w and W at PATH_W_ATOL
    t1 = time.perf_counter()
    cen_cpu, res_cpu = q.centralized(ds, device="cpu"), q.gadget(ds, device="cpu")
    cpu_s = time.perf_counter() - t1
    w_err = {"pegasos": float((cen.w.cpu() - cen_cpu.w).abs().max()),
             "gadget": float((res.W.cpu() - res_cpu.W).abs().max())}
    log(f"  quickstart against its CPU run ({cpu_s:.1f} s): Pegasos w {w_err['pegasos']:.3e}, "
        f"GADGET W {w_err['gadget']:.3e} after {res_cpu.iters} iterations (<= {PATH_W_ATOL})")
    for name, a in acc.items():
        require(abs(a - QUICKSTART_REF[name]) <= EXAMPLE_ACC_ATOL,
                f"quickstart {name} accuracy {a:.4f}, the reference's {QUICKSTART_REF[name]:.4f}")
        require(w_err[name] <= PATH_W_ATOL,
                f"quickstart's {name} weights differ from its CPU run by {w_err[name]:.3e}")
    require(res.iters == res_cpu.iters, f"quickstart's GADGET stopped at {res.iters} iterations, "
            f"its CPU run at {res_cpu.iters}")
    require(not peg_launches, f"quickstart's Pegasos launched {peg_launches}")
    require(got == {"fleet_half_step": res.iters},
            f"quickstart's GADGET launched {got} in {res.iters} iterations")
    t1 = time.perf_counter()
    p = subprocess.run([sys.executable, str(EXAMPLES / "torch_quickstart.py")],
                       capture_output=True, text=True, timeout=EXAMPLE_TIMEOUT_S, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    script_s = time.perf_counter() - t1
    log(f"  python examples/torch_quickstart.py: exit {p.returncode} in {script_s:.1f} s\n"
        + "\n".join(f"    {line}" for line in p.stdout.splitlines()))
    require(p.returncode == 0, f"examples/torch_quickstart.py exited {p.returncode}:\n"
            + p.stderr[-3000:])
    require("centralized Pegasos   acc=" in p.stdout and "GADGET (10 nodes)     acc=" in p.stdout,
            "examples/torch_quickstart.py printed no accuracy lines")
    return {"accuracy": acc, "iters": res.iters, "launches": got, "s": sec,
            "cpu_w_err": w_err, "script_s": script_s}


def example_faults(torch, K, P, S, X, dev) -> dict:
    """fault_tolerant_gossip: ``gadget_with_faults`` in its three networks
    on CUDA values, each round's Push-Sum weight recorded on the device;
    the mean alive-node accuracy within ``FAULT_ACC_ATOL`` of the reference
    example's, and under link drops every round's mass conserved."""
    f = load_example("torch_fault_tolerant_gossip")
    ds = f.make_dataset("usps", scale=f.SCALE, seed=0)
    Xte, yte = torch.from_numpy(ds.X_test).to(dev), torch.from_numpy(ds.y_test).to(dev)
    Xp, yp, _ = f.partition(ds.X_train, ds.y_train, f.N_NODES)
    Xp, yp = torch.from_numpy(Xp).to(dev), torch.from_numpy(yp).to(dev)
    out = {}
    for name, sim in f.cases():
        weights = []

        def recorded(st, t, round_=sim.round):
            st = round_(st, t)
            weights.append(st.weight)
            return st

        sim.round = recorded
        reset_counts(K, P, S, X)
        t0 = time.perf_counter()
        W = f.gadget_with_faults(Xp, yp, ds.lam, sim)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        accs = [float(f.obj.accuracy(W[i], Xte, yte)) for i in range(f.N_NODES)]
        alive = [a for i, a in enumerate(accs) if i not in sim.dead]
        mean = float(np.mean(alive))
        w = torch.stack(weights)
        mass_err = float((w.mean(dim=1) - 1.0).abs().max())
        log(f"  fault_tolerant_gossip, {name}: node-acc mean {mean:.4f} (reference "
            f"{FAULTS_REF[name]:.3f}; min {min(alive):.4f}, max {max(alive):.4f}), "
            f"{len(weights)} rounds on {w.device}, mass off 1 by at most {mass_err:.3e}, "
            f"launches {launched(counts(K, P, S, X))}, {sec:.1f} s")
        require(W.device.type == "cuda" and w.device.type == "cuda",
                f"{name}: the values or the Push-Sum weight left the card")
        require(bool(torch.isfinite(W).all()), f"{name}: W not finite")
        require(abs(mean - FAULTS_REF[name]) <= FAULT_ACC_ATOL,
                f"{name}: node-acc mean {mean:.4f}, the reference's {FAULTS_REF[name]:.3f}")
        if sim.drop == "link" and sim.drop_prob > 0:
            require(mass_err <= LINK_MASS_ATOL, f"{name}: Push-Sum mass off by {mass_err:.3e}")
        out[name] = {"node_acc_mean": mean, "node_acc_min": min(alive),
                     "node_acc_max": max(alive), "rounds": len(weights),
                     "mass_max_err": mass_err, "s": sec}
    return out


def example_serve(torch, K, P, S, X, dev) -> dict:
    """serve_batched: training through the sparse route ``schedule="auto"``
    picks (each kernel the trainer accounts once an iteration), the f32 and int8 exports served,
    every ragged query delivered, one ``ell_scores_prefetch`` launch a
    drained batch and one ``dense_scores`` a dense ``score``, the served
    shapes within the buckets, int8 agreement >= 0.9."""
    sb = load_example("torch_serve_batched")
    reset_counts(K, P, S, X)
    before = accounted()
    t0 = time.perf_counter()
    ds, Pe, res = sb.train(dev)
    torch.cuda.synchronize()
    train_launches = launched(counts(K, P, S, X))
    route = [kind for kind, n in accounted(before).items() if n]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_batched_") as td:
        reset_counts(K, P, S, X)
        out = sb.export_and_serve(ds, Pe, res, td, dev)
        serve_launches = launched(counts(K, P, S, X))
        sec = time.perf_counter() - t0
        # the same snapshot served through the plain versions on the CPU: the
        # same queries in the same buckets, so the same inputs to B8 and B9
        out_cpu = sb.export_and_serve(ds, Pe, res, td + "/cpu", "cpu")
    # and the training on the CPU: W at PATH_W_ATOL
    _, _, res_cpu = sb.train("cpu")
    w_err = float((res.W.cpu() - res_cpu.W).abs().max())
    ids = sorted(out_cpu["results"])
    got_s = np.array([float(out["results"][r][0]) for r in ids])
    want_s = np.array([float(out_cpu["results"][r][0]) for r in ids])
    served_err = float(np.abs(got_s - want_s).max() / max(1.0, np.abs(want_s).max()))
    dense_err = float(np.abs(out["dense_scores"] - out_cpu["dense_scores"]).max()
                      / max(1.0, np.abs(out_cpu["dense_scores"]).max()))
    # a label may differ from the CPU's only where the score is within the tolerance of 0
    sure = np.abs(want_s) > KERNEL_RTOL * max(1.0, np.abs(want_s).max())
    labels_ok = (sorted(out["results"]) == ids and all(
        out["results"][r][1] == out_cpu["results"][r][1] for r, s_ in zip(ids, sure) if s_)
        and np.array_equal(out["labels_f32"], out_cpu["labels_f32"]))
    log(f"  serve_batched against the CPU: trained W {w_err:.3e} (<= {PATH_W_ATOL}) after "
        f"{res_cpu.iters} iterations; the card's snapshot served on the CPU: batched scores "
        f"rel {served_err:.3e}, dense scores rel {dense_err:.3e} (<= {KERNEL_RTOL}), labels "
        f"{'equal' if labels_ok else 'DIFFER'}")
    require(res.iters == res_cpu.iters and w_err <= PATH_W_ATOL,
            f"serve_batched's W differs from its CPU run by {w_err:.3e}")
    require(served_err <= KERNEL_RTOL and dense_err <= KERNEL_RTOL and labels_ok,
            f"serve_batched's scores differ from the plain versions': batched {served_err:.3e}, "
            f"dense {dense_err:.3e}, labels {'equal' if labels_ok else 'differ'}")
    delivered = sum(isinstance(r, tuple) for r in out["results"].values())
    log(f"  serve_batched: {res.iters} iterations, training launches {train_launches}; "
        f"{delivered} of {sb.N_QUERIES} queries delivered in {out['batcher']['batches']} "
        f"batches, {out['server']['distinct_shapes']} shapes for {len(out['buckets'])} "
        f"buckets, serving launches {serve_launches}, int8 agreement {out['agree']:.4f}, "
        f"{sec:.1f} s")
    require_launches(train_launches, route, res.iters, "serve_batched's training")
    require(delivered == sb.N_QUERIES == out["batcher"]["requests"],
            f"serve_batched delivered {delivered} of {sb.N_QUERIES} queries")
    require(serve_launches == {"ell_scores_prefetch": out["batcher"]["batches"],
                               "dense_scores": 2},
            f"serve_batched's serving launched {serve_launches} for "
            f"{out['batcher']['batches']} batches and two dense calls")
    require(out["server"]["distinct_shapes"] <= len(out["buckets"]),
            f"{out['server']['distinct_shapes']} shapes for {len(out['buckets'])} buckets")
    require(out["agree"] >= INT8_MIN_AGREEMENT, f"int8 agreement {out['agree']:.4f}")
    return {"iters": res.iters, "train_launches": train_launches,
            "serve_launches": serve_launches, "batches": out["batcher"]["batches"],
            "distinct_shapes": out["server"]["distinct_shapes"], "buckets": len(out["buckets"]),
            "int8_agreement": out["agree"], "cpu_w_err": w_err,
            "served_scores_rel_err": served_err, "dense_scores_rel_err": dense_err, "s": sec}


def example_gossip(torch, FA, WK, K, P, S, X, dev) -> dict:
    """gossip_vs_allreduce: the example's three runs; each ends with its
    last five losses' mean below its first loss, the replicas'
    disagreement finite, B10 launched on every step."""
    g = load_example("torch_gossip_vs_allreduce")
    out = {}
    for mode, rounds in (("allreduce", 1), ("gossip", 1), ("gossip", 2)):
        reset_counts(K, P, S, X)
        reset_plain_backwards(FA, WK)
        t0 = time.perf_counter()
        losses, spread = g.run(mode, rounds, device=dev)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        got, plain = launched(counts(K, P, S, X)), plain_backward_counts(FA, WK)
        label = f"{mode} R={rounds}" if mode == "gossip" else mode
        log(f"  gossip_vs_allreduce, {label}: loss {losses[0]:.3f} -> "
            f"{np.mean(losses[-5:]):.3f}, replica disagreement {spread:.3%}, launches {got}, "
            f"plain backwards {plain}, {sec:.1f} s")
        require(all(math.isfinite(x) for x in losses), f"{label}: a loss is not finite")
        require(np.mean(losses[-5:]) < losses[0], f"{label}: the loss did not fall")
        require(math.isfinite(spread), f"{label}: disagreement {spread}")
        require(got.get("flash_attention", 0) > 0, f"{label}: flash_attention never launched")
        out[label] = {"first_loss": losses[0], "last5_loss": float(np.mean(losses[-5:])),
                      "spread": spread, "launches": got, "plain_backwards": plain, "s": sec}
    return out


def example_train_100m(torch, FA, WK, K, P, S, X, dev, tmp: Path) -> dict:
    """train_100m at the example's defaults in both modes: the loss drop
    above ``TRAIN_100M_MIN_DROP`` (the example's "IMPROVED"), every step's
    B10 launches and plain backward passes as remat makes them, seconds a
    step, tokens/s, the peak; the checkpoint saved as the example saves it
    and restored bit for bit."""
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.convert import train_state_to_reference
    from repro_torch.models.transformer import Model
    t = load_example("torch_train_100m")
    cfg = t.build_100m()
    steps_n, batch, seq = TRAIN_100M
    out = {}
    for mode in ("allreduce", "gossip"):
        tcfg = t.trainer_config(steps_n, mode, 2)
        model = Model(cfg, device=dev)
        state = t.init_state(model, tcfg)
        G = tcfg.n_replicas
        n_params = sum(v.numel() for v in state["params"].values()) // G
        want, want_plain = expected_step_launches(cfg, G, remat=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(K, P, S, X)
        reset_plain_backwards(FA, WK)
        t0 = time.perf_counter()
        state, losses = t.train(model, tcfg, state, steps=steps_n, batch=batch, seq=seq)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        got, plain = launched(counts(K, P, S, X)), plain_backward_counts(FA, WK)
        first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
        root = str(tmp / f"train_100m_{mode}")
        t.save_checkpoint(root, steps_n, cfg, tcfg, state)
        like = train_state_to_reference(cfg, tcfg, state)
        back = ckpt_io.restore(root, like)
        saved, _ = ckpt_io.tree_flatten(like)
        restored, _ = ckpt_io.tree_flatten(back)
        exact = len(saved) == len(restored) and all(
            a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(saved, restored))
        log(f"  train_100m, {mode}{f' G={G}' if G > 1 else ''}: {n_params / 1e6:.1f}M "
            f"parameters, loss {first:.4f} -> {last:.4f} (first and last ten), "
            f"{sec / steps_n:.4f} s a step, {batch * seq * steps_n / sec:,.0f} tokens/s, "
            f"max_memory_allocated {peak / 1e9:.2f} GB, flash_attention {got} "
            f"({ {k: v / steps_n for k, v in got.items()} } a step), plain backwards "
            f"{ {k: v / steps_n for k, v in plain.items()} } a step, checkpoint of "
            f"{len(saved)} leaves restored {'bit for bit' if exact else 'WITH DIFFERENCES'}")
        require(all(math.isfinite(x) for x in losses), f"train_100m {mode}: a loss not finite")
        require(last < first - TRAIN_100M_MIN_DROP,
                f"train_100m {mode}: loss {first:.4f} -> {last:.4f}, not below by "
                f"{TRAIN_100M_MIN_DROP}")
        require(got == {k: v * steps_n for k, v in want.items()}
                and plain == {k: v * steps_n for k, v in want_plain.items()},
                f"train_100m {mode}: launches {got}, plain backwards {plain} in {steps_n} "
                f"steps, want {want} and {want_plain} a step")
        require(exact, f"train_100m {mode}: the checkpoint did not restore bit for bit")
        out[mode] = {"replicas": G, "parameters": n_params, "steps": steps_n,
                     "batch": [batch, seq], "first10_loss": first, "last10_loss": last,
                     "s_per_step": sec / steps_n, "tokens_per_s": batch * seq * steps_n / sec,
                     "max_memory_bytes": peak, "launches_per_step": want,
                     "plain_backwards_per_step": want_plain, "checkpoint_leaves": len(saved)}
        del model, state, like, back, saved, restored
        free_cuda(torch)
    return out


def phase_examples(torch, FA, WK, K, P, S, X, dev) -> dict:
    """Phase 26: the five examples (``examples/torch_*.py``) through their
    own functions on the card, the launch counters reset before each run
    and read after it; each example's seconds."""
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        for name, run in (
                ("quickstart", lambda: example_quickstart(torch, K, P, S, X, dev)),
                ("fault_tolerant_gossip", lambda: example_faults(torch, K, P, S, X, dev)),
                ("serve_batched", lambda: example_serve(torch, K, P, S, X, dev)),
                ("gossip_vs_allreduce", lambda: example_gossip(torch, FA, WK, K, P, S, X, dev)),
                ("train_100m", lambda: example_train_100m(torch, FA, WK, K, P, S, X, dev,
                                                          Path(tmp)))):
            t0 = time.perf_counter()
            out[name] = run()
            out[name + "_s"] = time.perf_counter() - t0
            log(f"  {name}: {out[name + '_s']:.1f} s")
            free_cuda(torch)
    return out


def profile_iterations(torch, run) -> dict:
    """Device time by kernel, in all and in kernels alone (copies, such as
    pageable uploads whose time follows the host's, left out), kernel
    launches and copies on the device, and host time by operator over
    ``run()``, from torch.profiler. Only
    device-side events (kernels, copies) count as device time: an
    operator's row repeats the time of the kernels it launched. The
    profiler slows the host, so the caller divides the device time by an
    unprofiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    on_device = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                       key=lambda e: e.self_device_time_total, reverse=True)
    on_host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                     key=lambda e: e.self_cpu_time_total, reverse=True)
    copies = [e for e in on_device if e.key.startswith(("Memcpy", "Memset"))]
    device_us = sum(e.self_device_time_total for e in on_device)
    copy_us = sum(e.self_device_time_total for e in copies)
    return {"device_us": device_us, "kernel_us": device_us - copy_us,
            "kernel_launches": sum(e.count for e in on_device) - sum(e.count for e in copies),
            "copies": sum(e.count for e in copies),
            "top_device": [(e.key[:70], e.count, e.self_device_time_total)
                           for e in on_device[:8]],
            "top_host": [(e.key[:70], e.count, e.self_cpu_time_total) for e in on_host[:8]]}


def wrappers(K, P, S, X) -> tuple:
    """Every kernel wrapper of the port, in the order of ``KERNELS``; ``X``
    holds the transformer kernels' wrappers."""
    return (K.fleet_half_step, K.margins, K.grad_update, P.dense_scores, S.ell_margins,
            S.ell_margins_coeff, S.ell_grad_update, S.ell_margins_prefetch,
            S.ell_margins_prefetch_coeff,
            S.ell_grad_update_prefetch, S.ell_grad_update_prefetch_fold,
            S.ell_grad_update_fused, P.ell_scores_prefetch, *X)


def reset_counts(K, P, S, X) -> None:
    """Set every kernel's launch count to 0."""
    for fn in wrappers(K, P, S, X):
        fn.launches = 0


def counts(K, P, S, X) -> dict:
    """Every kernel's launch count, by name."""
    return {fn.__name__: fn.launches for fn in wrappers(K, P, S, X)}


def main() -> int:
    """Run every phase; the exit code."""
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs "
              "one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import counter_rng
    from repro_torch.core import gadget as gadget_mod
    from repro_torch.core import cutting_plane, multiclass, pegasos
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.gadget import GadgetConfig, gadget_train
    from repro_torch.telemetry.train import TrainTelemetry
    from repro_torch.data.svm_datasets import make_dataset, partition
    from repro_torch.kernels import _build
    from repro_torch.kernels.hinge_subgrad import hinge_subgrad as K
    from repro_torch.kernels.hinge_subgrad import ops
    from repro_torch.kernels.hinge_subgrad import predict as P
    from repro_torch.kernels.hinge_subgrad import ref as R
    from repro_torch.kernels.hinge_subgrad import sparse as S
    from repro_torch import serve
    from repro_torch import telemetry
    from repro_torch.configs import get_config
    from repro_torch.configs.gadget_svm import PAPER_RUNS
    from repro_torch.data import libsvm
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.kernels.rglru_scan import ops as RO
    from repro_torch.kernels.rglru_scan import rglru_scan as RG
    from repro_torch.kernels.rwkv6_scan import ops as WO
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as WK
    from repro_torch import optim
    from repro_torch.data.tokens import Batcher, TokenStreamConfig
    from repro_torch.launch import serve as serve_lm
    from repro_torch.launch import steps as steps_lm
    from repro_torch.launch.input_specs import make_host_batch
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import mesh as mesh_lm
    from repro_torch.launch import shardings as shard_lm
    from repro_torch import sharding as sharding_api
    from repro_torch.models.transformer import Model
    from repro_torch.sparse import formats
    from repro_torch.sparse.formats import ELL
    from repro_torch.telemetry import top
    from repro_torch.telemetry import trace as tmtr

    X = (FA.flash_attention, RG.rglru_scan, WK.wkv_scan)

    dev = torch.device("cuda")
    t_all = time.perf_counter()
    cfg, cfg_c = PAPER_RUNS["reuters"].gadget, PAPER_RUNS["ccat"].gadget
    require(PAPER_RUNS["reuters"].n_nodes == PAPER_RUNS["ccat"].n_nodes == N_NODES
            and cfg_c.sparse_schedule == "auto", "the paper runs are not 10 nodes, auto schedule")

    log("phase 1: card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    log("phase 2: build")
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"  built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(p.name for p in libs.values()))
    resources = {}
    for src, lib in libs.items():
        res = ptxas_resources(lib.with_suffix(".log").read_text())
        resources[src.name] = res
        log(f"  {src.name}: " + "; ".join(
            f"{k} {v.get('registers')} registers, {v.get('spill_stores')} B spilled, "
            f"{v.get('smem')} B static smem" for k, v in res.items()))

    log("phase 3: kernels against their plain versions")
    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = phase_kernels(torch, K, P, ops, cfg.lam, gen, dev)
    t0 = time.perf_counter()
    ds_c = make_dataset("ccat", scale=CCAT_SCALE, seed=0, sparse=True)
    gen_s = time.perf_counter() - t0
    ccat = partition(ds_c.X_train, ds_c.y_train, N_NODES, seed=0)
    log(f"  CCAT at scale {CCAT_SCALE}: train {ds_c.X_train.shape} (k = {ds_c.X_train.k_max}), "
        f"test {ds_c.X_test.shape}, generated in {gen_s:.1f} s, partitions "
        f"{tuple(ccat[0].cols.shape)}, block bound at B=1: {ccat[0].block_bound(1)}")
    kernels.update(phase_sparse_kernels(torch, S, ops, ccat, cfg_c.lam, gen, dev))
    serving_row, buckets = phase_serving_kernel(torch, P, ops, serve, formats, ds_c, ccat[0],
                                                gen, dev)
    kernels.update(serving_row)
    kernels.update(phase_transformer_kernels(torch, FA, FO, RG, RO, WK, WO, gen, dev))
    kernel_grads = phase_kernel_grads(torch, FA, RG, WK, gen, dev)
    op_checks = phase_op_checks(torch, dev)

    log("phase 4: main path, reuters at full size, fused")
    t0 = time.perf_counter()
    ds = make_dataset("reuters", scale=1.0, seed=0)
    Xp, yp, n_counts = partition(ds.X_train, ds.y_train, N_NODES, seed=0)
    X_dev, y_dev = torch.from_numpy(Xp).to(dev), torch.from_numpy(yp).to(dev)
    Xte, yte = torch.from_numpy(ds.X_test).to(dev), torch.from_numpy(ds.y_test).to(dev)
    torch.cuda.synchronize()
    log(f"  data: train {ds.X_train.shape}, test {ds.X_test.shape}, partitions "
        f"{tuple(Xp.shape)}, {time.perf_counter() - t0:.1f} s")
    gadget_train(X_dev, y_dev, cfg._replace(max_iters=20, check_every=10),
                 n_counts=n_counts, device=dev)  # warm-up: cuBLAS and the libraries
    torch.cuda.synchronize()
    reset_counts(K, P, S, X)
    t0 = time.perf_counter()
    res = gadget_train(X_dev, y_dev, cfg, n_counts=n_counts, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, pred = ops.dense_predict(res.w_consensus, Xte)
    n_correct = int((pred == yte).sum())
    acc = n_correct / len(yte)
    score_s = time.perf_counter() - t0
    main_counts = counts(K, P, S, X)
    objective = float(res.objective_trace[-1])
    log(f"  {res.iters} iterations in {train_s:.3f} s ({res.iters / train_s:.1f} it/s), "
        f"objective {objective:.4f}, test accuracy {acc:.4f} (scored in {score_s * 1e3:.1f} ms), "
        f"eps {res.epsilon:.3e}, launches {main_counts}")
    require(res.W.shape == (N_NODES, ds.d) and bool(torch.isfinite(res.W).all()),
            "final W not finite or misshaped")
    require(pred.shape == (ds.X_test.shape[0],), "prediction shape")
    require(acc >= MIN_ACCURACY, f"test accuracy {acc:.4f} < {MIN_ACCURACY}")
    require(objective <= MAX_OBJECTIVE, f"objective {objective:.4f} > {MAX_OBJECTIVE}")
    require(launched(main_counts) == {**dict.fromkeys(ops.HALF_STEP_KINDS["fused"], res.iters),
                                      "dense_scores": 1}, f"phase 4 launched {launched(main_counts)}")

    n_prof = 200
    prof = profile_iterations(torch, lambda: gadget_train(
        X_dev, y_dev, cfg._replace(max_iters=n_prof), n_counts=n_counts, device=dev))
    device_us = prof["device_us"] / n_prof
    host_us = train_s / res.iters * 1e6
    busy = device_us / host_us
    log(f"  profile of {n_prof} iterations: device {device_us:.1f} us/iteration against "
        f"{host_us:.1f} us/iteration of wall time unprofiled: device busy {busy:.3f}, "
        f"{prof['kernel_launches'] / n_prof:.2f} kernel launches an iteration")
    for key, count, us in prof["top_device"]:
        log(f"    device {us / n_prof:9.2f} us/it  x{count:<6d} {key}")
    for key, count, us in prof["top_host"]:
        log(f"    host   {us / n_prof:9.2f} us/it  x{count:<6d} {key}")
    require(device_us > 0, "the profiled window ran nothing on the device")

    log("phase 5: unfused path, 400 iterations")
    cfg_u = cfg._replace(fused=False, max_iters=400)
    reset_counts(K, P, S, X)
    t0 = time.perf_counter()
    res_u = gadget_train(X_dev, y_dev, cfg_u, n_counts=n_counts, device=dev)
    torch.cuda.synchronize()
    unfused_s = time.perf_counter() - t0
    unfused_counts = counts(K, P, S, X)
    log(f"  {res_u.iters} iterations in {unfused_s:.3f} s ({res_u.iters / unfused_s:.1f} it/s), "
        f"objective {float(res_u.objective_trace[-1]):.4f}, launches {unfused_counts}")
    require(bool(torch.isfinite(res_u.W).all()), "unfused W not finite")
    require_launches(unfused_counts, ops.HALF_STEP_KINDS["unfused"], res_u.iters,
                     "the unfused path")
    prof_u = profile_iterations(torch, lambda: gadget_train(
        X_dev, y_dev, cfg_u._replace(max_iters=n_prof), n_counts=n_counts, device=dev))
    device_us_u = prof_u["device_us"] / n_prof
    kernel_us_u = prof_u["kernel_us"] / n_prof
    launches_u = prof_u["kernel_launches"] / n_prof
    log(f"  profile of {n_prof} iterations: device {device_us_u:.1f} us/iteration (kernels "
        f"{kernel_us_u:.1f}), {launches_u:.2f} kernel launches and "
        f"{prof_u['copies'] / n_prof:.2f} copies an iteration")
    for key, count, us in prof_u["top_device"]:
        log(f"    device {us / n_prof:9.2f} us/it  x{count:<6d} {key}")

    log("phase 6: whole path on the card against the CPU, 200 iterations")

    cfg_6 = cfg._replace(max_iters=200)
    # the port's draws are keyed on the iteration: the CPU draws the card's numbers
    res_gpu = gadget_train(X_dev, y_dev, cfg_6, n_counts=n_counts, device=dev)
    t0 = time.perf_counter()
    res_cpu = gadget_train(Xp, yp, cfg_6, n_counts=n_counts, device="cpu")
    cpu_s = time.perf_counter() - t0
    w_err = float((res_gpu.W.cpu() - res_cpu.W).abs().max())
    obj_err = float(np.max(np.abs(res_gpu.objective_trace - res_cpu.objective_trace)
                            / np.abs(res_cpu.objective_trace)))
    log(f"  W max abs err {w_err:.3e} (<= {PATH_W_ATOL}), objective rel err {obj_err:.3e} "
        f"(<= {PATH_OBJ_RTOL}), CPU run {cpu_s:.1f} s")
    require(res_gpu.iters == res_cpu.iters == 200, "iteration counts differ")
    require(w_err <= PATH_W_ATOL, f"W differs by {w_err:.3e}")
    require(obj_err <= PATH_OBJ_RTOL, f"objective trace differs by {obj_err:.3e}")

    log("phase 7: sparse main path, CCAT as ELL planes at full width")
    parts_c, y_c, n_c = ccat
    k_c = parts_c.cols.shape[-1]
    schedule = ops.resolve_ell_schedule("auto", B=cfg_c.batch_size, k=k_c, d=parts_c.d,
                                        n_blocks_max=parts_c.block_bound(cfg_c.batch_size))
    log(f"  auto schedule at B={cfg_c.batch_size}, k={k_c}, d={parts_c.d}: {schedule[0]}, "
        f"blk_d {schedule[1]}, n_blocks_max {schedule[2]}")
    require(schedule[:2] == ("prefetch", 128), f"auto resolved to {schedule}")
    ccat_kinds = ops.HALF_STEP_KINDS[schedule[0]]
    cols_te = torch.from_numpy(ds_c.X_test.cols).to(dev)
    vals_te = torch.from_numpy(ds_c.X_test.vals).to(dev)
    y_te = torch.from_numpy(ds_c.y_test).to(dev)
    gadget_train(parts_c, y_c, cfg_c._replace(max_iters=20, check_every=10), n_counts=n_c,
                 device=dev)  # warm-up
    torch.cuda.synchronize()
    reset_counts(K, P, S, X)
    before = accounted()
    t0 = time.perf_counter()
    res_c = gadget_train(parts_c, y_c, cfg_c, n_counts=n_c, device=dev)
    torch.cuda.synchronize()
    sparse_s = time.perf_counter() - t0
    sparse_counts = counts(K, P, S, X)
    accounted_c = accounted(before)
    scores = R.ell_matvec_flat(res_c.w_consensus, cols_te, vals_te)
    n_correct_c = int((torch.where(scores >= 0.0, 1.0, -1.0) == y_te).sum())
    acc_c = n_correct_c / len(y_te)
    obj_c = float(res_c.objective_trace[-1])
    log(f"  {res_c.iters} iterations in {sparse_s:.3f} s ({res_c.iters / sparse_s:.1f} it/s), "
        f"objective {obj_c:.4f}, test accuracy {acc_c:.4f}, eps {res_c.epsilon:.3e}, "
        f"launches {sparse_counts}")
    require(res_c.W.shape == (N_NODES, parts_c.d) and bool(torch.isfinite(res_c.W).all()),
            "sparse W not finite or misshaped")
    require(acc_c >= CCAT_MIN_ACCURACY, f"CCAT test accuracy {acc_c:.4f} < {CCAT_MIN_ACCURACY}")
    require(obj_c <= CCAT_MAX_OBJECTIVE, f"CCAT objective {obj_c:.4f} > {CCAT_MAX_OBJECTIVE}")
    require_launches(accounted_c, ccat_kinds, res_c.iters, "kernel.launches accounted")
    require_launches(sparse_counts, ccat_kinds, res_c.iters, "the prefetch path")
    prof_c = profile_iterations(torch, lambda: gadget_train(
        parts_c, y_c, cfg_c._replace(max_iters=n_prof), n_counts=n_c, device=dev))
    device_us_c = prof_c["device_us"] / n_prof
    kernel_us_c = prof_c["kernel_us"] / n_prof
    launches_c = prof_c["kernel_launches"] / n_prof
    host_us_c = sparse_s / res_c.iters * 1e6
    busy_c = device_us_c / host_us_c
    log(f"  profile of {n_prof} iterations: device {device_us_c:.1f} us/iteration (kernels "
        f"{kernel_us_c:.1f}) against {host_us_c:.1f} us/iteration of wall time unprofiled: "
        f"device busy {busy_c:.3f}, {launches_c:.2f} kernel launches and "
        f"{prof_c['copies'] / n_prof:.2f} copies an iteration")
    for key, count, us in prof_c["top_device"]:
        log(f"    device {us / n_prof:9.2f} us/it  x{count:<6d} {key}")
    for key, count, us in prof_c["top_host"]:
        log(f"    host   {us / n_prof:9.2f} us/it  x{count:<6d} {key}")
    require(device_us_c > 0, "the profiled sparse window ran nothing on the device")

    log("phase 8: sweep path, 400 iterations")
    cfg_sw = cfg_c._replace(sparse_schedule="sweep", max_iters=400)
    reset_counts(K, P, S, X)
    t0 = time.perf_counter()
    res_sw = gadget_train(parts_c, y_c, cfg_sw, n_counts=n_c, device=dev)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    sweep_counts = counts(K, P, S, X)
    log(f"  {res_sw.iters} iterations in {sweep_s:.3f} s ({res_sw.iters / sweep_s:.1f} it/s), "
        f"objective {float(res_sw.objective_trace[-1]):.4f}, launches {sweep_counts}")
    require(bool(torch.isfinite(res_sw.W).all()), "sweep W not finite")
    require_launches(sweep_counts, ops.HALF_STEP_KINDS["sweep"], res_sw.iters, "the sweep")
    prof_sw = profile_iterations(torch, lambda: gadget_train(
        parts_c, y_c, cfg_sw._replace(max_iters=n_prof), n_counts=n_c, device=dev))
    device_us_sw = prof_sw["device_us"] / n_prof
    kernel_us_sw = prof_sw["kernel_us"] / n_prof
    launches_sw = prof_sw["kernel_launches"] / n_prof
    log(f"  profile of {n_prof} iterations: device {device_us_sw:.1f} us/iteration (kernels "
        f"{kernel_us_sw:.1f}), {launches_sw:.2f} kernel launches an iteration; prefetch "
        f"{res_c.iters / sparse_s:.1f} against sweep {res_sw.iters / sweep_s:.1f} iterations/s")

    log("phase 9: sparse parity, 200 iterations each")
    cfg_9 = cfg_c._replace(max_iters=200)
    res_pf = gadget_train(parts_c, y_c, cfg_9, n_counts=n_c, device=dev)
    t0 = time.perf_counter()
    res_pf_cpu = gadget_train(parts_c, y_c, cfg_9, n_counts=n_c, device="cpu")
    cpu_c_s = time.perf_counter() - t0
    w_err_c = float((res_pf.W.cpu() - res_pf_cpu.W).abs().max())
    obj_err_c = float(np.max(np.abs(res_pf.objective_trace - res_pf_cpu.objective_trace)
                              / np.abs(res_pf_cpu.objective_trace)))
    res_sw9 = gadget_train(parts_c, y_c, cfg_9._replace(sparse_schedule="sweep"), n_counts=n_c,
                           device=dev)
    sched_err = float((res_pf.W - res_sw9.W).abs().max())
    log(f"  CCAT card against CPU: W max abs err {w_err_c:.3e} (<= {PATH_W_ATOL}), objective "
        f"rel err {obj_err_c:.3e} (<= {PATH_OBJ_RTOL}), CPU run {cpu_c_s:.1f} s; prefetch "
        f"against sweep on the card: W {sched_err:.3e} (must be 0)")
    require(res_pf.iters == res_pf_cpu.iters == res_sw9.iters == 200, "iteration counts differ")
    require(w_err_c <= PATH_W_ATOL, f"sparse W differs from its CPU replay by {w_err_c:.3e}")
    require(obj_err_c <= PATH_OBJ_RTOL, f"sparse objective trace differs by {obj_err_c:.3e}")
    require(sched_err == 0.0, f"prefetch and sweep differ by {sched_err:.3e}")

    ds_r = make_dataset("reuters", scale=1.0, seed=0, sparse=True)
    parts_r, y_r, n_r = partition(ds_r.X_train, ds_r.y_train, N_NODES, seed=0)
    X_r = torch.from_numpy(np.stack([ELL(c, v, (c.shape[0], parts_r.d)).to_dense()
                                     for c, v in zip(parts_r.cols, parts_r.vals)])).to(dev)
    cfg_r = cfg._replace(max_iters=200)
    res_ell = gadget_train(parts_r, y_r, cfg_r, n_counts=n_r, device=dev)
    res_dense = gadget_train(X_r, y_r, cfg_r, n_counts=n_r, device=dev)
    ell_err = float((res_ell.w_consensus - res_dense.w_consensus).abs().max())
    log(f"  reuters ELL {tuple(parts_r.cols.shape)} against its dense form: consensus max abs "
        f"err {ell_err:.3e} (<= {SPARSE_PARITY_ATOL})")
    require(ell_err <= SPARSE_PARITY_ATOL, f"ELL and dense consensus differ by {ell_err:.3e}")

    log("phase 10: serving, the phase 7 model exported, loaded and served")
    d_c, k_c = parts_c.d, ds_c.X_test.k_max
    w_c = res_c.w_consensus.cpu().numpy()
    snap = serve.Snapshot(res_c.iters, w_c, obj_c)
    queries = ccat_queries(ds_c.X_test, ragged=False)
    ragged = ccat_queries(ds_c.X_test, ragged=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        root = Path(tmp)
        serve.to_checkpoint(snap, str(root / "f32"), lam=cfg_c.lam)
        serve.to_checkpoint(snap, str(root / "int8"), quantize="int8", lam=cfg_c.lam)
        srv = serve.SvmServer.load(str(root / "f32"))
        srv_q = serve.SvmServer.load(str(root / "int8"))
        require(srv.device.type == "cuda" and srv.meta["iteration"] == res_c.iters,
                "the f32 export did not load onto the card")
        serve_queries(srv, buckets, queries[:SERVE_ROWS], formats.pad_query_planes)  # warm-up
        shapes_warm = srv.stats()["distinct_shapes"]
        reset_counts(K, P, S, X)
        whole = serve_queries(srv, buckets, queries, formats.pad_query_planes)
        cut = serve_queries(srv, buckets, ragged, formats.pad_query_planes)
        serve_counts = counts(K, P, S, X)
        st = srv.stats()
        n_correct_s = int(np.sum(whole["labels"] == ds_c.y_test))
        acc_s = n_correct_s / len(queries)
        n_q = len(queries) + len(ragged)
        n_batches = whole["batches"] + cut["batches"]
        serve_s = whole["seconds"] + cut["seconds"]
        log(f"  buckets {[(b.rows, b.k, b.n_blocks_max) for b in buckets]}; whole pass: "
            f"{len(queries)} queries in {whole['batches']} batches (buckets k {whole['buckets']}), "
            f"test accuracy {acc_s:.4f}; ragged pass: {cut['batches']} batches (buckets k "
            f"{cut['buckets']}); {n_batches / serve_s:.1f} batches/s, {n_q / serve_s:.1f} "
            f"queries/s, {1e3 * serve_s / n_batches:.3f} ms host time per batch; stats {st}")
        require(len(queries) == ds_c.X_test.shape[0], "not every CCAT test query was served")
        require(n_correct_s == n_correct_c,
                f"served accuracy {acc_s:.4f} != phase 7's {acc_c:.4f}")
        require(len(cut["buckets"]) > 1, f"the ragged pass used buckets {cut['buckets']} only")
        require(serve_counts["ell_scores_prefetch"] == n_batches,
                f"ell_scores_prefetch launched {serve_counts['ell_scores_prefetch']} times for "
                f"{n_batches} batches")
        require(st["distinct_shapes"] <= len(buckets) and st["distinct_shapes"] >= shapes_warm,
                f"{st['distinct_shapes']} shapes served for {len(buckets)} buckets")
        w_dev = torch.from_numpy(w_c).to(dev)
        serve_err = 0.0
        for name, q, out in (("whole", queries, whole), ("ragged", ragged, cut)):
            cols_all, vals_all = formats.pad_query_planes(q, len(q), k_c)
            cols_all, vals_all = torch.from_numpy(cols_all).to(dev), torch.from_numpy(vals_all).to(dev)
            want = R.ell_predict_scores_ref(w_dev[None], cols_all, vals_all)[:, 0]
            got = torch.from_numpy(out["scores"]).to(dev)
            serve_err = max(serve_err, rel_err(got, want)[1])
            plain_lbl = torch.where(R.ell_matvec_flat(w_dev, cols_all, vals_all) >= 0, 1.0, -1.0)
            sure = want.abs() > 1e-5
            require(bool(torch.equal(torch.from_numpy(out["labels"]).to(dev)[sure], plain_lbl[sure])),
                    f"{name} pass: labels differ from the plain gather-dot's")
            require(bool(torch.isfinite(got).all()), f"{name} pass: non-finite scores")
        require(serve_err <= KERNEL_RTOL, f"served scores differ from the oracle by {serve_err:.3e}")
        prof_s = profile_iterations(torch, lambda: serve_queries(srv, buckets, queries,
                                                                 formats.pad_query_planes))
        device_us_s = prof_s["device_us"] / whole["batches"]
        busy_s = device_us_s / (1e3 * whole["batch_ms"])
        log(f"  profile of the whole pass: device {device_us_s:.2f} us/batch against "
            f"{1e3 * whole['batch_ms']:.1f} us/batch of host time unprofiled: device busy {busy_s:.4f}")
        for key, count, us in prof_s["top_device"]:
            log(f"    device {us / whole['batches']:9.2f} us/batch  x{count:<6d} {key}")
        for key, count, us in prof_s["top_host"]:
            log(f"    host   {us / whole['batches']:9.2f} us/batch  x{count:<6d} {key}")
        require(device_us_s > 0, "the profiled serving window ran nothing on the device")
        int8 = serve_queries(srv_q, buckets, queries, formats.pad_query_planes)
        agree = float(np.mean(int8["labels"] == whole["labels"]))
        log(f"  served scores against ell_predict_scores_ref: rel err {serve_err:.3e}; int8 export "
            f"against f32: label agreement {agree:.4f} (>= {INT8_MIN_AGREEMENT}), accuracy "
            f"{float(np.mean(int8['labels'] == ds_c.y_test)):.4f}")
        require(agree >= INT8_MIN_AGREEMENT, f"int8 labels agree with f32 on {agree:.4f} only")

        watch_root = str(root / "watch")
        serve.to_checkpoint(snap, watch_root)
        srv_w = serve.SvmServer.watch(watch_root)
        before = serve_queries(srv_w, buckets, queries[:4 * SERVE_ROWS], formats.pad_query_planes)
        shapes_before = srv_w.stats()["distinct_shapes"]
        require(srv_w.maybe_reload() is None, "an unchanged pointer reloaded")
        w_new = res_pf.w_consensus.cpu().numpy()  # phase 9's 200-iteration run
        new_step = res_c.iters + res_pf.iters
        serve.to_checkpoint(serve.Snapshot(res_pf.iters, w_new, float(res_pf.objective_trace[-1])),
                            watch_root, step=new_step)
        reloaded = srv_w.maybe_reload()
        after = serve_queries(srv_w, buckets, queries[:4 * SERVE_ROWS], formats.pad_query_planes)
        st_w = srv_w.stats()
        want_new = np.array([(v * w_new[c]).sum() for c, v in queries[:4 * SERVE_ROWS]], np.float32)
        swap_err = float(np.max(np.abs(after["scores"] - want_new)) / max(1.0, np.abs(want_new).max()))
        log(f"  hot swap: step {res_c.iters} -> {reloaded}, swaps {st_w['swaps']}, shapes "
            f"{shapes_before} -> {st_w['distinct_shapes']}, new scores rel err {swap_err:.3e}, "
            f"{int(np.sum(after['labels'] != before['labels']))} of {len(after['labels'])} labels moved")
        require(reloaded == new_step and st_w["swaps"] == 1, "the hot swap was not observed")
        require(st_w["distinct_shapes"] == shapes_before, "the hot swap changed the served shapes")
        require(swap_err <= KERNEL_RTOL, f"after the swap the scores are off by {swap_err:.3e}")

    srv_d = serve.SvmServer.from_snapshot(
        serve.Snapshot(res.iters, res.w_consensus.cpu().numpy(), objective))
    srv_d.score(ds.X_test[:SERVE_ROWS])  # warm-up
    reset_counts(K, P, S, X)
    t0 = time.perf_counter()
    _, dense_lbl = srv_d.score(ds.X_test)
    dense_s = time.perf_counter() - t0
    dense_counts = counts(K, P, S, X)
    n_correct_d = int(np.sum(dense_lbl == ds.y_test))
    acc_d = n_correct_d / len(ds.y_test)
    log(f"  reuters dense: {ds.X_test.shape[0]} queries in one score call, {dense_s * 1e3:.2f} ms "
        f"host time ({ds.X_test.shape[0] / dense_s:.1f} queries/s), test accuracy {acc_d:.4f}")
    require(dense_counts["dense_scores"] == 1, "reuters dense serving did not launch dense_scores once")
    require(n_correct_d == n_correct, f"dense served accuracy {acc_d:.4f} != phase 4's {acc:.4f}")

    del res_gpu, res_cpu, res_pf, res_pf_cpu, res_sw9, res_ell, res_dense, X_r, X_dev, Xte
    free_cuda(torch)

    transformer = phase_models(torch, get_config, Model, make_prefill_step, make_serve_step,
                               serve_lm, X, K, P, S, dev)

    def reset():
        reset_counts(K, P, S, X)

    def counts_of():
        return counts(K, P, S, X)

    core = types.SimpleNamespace(FaultPlan=FaultPlan, TrainTelemetry=TrainTelemetry,
                                 DrawPlan=gadget_mod.DrawPlan,
                                 GeneratorDraws=gadget_mod.GeneratorDraws,
                                 threefry2x32=counter_rng.threefry2x32,
                                 TrainState=gadget_mod.TrainState,
                                 gadget_train_stream=gadget_mod.gadget_train_stream)
    reuters = (Xp, yp, n_counts, ds)
    phase_s = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_anytime_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        log("phase 15: the fused step above its minibatch cap")
        c1 = phase_c1_route(torch, ops, K, gadget_train, GadgetConfig, dev, reset, counts_of)
        free_cuda(torch)
        phase_s["15"] = time.perf_counter() - t0
        log("phase 16: faults, reuters at full size")
        faults = phase_faults(torch, ops, core, gadget_train, cfg, reuters, dev, reset, counts_of)
        free_cuda(torch)
        phase_s["16"] = time.perf_counter() - t0 - sum(phase_s.values())
        log("phase 17: anytime export, the stream, resume and the snapshot ring")
        anytime = phase_anytime(torch, serve, core, gadget_train, cfg, cfg_c, reuters, ccat, dev,
                                tmp, reset, counts_of, ccat_kinds)
        phase_s["17"] = time.perf_counter() - t0 - sum(phase_s.values())
        log("phase 18: the live publisher behind a watching server")
        publisher = phase_publisher(torch, serve, formats, telemetry, R, cfg_c, ccat, ds_c,
                                    buckets, queries, dev, tmp, reset, counts_of, ccat_kinds)
        phase_s["18"] = time.perf_counter() - t0 - sum(phase_s.values())
        log("phase 19: the serving control plane")
        control = phase_control_plane(torch, serve, formats, libsvm, telemetry, tmtr, top, R,
                                      ds_c, w_c, n_correct_c, buckets, publisher["installed"],
                                      dev, tmp, reset, counts_of)
        phase_s["19"] = time.perf_counter() - t0 - sum(phase_s.values())
        free_cuda(torch)
        log("phase 20: the remaining solvers: host loop, Pegasos, the online baselines, "
            "multiclass")
        solvers = phase_solvers(torch, gadget_mod, pegasos, cutting_plane, multiclass, P, ops,
                                cfg, reuters, kernels, dev, reset, counts_of)
        free_cuda(torch)
        phase_s["20"] = time.perf_counter() - t0 - sum(phase_s.values())
        log(f"  {phase_s['20']:.1f} s")
        log("phase 21: the mesh, four gloo ranks on the card, then NCCL")
        mesh = phase_mesh(torch, partition, ds_r, tmp, ops.HALF_STEP_KINDS)
        phase_s["21"] = time.perf_counter() - t0 - sum(phase_s.values())
        log(f"  {phase_s['21']:.1f} s")
    free_cuda(torch)
    log("phase 22: serving the MoE, VLM and audio families at full width")
    families = phase_new_families(torch, get_config, Model, make_host_batch, make_prefill_step,
                                  make_serve_step, K, P, S, X, dev)
    phase_s["22"] = time.perf_counter() - t0 - sum(phase_s.values())
    log(f"  {phase_s['22']:.1f} s")
    log("phase 23: training, every family against the CPU, then four runs at full width")
    training = phase_training(torch, get_config, Model, make_host_batch, steps_lm, optim,
                              Batcher, TokenStreamConfig, FA, RG, WK, K, P, S, X, dev)
    phase_s["23"] = time.perf_counter() - t0 - sum(phase_s.values())
    log(f"  {phase_s['23']:.1f} s")
    free_cuda(torch)
    sharded, dryrun_out, s24, s25 = phases_sharded_and_dryrun(
        torch, get_config, Model, make_host_batch, steps_lm, optim, mesh_lm, shard_lm,
        sharding_api, SHAPES, FA, WK, K, P, S, X, dev)
    phase_s["24"], phase_s["25"] = s24, s25
    free_cuda(torch)
    log("phase 26: the five examples on the card")
    t26 = time.perf_counter()
    examples = phase_examples(torch, FA, WK, K, P, S, X, dev)
    phase_s["26"] = time.perf_counter() - t26
    log(f"  {phase_s['26']:.1f} s")
    log(f"  seconds per phase: {', '.join(f'{k}: {v:.1f}' for k, v in phase_s.items())}")

    log("phase 27: summary")
    # each kernel's launches on its path's phase; 0 for the entries on none
    launches = dict.fromkeys(KERNELS, 0)
    for c, kinds in ((main_counts, ops.HALF_STEP_KINDS["fused"] + ("dense_scores",)),
                     (unfused_counts, ops.HALF_STEP_KINDS["unfused"]), (sparse_counts, ccat_kinds),
                     (sweep_counts, ops.HALF_STEP_KINDS["sweep"]),
                     (serve_counts, ("ell_scores_prefetch",))):
        launches.update({name: c[name] for name in kinds})
    prefill = {arch: transformer[arch]["prefill"]["launches"]
               for arch in ("recurrentgemma-9b", "rwkv6-3b")}
    launches.update(flash_attention=prefill["recurrentgemma-9b"]["flash_attention"],
                    rglru_scan=prefill["recurrentgemma-9b"]["rglru_scan"],
                    wkv_scan=prefill["rwkv6-3b"]["wkv_scan"])
    paths = {"fleet_half_step": "fused training (phase 4)", "dense_scores": "scoring (phase 4)",
             "margins": "unfused training (phase 5)", "grad_update": "unfused training (phase 5)",
             "ell_margins_prefetch": "none: the margins-only entry, held in phase 3; sparse "
                                     "training (phase 7) runs ell_grad_update_fused",
             "ell_margins_prefetch_coeff": "none: held in phase 3; sparse training (phase 7) "
                                           "runs ell_grad_update_fused",
             "ell_grad_update_prefetch": "none: the buckets entry, held in phase 3; sparse "
                                         "training (phase 7) runs ell_grad_update_fused",
             "ell_grad_update_prefetch_fold": "none: held in phase 3; sparse training (phase 7) "
                                              "runs ell_grad_update_fused",
             "ell_grad_update_fused": "sparse training, auto = prefetch (phase 7)",
             "ell_margins": "none: the margins-only entry, held in phase 3; sparse training, "
                            "sweep (phase 8) runs ell_margins_coeff",
             "ell_margins_coeff": "sparse training, sweep (phase 8)",
             "ell_grad_update": "sparse training, sweep (phase 8)",
             "ell_scores_prefetch": "sparse serving (phase 10)",
             "flash_attention": "recurrentgemma-9b prefill (phase 11)",
             "rglru_scan": "recurrentgemma-9b prefill (phase 11)",
             "wkv_scan": "rwkv6-3b prefill (phase 14)"}
    # every later path each kernel runs, with its launches there
    more_paths = {name: [] for name in KERNELS}
    more_paths["fleet_half_step"] += [
        {"path": "faulted fused training, link mode (phase 16)", "launches": faults["link"]["launches"]},
        {"path": "faulted fused training, dead node, telemetry ring (phase 16)",
         "launches": faults["dead"]["launches"]},
        {"path": "faulted reuters stream (phase 17)",
         "launches": anytime["reuters_stream"]["fleet_half_step"]}]
    for name in ("margins", "grad_update"):
        more_paths[name] += [
            {"path": "fused step above its minibatch cap (phase 15)",
             "launches": c1["train_launches"][name]},
            {"path": "faulted unfused training (phase 16)", "launches": faults["unfused"][name]},
            {"path": "host-loop reference, random topology (phase 20)",
             "launches": solvers["host_loop"]["random"][name]},
            {"path": "host-loop reference, exponential topology (phase 20)",
             "launches": solvers["host_loop"]["exponential"][name]},
            {"path": f"dense mesh step, {MESH_WORLD} gloo ranks, all ranks (phase 21)",
             "launches": mesh["gloo"][name]},
            {"path": f"dense mesh step over NCCL, world {mesh['nccl']['world']} (phase 21)",
             "launches": mesh["nccl"][name]}]
    for name in ccat_kinds:
        more_paths[name] += [
            {"path": "CCAT stream (phase 17)", "launches": anytime["ccat_stream"][name]},
            {"path": "CCAT training behind the publisher (phase 18)", "launches": publisher[name]},
            {"path": f"sparse mesh step, prefetch, {MESH_WORLD} gloo ranks, all ranks (phase 21)",
             "launches": mesh["gloo"][name]}]
    more_paths["dense_scores"] += [
        {"path": "predict_multiclass at mnist's shape, C = 10 (phase 20)",
         "launches": solvers["multiclass"]["dense_scores"]},
        {"path": f"make_mesh_scorer, {MESH_WORLD} gloo ranks, all ranks (phase 21)",
         "launches": mesh["gloo"]["dense_scores"]},
        {"path": f"make_mesh_scorer over NCCL, world {mesh['nccl']['world']} (phase 21)",
         "launches": mesh["nccl"]["dense_scores"]}]
    more_paths["ell_scores_prefetch"] += [
        {"path": "serving behind the publisher (phase 18)",
         "launches": publisher["ell_scores_prefetch"]},
        {"path": "control plane, closed loop, whole (phase 19)",
         "launches": control["closed_loop"]["whole"]["ell_scores_prefetch"]},
        {"path": "control plane, closed loop, ragged (phase 19)",
         "launches": control["closed_loop"]["ragged"]["ell_scores_prefetch"]},
        {"path": "control plane, closed loop, whole, traced (phase 19)",
         "launches": control["closed_loop"]["whole, traced"]["ell_scores_prefetch"]},
        {"path": "control plane, open loop under overload (phase 19)",
         "launches": control["open_loop"]["ell_scores_prefetch"]}]
    for arch in ("qwen2-moe-a2.7b", "llava-next-mistral-7b", "hubert-xlarge"):
        more_paths["flash_attention"].append(
            {"path": f"{arch} forward at full width, {families[arch]['layers']} layers (phase 22)",
             "launches": families[arch]["launches"]["flash_attention"]})
    for run, row in training["card_vs_cpu"].items():
        for name, n in row["launches_per_step"].items():
            more_paths[name].append({"path": f"{run}, reduced, a train step (phase 23a)",
                                     "launches": n, "plain_backwards":
                                     row["plain_backwards_per_step"].get(name)})
    for part, arch in (("b", "qwen2-moe-a2.7b"), ("c", "hubert-xlarge"), ("d", "rwkv6-3b"),
                       ("e", "recurrentgemma-9b")):
        row = training[arch]
        for name, n in row["launches_per_step"].items():
            more_paths[name].append({"path": f"{arch} training at full width, a step "
                                     f"(phase 23{part})", "launches": n,
                                     "plain_backwards": row["plain_backwards_per_step"].get(name)})
        if "remat" in row:
            r = row["remat"]
            for name, n in r["remat"]["launches"].items():
                more_paths[name].append({
                    "path": f"{arch} training at full width, a step under remat "
                            f"{r['policy']!r} (phase 23{part})", "launches": n,
                    "plain_backwards": r["remat"]["plain_backwards"].get(name)})
    for arch, row in sharded.items():
        for name, n in row["launches_per_step"].items():
            more_paths[name].append({"path": f"{arch} sharded train step on a (1, 1) mesh, "
                                     f"{row['layers']} layers (phase 24)", "launches": n,
                                     "plain_backwards": row["plain_backwards_per_step"].get(name)})
    ex = examples
    more_paths["fleet_half_step"].append(
        {"path": "examples/torch_quickstart.py, GADGET (phase 26)",
         "launches": ex["quickstart"]["launches"]["fleet_half_step"]})
    for name, n in ex["serve_batched"]["train_launches"].items():
        more_paths[name].append({"path": "examples/torch_serve_batched.py, training (phase 26)",
                                 "launches": n})
    for name, n in ex["serve_batched"]["serve_launches"].items():
        more_paths[name].append({"path": "examples/torch_serve_batched.py, serving (phase 26)",
                                 "launches": n})
    for label, row in ex["gossip_vs_allreduce"].items():
        more_paths["flash_attention"].append(
            {"path": f"examples/torch_gossip_vs_allreduce.py, {label} (phase 26)",
             "launches": row["launches"].get("flash_attention", 0),
             "plain_backwards": row["plain_backwards"].get("flash_attention", 0)})
    for mode, row in ex["train_100m"].items():
        more_paths["flash_attention"].append(
            {"path": f"examples/torch_train_100m.py, {mode}, a step under remat (phase 26)",
             "launches": row["launches_per_step"]["flash_attention"],
             "plain_backwards": row["plain_backwards_per_step"]["flash_attention"]})
    sources = {"fleet_half_step": "hinge_subgrad.cu", "margins": "hinge_subgrad.cu",
               "grad_update": "hinge_subgrad.cu", "dense_scores": "predict.cu",
               "ell_scores_prefetch": "predict.cu",
               **{name: "sparse.cu" for name in KERNELS
                  if name.startswith("ell_") and name != "ell_scores_prefetch"}}
    sources = {name: f"{SOURCE_DIR}/{src}" for name, src in sources.items()}
    sources.update(TRANSFORMER_SOURCES)
    tolerance = {name: f"rel {KERNEL_RTOL}" for name in KERNELS}
    tolerance["ell_margins_prefetch_coeff"] += ("; margins bit for bit the margins entry's, "
                                                "coefficients bit for bit torch.where of them")
    tolerance["ell_grad_update_fused"] += ("; bit for bit the touched-block map, "
                                           "ell_margins_prefetch_coeff and "
                                           "ell_grad_update_prefetch_fold in turn")
    tolerance["ell_margins_coeff"] += ("; margins bit for bit ell_margins' and, at the sound map, "
                                       "ell_margins_prefetch_coeff's; coefficients bit for bit "
                                       "torch.where of them")
    tolerance["rglru_scan"] = "bit for bit"
    tolerance["flash_attention"] += f"; bf16 abs {BF16_ATOL} and one bf16 ulp + {KERNEL_RTOL}"
    for name in TRANSFORMER_REPLACES:
        tolerance[name] += (f"; gradients rel {KERNEL_RTOL} against autograd through the plain "
                            "version")
    line = {"kernels": [dict(name=name, route="cuda", source=sources[name],
                             replaces=REPLACES[name], launches=launches[name], path=paths[name],
                             paths=more_paths[name],
                             tolerance=tolerance[name], **kernels[name])
                        for name in KERNELS],
            "main_path": {"iters": res.iters, "train_s": train_s, "iters_per_s": res.iters / train_s,
                          "test_accuracy": acc, "objective": objective,
                          "device_us_per_iter": device_us, "host_us_per_iter": host_us,
                          "device_busy_share": busy,
                          "kernel_launches_per_iter": prof["kernel_launches"] / n_prof,
                          "unfused_iters_per_s": res_u.iters / unfused_s,
                          "unfused_device_us_per_iter": device_us_u,
                          "unfused_kernel_us_per_iter": kernel_us_u,
                          "unfused_kernel_launches_per_iter": launches_u,
                          "cpu_parity_w_err": w_err, "cpu_parity_obj_rel_err": obj_err},
            "sparse_path": {"dataset": f"ccat scale {CCAT_SCALE}", "generate_s": gen_s,
                            "schedule": list(schedule), "iters": res_c.iters,
                            "train_s": sparse_s, "iters_per_s": res_c.iters / sparse_s,
                            "test_accuracy": acc_c, "objective": obj_c,
                            "device_us_per_iter": device_us_c, "host_us_per_iter": host_us_c,
                            "device_busy_share": busy_c,
                            "kernel_us_per_iter": kernel_us_c,
                            "kernel_launches_per_iter": launches_c,
                            "sweep_iters_per_s": res_sw.iters / sweep_s,
                            "sweep_device_us_per_iter": device_us_sw,
                            "sweep_kernel_us_per_iter": kernel_us_sw,
                            "sweep_kernel_launches_per_iter": launches_sw,
                            "cpu_parity_w_err": w_err_c, "cpu_parity_obj_rel_err": obj_err_c,
                            "prefetch_vs_sweep_w_err": sched_err,
                            "reuters_ell_vs_dense_err": ell_err},
            "serving": {"dataset": f"ccat scale {CCAT_SCALE} test set",
                        "buckets": [[b.rows, b.k, b.n_blocks_max] for b in buckets],
                        "queries": n_q, "batches": n_batches, "serve_s": serve_s,
                        "batches_per_s": n_batches / serve_s, "queries_per_s": n_q / serve_s,
                        "mean_batch_host_ms": 1e3 * serve_s / n_batches,
                        "device_us_per_batch": device_us_s, "device_busy_share": busy_s,
                        "whole_buckets": whole["buckets"], "ragged_buckets": cut["buckets"],
                        "test_accuracy": acc_s, "scores_rel_err": serve_err,
                        "int8_label_agreement": agree, "distinct_shapes": st["distinct_shapes"],
                        "blocks_visited_ratio": st["blocks_visited_ratio"],
                        "cap_overflows": st["cap_overflows"], "swaps": st_w["swaps"],
                        "reuters_dense_queries": int(ds.X_test.shape[0]),
                        "reuters_dense_s": dense_s,
                        "reuters_dense_queries_per_s": ds.X_test.shape[0] / dense_s,
                        "reuters_dense_accuracy": acc_d},
            "transformer": transformer,
            "kernel_gradients_rel_err": kernel_grads, "op_checks_s": op_checks,
            "sharded": sharded, "dryrun": dryrun_out, "new_families": families,
            "training": training, "examples": examples,
            "c1_route": c1, "faults": faults, "anytime": anytime, "publisher": publisher,
            "control_plane": control, "solvers": solvers, "mesh": mesh,
            "later_phase_s": phase_s,
            "ptxas": resources,
            "total_s": time.perf_counter() - t_all}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
