"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

1. Prints torch/CUDA versions and the card's name and power limit.
2. Builds the port's four CUDA kernels (``csrc/bitunpack.cu``,
   ``csrc/filter_agg.cu``, ``csrc/block_agg.cu``, ``csrc/flash_fwd.cu``)
   from this checkout,
   one nvcc each, all at once, and prints nvcc's register, shared-memory
   and spill report, ``bitunpack``'s dynamic shared memory at the shapes
   it runs, and each kernel's SASS instruction count (``cuobjdump``).
3. Holds ``bitunpack`` bit-exact against its plain PyTorch version on the
   card (every width 1..32, ragged n to 2^24 + 17, and words 1-3 words
   past a 16-byte line) and against the numpy codec to 4096 values,
   and ``filter_agg``/``block_agg``
   against their plain versions (every comparator, float32 and int32
   columns, bool/uint8/int32 masks, ragged lengths, empty selections,
   NaN; sums and counts at rtol 3e-5 / atol 1e-3, min and max exact);
   times each kernel (device time from ``torch.profiler``, time per call
   from CUDA events) beside its memory bound, ``bitunpack`` also at 2^28
   values of 1, 7, 17 and 32 bits, ``filter_agg``/``block_agg`` at 2^28
   rows.  Then the mixed product
   (``layers.mixed_einsum``: bf16 operands, a float32 result, the
   reference's ``preferred_element_type=float32``), its route printed:
   each of the port's products forward and backward on the card against
   the CPU's upcast product, and the loss's head product at
   starcoder2_7b's widths timed beside the upcast float32 one.  Then
   the inference attention kernel (``flash_fwd``) against the block loop
   at ``FF_CHECKS`` (the serving cell's 32 x 2,048 with 36 heads over 4,
   G = 1, a later chunk with ``q_offset`` > 0, no mask), and timed at
   the cell's shape beside its bound, the loop and
   ``scaled_dot_product_attention``.
4. Drives the port's main path through the user entry points: a 2^27-row
   event table (1.5 GiB raw, half the paper's Table 1 scale, for the
   script's time) written into an
   8-OSD, 3-replica store with the default 8 MiB objects, then a
   filter -> agg, a filter -> project, a row-range read, an OSD loss,
   recovery and the aggregate again — every bitpack column decoded on
   the card.  Results are checked against numpy on the generated table
   and against the same scans with the numpy decode.
5. Device pushdown on the same table, on the card: ``pushdown_torch.
   pushdown_filter_aggregate`` and ``ops.filter_aggregate`` (the
   ``filter_agg`` kernel) and ``ops.masked_aggregate`` (``block_agg``),
   checked against the OSD scan's float64 result and numpy.
6. Packed ingest at deepseek_67b's vocabulary (102,400: bitpack17) and
   the train_4k batch (256 x 4096 tokens): a corpus written into an
   8-OSD, 3-replica store, a packed, prefetching, windowed
   ``ObjectDataLoader`` -> ``device_stream`` -> ``fused_batch`` (the
   ``bitunpack`` kernel) for 8 steps, each batch bit-equal to the plain
   loader's.
7. Skyhook on the main path's table: ``SkyhookDriver`` runs the filter ->
   agg and the filter -> project as a ``Query`` and through
   ``driver.scan`` (equal to ``vol.scan`` and numpy, at most one request
   per up OSD), then the filter -> agg client-side: both walls and both
   ``client_rx``.
8. Session: 16 threads behind a barrier issue the same filter -> agg
   through one ``ScanSession``; every result equals the direct scan's.
9. Faults: a ``FaultInjector`` campaign (8 bit flips, 2 torn writes on
   distinct copies) over the table's objects; the filter -> agg stays
   exact, scrub finds and heals exactly the injected copies and a second
   scrub finds none; transient failures on one OSD are retried.
10. Maintenance: a second table of the same schema and an eighth of the
    rows (2^24, for the script's time) in 1 MiB
    objects in a fresh store, compacted (8 MiB policy), scrubbed,
    rebalanced and aged by the four daemons while a client thread loops
    the filter -> agg (each result held against numpy); then
    ``apply_storage_resize`` adds an OSD, a topology change and a
    rebalance, and the query again.
11. Checkpoint: ``CheckpointManager(every_steps=1, keep=2)`` saves three
    steps of one deepseek_67b decoder layer's weights (692M bf16 values,
    1.38 GB) from the card into a fresh store and restores the latest
    onto the card, bit-equal; the retired step is gone.
12. KV pages: a dense (95, 1, 4096, 8, 128) bf16 K and V cache on the
    card through ``cache_to_objects`` (2048-token pages on axis 2) and
    back through ``objects_to_cache``, bit-equal.
13. Serve: yi_9b at its published widths and depth (48 layers, d_model
    4096, 32 heads / 4 KV heads of 128, d_ff 11008, vocab 64000), bf16,
    random weights from ``--seed``, through ``ServeEngine.generate``: 8
    requests of 256-1024 prompt tokens, 8 new tokens each, a 4096-slot
    cache (3.22 GB) parked to a fresh store and resumed bit-equal; a
    2^26-row request log (``examples/serve_pushdown.py``'s columns) in
    another fresh store, one filter -> agg per request from 8 threads
    through ``engine.analytics`` (a ``ScanSession``), equal to numpy.
    Then the prefill/decode invariant of ``tests/test_models.py``
    (prefill of 512 tokens and 512 teacher-forced decode steps against
    prefill of all 1024, batch 2) at full width in float32 with 3 of
    the 48 layers, held to rtol/atol 2e-2; the same check in bf16 at
    full depth (496 + 16 against 512) is printed without a gate.
14. Train, full width: yi_9b at its published widths with 8 of its 48
    layers (1,908,477,952 parameters; bf16 params and grads and float32
    AdamW moments are 22.9 GB), ``remat="full"``, random weights from
    ``--seed``.  A 1024 x 4096-token corpus built from ``--seed`` into a
    fresh 8-OSD, 2-replica store in one ``build_corpus`` call; a packed,
    prefetching ``ObjectDataLoader`` feeding ``Trainer(packed_ingest=
    True)`` (``fused_batch``: the ``bitunpack`` kernel) for 5 steps of
    4 x 4096 tokens.  Every loss finite and the last below the first;
    one ``bitunpack`` launch a step; step walls, tokens/s, model FLOPs
    and their share of the bf16 dense peak, peak memory, and the card's
    busy share of one more step under ``torch.profiler``.
15. Train restart: the same widths with 1 layer, 3 steps with a
    checkpoint at step 2 into the store; a fresh Trainer restores it and
    runs step 3 again under ``torch.use_deterministic_algorithms``:
    every leaf of params, m and v bit-equal to the uninterrupted run.
    Save and restore walls and GB/s.
16. Flash backward: the ``torch.autograd.Function`` against autograd
    through the checkpointed forward loop (``impl="scan"``) at one
    full-width layer's shapes (B 1, S 4096, H 32, K 4, hd 128, causal):
    dq, dk, dv within rtol/atol 1e-4 in float32, printed in bf16; both
    routes timed.
17. Mixture-of-experts serve: deepseek_v2_lite_16b at its published
    widths and depth (27 layers, d_model 2048, MLA with kv_lora_rank 512
    and 16 heads of 128 + 64, layer 0 dense, 26 layers of 64 routed
    experts top-6 and 2 shared; 15,706,470,400 parameters, 31.42 GB),
    bf16, random weights from ``--seed``, through the same requests,
    engine, park/resume (a 1,019,215,872 B latent cache, ``ckv`` and
    ``krope``) and analytics as yi_9b; the decode step beside its
    memory bound (every expert's weights are read each step); the
    shipped config's bf16 invariant (496 + 16 against 512, capacity
    factor 1.25) printed without a gate.
18. Mixture-of-experts invariant: the same widths in float32 with the
    dense layer and 5 of the 26 MoE layers (``MOE_F32_WHY``), at
    capacity factor n_routed / top_k (no token dropped in prefill, as
    decode drops none): 512 + 512 against 1024, batch 2, held to
    rtol/atol 2e-2.
19. Mixture-of-experts train: deepseek_v2_lite_16b's widths with its
    dense layer and 5 MoE layers (3,424,675,840 parameters, ~41 GB of
    bf16 params and grads and float32 moments), the yi_9b train phase's
    corpus (vocabulary 102,400: bitpack17), steps, batch and lr; every
    loss and ``aux_loss`` finite, ``aux_loss`` > 0, the last loss below
    the first; model FLOPs (top-6 + 2 shared experts) beside the FLOPs
    as run (every expert's capacity slots).
20. Recurrent serve: rwkv6_3b (32 layers, d_model 2560, 40 heads of 64,
    d_ff 8960, vocabulary 65,536; 3,073,484,800 parameters, 6.17 GB)
    and zamba2_2p7b (54 Mamba2 layers in 9 groups of 6, each group
    followed by one shared attention + MLP block; 80 SSD heads of 64,
    state 64, 32 attention heads of 80, d_ff 10240, vocabulary 32,000;
    2,396,144,800 parameters, 4.79 GB), each whole in bf16 through the
    yi_9b phase's requests, engine, park / resume (rwkv's 170,393,604 B
    state whole; zamba's 3,599,400,964 B of SSD and conv state whole and
    k / v in pages) and analytics; the decode step beside its memory
    bound; the bf16 invariant (240 + 16 against 256) without a gate.
21. Recurrent invariants in float32, 512 + 512 against 1024, batch 2,
    held to rtol/atol 2e-2: rwkv6_3b whole, zamba2_2p7b at one group (6
    Mamba2 layers and the shared block), its whole depth printed without
    a gate at 256 + 256 against 512.
22. Recurrent train: each at full width, packed ingest from a corpus at
    its vocabulary (bitpack16, bitpack15), the yi_9b train phase's
    steps, batch and lr: rwkv6_3b at 1 of its 32 layers, zamba2_2p7b at
    18 of its 54 (3 of its 9 groups, each with the shared block); every
    loss finite, the last below the first, ``aux_loss`` 0.
23. Multi-device on one card: two gloo ranks spawned on the card (NCCL
    refuses two ranks on one device).  (a) ``make_compressed_train_step``
    through ``Trainer`` on a (pod 2, data 1, model 1) mesh: yi_9b at its
    published widths with 2 layers, the train phase's corpus and lr, 4
    steps, each rank reading its half of every 4 x 4096-token batch
    through packed ingest; every loss finite and the last below the
    first, params bit-equal across the ranks after every step (a digest
    of their bits), and step 2's synced gradient recomputed on the host
    from both ranks' local gradients and errors (int32 sums, scale sums
    and new errors exact, the bf16 result within 1 ulp); step walls and
    the bytes each rank sends for the pod hop.  (b) One
    deepseek_v2_lite_16b MoE layer at full width under fsdp on (data 2):
    each rank's output bit-equal to the single-card ``_moe_math`` on its
    tokens with the whole weights; its megatron body in float32 on (data
    1, model 2) within 1e-5 of the largest output.

24. FSDP on one card: two gloo ranks on (data 2, model 1) under
    ``fsdp``, each holding half of every parameter and moment: yi_9b at
    full width with 1 layer in float32, 2 steps, each rank's losses and
    blocks against the unsharded steps (params and moments at atol 1e-4
    / rtol 1e-5); with 1 layer in bf16 (lr 1e-5) through
    ``Trainer(rules=...)`` and packed ingest (each rank unpacks its own
    words with ``bitunpack``), under
    deterministic algorithms: 2 steps and a checkpoint (gathered leaf by
    leaf, written once by rank 0), that checkpoint restored whole on the
    card by the unsharded ``Trainer`` and held bit-equal to the gathered
    state, step 3 timed, then fresh models and Trainers restored from
    it (rank 0 reads, scatters each rank's blocks) and run to step 3,
    every rank's blocks bit-equal to the uninterrupted run; save and
    restore walls and bytes; and deepseek_v2_lite_16b's dense and one
    MoE layer's gradients against the single-card math.
25. The model axis on one card: two gloo ranks on (data 1, model 2),
    yi_9b's heads, d_ff and vocabulary split in two.  (a) yi_9b at full
    width with 1 layer in float32 under ``megatron_sp``, 2 steps of 2 x
    1024 tokens against the unsharded step of the same seed (params and
    moments at atol 1e-4 / rtol 1e-5), then ``tp_sp`` serving of 4
    prompts of 1024 tokens and 8 greedy decode steps against the
    single-card model (logits within 1e-4 of its largest, tokens
    equal); (b) 1 layer in bf16 (lr 1e-5) under ``megatron_sp``, 2 x
    4096 tokens from packed ingest, 3 timed steps (wall, wire bytes by
    kind a rank a step, peak memory), and ``tp_sp`` serving in bf16
    timed; (c)
    deepseek_v2_lite_16b's dense and one MoE layer in float32 under
    ``megatron_sp``: one step's gradients against the single-card
    gradients on the same tokens, within 1e-4 of each leaf's largest.

26. The recurrent model axis on one card (``recurrent_tp_path``).
27. The dry run (``repro_torch.launch.dryrun``), started before the
    build as one subprocess a cell at nice 19, beside the phases above,
    on fake ``cuda`` tensors and a fake process group of 256 or 512
    ranks: yi_9b ``train_4k`` on (16, 16), the same with packed ingest
    (``fused``: ``packed_input_spec`` and the ``bitunpack`` operator's
    fake), deepseek_v2_lite_16b ``decode_32k``, and rwkv6_3b
    ``train_4k`` on (2, 16, 16); each record's per-rank peak memory,
    FLOPs, wire bytes and dominant roofline term (the H100's peaks).
    It fails if a cell fails.
28. The examples, each through its ``main(argv)`` on the card as a user
    runs it, under its own wall clock: ``examples/quickstart_torch.py``
    and ``examples/serve_pushdown_torch.py`` as they stand (their own
    assertions: scans, faults, the tiny LM, the maintenance plane, the
    registry pass; served tokens, the KV cache revived bit-exact, the
    request log's counts), and ``examples/train_e2e_torch.py --preset
    100m`` (12 layers, d_model 768, float32, 8 x 256 tokens a step) for
    20 steps with an OSD killed at step 10, its loss falling; each must
    launch ``bitunpack`` (scans, packed ingest).
29. starcoder2_7b at its published widths (32 layers, d_model 4608, 36
    heads / 4 KV heads of 128, d_ff 18432 gelu, layernorm, vocabulary
    49,152; 7.4 G parameters, 14.8 GB in bf16): (a) served whole in bf16
    through serve's requests, engine, park / resume and analytics, and
    its float32 invariant (512 + 512 against 1024) gated at 2e-2 at
    ``SC_F32_LAYERS`` layers; (b) trained at full width with
    ``SC_TRAIN_LAYERS`` layers from packed ingest (4 x 4096 tokens, 5
    steps at lr 1e-5: losses finite and falling) and the flash backward
    at one layer's shapes (1e-4); (c) with the reference's ``HEAD_TP =
    "head_dim"`` (36 heads: ``wq``, ``wk``, ``wv`` and ``wo`` split on
    the head dimension, 64 of 128 a rank) on two gloo ranks on (data 1,
    model 2): phase 25's float32 parity at 1 layer (2 ``megatron_sp``
    steps against the unsharded step, ``tp_sp`` prefill and 8 decode
    steps within 1e-4 of the largest logit), then 2 layers in bf16, one
    timed step of 2 x 1024 tokens and a timed ``tp_sp`` prefill and
    decode, the wire bytes beside each.  Every serve and train line
    names the ``HEAD_TP`` / ``XENT_MM`` in force.

Each path runs with the kernels' launch counts set to 0 just before it
and read just after; every kernel of a path must have launched (the
checkpoint and KV paths decode nothing and launch no kernel, nor does
the flash backward; the serve path launches ``bitunpack`` in its
analytics scans, the train paths once a step; so do the mixture-of-
experts and recurrent serve and train paths, and the invariants launch
none; in the multi-device path each rank launches it once a step; each
example launches it).  ``flash_fwd`` launches once a layer in the
yi_9b and starcoder2_7b serve paths' prefill (bf16 GQA with heads of
128) and in no other path: MLA, zamba2's heads of 80, training and the
head-dimension split keep the block loop.  The ``kernels`` line counts
each kernel's launches over the paths, ``flash_fwd_path``'s checks and
timings left out.  The
line before the last two is the ``kernels`` JSON object; the last line
is ``{"ok": true, "device": {...}}``; any failure raises and the exit
code is non-zero.  Needs a CUDA device and a checkout of the
repository.

Run from the root of a checkout:  python3 chip_smoke.py
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
DEVICE = "cuda:0"
FULL_ROWS_LOG2 = 28            # 2^28 rows x 12 B = 3 GiB, the paper's 3 GB
# the main path's table by default: half the paper's, for the script's
# time (its write and ~25 full scans took 144-210 s at 2^28 on H100
# machines); the kernels are still timed at 2^28
ROWS_LOG2 = 27
SWEEP_BITS = tuple(range(1, 33))
SWEEP_N = (0, 1, 31, 32, 33, 129, 1000, 4096, (1 << 24) + 17)
CODEC_N = 4096                 # the sweeps' numpy codec cross-check, values
OFFSETS = (1, 2, 3)            # words past a 16-byte line
OFFSET_N = (33, 4096, (1 << 24) + 17)
WIDTH_BITS = (1, 7, 17, 32)    # bitunpack timed at 2^28 values of each
AGG_SWEEP_N = (0, 1, 8191, 8192, 12345, (1 << 24) + 17)
CMPS = ("<", "<=", ">", ">=", "==", "!=")
KERNELS = ("bitunpack", "filter_agg", "block_agg", "flash_fwd")
# packed ingest: deepseek_67b's vocabulary (src/repro/configs/
# deepseek_67b.py:20) and the train_4k shape (configs/base.py:36)
INGEST_VOCAB, INGEST_SEQ, INGEST_BATCH = 102_400, 4096, 256
INGEST_SEQS, INGEST_STEPS = 4096, 8
MAINT_OBJECT_BYTES = 1 << 20   # the maintenance path's small objects
MAINT_ROWS_LOG2 = 24           # its table: 2^24 rows, for the script's time
# serve: yi_9b (src/repro/configs/yi_9b.py:14-29) with 8 requests of
# 256-1024 prompt tokens; the longest is exactly 1024, because the
# reference's flash attention needs a padded prompt longer than 512
# tokens to be a multiple of 512 (attention.py:114)
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT = "yi_9b", 8, (256, 1024)
SERVE_MAX_NEW, SERVE_MAX_SEQ = 8, 4096   # 8 new tokens: the script's time
SERVE_LOG_ROWS_LOG2 = 26       # the request log's rows
SERVE_CLIENTS = 8
# the invariant of tests/test_models.py:57-86 at full width: (prefill,
# decode steps) per dtype; float32 is held to the reference's 2e-2, for
# yi_9b at 3 of its 48 layers (all 48 took 57 s of the script's time,
# 24 took 32.8 s and held 2.2e-5, 12 14.9 s and 2.6e-5, 6 7.7 s and
# 2.2e-5: its conditioning is flat, and the script must stay inside 880
# s); bf16 (printed, no gate) at 496 + 16 (each teacher-forced decode
# step of a whole model takes ~0.1 s)
INVARIANT_F32, INVARIANT_BF16, INVARIANT_TOL = (512, 512), (496, 16), 2e-2
SERVE_F32_LAYERS = 3
# train: yi_9b at its published widths, 8 of its 48 layers (bf16 params
# and grads with float32 AdamW moments are 22.9 GB; all 48 need ~106 GB
# before activations; 24 took ~7.3 s a step, and the script's time goes
# to the phases after it), 4 x 4096 tokens a step, packed ingest from a
# 1024-sequence corpus; the launcher's warmup rule (max(steps // 10, 2))
# at lr 1e-4: from random weights at this width the launcher's 1e-3, and
# 3e-4, end 8 steps above the first loss (11.82 -> 12.73 and 13.83 on an
# H100), 1e-4 below it (9.47)
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = "yi_9b", 8, 4, 4096
TRAIN_SEQS, TRAIN_STEPS, TRAIN_LR = 1024, 5, 1e-4
TRAIN_WHY = ("bf16 params and grads with float32 AdamW moments of all of "
             "them need ~106 GB before activations, more than one card's "
             "80 GB; 8 keep the script's time for the phases after it")
# the restart: 1 layer (its 8.7 GB checkpoint at 2 layers took ~75 s of
# saves and a restore), 3 steps with one checkpoint, at step 2
RESTART_LAYERS, RESTART_STEPS, RESTART_EVERY = 1, 3, 2
# the flash backward at one full-width layer's shapes: B, S, H, K, hd
FLASH_SHAPE, FLASH_TOL = (1, 4096, 32, 4, 128), 1e-4
BF16_PEAK_FLOPS = 989e12       # H100 SXM data sheet, dense
# mixture of experts and MLA: deepseek_v2_lite_16b (src/repro/configs/
# deepseek_v2_lite_16b.py:17-46) served whole, as yi_9b is (the same
# requests and cache slots: 27 x 8 x 4096 x (512 + 64) bf16 latents),
# and its float32 invariant and training at full width with its dense
# layer and 5 of its 26 MoE layers (3,424,675,840 parameters: bf16
# params and grads and float32 moments ~41 GB; all 27 layers ~188 GB)
MOE_ARCH, MOE_TRAIN_LAYERS = "deepseek_v2_lite_16b", 6
# its float32 invariant at the train phase's depth, cut for phase 25
MOE_F32_LAYERS = 3
MOE_F32_WHY = ("all 27 layers in float32 (62.8 GB of weights) took 89.9 s "
               "of the script's time on an H100, the longest phase; 3 "
               "layers (the dense one and 2 MoE; 6 held 2.2e-5 in 19.4 s) "
               "make room for the model axes' phases in the script's 20 "
               "minutes")
MOE_KV_BYTES = 27 * SERVE_BATCH * SERVE_MAX_SEQ * (512 + 64) * 2
MOE_TRAIN_WHY = ("bf16 params and grads with float32 AdamW moments of all "
                 "15.7 B parameters need ~188 GB, more than one card's 80 GB")
# the recurrent families: rwkv6_3b (src/repro/configs/rwkv6_3b.py:13-32)
# and zamba2_2p7b (src/repro/configs/zamba2_2p7b.py:16-39), each served
# whole in bf16 through yi_9b's requests (the longest prompt, 1024, is a
# multiple of both chunks, 16 and 256) and trained at full width.  Their
# bf16 invariant is 240 + 16 against 256: zamba's chunk of 256 admits no
# 480-token prefill.  The float32 invariant is gated at 3 of rwkv6_3b's
# 32 layers and at one group (6 Mamba2 layers and the shared block) for
# zamba2_2p7b (SSM_F32_LAYERS, SSM_F32_WHY).  Both train at cut depth,
# each step's chunk loops issued op by op from the host: rwkv6_3b at 1
# of 32 layers, zamba2_2p7b at 1 of its 9 groups.
SSM_ARCHS = ("rwkv6_3b", "zamba2_2p7b")
SSM_TRAIN_LAYERS = {"rwkv6_3b": 1, "zamba2_2p7b": 6}
SSM_TRAIN_WHY = {
    "rwkv6_3b": "each layer runs 256 chunk steps of 16 tokens a step, "
                "issued one after the other from the host, ~2.2 s a layer "
                "on an H100; 1 keeps the phase under a minute",
    "zamba2_2p7b": "a step of all 54 took 10.4 s on an H100 (864 chunk "
                   "steps and 9 flash passes issued from the host), of 18 "
                   "4.4 s; 6, one group and its shared block, keep the "
                   "script well inside its 20 minutes"}
# multi-device on one card (phase 23): 2 gloo ranks on cuda:0; (a) yi_9b
# at full width with 2 layers on (pod 2, data 1, model 1), 4 steps of the
# train phase's batch, each rank its half; step 2's synced gradient
# recomputed on the host for every leaf of at most 20M elements a layer;
# (b) one deepseek_v2_lite_16b MoE layer under fsdp on (data 2), 4 x 2048
# tokens (4096 a rank), and its megatron body on (data 1, model 2) in
# float32 over the first 2048 (gloo takes CUDA all_gather and
# reduce_scatter on the H100's machine: scripts/gloo_cuda_probe.py)
MD_RANKS, MD_LAYERS, MD_STEPS, MD_CHECK_STEP = 2, 2, 4, 2
MD_HOST_NUMEL = 20_000_000
MD_MOE_TOKENS = (4, 2048)
MD_MEGATRON_TOL = 1e-5         # of the largest output: two F halves summed
MD_DEADLINE_S = 600
# FSDP on one card (phase 24): 2 gloo ranks on cuda:0, mesh (data 2,
# model 1), strategy fsdp, each rank's block of every parameter and
# moment, gathered at use; each rank's block of the batch from packed
# ingest.  (a) yi_9b at full width with 1 layer in float32, 2 x 1024
# tokens, 2 steps, each rank's blocks and losses against an unsharded run
# of the same seed and global batch on that rank; (b) yi_9b at full width with 1 layer in bf16, 2 x 4096 tokens a
# rank, 3 steps through the sharded Trainer with a checkpoint at step 2,
# timed, that checkpoint restored whole on the card by the unsharded
# Trainer, and fresh Trainers restored from it and run to step 3 (every
# rank's blocks bit-equal); (c) deepseek_v2_lite_16b's dense layer and one MoE
# layer at full width in float32, capacity n_routed / top_k, one step's
# gradients against the single-card math on each rank's tokens
FS_RANKS, FS_F32_LAYERS, FS_F32_STEPS, FS_F32_SEQ = 2, 1, 2, 1024
FS_CORPUS_SEQS = 64                  # the loader's first 3 batches need 12
FS_BF16_LAYERS, FS_BF16_STEPS, FS_CKPT_STEP = 1, 3, 2   # 2 layers took
# ~20 s more; at 1 layer and lr 1e-4 the loss gate failed (11.93, 13.27,
# 12.46 on an NVIDIA H100 80GB HBM3 at 700 W; one card's first steps at
# 1e-4 rise as much under XENT_MM "cast": scripts/xent_lr_check.py), so
# the one-layer bf16 runs of phases 24 and 25 take CUT_LR
CUT_LR = 1e-5
FS_MOE_LAYERS, FS_MOE_SEQ = 2, 1024
FS_TRAIN_TOL = {"rtol": 1e-5, "atol": 1e-4}    # tests/test_torch_fsdp.py
FS_MOE_TOL = {"rtol": 1e-5, "atol": 1e-6}      # tests/test_torch_distributed.py
FS_DEADLINE_S = 600
# the dry run (phase 27): the port's launch.dryrun, one subprocess a
# cell on fake "cuda" tensors, started before the build and run beside
# the other phases at nice 19 (each is a CPU process with a fake process
# group of 256 or 512 ranks; it puts nothing on the card).  Started after
# the main path instead, it slowed the gloo phases by up to a third
DRYRUN_CELLS = (("yi_9b", "train_4k", "single", "baseline"),
                ("yi_9b", "train_4k", "single", "fused"),
                ("deepseek_v2_lite_16b", "decode_32k", "single", "baseline"),
                ("rwkv6_3b", "train_4k", "multi", "baseline"))
DRYRUN_DEADLINE_S = 300        # past the end of the other phases
# the model axis on one card (phase 25): 2 gloo ranks on cuda:0, mesh
# (data 1, model 2), every rank the same sequences; (a) yi_9b at full
# width with 1 layer in float32 under megatron_sp, 2 steps of 2 x 1024
# tokens against the unsharded step, then tp_sp serving of 4 prompts of
# 1024 tokens and 8 greedy decode steps against the single-card model;
# (b) 1 layer in bf16, 2 x 4096 tokens, 3 timed steps, and tp_sp
# serving in bf16 timed; (c) deepseek_v2_lite_16b's dense and one MoE
# layer in float32 under megatron_sp, one step's gradients against the
# single-card gradients on the same 1024 tokens
TP_RANKS, TP_F32_LAYERS, TP_F32_STEPS, TP_F32_BATCH = 2, 1, 2, 2
TP_F32_SEQ, TP_SERVE_BATCH, TP_SERVE_SEQ, TP_DECODE = 1024, 4, 1024, 8
TP_BF16_LAYERS, TP_BF16_STEPS, TP_BF16_BATCH = 1, 3, 2   # lr CUT_LR
TP_MOE_LAYERS, TP_MOE_SEQ = 2, 1024
TP_LOGIT_TOL = 1e-4        # of the single-card model's largest logit
TP_GRAD_TOL = 1e-4         # of each gradient leaf's largest entry
TP_DEADLINE_S = 600
# the recurrent families' model axis on one card (phase 26): 2 gloo ranks
# on cuda:0, mesh (data 1, model 2), every rank the same sequences, from
# a packed corpus in zamba2_2p7b's vocabulary (the smallest of the three
# archs'); (a) rwkv6_3b at full width with 1 layer and zamba2_2p7b with
# one group (6 Mamba2 layers and the shared block) in float32, 2 tp_dp
# steps of 2 x 1024 tokens against the unsharded step, then tp_sp
# serving of 4 prompts of 1024 tokens and 8 greedy decode steps against
# the single-card model; (b) both in bf16 at RT_BF16_SERVE_LAYERS (whole
# they took 12.2 and 8.9 s on an H100), tp_sp prefill and
# decode timed, and tp_dp train steps of 2 x 4096 tokens at (a)'s depths
# timed; (c) yi_9b at full width with 2 layers in float32, its int8 KV
# cache served under tp_sp against the single-card int8 decode
# (phase 25's steps, batches, prompts and decode steps: TP_*)
RT_RANKS, RT_BF16_STEPS, RT_BF16_BATCH, RT_BF16_DECODE = 2, 1, 2, 4
RT_LAYERS = {"rwkv6_3b": 1, "zamba2_2p7b": 6}
RT_BF16_SERVE_LAYERS = {"rwkv6_3b": 8, "zamba2_2p7b": 18}
RT_Q8_LAYERS = 2
RT_VOCAB_ARCH = "zamba2_2p7b"
RT_DEADLINE_S = 600
# (a) holds each arch's first-step gradients (the first moment after one
# step) within RT_GRAD_TOL of each leaf's largest entry and its served
# logits within RT_LOGIT_TOL of the largest.  Adam's first update moves
# each entry by about lr times its gradient's sign, so an entry near zero
# that the two runs round to opposite signs parts their states by 2 lr:
# zamba2_2p7b's state after the steps is shown, not gated (at this init
# its one group turns last-bit changes into differences of 1e-3 of a
# leaf's largest gradient entry); rwkv6_3b's is gated at phase 25's
# tolerances.  The limits are 4 times the worst of the one-device
# evaluations of scripts/tp_spread.py --device cuda --d-model 0 on an
# H100 (zamba2_2p7b's one group on (a)'s first batch and prompts: each
# split layer's output changed in its last bits, four draws, and the
# prompts served one at a time), rounded up to one digit: gradients
# 4.20e-3 of a leaf's largest entry, logits 1.12e-4 of the largest
# (PERF.md §6)
RT_GRAD_TOL = 2e-2
RT_LOGIT_TOL = {"rwkv6_3b": TP_LOGIT_TOL, "zamba2_2p7b": 5e-4}
RT_STATE_GATED = ("rwkv6_3b",)
SSM_INVARIANT_BF16 = (240, 16)
SSM_F32_LAYERS = {"rwkv6_3b": 3, "zamba2_2p7b": 6}
SSM_F32_WHY = {
    "rwkv6_3b": "whole it took 50.5 s of the script on an H100 and held "
                "1.29e-4 of the 2e-2 gate (its conditioning is flat; 6 "
                "layers 1.80e-5 in 7.4 s): 3 make room for the sharded "
                "Trainer and the dry run",
    "zamba2_2p7b": "at this init a relative perturbation of 1e-7 grows to "
                   "~3e-3 over one group's six Mamba2 layers, so the whole "
                   "model's prefill and decode differ by ~0.1 in the "
                   "reference and the port alike (0.0343 at 256 + 256 "
                   "against 512 on an H100; scripts/ssm_conditioning.py)"}


# starcoder2_7b (src/repro/configs/starcoder2_7b.py:15-29, phase 29): 36
# heads, the case the reference's HEAD_TP = "head_dim" exists for (36 %
# 16 != 0).  (a) served whole in bf16 through the serve phase's requests,
# its float32 invariant gated at SC_F32_LAYERS; (b) trained at full width
# at SC_TRAIN_LAYERS of 32, the train phase's batch, steps and lr, and the
# flash backward at one layer's shapes; (c) under HEAD_TP = "head_dim"
# on 2 gloo ranks (data 1, model 2), 64 of hd 128 a rank: phase 25's
# float32 parity at 1 layer (its steps, batches, prompts, decode steps
# and tolerances), and SC_HD_BF16_LAYERS layers in bf16 for one timed
# step of 2 x SC_HD_SEQ tokens and a timed tp_sp prefill and decode.
# Each block pair's scores are all-reduced (B x H x 512 x 512 x 4 bytes:
# 75.5 MB at B 2), which gloo stages through the host, so (c)'s sequences
# stay at 1024 tokens
SC_ARCH, SC_F32_LAYERS, SC_TRAIN_LAYERS = "starcoder2_7b", 2, 4
SC_TRAIN_WHY = ("bf16 params and grads with float32 AdamW moments of all "
                "32 layers need ~89 GB before activations, more than one "
                "card's 80 GB; 4 keep the script inside its time")
SC_F32_WHY = ("the invariant's conditioning is flat in depth (yi_9b's held "
              "2.2e-5 at 24 layers and 2.6e-5 at 12); 2 keep the script "
              "inside its time")
SC_FLASH_SHAPE = (1, 4096, 36, 4, 128)
# its train lr: at the train phase's 1e-4 the loss rose from 11.36 to
# 15.39 over the 5 steps on an NVIDIA H100 80GB HBM3 at 700 W, under
# XENT_MM "mixed" and "cast" alike (scripts/xent_lr_check.py), at 5e-5
# to 11.34, at 3e-5 and 1e-5 it fell (to 9.61 and 8.22)
SC_TRAIN_LR = 1e-5
SC_HD_SEQ, SC_HD_BF16_LAYERS, SC_HD_BF16_STEPS = 1024, 2, 1
# the mixed product (bf16 operands, a float32 result) on the card: each
# of the port's products at a small shape against the CPU's plain
# version (the upcast product: the same sums in another order), and the
# head product at starcoder2_7b's widths timed beside the upcast one
MIXED_TOL = 1e-5             # of the largest entry
MIXED_HEAD = (4 * 1024, 4608, 49152)

# the inference attention kernel (kernels.flash_fwd) against the block
# loop it stands in for, (B, Sq, Sk, H, K, causal, q_offset): the
# serving cell's prefill (starcoder2_7b at 32 x 2,048), G = 1, a later
# chunk of a prompt (Sq < Sk, q_offset > 0, on and off the tiles), and
# no mask; within two bf16 steps and 2^-8 (tests/test_torch_flash_fwd.py
# says why); timed at the cell's shape beside its bound, the loop and
# PyTorch's scaled_dot_product_attention (a yardstick the port never
# calls)
FF_CHECKS = {"cell": (32, 2048, 2048, 36, 4, True, 0),
             "g1": (2, 1024, 1024, 8, 8, True, 0),
             "offset": (2, 512, 1536, 8, 2, True, 1024),
             "offset_ragged": (1, 200, 700, 4, 2, True, 333),
             "not_causal": (2, 512, 1024, 8, 2, False, 0)}
FF_TOL = {"rtol": 2.0 ** -6, "atol": 2.0 ** -8}


def _load_port():
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        raise SystemExit("chip_smoke: src/repro_torch not found beside this "
                         "script; run it from a checkout of the repository")
    sys.path.insert(0, str(root / "src"))
    import repro_torch.core as core
    from repro_torch import configs, pytree
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import format as fmt
    from repro_torch.core import pushdown_torch
    from repro_torch.data import corpus, fused_ingest, pipeline
    from repro_torch.distributed import elastic
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import bitunpack as bu
    from repro_torch.kernels import block_agg as ba
    from repro_torch.kernels import filter_agg as fa
    from repro_torch.kernels import flash_fwd as ff
    from repro_torch.launch import op_analysis
    from repro_torch.models import archs, attention, layers, moe, transformer
    from repro_torch.serve import engine, kvcache
    from repro_torch.train import optimizer, trainer
    return argparse.Namespace(
        core=core, fmt=fmt, bu=bu, fa=fa, ba=ba, ff=ff, ops=ops, ref=ref,
        build=_build, pushdown=pushdown_torch, corpus=corpus,
        pipeline=pipeline, ingest=fused_ingest, elastic=elastic,
        ckpt=ckpt, kvcache=kvcache, pytree=pytree, configs=configs,
        archs=archs, engine=engine, attention=attention, layers=layers,
        moe=moe, op_analysis=op_analysis,
        transformer=transformer, optimizer=optimizer, trainer=trainer)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(n: int, bits: int) -> float:
    """Least time for one decode: n*bits/8 bytes read + 4n written."""
    return (n * bits / 8 + 4 * n) / HBM_BYTES_PER_S * 1e3


def cuda_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def traced(fn) -> tuple[float, float, int, list]:
    """(device busy ms, host wall s, device events, top kernels) of one
    call of ``fn``: the summed durations of the kernels and copies
    ``torch.profiler`` saw on the card, the host clock around the call
    and a synchronise, how many device events the profiler kept, and
    the six names with the most device time as (name, ms, events).
    Only the card's activity is traced, and its events are read from
    the profiler's raw results: building the host-side event tree of a
    train step (~200,000 operations) takes minutes and adds nothing to
    these numbers."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    cuda = torch.autograd.DeviceType.CUDA
    busy_us, n = 0.0, 0
    by_name: dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        us = e.duration_ns() / 1e3
        busy_us += us
        n += 1
        by_name[e.name()][0] += us / 1e3
        by_name[e.name()][1] += 1
    top = sorted(((k[:80], ms, c) for k, (ms, c) in by_name.items()),
                 key=lambda x: -x[1])[:6]
    return busy_us / 1e3, wall, n, top


def device_ms(fn, iters: int) -> tuple[float, float]:
    """(device ms, device events) per call of ``fn`` from a profiled run
    of ``iters`` calls.  The profiler may keep fewer events than the
    calls launched (seen on the H100 for back-to-back calls late in a
    long process), so the events per call are reported beside it."""
    for _ in range(3):
        fn()

    def loop():
        for _ in range(iters):
            fn()

    busy, _, events, _ = traced(loop)
    if busy <= 0:
        raise AssertionError("torch.profiler saw no device time")
    return busy / iters, events / iters


def isolated_ms(fn, iters: int) -> float:
    """Median device time of one call of ``fn``: CUDA events recorded
    right before and after it, behind a GPU-side wait long enough for the
    host to enqueue the whole call, so no host launch cost is in it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)        # ~1 ms at 1.98 GHz
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def time_pair(kernel, plain, iters: int) -> dict:
    """A kernel and its plain version: device ms per call (CUDA events
    around one call, no launch cost; the number the records keep), the
    profiler's device ms and events per call beside it, and the ms per
    call with the host's launch cost (CUDA events around back-to-back
    calls)."""
    p_iters = max(2, iters // 10)
    prof_ms, prof_events = device_ms(kernel, iters)
    plain_prof_ms, plain_prof_events = device_ms(plain, p_iters)
    return {"ms": isolated_ms(kernel, iters),
            "plain_ms": isolated_ms(plain, p_iters),
            "profiler_ms": prof_ms, "profiler_events": prof_events,
            "plain_profiler_ms": plain_prof_ms,
            "plain_profiler_events": plain_prof_events,
            "call_ms": cuda_ms(kernel, iters),
            "plain_call_ms": cuda_ms(plain, p_iters)}


def timing_line(r: dict) -> str:
    return (f"device {r['ms']:.5f} ms, bound {r['bound_ms']:.5f} ms at "
            f"3.35 TB/s ({r['bound_ms'] / r['ms']:.1%} of it), plain "
            f"device {r['plain_ms']:.5f} ms; profiler: kernel "
            f"{r['profiler_ms']:.5f} ms ({r['profiler_events']:.2f} device "
            f"events per call), plain {r['plain_profiler_ms']:.5f} ms "
            f"({r['plain_profiler_events']:.2f}); per call with launch: "
            f"kernel {r['call_ms']:.5f} ms, plain {r['plain_call_ms']:.5f} "
            f"ms")


def _values(rng, bits: int, n: int) -> np.ndarray:
    return rng.integers(0, 1 << bits, n, dtype=np.uint64).astype(np.uint32)


def _words_tensor(words: np.ndarray, bits: int) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)
                            ).reshape(-1, bits)


# --------------------------------------------------------------------------
# kernel phase
# --------------------------------------------------------------------------


def kernel_sweep(dev, fmt, bu, ref) -> int:
    """Bit-exact sweep; returns the largest |kernel - plain| seen (0).
    Up to ``CODEC_N`` values the words are the numpy codec's encoding of
    known values, held against its decode and the values too; above it
    they are random words on the card, against the plain version (the
    numpy codec's 16.7 M-value encode and decode at every width took
    ~50-70 s of the script)."""
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(6)
    worst = 0
    for bits in SWEEP_BITS:
        for n in SWEEP_N:
            if n <= CODEC_N:
                v = _values(rng, bits, n)
                words = fmt.bitpack_encode(v, bits)
                w = _words_tensor(words, bits).to(dev)
            else:
                w = torch.randint(-(1 << 31), 1 << 31, (-(-n // 32), bits),
                                  dtype=torch.int32, device=dev,
                                  generator=gen)
            got = bu.bitunpack_groups(w, bits, n)
            plain = bu.bitunpack_plain(w, bits, n)
            torch.cuda.synchronize()
            diff = (got.to(torch.int64) - plain.to(torch.int64)).abs()
            worst = max(worst, int(diff.max()) if n else 0)
            if not torch.equal(got, plain):
                raise AssertionError(f"bitunpack differs: bits={bits} n={n}")
            if n > CODEC_N:
                continue
            got_np = got.cpu().numpy().view(np.uint32)
            if not (np.array_equal(got_np, fmt.bitpack_decode(
                    words, bits, n)) and np.array_equal(got_np, v)):
                raise AssertionError(f"bitunpack differs from the codec: "
                                     f"bits={bits} n={n}")
        # the host adapter the scan path calls, and the (R, 4, bits) form
        words = fmt.bitpack_encode(_values(rng, bits, 4096 + 5), bits)
        if not np.array_equal(bu.bitunpack_words(words, bits, 4096 + 5),
                              fmt.bitpack_decode(words, bits, 4096 + 5)):
            raise AssertionError(f"bitunpack_words differs: bits={bits}")
        tiles = _words_tensor(fmt.bitpack_encode(
            _values(rng, bits, 128 * 37), bits), bits).reshape(37, 4, bits)
        tiles = tiles.to(dev)
        got = bu.bitunpack(tiles, bits=bits)
        torch.cuda.synchronize()
        if not torch.equal(got, ref.bitunpack_ref(tiles, bits)):
            raise AssertionError(f"bitunpack tiles differ: bits={bits}")
    return worst


def offset_sweep(dev, fmt, bu) -> int:
    """Words that start 1-3 words past a 16-byte line (views into a
    larger tensor on the card), every width: kernel against its plain
    version, and against the numpy codec up to 4096 values.  Returns
    the largest |kernel - plain| seen (0)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    worst = 0
    for bits in SWEEP_BITS:
        for n in OFFSET_N:
            size = -(-n // 32) * bits
            buf = torch.randint(-(1 << 31), 1 << 31, (size + 6,),
                                dtype=torch.int32, device=dev, generator=gen)
            for off in OFFSETS:
                w = buf[off:off + size].view(-1, bits)
                if w.data_ptr() % 16 != 4 * off:
                    raise AssertionError(f"view at word {off} is not "
                                         f"{4 * off} bytes past a line")
                got = bu.bitunpack_groups(w, bits, n)
                plain = bu.bitunpack_plain(w, bits, n)
                torch.cuda.synchronize()
                diff = (got.to(torch.int64) - plain.to(torch.int64)).abs()
                worst = max(worst, int(diff.max()))
                if not torch.equal(got, plain) or (n <= 4096 and not
                        np.array_equal(got.cpu().numpy().view(np.uint32),
                                       fmt.bitpack_decode(
                                           w.cpu().numpy().view(np.uint32),
                                           bits, n))):
                    raise AssertionError(f"bitunpack differs: bits={bits} "
                                         f"n={n} word offset {off}")
    return worst


def sass_counts(lib: str) -> dict[str, collections.Counter]:
    """Per kernel function of a built library, its SASS instructions by
    opcode (``cuobjdump -sass``), and under ``"shuffle span"`` the
    instructions from its first shuffle to its last; {} where the
    toolkit has no cuobjdump."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.access(exe, os.X_OK):
        return {}
    dump = subprocess.run([exe, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    out, ops = {}, None
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            ops = out[m.group(1)] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)", line)
        if m and ops is not None:
            ops.append(m.group(1))
    counts = {}
    for fn, seq in out.items():
        c = collections.Counter(seq)
        shfl = [i for i, op in enumerate(seq) if op == "SHFL"]
        if shfl:
            c["shuffle span"] = shfl[-1] - shfl[0] + 1
        counts[fn] = c
    return counts


def build_report(P, bu, dev) -> None:
    """nvcc's register, shared-memory and spill lines, bitunpack's
    dynamic shared memory where it runs, and SASS counts."""
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name in KERNELS:
        info = P.build.build_info[name]
        print(f"  {name}: {info['seconds']:.2f}s nvcc")
        for line in sorted(set(info["ptxas"].splitlines())):
            if "ptxas info" in line and ("registers" in line
                                         or "spill" in line):
                print(f"    {line.strip()}")
        same = collections.Counter()     # template instances alike
        for c in sass_counts(info["path"]).values():
            span = c.pop("shuffle span", None)
            top = ", ".join(f"{op} {k}" for op, k in c.most_common(6))
            same[f"{c.total()} instructions ({top})"
                 + (f", {span} from the first SHFL to the last"
                    if span else "")] += 1
        for text, k in same.items():
            print(f"    SASS per kernel function: {text}"
                  + (f" [{k} instances]" if k > 1 else ""))
    for n, bits in ((696_320, 7), (1 << 20, 17), (1 << 28, 1),
                    (1 << 28, 17), (1 << 28, 32)):
        plan = bu.launch_plan(-(-n // 32), bits, n_sms)
        print(f"    bitunpack n={n} bitpack{bits}: tile {plan.tile} groups, "
              f"{plan.n_tiles} tiles, grid {plan.grid}, dynamic shared "
              f"memory {plan.smem_bytes} B per CTA")


def kernel_timing(bu, n: int, bits: int, words: torch.Tensor,
                  iters: int) -> dict:
    """bitunpack and its plain version, timed by :func:`time_pair`."""
    r = time_pair(lambda: bu.bitunpack_groups(words, bits, n),
                  lambda: bu.bitunpack_plain(words, bits, n), iters)
    nbytes = n * bits / 8 + 4 * n
    return {"n": n, "bits": bits, **r, "bound_ms": bound_ms(n, bits),
            "GB_per_s": nbytes / r["ms"] / 1e6}


def object_breakdown(dev, fmt, bu, n: int, bits: int) -> dict:
    """One main-path column decode split into H2D, kernel and D2H."""
    rng = np.random.default_rng(1)
    words = fmt.bitpack_encode(_values(rng, bits, n), bits)
    host = _words_tensor(words, bits).pin_memory()
    back = torch.empty(n, dtype=torch.int32).pin_memory()
    times = {"h2d_ms": [], "kernel_ms": [], "d2h_ms": []}
    for _ in range(23):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        w = host.to(dev, non_blocking=True)
        ev[1].record()
        out = bu.bitunpack_groups(w, bits, n)
        ev[2].record()
        back.copy_(out, non_blocking=True)
        ev[3].record()
        ev[3].synchronize()
        for k, (a, b) in zip(times, zip(ev, ev[1:])):
            times[k].append(a.elapsed_time(b))
    if not np.array_equal(back.numpy().view(np.uint32),
                          fmt.bitpack_decode(words, bits, n)):
        raise AssertionError("object decode differs")
    return {k: float(np.median(v[3:])) for k, v in times.items()}


def _agg_values(rng, n: int, dtype) -> np.ndarray:
    """Unit normals (tile sums stay where atol 1e-3 holds), or integers
    whose tile sums are exact in float32."""
    if dtype == np.int32:
        return rng.integers(-1000, 1000, n).astype(np.int32)
    return rng.normal(size=n).astype(np.float32)


def _held(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Kernel partials against the plain version's: sums and counts at
    rtol 3e-5 / atol 1e-3, min and max exact (NaN where NaN).  Returns
    the largest |difference| (NaN positions left out)."""
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if got.numel() == 0:
        return 0.0
    try:
        torch.testing.assert_close(got[:, :2], want[:, :2], rtol=3e-5,
                                   atol=1e-3, equal_nan=True)
        torch.testing.assert_close(got[:, 2:], want[:, 2:], rtol=0, atol=0,
                                   equal_nan=True)
    except AssertionError as e:
        raise AssertionError(f"{what}: kernel differs from plain: {e}")
    d = (got - want).abs()
    d = d[~torch.isnan(d)]
    return float(d.max()) if d.numel() else 0.0


def agg_sweep(dev, P) -> tuple[float, float]:
    """filter_agg and block_agg against their plain versions on the card;
    returns each kernel's largest |kernel - plain| over the sweep."""
    rng = np.random.default_rng(3)
    fa_err = ba_err = 0.0
    for n in AGG_SWEEP_N:
        for vt, ft in ((np.float32, np.float32), (np.int32, np.int32),
                       (np.float32, np.int32)):
            v = torch.from_numpy(_agg_values(rng, n, vt)).to(dev)
            f = torch.from_numpy(rng.integers(0, 50, n).astype(ft)).to(dev)
            for cmp in CMPS:
                for thr in (25, 1e9):           # 1e9: the empty selection
                    what = f"filter_agg n={n} {vt.__name__}/{ft.__name__} " \
                           f"{cmp} {thr}"
                    fa_err = max(fa_err, _held(
                        P.fa.filter_agg(v, f, cmp, thr),
                        P.fa.filter_agg_plain(v, f, cmp, thr), what))
            for mt in (torch.bool, torch.uint8, torch.int32):
                m = (f < 20).to(mt)
                ba_err = max(ba_err, _held(
                    P.ba.block_agg(v, m), P.ba.block_agg_plain(v, m),
                    f"block_agg n={n} {vt.__name__}/{mt}"))
        if n > 1:
            # a selected NaN, a NaN in the filter, a misaligned start
            v = torch.from_numpy(_agg_values(rng, n, np.float32)).to(dev)
            f = torch.from_numpy(rng.integers(0, 50, n).astype(np.float32)
                                 ).to(dev)
            v[n // 2], f[n // 2] = float("nan"), 1.0
            f[0] = float("nan")
            for cmp in CMPS:
                fa_err = max(fa_err, _held(
                    P.fa.filter_agg(v, f, cmp, 25),
                    P.fa.filter_agg_plain(v, f, cmp, 25),
                    f"filter_agg NaN n={n} {cmp}"))
                fa_err = max(fa_err, _held(
                    P.fa.filter_agg(v[1:], f[1:], cmp, 25),
                    P.fa.filter_agg_plain(v[1:], f[1:], cmp, 25),
                    f"filter_agg misaligned n={n - 1} {cmp}"))
            ba_err = max(ba_err, _held(
                P.ba.block_agg(v, f < 20), P.ba.block_agg_plain(v, f < 20),
                f"block_agg NaN n={n}"))
            ba_err = max(ba_err, _held(
                P.ba.block_agg(v[1:], f[1:] < 20),
                P.ba.block_agg_plain(v[1:], f[1:] < 20),
                f"block_agg misaligned n={n - 1}"))
    # the combined results against the whole-column oracles
    n = AGG_SWEEP_N[-1]
    v = torch.from_numpy(_agg_values(rng, n, np.float32)).to(dev)
    f = torch.from_numpy(rng.integers(0, 50, n).astype(np.int32)).to(dev)
    for got, want, what in (
            (P.ops.filter_aggregate(v, f, "<", 25),
             P.ref.filter_agg_ref(v, f, "<", 25), "filter_aggregate"),
            (P.ops.masked_aggregate(v, f > 30),
             P.ref.block_agg_ref(v, f > 30), "masked_aggregate")):
        _held(torch.stack([got[k] for k in ("sum", "count", "min", "max")])
              [None], torch.stack([want[k] for k in ("sum", "count", "min",
                                                     "max")])[None], what)
    return fa_err, ba_err


def agg_bound_ms(n: int, *dtypes: torch.dtype, tile: int = 8192) -> float:
    """Least time: each input column read once, one (4,) float32 row per
    tile written, at 3.35 TB/s."""
    nbytes = sum(n * torch.empty(0, dtype=d).element_size() for d in dtypes)
    return (nbytes + 16 * -(-n // tile)) / HBM_BYTES_PER_S * 1e3


def agg_timing(kernel, plain, n: int, dtypes, iters: int) -> dict:
    return {"n": n, **time_pair(kernel, plain, iters),
            "bound_ms": agg_bound_ms(n, *dtypes)}


# --------------------------------------------------------------------------
# main-path phase
# --------------------------------------------------------------------------


def make_events(dev, n: int, seed: int) -> dict[str, torch.Tensor]:
    """The event table of the pushdown benchmark, generated on the card."""
    torch.manual_seed(seed)
    run = torch.randint(0, 100, (n,), device=dev, dtype=torch.int32)
    hits = torch.poisson(torch.full((n,), 12.0, device=dev)).to(torch.int32)
    gamma = torch.distributions.Gamma(torch.tensor(2.0, device=dev),
                                      torch.tensor(1 / 20.0, device=dev))
    e_pt = gamma.sample((n,)).to(torch.float32)
    return {"e_pt": e_pt, "run": run, "hits": hits}


def _bitpack_cols(store, omap, fmt) -> dict[str, set[str]]:
    """Per object, its bitpack-coded columns (read off the primary's
    disk, outside the fabric)."""
    out = {}
    for name in omap.object_names():
        osd = store.osds[store.cluster.primary(name)]
        with osd.lock:
            blob = osd.data[name]
        out[name] = {c["name"] for c in fmt.block_header(blob)["columns"]
                     if c["codec"].startswith("bitpack")}
    return out


def main_path(P, store, table: dict[str, np.ndarray]) -> dict:
    return _drive(P.core, P.fmt, P.bu, store, table, len(table["e_pt"]))


def _drive(core, fmt, bu, store, table, n) -> dict:
    vol = core.GlobalVOL(store)
    omap = vol.create(_events_ds(core, "events", n), core.PartitionPolicy())
    per_obj = len(omap.extents[0])
    r0 = n // 3 + 12_345
    r1 = min(n, r0 + 3 * per_obj // 2)

    def q_agg():
        return (vol.scan("events").filter("run", "<", 50)
                .agg("sum", "e_pt").agg("count", "e_pt").execute())

    def q_project():
        return (vol.scan("events").filter("hits", ">", 20)
                .project("hits", "run").execute())

    def q_rows():
        return vol.read(omap, core.RowRange(r0, r1))

    walls = {}
    fmt.set_bitunpack_backend("device")
    bu.launches = 0                      # the main path's run starts here
    t = time.perf_counter()
    vol.write(omap, table)
    walls["write_s"] = time.perf_counter() - t
    t = time.perf_counter()
    agg, agg_stats = q_agg()
    walls["filter_agg_s"] = time.perf_counter() - t
    t = time.perf_counter()
    proj, proj_stats = q_project()
    walls["filter_project_s"] = time.perf_counter() - t
    t = time.perf_counter()
    rows = q_rows()
    walls["row_read_s"] = time.perf_counter() - t
    victim = store.cluster.primary(omap.object_names()[0])
    store.fail_osd(victim)
    t = time.perf_counter()
    rec = store.recover()
    walls["recover_s"] = time.perf_counter() - t
    t = time.perf_counter()
    agg2, agg2_stats = q_agg()
    walls["filter_agg_after_recover_s"] = time.perf_counter() - t
    launches = bu.launches               # ... and ends here

    # every bitpack column decode the scans asked for, counted from the
    # objects' own headers and the scans' prune counts: the aggregates
    # decode run, the projection hits and run, the read every column
    bp = _bitpack_cols(store, omap, fmt)
    if any(cols != {"run", "hits"} for cols in bp.values()):
        raise AssertionError(f"unexpected codecs: {bp}")
    n_obj = omap.n_objects
    touched = [e for e in omap.extents
               if e.row_start < r1 and e.row_stop > r0]
    expect = ((n_obj - agg_stats["objects_pruned"])
              + 2 * (n_obj - proj_stats["objects_pruned"])
              + 2 * len(touched)
              + (n_obj - agg2_stats["objects_pruned"]))
    if not launches > 0 or launches != expect:
        raise AssertionError(f"bitunpack launches {launches} != bitpack "
                             f"column decodes {expect}")
    if rec["objects_lost"]:
        raise AssertionError(f"recover lost {rec['objects_lost']} objects")

    # against numpy, straight from the generated table
    m = table["run"] < 50
    want_sum = float(table["e_pt"][m].astype(np.float64).sum())
    want_count = float(m.sum())
    for name, got in (("filter_agg", agg), ("after_recover", agg2)):
        if got["count(e_pt)"] != want_count:
            raise AssertionError(f"{name}: count {got['count(e_pt)']} "
                                 f"!= {want_count}")
        if abs(got["sum(e_pt)"] - want_sum) > 1e-9 * abs(want_sum):
            raise AssertionError(f"{name}: sum {got['sum(e_pt)']!r} "
                                 f"!= {want_sum!r} (rel 1e-9)")
    m = table["hits"] > 20
    for k in ("hits", "run"):
        if not np.array_equal(proj[k], table[k][m]):
            raise AssertionError(f"filter_project: column {k} differs")
    for k in ("e_pt", "run", "hits"):
        if not np.array_equal(rows[k], table[k][r0:r1]):
            raise AssertionError(f"row_read: column {k} differs")

    # against the same scans with the numpy decode: exactly equal
    fmt.set_bitunpack_backend("numpy")
    try:
        t = time.perf_counter()
        agg_np, _ = q_agg()
        walls["filter_agg_numpy_decode_s"] = time.perf_counter() - t
        proj_np, _ = q_project()
        rows_np = q_rows()
    finally:
        fmt.set_bitunpack_backend("device")
    if agg_np != agg2:
        raise AssertionError(f"numpy decode agg {agg_np} != {agg2}")
    for k in proj:
        if not np.array_equal(proj_np[k], proj[k]):
            raise AssertionError(f"numpy decode project: {k} differs")
    for k in rows:
        if not np.array_equal(rows_np[k], rows[k]):
            raise AssertionError(f"numpy decode rows: {k} differs")
    # one more filter -> agg under the profiler: how busy the card is
    busy_ms, traced_s, _, _ = traced(q_agg)
    f = store.fabric.snapshot()
    return {"rows": n, "objects": n_obj, "rows_per_object": per_obj,
            **walls, "launches": launches,
            "bitpack_decodes": expect, "sum_e_pt": agg["sum(e_pt)"],
            "count": agg["count(e_pt)"], "projected_rows": int(m.sum()),
            "read_rows": r1 - r0, "recovered": rec["objects_moved"],
            "victim": victim, "fabric_ops": f["ops"],
            "client_rx": f["client_rx"],
            "traced_filter_agg_s": traced_s,
            "traced_filter_agg_device_busy_ms": busy_ms,
            "traced_filter_agg_device_busy_share": busy_ms / 1e3 / traced_s}


# the examples (phase 28): examples/quickstart_torch.py and
# examples/serve_pushdown_torch.py as they stand, and
# examples/train_e2e_torch.py at its 100m preset (its full width: 12
# layers, d_model 768, 8 x 256 tokens a step, float32) for a cut number
# of steps with an OSD killed half way, each through its main(argv) on
# the card as a user runs it
EXAMPLES = ("quickstart_torch", "serve_pushdown_torch", "train_e2e_torch")
EXAMPLE_E2E_PRESET, EXAMPLE_E2E_STEPS, EXAMPLE_E2E_KILL = "100m", 20, 10


# --------------------------------------------------------------------------
# device pushdown phase
# --------------------------------------------------------------------------


def _zero_counts(P) -> None:
    P.bu.launches = P.fa.launches = P.ba.launches = P.ff.launches = 0


def _counts(P) -> dict[str, int]:
    return {"bitunpack": P.bu.launches, "filter_agg": P.fa.launches,
            "block_agg": P.ba.launches, "flash_fwd": P.ff.launches}


def _scalars(res: dict) -> dict[str, float]:
    return {k: float(res[k]) for k in ("sum", "count", "min", "max")}


def _check_agg(name: str, got: dict, want_sum: float, want_count: float,
               sel: np.ndarray) -> None:
    """Sum and count to rtol 3e-5 (float32 partials against a float64
    reference; the count is inexact above 2^24), min and max exactly."""
    for k, want in (("sum", want_sum), ("count", want_count)):
        if abs(got[k] - want) > 3e-5 * abs(want):
            raise AssertionError(f"{name}: {k} {got[k]!r} != {want!r} "
                                 f"(rtol 3e-5)")
    if got["min"] != float(sel.min()) or got["max"] != float(sel.max()):
        raise AssertionError(f"{name}: min/max {got['min']!r}/{got['max']!r}"
                             f" != {float(sel.min())!r}/{float(sel.max())!r}")


def pushdown_path(P, ev: dict[str, torch.Tensor],
                  table: dict[str, np.ndarray], scan: dict) -> dict:
    """The device data plane on the event table that lives on the card:
    pushdown_filter_aggregate and ops.filter_aggregate (filter_agg) and
    ops.masked_aggregate (block_agg)."""
    walls = {}
    _zero_counts(P)                      # the path's run starts here
    t = time.perf_counter()
    pd = _scalars(P.pushdown.pushdown_filter_aggregate(
        ev["e_pt"], ev["run"], "<", 50))
    walls["pushdown_filter_aggregate_s"] = time.perf_counter() - t
    t = time.perf_counter()
    fo = _scalars(P.ops.filter_aggregate(ev["e_pt"], ev["run"], "<", 50))
    walls["filter_aggregate_s"] = time.perf_counter() - t
    t = time.perf_counter()
    mo = _scalars(P.ops.masked_aggregate(ev["e_pt"], ev["hits"] > 20))
    walls["masked_aggregate_s"] = time.perf_counter() - t
    launches = _counts(P)                # ... and ends here
    if launches != {"bitunpack": 0, "filter_agg": 2, "block_agg": 1,
                    "flash_fwd": 0}:
        raise AssertionError(f"device pushdown launches {launches}")

    sel = table["e_pt"][table["run"] < 50]
    for name, got in (("pushdown_filter_aggregate", pd),
                      ("filter_aggregate", fo)):
        _check_agg(name, got, scan["sum_e_pt"], scan["count"], sel)
    sel = table["e_pt"][table["hits"] > 20]
    _check_agg("masked_aggregate", mo, float(sel.astype(np.float64).sum()),
               float(sel.size), sel)
    return {**walls, "launches": launches,
            "pushdown_filter_aggregate": pd, "masked_aggregate": mo}


# --------------------------------------------------------------------------
# packed-ingest phase
# --------------------------------------------------------------------------


def ingest_path(dev, P) -> dict:
    """Corpus -> store -> packed windowed loader -> device_stream ->
    fused_batch on the card, each batch held bit-equal to the plain
    loader's (whose OSDs decode on the card)."""
    core, Loader = P.core, P.pipeline.ObjectDataLoader
    spec = P.corpus.CorpusSpec(n_seqs=INGEST_SEQS, seq_len=INGEST_SEQ,
                               vocab_size=INGEST_VOCAB)
    store = core.make_store(8, replicas=3)
    try:
        vol = core.GlobalVOL(store)
        t = time.perf_counter()
        # one write: a vol.write whose row range covers part of an
        # object replaces that object with only those rows (both
        # packages), so the corpus is not written in chunks
        omap = P.corpus.build_corpus(vol, spec, chunk_rows=INGEST_SEQS)
        build_s = time.perf_counter() - t
        bits = P.fmt.bitpack_width(INGEST_VOCAB - 1)

        def rx_of(loader) -> tuple[list, int]:
            rx = store.fabric.snapshot()["client_rx"]
            batches = [loader.make_batch(s) for s in range(INGEST_STEPS)]
            return batches, store.fabric.snapshot()["client_rx"] - rx

        want, rx_plain = rx_of(Loader(vol, "corpus", global_batch=INGEST_BATCH,
                                      prefetch=0))
        packed_words, rx_packed = rx_of(Loader(
            vol, "corpus", global_batch=INGEST_BATCH, packed=True,
            prefetch=0))
        if packed_words[0]["tokens_packed"].shape != (
                INGEST_BATCH, INGEST_SEQ // 32, bits):
            raise AssertionError(f"packed batch shape "
                                 f"{packed_words[0]['tokens_packed'].shape}")

        loader = Loader(vol, "corpus", global_batch=INGEST_BATCH, packed=True,
                        prefetch=2, window_steps=2)
        got, step_ms = [], []
        _zero_counts(P)                  # the path's run starts here
        t0 = t = time.perf_counter()
        stream = P.ingest.device_stream(loader, lookahead=1, device=dev)
        for _ in range(INGEST_STEPS):
            got.append(P.ingest.fused_batch(next(stream)))
            torch.cuda.synchronize()
            now = time.perf_counter()
            step_ms.append((now - t) * 1e3)
            t = now
        wall_s = time.perf_counter() - t0
        launches = _counts(P)            # ... and ends here
        stream.close()
        loader.close()
        if launches != {"bitunpack": INGEST_STEPS, "filter_agg": 0,
                        "block_agg": 0, "flash_fwd": 0}:
            raise AssertionError(f"ingest launches {launches}")
        for s, (fb, w) in enumerate(zip(got, want)):
            for k in ("tokens", "labels"):
                if not torch.equal(fb[k], torch.from_numpy(w[k]).to(dev)):
                    raise AssertionError(f"ingest step {s}: {k} differs "
                                         f"from the plain loader's")
        # the card's share of a step: one batch's H2D copy from pinned
        # memory, and its unpack + labels (after the path's counts)
        host = torch.from_numpy(packed_words[0]["tokens_packed"]
                                .view(np.int32)).pin_memory()
        h2d_ms = isolated_ms(lambda: host.to(dev, non_blocking=True), 20)
        on_dev = host.to(dev)
        fused_ms = isolated_ms(lambda: P.ingest.fused_batch(on_dev), 20)
        return {"sequences": INGEST_SEQS, "seq_len": INGEST_SEQ,
                "vocab": INGEST_VOCAB, "bits": bits,
                "global_batch": INGEST_BATCH, "steps": INGEST_STEPS,
                "objects": omap.n_objects, "build_corpus_s": build_s,
                "wall_s": wall_s, "ms_per_step": wall_s * 1e3 / INGEST_STEPS,
                "step_ms": step_ms, "h2d_ms": h2d_ms,
                "fused_batch_ms": fused_ms,
                "device_share": (h2d_ms + fused_ms) * INGEST_STEPS
                / (wall_s * 1e3),
                "client_rx_plain": rx_plain,
                "client_rx_packed": rx_packed, "launches": launches}
    finally:
        store.close()


# --------------------------------------------------------------------------
# storage planes: Skyhook driver, scan session, faults, maintenance,
# checkpoint and KV pages
# --------------------------------------------------------------------------


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _events_ds(core, name: str, n: int):
    return core.LogicalDataset(
        name, (core.Column("e_pt", "float32"), core.Column("run", "int32"),
               core.Column("hits", "int32")), n, 4096)


def _check_sum_count(what: str, got: dict, table: dict) -> None:
    """``run < 50`` -> sum and count of ``e_pt``: the count exactly, the
    float64 sum to rel 1e-9 of numpy's on the generated table."""
    m = table["run"] < 50
    want_sum = float(table["e_pt"][m].astype(np.float64).sum())
    if got["count(e_pt)"] != float(m.sum()):
        raise AssertionError(f"{what}: count {got['count(e_pt)']} != "
                             f"{float(m.sum())}")
    if abs(got["sum(e_pt)"] - want_sum) > 1e-9 * abs(want_sum):
        raise AssertionError(f"{what}: sum {got['sum(e_pt)']!r} != "
                             f"{want_sum!r} (rel 1e-9)")


def _agg_scan(vol, ds: str):
    return (vol.scan(ds).filter("run", "<", 50).agg("sum", "e_pt")
            .agg("count", "e_pt"))


def skyhook_path(P, store, table: dict) -> dict:
    """``SkyhookDriver`` over the main path's table: the filter -> agg and
    the filter -> project as a ``Query`` and through ``driver.scan``,
    then the same filter -> agg client-side (no pushdown)."""
    core = P.core
    vol = core.GlobalVOL(store)
    direct_agg, _ = _agg_scan(vol, "events").execute()
    direct_proj, _ = (vol.scan("events").filter("hits", ">", 20)
                      .project("hits", "run").execute())
    drv = core.SkyhookDriver(vol, n_workers=4)
    q_agg = core.Query("events", filter=("run", "<", 50),
                       aggregate=(("sum", "e_pt"), ("count", "e_pt")))
    q_proj = core.Query("events", filter=("hits", ">", 20),
                        projection=("hits", "run"))
    runs, walls, stats = {}, {}, {}
    try:
        _zero_counts(P)                  # the path's run starts here
        for name, run in (
                ("query_agg", lambda: drv.execute(q_agg)),
                ("query_project", lambda: drv.execute(q_proj)),
                ("scan_agg", lambda: drv.execute(
                    _agg_scan(drv, "events"))),
                ("scan_project", lambda: drv.execute(
                    drv.scan("events").filter("hits", ">", 20)
                    .project("hits", "run"))),
                ("client_side_agg", lambda: drv.execute_client_side(q_agg))):
            t = time.perf_counter()
            runs[name], st = run()
            walls[f"{name}_s"] = time.perf_counter() - t
            stats[name] = {k: v for k, v in dataclasses.asdict(st).items()
                           if k != "prune"}
        launches = _counts(P)            # ... and ends here
    finally:
        drv.close()
    k_up = len(store.cluster.up_osds)
    pushed = 0
    for name in ("query_agg", "scan_agg", "query_project", "scan_project"):
        st = stats[name]
        if not st["pushdown"] or st["fabric_ops"] > k_up:
            raise AssertionError(f"skyhook {name}: pushdown "
                                 f"{st['pushdown']}, {st['fabric_ops']} "
                                 f"ops > {k_up} OSDs")
        per_obj = 2 if name.endswith("project") else 1
        pushed += per_obj * (st["objects_touched"] - st["objects_pruned"])
    if stats["client_side_agg"]["pushdown"]:
        raise AssertionError("client-side query reports a pushdown")
    if launches["bitunpack"] < pushed or launches["filter_agg"] \
            or launches["block_agg"]:
        raise AssertionError(f"skyhook launches {launches}, expected at "
                             f"least {pushed} bitunpack")
    for name in ("query_agg", "scan_agg", "client_side_agg"):
        _check_sum_count(f"skyhook {name}", runs[name], table)
        if runs[name]["count(e_pt)"] != direct_agg["count(e_pt)"]:
            raise AssertionError(f"skyhook {name}: count differs from "
                                 f"vol.scan")
    m = table["hits"] > 20
    for name in ("query_project", "scan_project"):
        for k in ("hits", "run"):
            if not (np.array_equal(runs[name][k], table[k][m])
                    and np.array_equal(runs[name][k], direct_proj[k])):
                raise AssertionError(f"skyhook {name}: column {k} differs")
    rx_push = stats["query_agg"]["client_rx_bytes"]
    rx_client = stats["client_side_agg"]["client_rx_bytes"]
    return {**walls, "launches": launches, "stats": stats,
            "client_rx_pushdown": rx_push, "client_rx_client_side": rx_client,
            "offload_ratio": rx_client / max(rx_push, 1)}


def _run_clients(n: int, fn) -> tuple[list, float]:
    """``fn(i)`` for i in range(n) on ``n`` threads released together by
    a barrier: the results in order and the wall from the first start to
    the last join.  A client's exception is raised here."""
    results: list = [None] * n
    errors: list = []
    bar = threading.Barrier(n)

    def client(i):
        try:
            bar.wait(timeout=60)
            results[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 -- raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t
    if any(th.is_alive() for th in threads):
        raise AssertionError("a client thread did not finish")
    if errors:
        raise errors[0]
    return results, wall


def session_path(P, store, table: dict) -> dict:
    """16 client threads behind a barrier issue the same filter -> agg
    through one ``ScanSession``; every result must equal the direct
    scan's."""
    core = P.core
    vol = core.GlobalVOL(store)
    t = time.perf_counter()
    direct, _ = _agg_scan(vol, "events").execute()
    direct_s = time.perf_counter() - t
    session = core.ScanSession(vol, window_s=0.02)
    n_clients = 16
    _zero_counts(P)                      # the path's run starts here
    results, wall = _run_clients(
        n_clients, lambda i: session.execute(_agg_scan(vol, "events"))[0])
    launches = _counts(P)                # ... and ends here
    if any(r != direct for r in results):
        raise AssertionError("session: a result differs from the direct "
                             "scan's")
    _check_sum_count("session", direct, table)
    st = dict(session.stats)
    if st["admitted"] != n_clients or st["deduped"] < 1 \
            or st["executed"] + st["deduped"] != n_clients:
        raise AssertionError(f"session stats {st}")
    if not launches["bitunpack"] > 0:
        raise AssertionError(f"session launches {launches}")
    return {"clients": n_clients, "window_s": 0.02, "wall_s": wall,
            "direct_scan_s": direct_s, "stats": st, "launches": launches}


def faults_path(P, store, table: dict, seed: int) -> dict:
    """A fault campaign over the table's objects (8 bit flips, 2 torn
    writes on distinct copies): the filter -> agg stays exact, scrub
    finds and heals exactly the injected copies, a second scrub finds
    none; then transient failures on one OSD during a query."""
    core = P.core
    vol = core.GlobalVOL(store)
    names = vol.open("events").object_names()
    fi = core.FaultInjector(store)
    detected0 = store.fabric.corruptions_detected
    placed = fi.campaign(names, flips=8, torn=2, seed=seed)
    if len(placed) != 10:
        raise AssertionError(f"campaign placed {len(placed)} of 10")
    walls = {}
    _zero_counts(P)                      # the path's run starts here
    t = time.perf_counter()
    agg, _ = _agg_scan(vol, "events").execute()
    walls["filter_agg_under_faults_s"] = time.perf_counter() - t
    read_detected = store.fabric.corruptions_detected - detected0
    t = time.perf_counter()
    first = store.scrub()
    walls["scrub_s"] = time.perf_counter() - t
    detected = store.fabric.corruptions_detected - detected0
    t = time.perf_counter()
    second = store.scrub()
    walls["second_scrub_s"] = time.perf_counter() - t
    victim = store.cluster.up_osds[0]
    retries0 = store.fabric.retries
    fi.transient_failures(victim, 3)
    t = time.perf_counter()
    agg2, _ = _agg_scan(vol, "events").execute()
    walls["filter_agg_transient_s"] = time.perf_counter() - t
    retries = store.fabric.retries - retries0
    launches = _counts(P)                # ... and ends here
    fi.clear()
    _check_sum_count("faults: filter_agg under the campaign", agg, table)
    _check_sum_count("faults: filter_agg under transient failures", agg2,
                     table)
    if detected != fi.corruptions_injected or first["lost"] != ():
        raise AssertionError(f"faults: {detected} corruptions detected of "
                             f"{fi.corruptions_injected} injected; lost "
                             f"{first['lost']}")
    if second["corrupt_copies"] or second["healed_copies"]:
        raise AssertionError(f"faults: second scrub {second}")
    if not retries > 0:
        raise AssertionError("faults: no retry under transient failures")
    if not launches["bitunpack"] > 0:
        raise AssertionError(f"faults launches {launches}")
    return {**walls, "injected": fi.corruptions_injected,
            "detected_by_reads": read_detected, "detected": detected,
            "scrub": {k: first[k] for k in ("objects_scrubbed",
                                            "corrupt_copies",
                                            "healed_copies")},
            "second_scrub_corrupt": second["corrupt_copies"],
            "transient_osd": victim, "retries": retries,
            "launches": launches}


def maintenance_path(P, dev, rows: int, seed: int) -> dict:
    """A second dataset of the event table's schema in 1 MiB objects,
    compacted by the default (8 MiB) policy, scrubbed, rebalanced and
    aged by the four daemons while a client thread loops the filter ->
    agg; then one OSD more, a topology change and a rebalance, and the
    query again."""
    core = P.core
    ev = make_events(dev, rows, seed + 1)
    table = {k: v.cpu().numpy() for k, v in ev.items()}
    del ev
    store = core.make_store(8, replicas=3)
    try:
        vol = core.GlobalVOL(store)
        omap = vol.create(_events_ds(core, "events2", rows),
                          core.PartitionPolicy(
                              target_object_bytes=MAINT_OBJECT_BYTES))
        t = time.perf_counter()
        vol.write(omap, table)
        write_s = time.perf_counter() - t
        n_before = omap.n_objects
        plane = core.MaintenancePlane(store)
        stop = threading.Event()
        seen, errors = [], []

        def client():
            try:
                while not stop.is_set():
                    r, _ = _agg_scan(vol, "events2").execute()
                    _check_sum_count("maintenance: live filter_agg", r,
                                     table)
                    seen.append(r)
            except BaseException as e:  # noqa: BLE001 -- raised below
                errors.append(e)

        reader = threading.Thread(target=client, name="live-scan")
        _zero_counts(P)                  # the path's run starts here
        t0 = time.perf_counter()
        plane.start()
        reader.start()
        try:
            # compaction is done when three seconds pass without a run
            prev, t_last = -1, time.perf_counter()
            while time.perf_counter() - t_last < 3.0:
                if errors:
                    break
                if time.perf_counter() - t0 > 600:
                    raise AssertionError("maintenance: compaction did not "
                                         "settle")
                if plane.compact_runs != prev:
                    prev, t_last = plane.compact_runs, time.perf_counter()
                time.sleep(0.05)
            # paused, the daemon finishes its step; any run still left
            # is folded here, with the client still scanning
            plane.pause()
            extra = 0
            while plane.compact_step() is not None:
                extra += 1
            compact_s = (time.perf_counter() if extra else t_last) - t0
            stop.set()
            reader.join(timeout=600)
            daemons_s = time.perf_counter() - t0
            if reader.is_alive():
                raise AssertionError("maintenance: the client thread did "
                                     "not stop")
            if errors:
                raise errors[0]
            n_after = vol.open("events2").n_objects
            t = time.perf_counter()
            resize = P.elastic.apply_storage_resize(store, add=("osd.8",))
            plane.note_topology_change()
            moved = 0
            while True:
                got = plane.rebalance_step()
                if not got["objects"]:
                    break
                moved += got["bytes"]
            resize_s = time.perf_counter() - t
            t = time.perf_counter()
            again, _ = _agg_scan(vol, "events2").execute()
            requery_s = time.perf_counter() - t
        finally:
            stop.set()
            plane.stop()
        launches = _counts(P)            # ... and ends here
        _check_sum_count("maintenance: after the resize", again, table)
        stats = plane.stats()
        if stats["errors"]:
            raise AssertionError(f"maintenance daemon errors: "
                                 f"{stats['errors']}")
        if not seen:
            raise AssertionError("maintenance: no live query completed")
        if n_after * 4 > n_before:
            raise AssertionError(f"maintenance: compaction left {n_after} "
                                 f"of {n_before} objects")
        if resize["objects_lost"]:
            raise AssertionError(f"resize lost {resize['objects_lost']}")
        if not launches["bitunpack"] > 0:
            raise AssertionError(f"maintenance launches {launches}")
        f = store.fabric.snapshot()
        return {"rows": rows, "objects_before": n_before,
                "objects_after": n_after, "write_s": write_s,
                "compact_s": compact_s, "daemons_s": daemons_s,
                "live_queries": len(seen), "compact_runs":
                stats["compact_runs"], "scrub_objects": stats["scrub_objects"],
                "scrub_rounds": stats["scrub_rounds"],
                "dead_pending": stats["dead_pending"],
                "compaction_bytes": f["compaction_bytes"],
                "resize_moved_objects": resize["objects_moved"],
                "rebalance_bytes": moved, "resize_s": resize_s,
                "requery_s": requery_s, "launches": launches}
    finally:
        store.close()


# one deepseek_67b decoder layer (src/repro/configs/deepseek_67b.py:14-19:
# d_model 8192, 64 heads of 128, 8 KV heads, d_ff 22016)
LAYER_SHAPES = {"wq": (8192, 8192), "wk": (8192, 1024), "wv": (8192, 1024),
                "wo": (8192, 8192), "w_gate": (8192, 22016),
                "w_up": (8192, 22016), "w_down": (22016, 8192),
                "attn_norm": (8192,), "mlp_norm": (8192,)}
# a dense KV cache at deepseek_67b's widths: 95 layers, one session of
# 4096 tokens, 8 KV heads of 128 (serve/engine.py parks it on axis 2)
KV_SHAPE = (95, 1, 4096, 8, 128)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape or a.device != b.device:
        return False
    if a.dtype.is_floating_point:
        width = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (x.view(width[x.element_size()]) for x in (a, b))
    return bool(torch.equal(a, b))


def checkpoint_path(P, dev, seed: int) -> dict:
    """``CheckpointManager(every_steps=1, keep=2)`` saves three steps of
    a bf16 state tree on the card into a fresh 8-OSD, 3-replica store,
    then restores the latest onto the card."""
    ckpt, pytree = P.ckpt, P.pytree
    steps = 3
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = {"params": {k: torch.randn(s, generator=gen, device=dev,
                                       dtype=torch.bfloat16)
                        for k, s in LAYER_SHAPES.items()},
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    nbytes = sum(t.nbytes for _, t in pytree.flatten_with_keys(state))
    store = P.core.make_store(8, replicas=3)
    try:
        mgr = ckpt.CheckpointManager(store, every_steps=1, keep=2)
        snap_s, save_s = [], []
        for step in range(1, steps + 1):
            state["step"].fill_(step)
            _sync(dev)
            t = time.perf_counter()
            mgr.maybe_save(state, step)
            snap_s.append(time.perf_counter() - t)
            if step < steps:             # the next train step mutates
                for t_ in state["params"].values():
                    t_.mul_(-1)
            mgr.wait()
            save_s.append(time.perf_counter() - t)
        like = pytree.map_with_keys(lambda _k, x: torch.empty_like(x), state)
        _sync(dev)
        t = time.perf_counter()
        got, manifest = ckpt.restore(store, like)
        _sync(dev)
        restore_s = time.perf_counter() - t
        if manifest["step"] != steps:
            raise AssertionError(f"restored step {manifest['step']}")
        for (k, a), (_, b) in zip(pytree.flatten_with_keys(got),
                                  pytree.flatten_with_keys(state)):
            if not _bits_equal(a, b):
                raise AssertionError(f"checkpoint leaf {k} differs")
        kept = sorted(int(n.split("step-")[1].split("/")[0])
                      for n in store.list_objects("ckpt/")
                      if n.endswith(".manifest"))
        if kept != [steps - 1, steps] or \
                store.list_objects("ckpt/train/step-1/"):
            raise AssertionError(f"retention kept steps {kept}")
        return {"values": sum(t.numel() for _, t in
                              pytree.flatten_with_keys(state)),
                "bytes": nbytes, "steps": steps, "kept": kept,
                "objects": len(store.list_objects("ckpt/")),
                "snapshot_s": snap_s, "save_s": save_s,
                "save_GB_per_s": [nbytes / s / 1e9 for s in save_s],
                "restore_s": restore_s,
                "restore_GB_per_s": nbytes / restore_s / 1e9}
    finally:
        store.close()


def kv_path(P, dev, seed: int) -> dict:
    """A dense KV cache on the card through ``cache_to_objects`` with the
    serving engine's sequence axes, then back onto the card through
    ``objects_to_cache``."""
    kvcache, pytree = P.kvcache, P.pytree
    shape = KV_SHAPE
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    cache = {"k": torch.randn(shape, generator=gen, device=dev,
                              dtype=torch.bfloat16),
             "v": torch.randn(shape, generator=gen, device=dev,
                              dtype=torch.bfloat16),
             "pos": torch.tensor(shape[2] - 1, dtype=torch.int32,
                                 device=dev)}
    seq_axes = {k: 2 for k, _ in pytree.flatten_with_keys(cache)
                if any(t in k for t in ("'k'", "'v'", "'ckv'", "'krope'"))}
    nbytes = sum(t.nbytes for _, t in pytree.flatten_with_keys(cache))
    store = P.core.make_store(8, replicas=3)
    try:
        _sync(dev)
        t = time.perf_counter()
        manifest = kvcache.cache_to_objects(store, cache, "s0",
                                            seq_axes=seq_axes)
        park_s = time.perf_counter() - t
        like = pytree.map_with_keys(lambda _k, x: torch.empty_like(x), cache)
        _sync(dev)
        t = time.perf_counter()
        back = kvcache.objects_to_cache(store, like, "s0")
        _sync(dev)
        resume_s = time.perf_counter() - t
        pages = {k: len(m["pages"]) for k, m in manifest["leaves"].items()}
        want = -(-shape[2] // kvcache.PAGE_TOKENS)
        if pages != {"['k']": want, "['pos']": 1, "['v']": want}:
            raise AssertionError(f"KV pages per leaf {pages}")
        for (k, a), (_, b) in zip(pytree.flatten_with_keys(back),
                                  pytree.flatten_with_keys(cache)):
            if not _bits_equal(a, b):
                raise AssertionError(f"KV leaf {k} differs")
        return {"shape": list(shape), "bytes": nbytes, "pages": pages,
                "park_s": park_s, "park_GB_per_s": nbytes / park_s / 1e9,
                "resume_s": resume_s,
                "resume_GB_per_s": nbytes / resume_s / 1e9}
    finally:
        store.close()


PLANE_PATHS = ("skyhook", "session", "faults", "maintenance", "serve")
TRAIN_PATHS = ("train", "train restart")
MOE_PATHS = ("moe serve", "moe train")
SSM_PATHS = tuple(f"{a} {p}" for a in SSM_ARCHS
                  for p in ("serve", "train"))
PATHS = PLANE_PATHS + TRAIN_PATHS + MOE_PATHS + SSM_PATHS + (
    "multi-device", "fsdp", "model axis", "recurrent model axis",
    "examples", "starcoder2_7b serve", "starcoder2_7b train",
    "head_dim model axis")


def table_planes(P, store, table: dict, seed: int, card: str) -> dict:
    """The planes that run on the main path's store and table."""
    sky = skyhook_path(P, store, table)
    print("skyhook: " + json.dumps(sky), flush=True)
    print(f"skyhook: filter -> agg pushed down {sky['query_agg_s']:.4f} s, "
          f"client_rx {sky['client_rx_pushdown']} B; client-side "
          f"{sky['client_side_agg_s']:.4f} s, client_rx "
          f"{sky['client_rx_client_side']} B (offload ratio "
          f"{sky['offload_ratio']:.1f}x)  [{card}]", flush=True)
    ses = session_path(P, store, table)
    print("session: " + json.dumps(ses), flush=True)
    print(f"session: {ses['clients']} clients {ses['wall_s']:.4f} s, "
          f"executed {ses['stats']['executed']} of {ses['stats']['admitted']}"
          f" admitted (deduped {ses['stats']['deduped']}); one direct scan "
          f"{ses['direct_scan_s']:.4f} s  [{card}]", flush=True)
    flt = faults_path(P, store, table, seed)
    print("faults: " + json.dumps(flt), flush=True)
    return {"skyhook": sky, "session": ses, "faults": flt}


def fresh_planes(P, dev, seed: int, card: str, maint_rows: int) -> dict:
    """The planes that run in stores of their own, one after another."""
    mnt = maintenance_path(P, dev, maint_rows, seed)
    print("maintenance: " + json.dumps(mnt), flush=True)
    print(f"maintenance: {mnt['objects_before']} -> {mnt['objects_after']} "
          f"objects in {mnt['compact_s']:.3f} s under "
          f"{mnt['live_queries']} live queries  [{card}]", flush=True)
    gc.collect()
    ck = checkpoint_path(P, dev, seed)
    print("checkpoint: " + json.dumps(ck), flush=True)
    print(f"checkpoint: {ck['bytes']} B per step, save "
          + ", ".join(f"{s:.3f} s ({r:.3f} GB/s)"
                      for s, r in zip(ck["save_s"], ck["save_GB_per_s"]))
          + f"; restore {ck['restore_s']:.3f} s "
          f"({ck['restore_GB_per_s']:.3f} GB/s)  [{card}]", flush=True)
    gc.collect()
    kv = kv_path(P, dev, seed)
    print("kv pages: " + json.dumps(kv), flush=True)
    print(f"kv pages: {kv['bytes']} B, park {kv['park_s']:.3f} s "
          f"({kv['park_GB_per_s']:.3f} GB/s), resume {kv['resume_s']:.3f} s "
          f"({kv['resume_GB_per_s']:.3f} GB/s)  [{card}]", flush=True)
    return {"maintenance": mnt, "checkpoint": ck, "kv": kv}


# --------------------------------------------------------------------------
# serve: yi_9b through the engine, KV session, analytics, invariant
# --------------------------------------------------------------------------


def _timed(fn, dev, walls: list):
    """``fn`` with the wall of each call, the card synchronised around
    it, appended to ``walls``."""
    def run(*args):
        _sync(dev)
        t = time.perf_counter()
        out = fn(*args)
        _sync(dev)
        walls.append(time.perf_counter() - t)
        if not bool(torch.isfinite(out[0]).all()):
            raise AssertionError("serve: non-finite logits")
        return out
    return run


def _serve_requests(P, cfg, rng) -> list:
    lens = [SERVE_PROMPT[1]] + sorted(
        int(n) for n in rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1,
                                     SERVE_BATCH - 1))
    return [P.engine.Request(prompt=rng.integers(
        1, cfg.vocab_size, n).astype(np.int32), max_new=SERVE_MAX_NEW)
        for n in lens]


def _request_log(dev, n: int, seed: int) -> dict[str, np.ndarray]:
    """``examples/serve_pushdown.py``'s request log, generated on the
    card: latency_ms float32 gamma(3, 12), tokens_out int32 in [1, 512),
    model_id int32 in [0, 4)."""
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    gamma = torch.distributions.Gamma(torch.tensor(3.0, device=dev),
                                      torch.tensor(1 / 12.0, device=dev))
    torch.manual_seed(seed + 3)
    table = {"latency_ms": gamma.sample((n,)).to(torch.float32),
             "tokens_out": torch.randint(1, 512, (n,), generator=gen,
                                         device=dev, dtype=torch.int32),
             "model_id": torch.randint(0, 4, (n,), generator=gen,
                                       device=dev, dtype=torch.int32)}
    return {k: v.cpu().numpy() for k, v in table.items()}


def _analytics(P, engine, dev, seed: int) -> dict:
    """The request log in a fresh 8-OSD, 3-replica store, one filter ->
    agg per request from ``SERVE_CLIENTS`` threads through the engine's
    analytics session; every result equal to numpy."""
    core = P.core
    n = 1 << SERVE_LOG_ROWS_LOG2
    t = time.perf_counter()
    table = _request_log(dev, n, seed)
    gen_s = time.perf_counter() - t
    store = core.make_store(8, replicas=3)
    try:
        vol = core.GlobalVOL(store)
        omap = vol.create(core.LogicalDataset(
            "reqlog", (core.Column("latency_ms", "float32"),
                       core.Column("tokens_out", "int32"),
                       core.Column("model_id", "int32")), n, 4096),
            core.PartitionPolicy())
        t = time.perf_counter()
        vol.write(omap, table)
        write_s = time.perf_counter() - t
        packed = _bitpack_cols(store, omap, P.fmt)
        if any(c != {"tokens_out", "model_id"} for c in packed.values()):
            raise AssertionError(f"request log bitpack columns {packed}")
        session = engine.attach_analytics(vol, window_s=0.02)

        def request(_i):                 # each request builds its scan
            return engine.analytics(
                vol.scan("reqlog").filter("latency_ms", ">", 100.0)
                .agg("count", "tokens_out").agg("sum", "tokens_out"))[0]

        results, wall = _run_clients(SERVE_CLIENTS, request)
        m = table["latency_ms"] > 100.0
        want = {"count(tokens_out)": float(m.sum()),
                "sum(tokens_out)": float(
                    table["tokens_out"][m].astype(np.int64).sum())}
        if any(r != want for r in results):
            raise AssertionError(f"serve analytics: {results[0]} != {want}")
        st = dict(session.stats)
        if st["admitted"] != SERVE_CLIENTS or \
                st["executed"] + st["deduped"] != SERVE_CLIENTS:
            raise AssertionError(f"serve analytics session stats {st}")
        return {"rows": n, "objects": omap.n_objects,
                "generate_s": gen_s, "write_s": write_s, "wall_s": wall,
                "clients": SERVE_CLIENTS, "stats": st, "result": want}
    finally:
        store.close()


def _invariant(P, model, dev, n_prefill: int, n_decode: int,
               seed: int) -> dict:
    """prefill(n_prefill) then n_decode teacher-forced decode steps
    against prefill of all n_prefill + n_decode tokens, batch 2: the
    last logits of each, max |err| and whether they meet rtol = atol =
    ``INVARIANT_TOL``."""
    S = n_prefill + n_decode
    gen = torch.Generator().manual_seed(seed + 4)
    toks = torch.randint(0, model.cfg.vocab_size, (2, S), generator=gen,
                         dtype=torch.int32).to(dev)
    pad = P.engine.ServeEngine(model, max_seq=S)._pad_cache
    t = time.perf_counter()
    with torch.inference_mode():
        full, _ = model.prefill({"tokens": toks})
        logits, cache = model.prefill({"tokens": toks[:, :n_prefill]})
        cache = pad(cache)
        for i in range(n_prefill, S):
            logits, cache = model.decode_step(toks[:, i:i + 1], cache)
        _sync(dev)
    err = (logits - full).abs()
    ok = bool((err <= INVARIANT_TOL + INVARIANT_TOL * full.abs()).all())
    return {"dtype": str(model.cfg.param_dtype).removeprefix("torch."),
            "prefill": n_prefill, "decode_steps": n_decode,
            "max_abs_err": float(err.max()),
            "max_abs_logit": float(full.abs().max()),
            "finite": bool(torch.isfinite(logits).all()
                           and torch.isfinite(full).all()),
            "within_2e-2": ok, "wall_s": time.perf_counter() - t}


def _serve_run(P, cfg, model, dev, seed: int, card: str,
               flash: int) -> dict:
    """``model`` through ``ServeEngine``: generate the requests, park and
    resume the session bit-equal, one decode step traced, the analytics
    scans.  The launch counts are zeroed before the timed generate and
    read after the analytics; its one prefill must launch ``flash``
    inference attention kernels (one a layer where the model's
    attention takes ``flash_fwd``, else 0)."""
    n_params = sum(p.numel() for p in model.parameters())
    store = P.core.make_store(8, replicas=3)
    try:
        engine = P.engine.ServeEngine(model, max_seq=SERVE_MAX_SEQ,
                                      store=store)
        rng = np.random.default_rng(seed)
        reqs = _serve_requests(P, cfg, rng)
        # the same batch for two tokens first: the first call of each
        # kernel shape and library handle stays out of the timed run
        engine.generate([P.engine.Request(r.prompt, max_new=2)
                         for r in reqs])
        prefill_s, decode_s = [], []
        engine._prefill = _timed(engine._prefill, dev, prefill_s)
        engine._decode = _timed(engine._decode, dev, decode_s)
        _zero_counts(P)                  # the path's run starts here
        t = time.perf_counter()
        comps = engine.generate(reqs)
        generate_s = time.perf_counter() - t
        if [c.steps for c in comps] != [SERVE_MAX_NEW] * SERVE_BATCH or \
                any(((c.tokens < 0) | (c.tokens >= cfg.vocab_size)).any()
                    for c in comps):
            raise AssertionError("serve: completions "
                                 f"{[c.steps for c in comps]}")
        cache = engine._last_cache
        nbytes = sum(t_.nbytes for _, t_ in
                     P.pytree.flatten_with_keys(cache))
        _sync(dev)
        t = time.perf_counter()
        engine.park_session("serve-0")
        park_s = time.perf_counter() - t
        t = time.perf_counter()
        back = engine.resume_session("serve-0", SERVE_BATCH)
        _sync(dev)
        resume_s = time.perf_counter() - t
        manifest = json.loads(store.get("kv/serve-0/.manifest").decode())
        pages = {k: len(m["pages"]) for k, m in manifest["leaves"].items()}
        # leaves with a sequence axis in pages, the others (``pos``,
        # the recurrent states) whole
        want = {f"['{k}']": (SERVE_MAX_SEQ // P.kvcache.PAGE_TOKENS
                             if k in P.engine._SEQ_LEAVES else 1)
                for k in cache}
        if pages != want:
            raise AssertionError(f"serve KV pages per leaf {pages}")
        for key in cache:
            if not _bits_equal(back[key], cache[key]):
                raise AssertionError(f"serve: resumed leaf {key} differs")
        del back
        # one more decode step under the profiler: the card's busy share
        tok = torch.zeros((SERVE_BATCH, 1), dtype=torch.int32, device=dev)
        with torch.inference_mode():
            busy_ms, step_s, events, top = traced(
                lambda: model.decode_step(tok, cache))
    finally:
        store.close()
    ana = _analytics(P, engine, dev, seed)
    launches = _counts(P)                # ... and ends here
    if not launches["bitunpack"] > 0 or launches["filter_agg"] \
            or launches["block_agg"] or launches["flash_fwd"] != flash:
        raise AssertionError(f"serve launches {launches}, want "
                             f"flash_fwd {flash}")
    steps = len(decode_s)
    res = {"arch": cfg.name, "params": n_params, "switches": switches(P),
           "batch": SERVE_BATCH, "prompt_lens": [len(r.prompt)
                                                 for r in reqs],
           "max_new": SERVE_MAX_NEW, "max_seq": SERVE_MAX_SEQ,
           "generate_s": generate_s, "prefill_ms": prefill_s[0] * 1e3,
           "decode_steps": steps,
           "decode_ms_per_step": sum(decode_s) / steps * 1e3,
           "decode_ms_median": float(np.median(decode_s)) * 1e3,
           "decode_tokens_per_s": SERVE_BATCH * steps / sum(decode_s),
           "traced_step": {"wall_ms": step_s * 1e3, "busy_ms": busy_ms,
                           "busy_share": busy_ms / (step_s * 1e3),
                           "device_events": events,
                           "top_kernels": top},
           "generate_tokens_per_s": sum(c.steps for c in comps)
           / generate_s,
           "peak_mem_GB": torch.cuda.max_memory_allocated(dev) / 1e9,
           "kv_bytes": nbytes, "kv_pages": pages, "park_s": park_s,
           "park_GB_per_s": nbytes / park_s / 1e9, "resume_s": resume_s,
           "resume_GB_per_s": nbytes / resume_s / 1e9,
           "analytics": ana, "launches": launches}
    print("serve: " + json.dumps(res), flush=True)
    print(f"serve: {cfg.name} bf16 {n_params} params ({switches(P)}), "
          f"{SERVE_BATCH} "
          f"requests of {min(res['prompt_lens'])}-{max(res['prompt_lens'])}"
          f" tokens: prefill {res['prefill_ms']:.3f} ms, decode "
          f"{res['decode_ms_per_step']:.3f} ms per step ({steps} steps, "
          f"{res['decode_tokens_per_s']:.1f} tokens/s; card busy "
          f"{busy_ms:.3f} ms of a traced {step_s * 1e3:.3f} ms step, "
          f"{events} device events); peak memory "
          f"{res['peak_mem_GB']:.3f} GB; KV {nbytes} B park "
          f"{park_s:.3f} s ({res['park_GB_per_s']:.3f} GB/s), resume "
          f"{resume_s:.3f} s ({res['resume_GB_per_s']:.3f} GB/s), bit-equal;"
          f" analytics {ana['clients']} clients {ana['wall_s']:.4f} s, "
          f"executed {ana['stats']['executed']} of "
          f"{ana['stats']['admitted']}, bitunpack launches "
          f"{launches['bitunpack']}  [{card}]", flush=True)
    return res


def _seeded(P, cfg, dev, seed: int):
    """``cfg``'s model on the card, its weights drawn from ``seed``, and
    the seconds that took."""
    t = time.perf_counter()
    model = P.archs.build_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(seed))
    _sync(dev)
    return model, time.perf_counter() - t


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype=torch.float32,
                               compute_dtype=torch.float32)


def serve_path(P, dev, seed: int, card: str) -> dict:
    """yi_9b at full width and depth in bf16 through ``ServeEngine``:
    generate, park and resume the session, the analytics scans; then the
    prefill/decode invariant in bf16 (printed) and float32 at
    ``SERVE_F32_LAYERS`` layers (gated)."""
    cfg = P.configs.get_config(SERVE_ARCH)
    model, init_s = _seeded(P, cfg, dev, seed)
    # GQA with heads of 128 in bf16: flash_fwd once a layer
    res = _serve_run(P, cfg, model, dev, seed, card, flash=cfg.n_layers)
    res["init_s"] = init_s
    res["invariant_bf16"] = _invariant(P, model, dev, *INVARIANT_BF16, seed)
    print("serve invariant (bf16, no gate): "
          + json.dumps(res["invariant_bf16"]), flush=True)
    del model
    _free_card()
    model, _ = _seeded(P, dataclasses.replace(
        _f32(cfg), n_layers=SERVE_F32_LAYERS), dev, seed)
    inv = _invariant(P, model, dev, *INVARIANT_F32, seed)
    inv["layers"] = SERVE_F32_LAYERS
    del model
    _free_card()
    res["invariant_f32"] = inv
    print("serve invariant (float32): " + json.dumps(inv), flush=True)
    if not (inv["finite"] and inv["within_2e-2"]):
        raise AssertionError(f"serve: float32 prefill/decode invariant "
                             f"fails rtol/atol {INVARIANT_TOL}: {inv}")
    shape = P.configs.SHAPES["decode_32k"]
    B, S = shape.global_batch, shape.seq_len
    need = (2 * cfg.n_layers * B * S * cfg.n_kv_heads * cfg.head_dim
            * torch.bfloat16.itemsize)
    print(f"reduced: serve at batch {SERVE_BATCH} x {SERVE_MAX_SEQ} cache "
          f"slots; decode_32k's batch of {B} x {S} tokens needs "
          f"{need / 1e9:.1f} GB of KV cache, more than one card's 80 GB; "
          f"the float32 invariant at {SERVE_F32_LAYERS} of {cfg.n_layers} "
          f"layers, to keep the script's time for the phases after it")
    return res


def decode_bound_ms(model, cache_bytes: int) -> float:
    """Least time of one decode step at the card's memory rate: every
    weight read once (each routed expert's too: the experts compute all
    their C = 8 slots; zamba's shared block once, though it runs G
    times), the token embedding's B rows, the whole cache (the latent
    cache, the recurrent states, zamba's k / v)."""
    cfg = model.cfg
    tok = model.embed["tok"]
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    nbytes += (SERVE_BATCH - tok.shape[0]) * cfg.d_model * tok.element_size()
    return (nbytes + cache_bytes) / HBM_BYTES_PER_S * 1e3


def moe_serve_path(P, dev, seed: int, card: str) -> dict:
    """deepseek_v2_lite_16b at full width and depth in bf16 through
    ``ServeEngine``, as the yi_9b phase runs it (the MLA latent cache
    parked and resumed); the shipped config's prefill/decode invariant
    in bf16, printed without a gate."""
    _free_card()
    cfg = P.configs.get_config(MOE_ARCH)
    model, init_s = _seeded(P, cfg, dev, seed)
    # MLA's heads are 192 / 128 wide: the block loop, no flash_fwd
    res = _serve_run(P, cfg, model, dev, seed, card, flash=0)
    res["init_s"] = init_s
    kv = res["kv_bytes"] - 4
    if kv != MOE_KV_BYTES:
        raise AssertionError(f"moe serve: latent cache {kv} B, want "
                             f"{MOE_KV_BYTES}")
    res["decode_bound_ms"] = decode_bound_ms(model, kv)
    experts = sum(p.numel() * p.element_size()
                  for n, p in model.named_parameters() if ".moe.w" in n)
    print(f"moe serve: decode {res['decode_ms_per_step']:.3f} ms per step "
          f"against a {res['decode_bound_ms']:.3f} ms bound at 3.35 TB/s "
          f"({experts} B of routed experts read each step, all "
          f"{cfg.moe.n_routed} in each of {len(model.blocks)} layers, plus "
          f"the rest of the weights and the {kv} B latent cache)  [{card}]",
          flush=True)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    res["invariant_bf16"] = _invariant(P, model, dev, *INVARIANT_BF16, seed)
    print("moe serve invariant (bf16, capacity factor "
          f"{cfg.moe.capacity_factor}, no gate): "
          + json.dumps(res["invariant_bf16"]), flush=True)
    del model
    _free_card()
    shape = P.configs.SHAPES["decode_32k"]
    B, S = shape.global_batch, shape.seq_len
    m = cfg.mla
    need = (cfg.n_layers * B * S * (m.kv_lora_rank + m.qk_rope_head_dim)
            * torch.bfloat16.itemsize)
    print(f"reduced: moe serve at batch {SERVE_BATCH} x {SERVE_MAX_SEQ} "
          f"latent-cache slots; decode_32k's batch of {B} x {S} tokens "
          f"needs {need / 1e9:.1f} GB of latent cache beside "
          f"{weights / 1e9:.2f} GB of weights, more than one card's 80 GB")
    return res


def moe_invariant_path(P, dev, seed: int, card: str) -> dict:
    """The prefill/decode invariant of deepseek_v2_lite_16b at full width
    with ``MOE_F32_LAYERS`` layers in float32, gated at
    ``INVARIANT_TOL``, with a capacity factor of n_routed / top_k so
    that prefill drops no token (decode never does: C = 8 >= B)."""
    _free_card()
    cfg = P.configs.get_config(MOE_ARCH)
    full = dataclasses.replace(_f32(cfg), n_layers=MOE_F32_LAYERS,
                               moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_routed / cfg.moe.top_k))
    model, init_s = _seeded(P, full, dev, seed)
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    inv = _invariant(P, model, dev, *INVARIANT_F32, seed)
    inv.update(init_s=init_s, weight_bytes=nbytes,
               capacity_factor=full.moe.capacity_factor,
               peak_mem_GB=torch.cuda.max_memory_allocated(dev) / 1e9)
    del model
    _free_card()
    print("moe invariant (float32): " + json.dumps(inv), flush=True)
    print(f"moe invariant: {cfg.name} float32 ({nbytes} B of weights), "
          f"prefill {INVARIANT_F32[0]} + {INVARIANT_F32[1]} decode steps "
          f"against prefill of {sum(INVARIANT_F32)}, batch 2: max |err| "
          f"{inv['max_abs_err']!r} of logits up to "
          f"{inv['max_abs_logit']:.4f}, within {INVARIANT_TOL}: "
          f"{inv['within_2e-2']}; {inv['wall_s']:.3f} s, peak "
          f"{inv['peak_mem_GB']:.3f} GB  [{card}]", flush=True)
    print(f"reduced: moe invariant at {MOE_F32_LAYERS} of {cfg.name}'s "
          f"{cfg.n_layers} layers: {MOE_F32_WHY}")
    print(f"reduced: moe invariant at capacity factor "
          f"{full.moe.capacity_factor:.4f} (n_routed / top_k) for the "
          f"shipped {cfg.moe.capacity_factor}: at 1.25 a "
          f"{sum(INVARIANT_F32)}-token prefill drops tokens that decode "
          f"never drops, so the two paths differ by design (the smoke "
          f"config runs at 8.0 for the same reason)")
    if not (inv["finite"] and inv["within_2e-2"]):
        raise AssertionError(f"moe: float32 prefill/decode invariant "
                             f"fails rtol/atol {INVARIANT_TOL}: {inv}")
    return inv


# --------------------------------------------------------------------------
# training: the full-width step, the restart, the flash backward
# --------------------------------------------------------------------------


def _free_card() -> None:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _train_world(P, cfg, seed: int):
    """A fresh 8-OSD, 2-replica store holding the corpus, written in one
    ``build_corpus`` call (a chunked write that cuts objects loses rows
    in both packages)."""
    core = P.core
    store = core.make_store(8, replicas=2)
    vol = core.GlobalVOL(store)
    spec = P.corpus.CorpusSpec(n_seqs=TRAIN_SEQS, seq_len=TRAIN_SEQ,
                               vocab_size=cfg.vocab_size, seed=seed)
    omap = P.corpus.build_corpus(vol, spec, chunk_rows=TRAIN_SEQS)
    return store, vol, omap


def _trainer(P, model, store, vol, seed: int, steps: int, every: int,
             lr: float = TRAIN_LR):
    """The launcher's wiring: a packed, prefetching loader feeding a
    packed-ingest ``Trainer``."""
    loader = P.pipeline.ObjectDataLoader(vol, "corpus",
                                         global_batch=TRAIN_BATCH,
                                         seed=seed, packed=True, prefetch=2)
    opt = P.optimizer.OptConfig(lr=lr,
                                warmup_steps=max(steps // 10, 2),
                                total_steps=steps)
    cfg = P.trainer.TrainerConfig(total_steps=steps, ckpt_every=every,
                                  ckpt_keep=2, log_every=steps,
                                  packed_ingest=True)
    return P.trainer.Trainer(model, loader, store, opt=opt, cfg=cfg,
                             log=lambda msg: print(msg, flush=True))


def train_flops(P, cfg, model, batch: int, seq: int) -> tuple[float, float]:
    """(model FLOPs, FLOPs as run) of one train step.  Model FLOPs: 6 per
    matrix-multiplied parameter a token touches (all but the token
    embedding, a gather; of the routed experts the top_k a token is sent
    to; zamba's shared block once for each of its G uses) per token,
    plus causal attention's two S x S products per attention layer (q.k
    over the q/k head width, p.v over the v head width), half of them
    masked, three times over (forward and backward).  The SSM layers'
    chunked scans (masked einsums within a chunk, the carried state) are
    left out: at these widths they are under 5% of the products.  As
    run, each routed expert computes all its C capacity slots
    instead."""
    tokens = batch * seq
    routed = sum(p.numel() for n, p in model.named_parameters()
                 if ".moe.w" in n)
    n_params = sum(p.numel() for p in model.parameters())
    dense = n_params - cfg.vocab_size * cfg.d_model - routed
    if cfg.attention == "mla":
        qk = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        vd = cfg.mla.v_head_dim
    else:
        qk = vd = cfg.head_dim
    attn_layers = cfg.n_layers
    if cfg.family == "hybrid":
        attn_layers = model.n_groups
        dense += (model.n_groups - 1) * sum(
            p.numel() for p in model.shared.parameters())
    elif cfg.family == "ssm":
        attn_layers = 0
    attn = 3 * attn_layers * batch * seq * seq * cfg.n_heads * (qk + vd)
    flops = padded = 6 * dense * tokens + attn
    if cfg.moe is not None:
        m = cfg.moe
        per_slot = 3 * cfg.d_model * m.d_ff_expert     # w1, w3, w2
        n_moe = len(model.blocks)
        flops += 6 * tokens * m.top_k * per_slot * n_moe
        padded += (6 * m.n_routed * P.moe._capacity(tokens, cfg) * per_slot
                   * n_moe)
    return float(flops), float(padded)


def train_path(P, dev, seed: int, card: str, arch: str = TRAIN_ARCH,
               layers: int = TRAIN_LAYERS, tag: str = "train",
               why: str = TRAIN_WHY, lr: float = TRAIN_LR) -> dict:
    """:func:`train_run` and its gates: one ``bitunpack`` launch a step,
    the losses finite and falling, a MoE's aux losses positive and a
    dense model's 0."""
    res = train_run(P, dev, seed, card, arch, layers, tag, why, lr)
    losses, aux, launches = res["losses"], res["aux_losses"], res["launches"]
    if launches != {"bitunpack": TRAIN_STEPS, "filter_agg": 0,
                    "block_agg": 0, "flash_fwd": 0}:
        raise AssertionError(f"{tag} launches {launches}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: losses {losses}")
    if res["moe"] and not all(np.isfinite(a) and a > 0 for a in aux):
        raise AssertionError(f"{tag}: aux losses {aux}")
    if not res["moe"] and any(a != 0 for a in aux):
        raise AssertionError(f"{tag}: aux losses {aux}, want 0")
    return res


def train_run(P, dev, seed: int, card: str, arch: str, layers: int,
              tag: str, why: str, lr: float) -> dict:
    """``arch`` at full width, ``layers`` layers, remat "full": the
    corpus in the store -> packed loader -> ``fused_batch`` (bitunpack)
    -> train step, ``TRAIN_STEPS`` steps, then one step traced."""
    _free_card()
    cfg = dataclasses.replace(P.configs.get_config(arch), n_layers=layers)
    model = P.archs.build_model(cfg, remat="full", device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    t = time.perf_counter()
    store, vol, omap = _train_world(P, cfg, seed)
    world_s = time.perf_counter() - t
    try:
        # no checkpoint at this depth: one save is tens of GB of host copies
        tr = _trainer(P, model, store, vol, seed, TRAIN_STEPS,
                      every=TRAIN_STEPS + 1, lr=lr)
        t = time.perf_counter()
        state, start = tr.init_or_restore(seed)
        _sync(dev)
        init_s = time.perf_counter() - t
        if start != 0:
            raise AssertionError(f"{tag}: fresh store restored step {start}")
        _zero_counts(P)                  # the path's run starts here
        t = time.perf_counter()
        state = tr.run(state, start_step=0)
        run_s = time.perf_counter() - t
        launches = _counts(P)            # ... and ends here
        peak = torch.cuda.max_memory_allocated(dev)
        words = next(tr.loader)["tokens_packed"]
        tr.loader.close()
    finally:
        store.close()
    losses = [r["loss"] for r in tr.history]
    aux = [r["aux_loss"] for r in tr.history]
    batch = {"tokens_packed": torch.from_numpy(
        np.ascontiguousarray(words).view(np.int32)).to(dev)}
    t = time.perf_counter()
    busy_ms, step_s, events, top = traced(lambda: tr.train_step(state,
                                                                 batch))
    trace_s = time.perf_counter() - t
    walls = [r["wall_s"] for r in tr.history]
    later = walls[1:]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops, padded = train_flops(P, cfg, model, TRAIN_BATCH, TRAIN_SEQ)
    mean_s = float(np.mean(later))
    res = {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
           "moe": cfg.moe is not None, "switches": switches(P),
           "remat": "full", "microbatches": 1, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "lr": lr,
           "corpus_sequences": TRAIN_SEQS, "corpus_objects": omap.n_objects,
           "corpus_write_s": world_s, "trace_s": trace_s, "init_s": init_s, "run_s": run_s, "losses": losses,
           "aux_losses": aux,
           "grad_norms": [r["grad_norm"] for r in tr.history],
           "step_s": walls, "first_step_s": walls[0],
           "step_mean_s": mean_s, "step_median_s": float(np.median(later)),
           "tokens_per_s": tokens / mean_s, "model_flops": flops,
           "bf16_peak_share": flops / mean_s / BF16_PEAK_FLOPS,
           "flops_as_run": padded,
           "peak_mem_GB": peak / 1e9,
           "traced_step": {"wall_s": step_s, "busy_ms": busy_ms,
                           "busy_share": busy_ms / (step_s * 1e3),
                           "device_events": events, "top_kernels": top},
           "launches": launches}
    print(f"{tag}: " + json.dumps(res), flush=True)
    print(f"{tag}: {cfg.name} {cfg.n_layers} layers, {n_params} params "
          f"({switches(P)}), {TRAIN_STEPS} packed-ingest steps of "
          f"{TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens: loss {losses[0]:.4f} -> {losses[-1]:.4f}"
          + (f" (aux {aux[0]:.6f} -> {aux[-1]:.6f})" if cfg.moe else "")
          + f"; step {mean_s:.4f} s mean, {res['step_median_s']:.4f} s median "
          f"(first {walls[0]:.4f} s), {res['tokens_per_s']:.1f} tokens/s, "
          f"{flops:.4g} model FLOPs a step = "
          f"{res['bf16_peak_share']:.2%} of the bf16 dense peak"
          + (f" ({padded:.4g} as run, every expert's capacity slots "
             f"computed)" if cfg.moe else "")
          + f"; traced step: card busy {busy_ms:.1f} ms of "
          f"{step_s * 1e3:.1f} ms ({events} device events); peak memory "
          f"{res['peak_mem_GB']:.3f} GB; bitunpack launches "
          f"{launches['bitunpack']}  [{card}]", flush=True)
    full = P.configs.get_config(arch)
    depth = (f"{layers} of {arch}'s {full.n_layers} layers ({why}) and "
             if layers < full.n_layers else f"all {layers} layers and ")
    print(f"reduced: {tag} at {depth}a global batch of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens (train_4k is 256 x 4096 on a pod); a "
          f"{TRAIN_SEQS}-sequence corpus")
    del tr, state, model, batch
    return res


def _state_leaves(state) -> dict[str, torch.Tensor]:
    return {f"{part}/{name}": t
            for part, tree in (("params", state["params"]),
                               ("m", state["opt"]["m"]),
                               ("v", state["opt"]["v"]))
            for name, t in tree.items()}


def restart_path(P, dev, seed: int, card: str) -> dict:
    """The same widths at ``RESTART_LAYERS`` layers: ``RESTART_STEPS``
    steps with a checkpoint at ``RESTART_EVERY``; then a fresh Trainer
    restores that checkpoint and runs the steps after it again — every
    leaf of params, m and v bit-equal to the uninterrupted run, under
    ``torch.use_deterministic_algorithms``."""
    _free_card()
    cfg = dataclasses.replace(P.configs.get_config(TRAIN_ARCH),
                              n_layers=RESTART_LAYERS)
    model = P.archs.build_model(cfg, remat="full", device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    store, vol, _ = _train_world(P, cfg, seed)
    torch.use_deterministic_algorithms(True)
    try:
        _zero_counts(P)                  # the path's run starts here
        tr = _trainer(P, model, store, vol, seed, RESTART_STEPS,
                      every=RESTART_EVERY)
        state = tr.run(tr.init_or_restore(seed)[0], start_step=0)
        want = {k: t.clone() for k, t in _state_leaves(state).items()}
        want_losses = [r["loss"] for r in tr.history]
        tr.loader.close()
        last = tr.ckpts.saved_steps[-1]
        again = _trainer(P, model, store, vol, seed, RESTART_STEPS,
                         every=RESTART_STEPS + 1)
        _sync(dev)
        t = time.perf_counter()
        state, start = again.init_or_restore(seed)
        _sync(dev)
        restore_s = time.perf_counter() - t
        if start != last:
            raise AssertionError(f"restart: restored step {start}")
        state = again.run(state, start_step=start)
        again.loader.close()
        launches = _counts(P)            # ... and ends here
    finally:
        torch.use_deterministic_algorithms(False)
        store.close()
    got = _state_leaves(state)
    if sorted(got) != sorted(want):
        raise AssertionError("restart: the restored state has other leaves")
    differ = [k for k in want if not _bits_equal(got[k], want[k])]
    if differ:
        raise AssertionError(f"restart: {len(differ)} of {len(want)} leaves "
                             f"differ, e.g. {differ[:4]}")
    if [r["loss"] for r in again.history] != want_losses[start:]:
        raise AssertionError("restart: losses differ")
    ran = RESTART_STEPS + (RESTART_STEPS - start)
    if launches != {"bitunpack": ran, "filter_agg": 0, "block_agg": 0,
                    "flash_fwd": 0}:
        raise AssertionError(f"restart launches {launches}")
    saves = tr.ckpts.timings + again.ckpts.timings
    handoff = [r["ckpt_s"] for r in tr.history + again.history
               if "ckpt_s" in r]
    nbytes = saves[0]["bytes"]
    res = {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
           "steps": RESTART_STEPS, "ckpt_every": RESTART_EVERY,
           "restored_step": start, "leaves": len(want),
           "bit_equal_leaves": len(want) - len(differ),
           "losses": want_losses, "ckpt_bytes": nbytes,
           "saves": saves, "handoff_s": handoff,
           "save_GB_per_s": [r["bytes"] / (r["snapshot_s"] + r["write_s"])
                             / 1e9 for r in saves],
           "restore_s": restore_s,
           "restore_GB_per_s": nbytes / restore_s / 1e9,
           "peak_mem_GB": torch.cuda.max_memory_allocated(dev) / 1e9,
           "launches": launches}
    print("train restart: " + json.dumps(res), flush=True)
    print(f"train restart: {cfg.name} {cfg.n_layers} layers, {n_params} "
          f"params, checkpoint {nbytes} B: saves "
          + ", ".join(f"{r['snapshot_s'] + r['write_s']:.3f} s" for r in saves)
          + f" (snapshot + write; {min(res['save_GB_per_s']):.3f}-"
          f"{max(res['save_GB_per_s']):.3f} GB/s), restore of step {start} "
          f"{restore_s:.3f} s ({res['restore_GB_per_s']:.3f} GB/s); steps "
          f"{start}->{RESTART_STEPS} again: {len(want)} of {len(want)} "
          f"leaves of params, m and v bit-equal  [{card}]", flush=True)
    del tr, again, state, model, want, got
    return res


def _flash_grads(attention, q, k, v, dout, impl: str):
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = attention.flash_attention(q, k, v, causal=True, impl=impl)
    return torch.autograd.grad(out, (q, k, v), dout)


def flash_path(P, dev, seed: int, card: str, shape=FLASH_SHAPE,
               tag: str = "flash backward") -> dict:
    """The flash backward (the ``torch.autograd.Function``) against
    autograd through the checkpointed forward loop (``impl="scan"``) at
    one full-width layer's shapes, causal, in float32 (gated at
    ``FLASH_TOL``) and bf16 (printed); both timed, forward + backward."""
    _free_card()
    B, S, H, K, hd = shape
    res = {"shape": {"B": B, "S": S, "H": H, "K": K, "hd": hd}}
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, dout = (torch.randn(shape, generator=gen, device=dev,
                                     dtype=dtype)
                         for shape in ((B, S, H, hd), (B, S, K, hd),
                                       (B, S, K, hd), (B, S, H, hd)))
        got, want = {}, {}
        for impl in ("vjp", "scan"):
            torch.cuda.reset_peak_memory_stats(dev)
            grads = _flash_grads(P.attention, q, k, v, dout, impl)
            torch.cuda.synchronize(dev)
            want[impl] = (grads, torch.cuda.max_memory_allocated(dev) / 1e9)
        errs = {n: float((a.float() - b.float()).abs().max())
                for n, a, b in zip("qkv", want["vjp"][0], want["scan"][0])}
        ok = all(torch.allclose(a.float(), b.float(), rtol=FLASH_TOL,
                                atol=FLASH_TOL)
                 for a, b in zip(want["vjp"][0], want["scan"][0]))
        for impl in ("vjp", "scan"):
            got[impl] = cuda_ms(
                lambda impl=impl: _flash_grads(P.attention, q, k, v, dout,
                                               impl), 3)
        name = str(dtype).removeprefix("torch.")
        res[name] = {"max_abs_err": errs, "within_tol": ok,
                     "vjp_ms": got["vjp"], "scan_ms": got["scan"],
                     "vjp_peak_GB": want["vjp"][1],
                     "scan_peak_GB": want["scan"][1]}
        del q, k, v, dout, want
        if dtype == torch.float32 and not ok:
            raise AssertionError(f"{tag}: vjp vs scan {errs} "
                                 f"outside rtol/atol {FLASH_TOL}")
    print(f"{tag}: " + json.dumps(res), flush=True)
    for name in ("float32", "bfloat16"):
        r = res[name]
        print(f"{tag} {name} (B {B}, S {S}, H {H}, K {K}, hd {hd},"
              f" causal): dq/dk/dv max |vjp - scan| "
              f"{max(r['max_abs_err'].values())!r}"
              + (f" (gate {FLASH_TOL})" if name == "float32" else
                 " (printed, no gate)")
              + f"; forward + backward vjp {r['vjp_ms']:.3f} ms "
              f"({r['vjp_peak_GB']:.3f} GB peak), scan {r['scan_ms']:.3f} ms"
              f" ({r['scan_peak_GB']:.3f} GB)  [{card}]", flush=True)
    return res


def moe_paths(P, dev, seed: int, card: str) -> dict:
    """deepseek_v2_lite_16b: served whole in bf16, its float32 invariant
    and training at full width on its dense layer and 5 MoE layers."""
    out = {"moe serve": moe_serve_path(P, dev, seed, card)}
    out["moe invariant"] = moe_invariant_path(P, dev, seed, card)
    out["moe train"] = train_path(P, dev, seed, card, arch=MOE_ARCH,
                                  layers=MOE_TRAIN_LAYERS, tag="moe train",
                                  why=MOE_TRAIN_WHY)
    return out


# --------------------------------------------------------------------------
# the recurrent families: rwkv6_3b and zamba2_2p7b
# --------------------------------------------------------------------------


def _cache_bytes(shapes: dict) -> int:
    return sum(v.numel() * v.element_size() for k, v in shapes.items()
               if k != "pos")


def _f32_invariant(P, cfg, dev, seed: int, card: str, layers: int,
                   split: tuple[int, int]) -> dict:
    """The prefill/decode invariant of ``cfg`` at ``layers`` layers in
    float32, printed; the bf16 model must be freed first."""
    model, init_s = _seeded(P, dataclasses.replace(_f32(cfg),
                                                   n_layers=layers),
                            dev, seed)
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    inv = _invariant(P, model, dev, *split, seed)
    inv.update(layers=layers, init_s=init_s, weight_bytes=nbytes,
               peak_mem_GB=torch.cuda.max_memory_allocated(dev) / 1e9)
    del model
    _free_card()
    gate = f"within {INVARIANT_TOL}: {inv['within_2e-2']}"
    print(f"{cfg.name} serve invariant (float32, {layers} layers): "
          + json.dumps(inv), flush=True)
    print(f"{cfg.name} invariant: float32 at {layers} of {cfg.n_layers} "
          f"layers ({nbytes} B of weights), prefill {split[0]} + "
          f"{split[1]} decode steps against prefill of {sum(split)}, batch "
          f"2: max |err| {inv['max_abs_err']!r} of logits up to "
          f"{inv['max_abs_logit']:.4f}, {gate}; {inv['wall_s']:.3f} s, "
          f"peak {inv['peak_mem_GB']:.3f} GB  [{card}]", flush=True)
    return inv


def recurrent_serve_path(P, dev, seed: int, card: str, arch: str) -> dict:
    """``arch`` at full width and depth in bf16 through ``ServeEngine``,
    as the yi_9b phase runs it (the recurrent states parked whole,
    zamba's k / v in pages); the decode step beside its memory bound;
    the bf16 invariant printed; then the float32 invariant at
    ``SSM_F32_LAYERS`` gated at ``INVARIANT_TOL`` (the bf16 model freed
    first)."""
    _free_card()
    cfg = P.configs.get_config(arch)
    model, init_s = _seeded(P, cfg, dev, seed)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    # no attention (rwkv6), or heads of 80 (zamba2's shared block)
    res = _serve_run(P, cfg, model, dev, seed, card, flash=0)
    res["init_s"] = init_s
    cache = res["kv_bytes"] - 4
    want = _cache_bytes(model.abstract_cache(SERVE_BATCH, SERVE_MAX_SEQ)[0])
    if cache != want:
        raise AssertionError(f"{arch} serve: cache {cache} B, want {want}")
    res["decode_bound_ms"] = decode_bound_ms(model, cache)
    print(f"{arch} serve: decode {res['decode_ms_per_step']:.3f} ms per "
          f"step against a {res['decode_bound_ms']:.3f} ms bound at 3.35 "
          f"TB/s ({weights} B of weights and the {cache} B cache read "
          f"once)  [{card}]", flush=True)
    res["invariant_bf16"] = _invariant(P, model, dev, *SSM_INVARIANT_BF16,
                                       seed)
    print(f"{arch} serve invariant (bf16, no gate): "
          + json.dumps(res["invariant_bf16"]), flush=True)
    del model
    _free_card()
    layers = SSM_F32_LAYERS[arch]
    inv = _f32_invariant(P, cfg, dev, seed, card, layers, INVARIANT_F32)
    res["invariant_f32"] = inv
    print(f"reduced: {arch} float32 invariant gated at {layers} of "
          f"{cfg.n_layers} layers: {SSM_F32_WHY[arch]}")
    shape = P.configs.SHAPES["decode_32k"]
    B, S = shape.global_batch, shape.seq_len
    need = _cache_bytes(P.archs.build_model(cfg, device="meta")
                        .abstract_cache(B, S)[0])
    print(f"reduced: {arch} serve at batch {SERVE_BATCH}, prompts of "
          f"{SERVE_PROMPT[0]}-{SERVE_PROMPT[1]} tokens, {SERVE_MAX_SEQ} "
          f"cache slots; decode_32k is a batch of {B} x {S} tokens, whose "
          f"cache is {need / 1e9:.2f} GB beside {weights / 1e9:.2f} GB of "
          + ("weights: it would fit, but its prefill of "
             f"{B * S} tokens does not fit the script's time"
             if need + weights < 70e9 else
             "weights, more than one card's 80 GB"))
    if not (inv["finite"] and inv["within_2e-2"]):
        raise AssertionError(f"{arch}: float32 prefill/decode invariant "
                             f"fails rtol/atol {INVARIANT_TOL}: {inv}")
    return res


def ssm_paths(P, dev, seed: int, card: str) -> dict:
    """rwkv6_3b and zamba2_2p7b: each served whole in bf16, its float32
    invariant gated, and trained at full width."""
    out = {}
    for arch in SSM_ARCHS:
        out[f"{arch} serve"] = recurrent_serve_path(P, dev, seed, card,
                                                    arch)
        out[f"{arch} train"] = train_path(
            P, dev, seed, card, arch=arch, layers=SSM_TRAIN_LAYERS[arch],
            tag=f"{arch} train", why=SSM_TRAIN_WHY[arch])
    return out


# --------------------------------------------------------------------------
# multi-device on one card: two gloo ranks on cuda:0
# --------------------------------------------------------------------------


def _param_digest(model) -> torch.Tensor:
    """Two position-weighted 64-bit sums of each parameter's bits, in
    2^24-element chunks: equal on two ranks when their params are."""
    out = []
    for p in model.parameters():
        flat = p.detach().reshape(-1)
        flat = flat.view(torch.int16 if p.element_size() == 2
                         else torch.int32)
        h = torch.zeros(2, dtype=torch.int64, device=p.device)
        for i in range(0, flat.numel(), 1 << 24):
            x = flat[i:i + (1 << 24)].to(torch.int64)
            w = torch.arange(i, i + x.numel(), device=p.device) \
                % 1_000_003 + 1
            h[0] += x.sum()
            h[1] += (x * w).sum()
        out.append(h)
    return torch.stack(out).cpu()


def _md_host_leaves(model) -> list[str]:
    """The parameters whose synced gradient the host recomputes: every
    reference leaf (its layers together) of at most ``MD_HOST_NUMEL``
    elements a layer: the norms and the attention projections."""
    return [n for n, p in model.named_parameters()
            if p.numel() <= MD_HOST_NUMEL]


def _md_train(P, rank: int, tmp: Path, seed: int) -> dict:
    """(a): yi_9b at full width, ``MD_LAYERS`` layers, on a (pod 2,
    data 1, model 1) mesh through ``make_compressed_train_step`` fed by
    packed ingest: each rank's half of every batch."""
    from repro_torch.distributed import compression
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as lmesh

    dev = torch.device(DEVICE)
    mesh = lmesh.make_smoke_mesh((MD_RANKS, 1, 1), ("pod", "data", "model"))
    pod = mesh.get_coordinate()[0]
    rules = shd.MeshRules(mesh, strategy="megatron_sp")
    cfg = dataclasses.replace(P.configs.get_config(TRAIN_ARCH),
                              n_layers=MD_LAYERS)
    model = P.archs.build_model(cfg, remat="full", device=dev)
    t = time.perf_counter()
    store, vol, _ = _train_world(P, cfg, seed)
    world_s = time.perf_counter() - t
    host = _md_host_leaves(model)
    digests, saved = [], {}

    def copy(t: torch.Tensor) -> np.ndarray:
        t = t.detach()
        return (t.float() if t.is_floating_point() else t).to(
            "cpu", copy=True).numpy()

    def observe(grads, err, synced, sums):
        for n in host:
            saved.update({f"g/{n}": copy(grads[n]), f"e/{n}": copy(err[n]),
                          f"synced/{n}": copy(synced[n]),
                          f"tot/{n}": copy(sums[n][0]),
                          f"s_tot/{n}": copy(sums[n][1])})

    try:
        loader = P.pipeline.ObjectDataLoader(
            vol, "corpus", global_batch=TRAIN_BATCH, dp_rank=pod,
            dp_size=MD_RANKS, seed=seed, packed=True, prefetch=2)
        opt = P.optimizer.OptConfig(lr=TRAIN_LR,
                                    warmup_steps=max(MD_STEPS // 10, 2),
                                    total_steps=MD_STEPS)
        step = compression.make_compressed_train_step(model, opt, rules)
        calls = []

        def step_fn(state, batch):
            calls.append(1)
            return step(state, batch, observe=observe
                        if len(calls) == MD_CHECK_STEP else None)

        tr = P.trainer.Trainer(
            model, loader, store, opt=opt,
            cfg=P.trainer.TrainerConfig(total_steps=MD_STEPS,
                                        ckpt_every=MD_STEPS + 1,
                                        log_every=MD_STEPS,
                                        packed_ingest=True),
            step_fn=step_fn, log=lambda msg: None)
        state, _ = tr.init_or_restore(seed)
        state = compression.init_compressed_state(state)
        _sync(dev)

        def on_step(n: int) -> None:
            digests.append(_param_digest(model))
            if n == MD_CHECK_STEP:
                saved.update({f"e_new/{k}": copy(state["err"][k][0])
                              for k in host})

        _zero_counts(P)                  # the path's run starts here
        tr.run(state, start_step=0, on_step=on_step)
        launches = _counts(P)            # ... and ends here
        peak = torch.cuda.max_memory_allocated(dev)
        tr.loader.close()
    finally:
        store.close()
    np.savez(tmp / f"check{rank}.npz", **saved)
    n_elems = sum(p.numel() for p in model.parameters())
    n_leaves = len({P.transformer.reference_path(n)[0]
                    for n, _ in model.named_parameters()})
    return {"pod": pod, "params": n_elems, "losses": [
        r["loss"] for r in tr.history], "step_s": [
        r["wall_s"] for r in tr.history], "grad_norms": [
        r["grad_norm"] for r in tr.history],
        "digests": [d.tolist() for d in digests],
        "hop_bytes_per_step": 4 * n_elems + 4 * n_leaves,
        "reference_leaves": n_leaves, "corpus_write_s": world_s,
        "peak_mem_GB": peak / 1e9, "launches": launches,
        "host_leaves": host}


def _md_moe(P, rank: int, seed: int) -> dict:
    """(b): one deepseek_v2_lite_16b MoE layer at full width under fsdp
    on (data 2): each rank's output against the single-card math on its
    tokens with the whole weights."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models.layers import dense_init_
    from repro_torch.models.transformer import PARAM_SPECS, fan_in

    dev = torch.device(DEVICE)
    mesh = lmesh.make_smoke_mesh((MD_RANKS,), ("data",))
    rules = shd.MeshRules(mesh, strategy="fsdp")
    cfg = P.configs.get_config(MOE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(seed)
    whole = P.moe.init_moe(cfg, device=dev)
    for k, w in whole.items():
        dense_init_(w, fan_in("moe", k, w.shape), gen)
    x = (torch.randn(MD_MOE_TOKENS + (cfg.d_model,), generator=gen,
                     device=dev) * 0.5).to(cfg.compute_dtype)
    local = {k: shd.local_shard(w.detach(), rules.sharding(
        *PARAM_SPECS[("moe", k)])) for k, w in whole.items()}
    xs = shd.local_shard(x, rules.sharding("tokens", None, None))
    T = xs.shape[0] * xs.shape[1]
    walls = {}
    with torch.no_grad():
        shared = tuple(whole[k] for k in ("sw1", "sw3", "sw2"))
        for _ in range(2):               # the second call is timed
            _sync(dev)
            t = time.perf_counter()
            want, aux, z = P.moe._moe_math(
                cfg, xs.reshape(T, -1), whole["router"], whole["w1"],
                whole["w3"], whole["w2"], shared)
            _sync(dev)
            walls["single_card_s"] = time.perf_counter() - t
            _sync(dev)
            t = time.perf_counter()
            with shd.use_rules(rules):
                got, total = P.moe.moe_ffn(cfg, local, xs)
            _sync(dev)
            walls["sharded_s"] = time.perf_counter() - t
    mean = torch.stack([aux, z]).float()
    dist.all_reduce(mean, group=mesh.get_group("data"))
    mean = mean / MD_RANKS
    want = want.to(xs.dtype).reshape(xs.shape)
    res = {"tokens": T, "out_equal": bool(torch.equal(got, want)),
           "max_abs_err": float((got.float() - want.float()).abs().max()),
           "aux_plus_zloss": float(total),
           "mean_single_card": float(mean.sum()),
           "local_w1": list(local["w1"].shape), **walls}
    del got, want, local

    # the megatron body on (data 1, model 2) in float32: the sequence
    # all-gathered, each rank its F half, the output reduce-scattered
    mesh = lmesh.make_smoke_mesh((1, MD_RANKS), ("data", "model"))
    rules = shd.MeshRules(mesh, strategy="megatron_sp")
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    w32 = {k: w.detach().float() for k, w in whole.items()}
    del whole
    x32 = x[:1].float()
    local = {k: shd.local_shard(w, rules.sharding(*PARAM_SPECS[("moe", k)]))
             for k, w in w32.items()}
    xs = shd.local_shard(x32, rules.sharding("dp", "act_seq", None))
    with torch.no_grad():
        _sync(dev)
        t = time.perf_counter()
        with shd.use_rules(rules):
            got, _ = P.moe.moe_ffn(cfg32, local, xs)
        _sync(dev)
        res["megatron_s"] = time.perf_counter() - t
        want = P.moe._moe_math(
            cfg32, x32.reshape(-1, cfg.d_model), w32["router"], w32["w1"],
            w32["w3"], w32["w2"], tuple(w32[k] for k in ("sw1", "sw3",
                                                          "sw2")))[0]
    half = want.reshape(x32.shape).chunk(MD_RANKS, dim=1)[
        mesh.get_coordinate()[1]]
    res["megatron"] = {
        "tokens": x32.shape[1], "local_w1": list(local["w1"].shape),
        "max_abs_err": float((got - half).abs().max()),
        "max_abs_out": float(half.abs().max())}
    return res


def _md_rank(rank: int, world: int, init: str, tmp: str, seed: int) -> None:
    import torch.distributed as dist
    P = _load_port()
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        res = {"train": _md_train(P, rank, Path(tmp), seed)}
        _free_card()
        res["moe"] = _md_moe(P, rank, seed)
        (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def _md_host_check(tmp: Path, host: list[str], leaf_of) -> dict:
    """The synced gradient of step ``MD_CHECK_STEP`` recomputed on the
    host from both ranks' local gradients and errors, in numpy: the
    reference's formula with one scale per reference leaf."""
    inv127 = np.float32(1) / np.float32(127)
    ranks = [np.load(tmp / f"check{r}.npz") for r in range(MD_RANKS)]
    groups: dict = {}
    for n in host:
        groups.setdefault(leaf_of(n), []).append(n)
    tot_bad = s_bad = e_bad = 0
    ulps = 0
    elems = 0
    for names in groups.values():
        xs = [{n: r[f"g/{n}"] + r[f"e/{n}"] for n in names} for r in ranks]
        scales = [np.maximum(np.float32(max(np.abs(x[n]).max()
                                            for n in names)) * inv127,
                             np.float32(1e-12)) for x in xs]
        s_tot = np.float32(scales[0] + scales[1])
        for n in names:
            qs = [np.clip(np.rint(x[n] / s), -127, 127)
                  for x, s in zip(xs, scales)]
            tot = (qs[0].astype(np.int32) + qs[1].astype(np.int32))
            dec = (tot.astype(np.float32) * np.float32(s_tot / 2)) \
                / np.float32(2)
            bf = torch.from_numpy(dec).to(torch.bfloat16).float().numpy()
            for r, x, q, s in zip(ranks, xs, qs, scales):
                tot_bad += int((r[f"tot/{n}"] != tot).sum())
                s_bad += int(r[f"s_tot/{n}"] != s_tot)
                e_new = (x[n].astype(np.float64)
                         - q.astype(np.float64) * np.float64(s)
                         ).astype(np.float32)
                e_bad += int((r[f"e_new/{n}"] != e_new).sum())
                got = torch.from_numpy(r[f"synced/{n}"]).to(
                    torch.bfloat16).view(torch.int16).int()
                want = torch.from_numpy(bf).to(torch.bfloat16).view(
                    torch.int16).int()
                ulps = max(ulps, int((got - want).abs().max()))
            elems += tot.size
    return {"elements": elems, "reference_leaves": len(groups),
            "int32_sums_differing": tot_bad, "scale_sums_differing": s_bad,
            "new_errors_differing": e_bad, "synced_max_bf16_ulps": ulps}


def multi_device_path(P, dev, seed: int, card: str) -> dict:
    """Phase 23: ``MD_RANKS`` gloo ranks on this one card (NCCL refuses
    two ranks on one device): (a) the compressed train step, (b) the
    sharded MoE token path.  Collectives on CUDA tensors through gloo."""
    _free_card()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        ctx = torch.multiprocessing.spawn(
            _md_rank, args=(MD_RANKS, f"file://{tmp}/pg", str(tmp), seed),
            nprocs=MD_RANKS, join=False)
        deadline = time.monotonic() + MD_DEADLINE_S
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise AssertionError(f"multi-device: a rank did not "
                                         f"finish in {MD_DEADLINE_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        ranks = [json.loads((tmp / f"rank{r}.json").read_text())
                 for r in range(MD_RANKS)]
        train = [r["train"] for r in ranks]
        check = _md_host_check(
            tmp, train[0]["host_leaves"],
            lambda n: P.transformer.reference_path(n)[0])
    wall = time.perf_counter() - t0
    moe = [r["moe"] for r in ranks]
    launches = {k: sum(t["launches"][k] for t in train) for k in KERNELS}
    same = [a == b for a, b in zip(train[0]["digests"],
                                   train[1]["digests"])]
    res = {"ranks": MD_RANKS, "wall_s": wall, "check_step": MD_CHECK_STEP,
           "host_check": check, "params_equal_after_each_step": same,
           "train": [{k: v for k, v in t.items()
                      if k not in ("digests", "host_leaves")}
                     for t in train],
           "moe": moe, "launches": launches}
    print("multi-device: " + json.dumps(res), flush=True)
    t = train[0]
    print(f"multi-device (a): {TRAIN_ARCH} {MD_LAYERS} layers "
          f"({t['params']} params) on (pod {MD_RANKS}, data 1, model 1), "
          f"{MD_STEPS} packed-ingest steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens, each rank its half: loss {t['losses'][0]:.4f} -> "
          f"{t['losses'][-1]:.4f}; step walls (s) rank 0 "
          f"{[round(w, 4) for w in t['step_s']]}, rank 1 "
          f"{[round(w, 4) for w in train[1]['step_s']]}; pod hop "
          f"{t['hop_bytes_per_step']} B a rank a step (int32 sums of "
          f"{t['params']} elements + {t['reference_leaves']} float32 "
          f"scales; int8 would be {t['params'] + 4 * t['reference_leaves']}"
          f" B); params equal across ranks after each step: {same}; step "
          f"{MD_CHECK_STEP} recomputed on the host over "
          f"{check['elements']} elements: {check}; peak memory "
          f"{[round(x['peak_mem_GB'], 3) for x in train]} GB; bitunpack "
          f"launches {[x['launches']['bitunpack'] for x in train]}  "
          f"[{card}]", flush=True)
    print(f"multi-device (b): {MOE_ARCH} MoE layer at full width under "
          f"fsdp on (data {MD_RANKS}), {moe[0]['tokens']} tokens a rank, "
          f"w1 shard {moe[0]['local_w1']}: output equal to the single-card "
          f"math {[m['out_equal'] for m in moe]} (max |err| "
          f"{[m['max_abs_err'] for m in moe]}), aux + zloss "
          f"{moe[0]['aux_plus_zloss']!r} against the ranks' mean "
          f"{moe[0]['mean_single_card']!r}; sharded "
          f"{[round(m['sharded_s'], 4) for m in moe]} s, single card "
          f"{[round(m['single_card_s'], 4) for m in moe]} s; the "
          f"megatron body in float32 on (data 1, model {MD_RANKS}), "
          f"{moe[0]['megatron']['tokens']} tokens, w1 shard "
          f"{moe[0]['megatron']['local_w1']}: max |err| against the "
          f"single-card math "
          f"{[m['megatron']['max_abs_err'] for m in moe]} of outputs up to "
          f"{moe[0]['megatron']['max_abs_out']:.4f} (gate {MD_MEGATRON_TOL}"
          f" of that), {[round(m['megatron_s'], 4) for m in moe]} s; phase "
          f"{wall:.1f} s  [{card}]", flush=True)
    print(f"reduced: multi-device at {MD_LAYERS} of {TRAIN_ARCH}'s 48 "
          f"layers and {MD_STEPS} steps, 2 ranks sharing one card (the "
          f"production mesh is (2, 16, 16)); one MoE layer of 26")
    if launches != {"bitunpack": MD_RANKS * MD_STEPS, "filter_agg": 0,
                    "block_agg": 0, "flash_fwd": 0}:
        raise AssertionError(f"multi-device launches {launches}")
    for x in train:
        if x["launches"]["bitunpack"] != MD_STEPS:
            raise AssertionError(f"multi-device: rank launches {x}")
        if not all(np.isfinite(x["losses"])) or \
                not x["losses"][-1] < x["losses"][0]:
            raise AssertionError(f"multi-device: losses {x['losses']}")
    if len(same) != MD_STEPS or not all(same):
        raise AssertionError(f"multi-device: params differ across ranks "
                             f"{same}")
    if check["int32_sums_differing"] or check["scale_sums_differing"] \
            or check["new_errors_differing"] \
            or check["synced_max_bf16_ulps"] > 1:
        raise AssertionError(f"multi-device: host recomputation {check}")
    for m in moe:
        if not m["out_equal"]:
            raise AssertionError(f"multi-device: sharded MoE {m}")
        meg = m["megatron"]
        if not meg["max_abs_err"] <= MD_MEGATRON_TOL * meg["max_abs_out"]:
            raise AssertionError(f"multi-device: megatron body {meg}")
        if abs(m["aux_plus_zloss"] - m["mean_single_card"]) \
                > 1e-6 * abs(m["mean_single_card"]):
            raise AssertionError(f"multi-device: MoE aux {m}")
    return res


def _fs_whole(P, model, tree: dict, rules) -> dict:
    """Each leaf of ``tree`` (a rank's blocks, by parameter name) whole,
    on the card (compared there: on the host the comparisons took most
    of the phase)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.train import steps

    specs = steps.param_specs(model)
    params = dict(model.named_parameters())
    return {n: shd.gather_whole(t.detach(), shd.fitted(
        rules, specs[n], params[n].fsdp_shape), rules)
        for n, t in tree.items()}


def _fs_close(got: dict, want: dict, tol: dict, outliers: float = 0.0,
              bound: float = 0.0) -> dict:
    """(max |err|, entries outside ``tol``, entries in all) of two trees;
    ``ok`` when at most ``outliers`` of the entries leave ``tol``, each by
    no more than ``bound``."""
    worst, bad, n, ok = 0.0, 0, 0, True
    for k, w in want.items():
        g = got[k].float()
        w = w.float()
        off = ~torch.isclose(g, w, **tol)
        err = (g - w).abs()
        worst = max(worst, float(err.max()))
        bad += int(off.sum())
        n += w.numel()
        if off.any() and float(err[off].max()) > bound:
            ok = False
    return {"max_abs_err": worst, "outside_tol": bad, "entries": n,
            "ok": ok and bad <= outliers * n}


def _fs_batches(P, vol, rank: int, seed: int, steps: int,
                dp_size: int = FS_RANKS) -> list:
    """This rank's packed words of the first ``steps`` global batches
    (``TRAIN_BATCH`` sequences, each of ``dp_size`` ranks its part)."""
    from repro_torch.train.trainer import _on_device

    loader = P.pipeline.ObjectDataLoader(
        vol, "corpus", global_batch=TRAIN_BATCH, dp_rank=rank,
        dp_size=dp_size, seed=seed, packed=True, prefetch=2)
    try:
        return [_on_device(next(loader), DEVICE)["tokens_packed"]
                for _ in range(steps)]
    finally:
        loader.close()


def _fs_f32(P, rules, words: list, seed: int) -> dict:
    """(a): yi_9b, ``FS_F32_LAYERS`` layer at full width in float32,
    ``FS_F32_STEPS`` steps on each rank's first sequence cut to
    ``FS_F32_SEQ`` tokens; then, on every rank, the unsharded steps from
    the same seed on both ranks' tokens, and the rank's blocks of its
    params, ``m`` and ``v`` held against the same blocks of the unsharded
    state (cut on the card, no gather)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.train import steps

    dev = torch.device(DEVICE)
    cfg = dataclasses.replace(P.configs.get_config(TRAIN_ARCH),
                              n_layers=FS_F32_LAYERS,
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    opt = P.optimizer.OptConfig(lr=TRAIN_LR, warmup_steps=2,
                                total_steps=FS_F32_STEPS)
    model = P.archs.build_model(cfg, remat="full", device=dev)
    state = steps.init_train_state(
        model, torch.Generator(device=dev).manual_seed(seed))
    state = steps.shard_train_state(model, state, rules)
    step = steps.make_train_step(model, opt)
    group = rules.mesh.get_group("data")
    tokens, losses = [], []
    with shd.use_rules(rules):
        for w in words[:FS_F32_STEPS]:
            batch = P.ingest.fused_batch(w[:1, :FS_F32_SEQ // 32])
            tokens.append(shd.all_gather_dim(batch["tokens"], 0, group))
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    cuts = {n: rules.named(shd.fitted(rules, p.fsdp_spec, p.fsdp_shape))
            for n, p in state["params"].items()}
    got = {"params": {n: p.detach() for n, p in state["params"].items()},
           "m": state["opt"]["m"], "v": state["opt"]["v"]}
    del model, state, step
    _free_card()
    model = P.archs.build_model(cfg, remat="full", device=dev)
    state = steps.init_train_state(
        model, torch.Generator(device=dev).manual_seed(seed))
    step = steps.make_train_step(model, opt)
    want_losses = []
    for t in tokens:
        state, m = step(state, {"tokens": t,
                                "labels": P.ingest.derive_labels(t)})
        want_losses.append(float(m["loss"]))

    def blocks(tree: dict) -> dict:
        return {n: shd.local_shard(t.detach(), cuts[n])
                for n, t in tree.items()}

    moved = 2 * TRAIN_LR * FS_F32_STEPS
    res = {"losses": losses, "tokens": list(tokens[0].shape),
           "unsharded_losses": want_losses,
           "params": _fs_close(got["params"], blocks(state["params"]),
                               FS_TRAIN_TOL, 1e-3, moved),
           "m": _fs_close(got["m"], blocks(state["opt"]["m"]),
                          FS_TRAIN_TOL),
           "v": _fs_close(got["v"], blocks(state["opt"]["v"]),
                          FS_TRAIN_TOL)}
    del model, state, step, got
    _free_card()
    return res


def _fs_merge(parts: list) -> dict:
    """The ranks' ``_fs_close`` results of their blocks as one."""
    return {"max_abs_err": max(x["max_abs_err"] for x in parts),
            "outside_tol": sum(x["outside_tol"] for x in parts),
            "entries": sum(x["entries"] for x in parts),
            "ok": all(x["ok"] for x in parts)}


def _fs_trainer(P, model, store, vol, rules, seed: int, total: int,
                every: int, step_fn):
    """A sharded packed-ingest ``Trainer`` of this rank: a loader of its
    rows of every ``TRAIN_BATCH`` batch, the phase's lr and schedule."""
    import torch.distributed as dist

    loader = P.pipeline.ObjectDataLoader(
        vol, "corpus", global_batch=TRAIN_BATCH, dp_rank=dist.get_rank(),
        dp_size=FS_RANKS, seed=seed, packed=True, prefetch=2)
    opt = P.optimizer.OptConfig(lr=CUT_LR, warmup_steps=2,
                                total_steps=FS_BF16_STEPS)
    cfg = P.trainer.TrainerConfig(total_steps=total, ckpt_every=every,
                                  ckpt_keep=2, log_every=FS_BF16_STEPS,
                                  packed_ingest=True)
    return P.trainer.Trainer(model, loader, store, opt=opt, cfg=cfg,
                             step_fn=step_fn, rules=rules,
                             log=lambda msg: None)


def _fs_whole_check(P, cfg, store, vol, whole: dict, seed: int) -> dict:
    """(b), the writer: the step-``FS_CKPT_STEP`` checkpoint restored
    whole on the card by the unsharded ``Trainer``, every leaf held
    bit-equal to ``whole`` (the sharded state gathered, on the host)."""
    dev = torch.device(DEVICE)
    model = P.archs.build_model(cfg, remat="full", device=dev)
    loader = P.pipeline.ObjectDataLoader(vol, "corpus",
                                         global_batch=TRAIN_BATCH,
                                         seed=seed, packed=True)
    single = P.trainer.Trainer(
        model, loader, store, cfg=P.trainer.TrainerConfig(
            total_steps=FS_CKPT_STEP, packed_ingest=True),
        log=lambda msg: None)
    _sync(dev)
    t = time.perf_counter()
    state, step = single.init_or_restore(seed)
    _sync(dev)
    restore_s = time.perf_counter() - t
    loader.close()
    want = {part: P.transformer._reference_leaves(model, tree) for part, tree
            in (("params", whole["params"]), ("m", whole["opt"]["m"]),
                ("v", whole["opt"]["v"]))}
    differ, n = [], 0
    for k, t in _state_leaves(state).items():
        part, name = k.split("/", 1)
        n += 1
        if not _bits_equal(t, want[part][name].to(dev)):
            differ.append(k)
    if int(state["opt"]["step"]) != int(whole["opt"]["step"]):
        differ.append("step")
    nbytes = sum(t.numel() * t.element_size()
                 for t in _state_leaves(state).values())
    del model, state, single, want
    _free_card()
    return {"step": step, "restore_s": restore_s, "bytes": nbytes,
            "leaves": n, "differ": differ[:8], "n_differ": len(differ)}


def _fs_bf16(P, rules, store, vol, seed: int) -> dict:
    """(b): yi_9b, ``FS_BF16_LAYERS`` layers at full width in bf16,
    through the sharded ``Trainer`` with packed ingest, under
    deterministic algorithms: ``FS_CKPT_STEP`` steps and a checkpoint,
    the checkpoint restored whole on the card by the unsharded Trainer
    (the writer) against the gathered state, the steps on to
    ``FS_BF16_STEPS``; then fresh models and Trainers restored from the
    checkpoint and run to ``FS_BF16_STEPS``, every rank's blocks
    bit-equal to the uninterrupted run's.  Steps timed, with the
    collective bytes of each."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding as shd
    from repro_torch.train import steps

    dev = torch.device(DEVICE)
    writer = dist.get_rank() == 0
    cfg = dataclasses.replace(P.configs.get_config(TRAIN_ARCH),
                              n_layers=FS_BF16_LAYERS)
    opt = P.optimizer.OptConfig(lr=CUT_LR, warmup_steps=2,
                                total_steps=FS_BF16_STEPS)
    moved: list[dict] = []

    def recorded(model):
        step = steps.make_train_step(model, opt)

        def step_fn(state, batch):
            shd.reset_collective_bytes()
            out = step(state, batch)
            moved.append(dict(shd.COLLECTIVE_BYTES))
            return out
        return step_fn

    _free_card()
    dist.barrier()                       # rank 0 ran (a)'s unsharded step
    torch.use_deterministic_algorithms(True)
    try:
        _zero_counts(P)                  # the path's run starts here
        model = P.archs.build_model(cfg, remat="full", device=dev)
        n_params = sum(p.numel() for p in model.parameters())
        step_fn = recorded(model)
        first = _fs_trainer(P, model, store, vol, rules, seed, FS_CKPT_STEP,
                            FS_CKPT_STEP, step_fn)
        state, _ = first.init_or_restore(seed)
        local = sum(p.numel() for p in model.parameters())
        state = first.run(state, start_step=0)     # waits for the save
        whole = P.transformer.sharded_state_to_reference(state, rules,
                                                         writer)
        check = _fs_whole_check(P, cfg, store, vol, whole, seed) \
            if writer else None
        del whole
        dist.barrier()
        rest = _fs_trainer(P, model, store, vol, rules, seed, FS_BF16_STEPS,
                           FS_BF16_STEPS + 1, step_fn)
        state = rest.run(state, start_step=FS_CKPT_STEP)
        peak = torch.cuda.max_memory_allocated(dev)
        want = {k: t.clone() for k, t in _state_leaves(state).items()}
        history = first.history + rest.history
        saves = first.ckpts.timings
        first.loader.close()
        rest.loader.close()
        del model, state, first, rest, step_fn
        _free_card()
        model = P.archs.build_model(cfg, remat="full", device=dev)
        again = _fs_trainer(P, model, store, vol, rules, seed, FS_BF16_STEPS,
                            FS_BF16_STEPS + 1, recorded(model))
        _sync(dev)
        t = time.perf_counter()
        state, start = again.init_or_restore(seed)
        _sync(dev)
        restore_s = time.perf_counter() - t
        state = again.run(state, start_step=start)
        again.loader.close()
        launches = _counts(P)            # ... and ends here
        got = _state_leaves(state)
        differ = [k for k in want if not _bits_equal(got[k], want[k])]
        n_leaves = len(want) if sorted(got) == sorted(want) else -1
        relosses = [r["loss"] for r in again.history]
    finally:
        torch.use_deterministic_algorithms(False)
    del model, state, again, got, want
    _free_card()
    return {"params": n_params, "local_params": local,
            "step_s": [r["wall_s"] for r in history],
            "losses": [r["loss"] for r in history],
            "bytes": moved[:FS_BF16_STEPS], "peak_mem_GB": peak / 1e9,
            "saves": saves, "restored_step": start,
            "restore_s": restore_s, "restart_losses": relosses,
            "leaves": n_leaves,
            "differ": differ[:8], "n_differ": len(differ),
            "whole_check": check, "launches": launches}


def _fs_moe(P, rules, words: list, seed: int) -> dict:
    """(c): deepseek_v2_lite_16b's dense layer and one MoE layer at full
    width in float32, capacity n_routed / top_k: one step's gradients
    under FSDP, gathered, against the single-card gradients of each
    rank's tokens with the whole weights, averaged (rank 0)."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding as shd
    from repro_torch.train import steps

    dev = torch.device(DEVICE)
    base = P.configs.get_config(MOE_ARCH)
    cfg = dataclasses.replace(
        base, n_layers=FS_MOE_LAYERS, param_dtype=torch.float32,
        compute_dtype=torch.float32, moe=dataclasses.replace(
            base.moe, capacity_factor=base.moe.n_routed / base.moe.top_k))
    model = P.archs.build_model(cfg, remat="full", device=dev)
    state = steps.init_train_state(
        model, torch.Generator(device=dev).manual_seed(seed))
    state = steps.shard_train_state(model, state, rules)
    batch = P.ingest.fused_batch(words[0][:1, :FS_MOE_SEQ // 32])
    tokens = shd.all_gather_dim(batch["tokens"], 0,
                                rules.mesh.get_group("data"))
    params = state["params"]
    _sync(dev)
    t = time.perf_counter()
    with shd.use_rules(rules):
        loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
    _sync(dev)
    res = {"fsdp_s": time.perf_counter() - t, "tokens": list(tokens.shape),
           "aux_loss": float(metrics["aux_loss"]),
           "loss": float(metrics["loss"])}
    with shd.use_rules(rules):
        got = _fs_whole(P, model, dict(zip(params, grads)), rules)
    del model, state, grads, params
    _free_card()
    if dist.get_rank() == 0:
        model = P.archs.build_model(cfg, remat="full", device=dev)
        model.init(torch.Generator(device=dev).manual_seed(seed))
        params = dict(model.named_parameters())
        want = {n: torch.zeros_like(p) for n, p in params.items()}
        _sync(dev)
        t = time.perf_counter()
        for row in tokens:
            t1 = row[None]
            loss, _ = model.loss({"tokens": t1,
                                  "labels": P.ingest.derive_labels(t1)})
            for n, g in zip(params, torch.autograd.grad(
                    loss, list(params.values()))):
                want[n] += g / FS_RANKS
        _sync(dev)
        res["single_card_s"] = time.perf_counter() - t
        res["grads"] = _fs_close(got, want, FS_MOE_TOL)
        del model, params
    del got
    _free_card()
    return res


def _fs_rank(rank: int, world: int, init: str, tmp: str, seed: int) -> None:
    import torch.distributed as dist
    P = _load_port()
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        from repro_torch.distributed import sharding as shd
        from repro_torch.launch import mesh as lmesh

        mesh = lmesh.make_smoke_mesh((FS_RANKS, 1), ("data", "model"))
        rules = shd.MeshRules(mesh, strategy="fsdp")
        store = P.core.make_store(8, replicas=2)
        try:
            vol = P.core.GlobalVOL(store)
            P.corpus.build_corpus(vol, P.corpus.CorpusSpec(
                n_seqs=FS_CORPUS_SEQS, seq_len=TRAIN_SEQ,
                vocab_size=P.configs.get_config(TRAIN_ARCH).vocab_size,
                seed=seed), chunk_rows=FS_CORPUS_SEQS)
            words = _fs_batches(P, vol, rank, seed, FS_F32_STEPS)
            walls = {}
            t = time.perf_counter()
            _zero_counts(P)
            res = {"f32": _fs_f32(P, rules, words, seed)}
            res["f32"]["launches"] = _counts(P)
            walls["a_s"] = time.perf_counter() - t
            t = time.perf_counter()
            res["bf16"] = _fs_bf16(P, rules, store, vol, seed)
            walls["b_s"] = time.perf_counter() - t
        finally:
            store.close()
        t = time.perf_counter()
        _zero_counts(P)
        res["moe"] = _fs_moe(P, rules, words, seed)
        res["moe"]["launches"] = _counts(P)
        walls["c_s"] = time.perf_counter() - t
        res["walls"] = walls
        (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def _spawned(fn, ranks: int, seed: int, deadline_s: float, what: str
             ) -> list:
    """Run ``fn(rank, world, init, tmp, seed)`` in ``ranks`` spawned
    processes; each writes ``rank{r}.json``, returned in rank order."""
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        ctx = torch.multiprocessing.spawn(
            fn, args=(ranks, f"file://{tmp}/pg", str(tmp), seed),
            nprocs=ranks, join=False)
        deadline = time.monotonic() + deadline_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise AssertionError(f"{what}: a rank did not finish "
                                         f"in {deadline_s} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        return [json.loads((tmp / f"rank{r}.json").read_text())
                for r in range(ranks)]


def fsdp_path(P, dev, seed: int, card: str) -> dict:
    """Phase 24: ``FS_RANKS`` gloo ranks on this one card run the train
    step with its state sharded ZeRO-3 style (``train.steps.
    shard_train_state`` under ``MeshRules(strategy="fsdp")``), (b)
    through the sharded ``Trainer`` and its checkpoints."""
    _free_card()
    t0 = time.perf_counter()
    ranks = _spawned(_fs_rank, FS_RANKS, seed, FS_DEADLINE_S, "fsdp")
    wall = time.perf_counter() - t0
    a = dict(ranks[0]["f32"], **{k: _fs_merge([r["f32"][k] for r in ranks])
                                 for k in ("params", "m", "v")})
    b = [r["bf16"] for r in ranks]
    c = ranks[0]["moe"]
    per_step = [{k: v for k, v in x.items() if v} for x in b[0]["bytes"]]
    launches = {k: sum(x["launches"][k] for x in b) for k in KERNELS}
    res = {"ranks": FS_RANKS, "wall_s": wall, "f32": a, "bf16": b,
           "moe": c, "launches": launches}
    print("fsdp: " + json.dumps(res), flush=True)
    print(f"fsdp (a): {TRAIN_ARCH} {FS_F32_LAYERS} layer in float32 under "
          f"fsdp on (data {FS_RANKS}, model 1), {FS_F32_STEPS} steps of "
          f"{a['tokens']} tokens: losses {a['losses']} against unsharded "
          f"{a['unsharded_losses']}; each rank's blocks against the "
          f"unsharded state's: params {a['params']}, m {a['m']}, v "
          f"{a['v']}  [{card}]", flush=True)
    print(f"fsdp (b): {TRAIN_ARCH} {FS_BF16_LAYERS} layers "
          f"({b[0]['params']} params, {b[0]['local_params']} a rank) in "
          f"bf16, {FS_BF16_STEPS} packed-ingest steps of {FS_RANKS} x "
          f"{TRAIN_BATCH // FS_RANKS} x {TRAIN_SEQ} tokens: losses rank 0 "
          f"{[round(x, 4) for x in b[0]['losses']]}, rank 1 "
          f"{[round(x, 4) for x in b[1]['losses']]}; step walls (s) rank 0 "
          f"{[round(x, 4) for x in b[0]['step_s']]}, rank 1 "
          f"{[round(x, 4) for x in b[1]['step_s']]}; wire bytes a rank a "
          f"step {per_step}; peak memory "
          f"{[round(x['peak_mem_GB'], 3) for x in b]} GB; bitunpack "
          f"launches {[x['launches']['bitunpack'] for x in b]}  [{card}]",
          flush=True)
    save, whole = b[0]["saves"][0], b[0]["whole_check"]
    save_rate = save["bytes"] / (save["snapshot_s"] + save["write_s"]) / 1e9
    whole_rate = whole["bytes"] / whole["restore_s"] / 1e9
    print(f"fsdp (b) checkpoint: sharded Trainer, step {FS_CKPT_STEP} saved "
          f"once by rank 0 ({save['bytes']} B: gather + host snapshot "
          f"{save['snapshot_s']:.3f} s, write {save['write_s']:.3f} s, "
          f"{save_rate:.3f} GB/s); restored whole on the card by the "
          f"unsharded Trainer in {whole['restore_s']:.3f} s "
          f"({whole_rate:.3f} GB/s), {whole['leaves'] - whole['n_differ']} of "
          f"{whole['leaves']} leaves bit-equal to the gathered state; fresh "
          f"Trainers restored step {b[0]['restored_step']} in "
          f"{[round(x['restore_s'], 3) for x in b]} s (rank 0 reads, "
          f"scatters each rank's blocks) and ran to {FS_BF16_STEPS}: "
          f"{[x['leaves'] - x['n_differ'] for x in b]} of "
          f"{[x['leaves'] for x in b]} blocks bit-equal to the "
          f"uninterrupted run  [{card}]", flush=True)
    print(f"fsdp (c): {MOE_ARCH} dense + MoE layer in float32 at capacity "
          f"n_routed / top_k, {c['tokens']} tokens, one step's gathered "
          f"gradients against the single-card math on each rank's tokens: "
          f"{c['grads']}; aux_loss {c['aux_loss']!r}; fsdp "
          f"{c['fsdp_s']:.3f} s, single card (both halves) "
          f"{c['single_card_s']:.3f} s; parts (s) "
          f"{ {k: round(v, 1) for k, v in ranks[0]['walls'].items()} }, "
          f"phase {wall:.1f} s  [{card}]", flush=True)
    print(f"reduced: fsdp at {FS_F32_LAYERS} and {FS_BF16_LAYERS} of "
          f"{TRAIN_ARCH}'s 48 layers and {FS_MOE_LAYERS} of {MOE_ARCH}'s "
          f"27, 2 ranks sharing one card (the production mesh is (16, 16))")
    for name, r in (("params", a["params"]), ("m", a["m"]), ("v", a["v"]),
                    ("moe grads", c["grads"])):
        if not r["ok"]:
            raise AssertionError(f"fsdp: {name} {r}")
    for x in (r["f32"] for r in ranks):
        if len(x["losses"]) != FS_F32_STEPS or not np.allclose(
                x["losses"], x["unsharded_losses"], **FS_TRAIN_TOL):
            raise AssertionError(f"fsdp (a): losses {x['losses']} against "
                                 f"unsharded {x['unsharded_losses']}")
    ran = 2 * FS_BF16_STEPS - FS_CKPT_STEP     # the restart's steps again
    if launches != {"bitunpack": FS_RANKS * ran, "filter_agg": 0,
                    "block_agg": 0, "flash_fwd": 0}:
        raise AssertionError(f"fsdp launches {launches}")
    if whole["n_differ"] or whole["step"] != FS_CKPT_STEP or len(
            b[0]["saves"]) != 1 or any(x["saves"] for x in b[1:]):
        raise AssertionError(f"fsdp: checkpoint {whole}, saves "
                             f"{[x['saves'] for x in b]}")
    for x in b:
        if x["n_differ"] or x["leaves"] <= 0 or \
                x["restored_step"] != FS_CKPT_STEP or \
                x["restart_losses"] != x["losses"][FS_CKPT_STEP:]:
            raise AssertionError(f"fsdp: restart {x['differ']} "
                                 f"({x['n_differ']} blocks differ), losses "
                                 f"{x['restart_losses']} vs {x['losses']}")
    for x in b:
        if not all(np.isfinite(x["losses"])) or \
                not x["losses"][-1] < x["losses"][0]:
            raise AssertionError(f"fsdp: losses {x['losses']}")
    if b[0]["losses"] != b[1]["losses"]:
        raise AssertionError(f"fsdp: ranks report different losses "
                             f"{[x['losses'] for x in b]}")
    if not c["aux_loss"] > 0 or not all(
            x["launches"]["bitunpack"] == FS_F32_STEPS
            for x in (r["f32"] for r in ranks)):
        raise AssertionError(f"fsdp: aux {c['aux_loss']}, launches "
                             f"{[r['f32']['launches'] for r in ranks]}")
    return res


# --------------------------------------------------------------------------
# the model axis on one card (phase 25)
# --------------------------------------------------------------------------


def _tp_rel(got: dict, want: dict, tol: float) -> dict:
    """(worst |err| over a leaf's largest entry, its leaf) of two trees;
    ``ok`` when that stays within ``tol``."""
    worst, at = 0.0, None
    for k, w in want.items():
        w = w.float()
        err = float((got[k].float() - w).abs().max())
        rel = err / max(float(w.abs().max()), 1e-30)
        if rel >= worst:
            worst, at = rel, k
    return {"max_rel_err": worst, "leaf": at, "ok": worst <= tol}


def _tp_serve(model, prompts: torch.Tensor, steps: int,
              with_cache: bool = False) -> tuple:
    """(logits of the prefill and each decode step, greedy tokens, and
    with ``with_cache`` the last cache) of ``steps`` decode steps after a
    prefill of ``prompts``, each step's input its own last greedy
    tokens."""
    logits, cache = model.prefill({"tokens": prompts},
                                  max_seq=prompts.shape[1] + steps)
    outs, toks = [logits], []
    for _ in range(steps):
        tok = logits.argmax(-1, keepdim=True).int()
        toks.append(tok)
        logits, cache = model.decode_step(tok, cache)
        outs.append(logits)
    return (outs, toks, cache) if with_cache else (outs, toks)


def _tp_cfg(P, arch: str, layers: int | None = None, f32: bool = False):
    cfg = P.configs.get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return _f32(cfg) if f32 else cfg


def _tp_check(logits: list, toks: list, want: list, want_toks: list,
                    tol: float) -> dict:
    top = max(float(w.abs().max()) for w in want)
    err = max(float((g - w).abs().max()) for g, w in zip(logits, want))
    return {"max_abs_err": err, "max_abs_logit": top,
            "within": err <= tol * top,
            "tokens_equal": all(torch.equal(a, b)
                                for a, b in zip(toks, want_toks))}


def _tp_single(P, cfg, opt, batches: list, prompts, seed: int) -> dict:
    """The single-card run of a parity check on rank 0: the unsharded
    steps' state (and ``m1``, the first moment after the first step: its
    clipped gradients times 1 - beta1) and the served logits and tokens
    of the seeded weights."""
    from repro_torch.train import steps

    dev = torch.device(DEVICE)

    def seeded():
        return _seeded(P, cfg, dev, seed)[0]

    model = seeded()
    state = {"params": dict(model.named_parameters()),
             "opt": P.optimizer.init_opt_state(
                 dict(model.named_parameters()), torch.float32)}
    step = steps.make_train_step(model, opt)
    losses, m1 = [], None
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        if m1 is None:
            m1 = {n: t.clone() for n, t in state["opt"]["m"].items()}
    out = {"losses": losses, "m1": m1,
           "params": {n: p.detach().clone()
                      for n, p in state["params"].items()},
           "m": state["opt"]["m"], "v": state["opt"]["v"]}
    del model, state, step
    _free_card()
    model = seeded()
    with torch.no_grad():
        out["logits"], out["toks"] = _tp_serve(model, prompts, TP_DECODE)
    del model
    _free_card()
    return out


def _tp_parity(P, cfg, train, serve, words: list, seed: int,
               logit_tol: float = TP_LOGIT_TOL,
               first_step: bool = False) -> dict:
    """``cfg`` (float32) trained ``TP_F32_STEPS`` steps under ``train``
    on the same 2 x 1024 tokens on both ranks against the unsharded step
    (rank 0): the state after the last step and, with ``first_step``,
    the first moment after the first (``m1``: the clipped first-step
    gradients times 1 - beta1, before Adam divides by their size); then
    the seeded weights served under ``serve`` against the single-card
    model within ``logit_tol`` of its largest logit."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding as shd
    from repro_torch.train import steps

    dev = torch.device(DEVICE)
    opt = P.optimizer.OptConfig(lr=TRAIN_LR, warmup_steps=2,
                                total_steps=TP_F32_STEPS)
    batches = [P.ingest.fused_batch(w[:TP_F32_BATCH, :TP_F32_SEQ // 32])
               for w in words[:TP_F32_STEPS]]
    prompts = P.ingest.fused_batch(
        words[0][:TP_SERVE_BATCH, :TP_SERVE_SEQ // 32])["tokens"]
    model = P.archs.build_model(cfg, remat="full", device=dev)
    state = steps.init_train_state(
        model, torch.Generator(device=dev).manual_seed(seed))
    state = steps.shard_train_state(model, state, train)
    step = steps.make_train_step(model, opt)
    losses, m1 = [], None
    shd.reset_collective_bytes()
    with shd.use_rules(train):
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            if first_step and m1 is None:     # a whole leaf is the block
                m1 = {k: t.clone() for k, t in _fs_whole(
                    P, model, state["opt"]["m"], train).items()}
        got = {"m1": m1,
               "params": _fs_whole(P, model, state["params"], train),
               "m": _fs_whole(P, model, state["opt"]["m"], train),
               "v": _fs_whole(P, model, state["opt"]["v"], train)}
    train_bytes = dict(shd.COLLECTIVE_BYTES)
    del model, state, step, m1
    _free_card()
    model = _seeded(P, cfg, dev, seed)[0]
    steps.shard_params(model, serve)
    shd.reset_collective_bytes()
    with torch.no_grad(), shd.use_rules(serve):
        logits, toks = _tp_serve(model, prompts, TP_DECODE)
    serve_bytes = dict(shd.COLLECTIVE_BYTES)
    del model
    _free_card()
    res = {"losses": losses, "tokens": list(batches[0]["tokens"].shape),
           "prompts": list(prompts.shape), "train_bytes": train_bytes,
           "serve_bytes": serve_bytes}
    if dist.get_rank() == 0:
        want = _tp_single(P, cfg, opt, batches, prompts, seed)
        lr_moved = 2 * TRAIN_LR * TP_F32_STEPS
        res.update(
            unsharded_losses=want["losses"],
            params=_fs_close(got["params"], want["params"], FS_TRAIN_TOL,
                             1e-3, lr_moved),
            m=_fs_close(got["m"], want["m"], FS_TRAIN_TOL),
            v=_fs_close(got["v"], want["v"], FS_TRAIN_TOL),
            serve=_tp_check(logits, toks, want["logits"], want["toks"],
                            logit_tol),
            rel={k: _tp_rel(got[k], want[k], 1.0)
                 for k in ("params", "m", "v")})
        if first_step:
            res.update(grads=_tp_rel(got["m1"], want["m1"], RT_GRAD_TOL),
                       sign_flips=_sign_flips(got["m1"], want["m1"]))
        del got, logits, want
    _free_card()
    return res


def _tp_bf16(P, train, serve, words: list, seed: int,
             arch: str = TRAIN_ARCH, layers: int = TP_BF16_LAYERS,
             n_steps: int = TP_BF16_STEPS, seq: int = TRAIN_SEQ) -> dict:
    """(b): ``arch`` (yi_9b), ``layers`` layers at full width in bf16
    under ``megatron_sp``, ``n_steps`` timed steps of the same two
    ``seq``-token sequences on both ranks, with the collective bytes of
    each step; then its trained weights served under ``tp_sp`` (on
    (data 1, model 2) the same blocks), timed."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.train import steps

    dev = torch.device(DEVICE)
    cfg = dataclasses.replace(P.configs.get_config(arch), n_layers=layers)
    opt = P.optimizer.OptConfig(lr=CUT_LR, warmup_steps=2,
                                total_steps=n_steps)
    model = P.archs.build_model(cfg, remat="full", device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    state = steps.init_train_state(
        model, torch.Generator(device=dev).manual_seed(seed))
    state = steps.shard_train_state(model, state, train)
    local = sum(p.numel() for p in model.parameters())
    step = steps.make_train_step(model, opt)
    prompts = P.ingest.fused_batch(
        words[0][:TP_SERVE_BATCH, :TP_SERVE_SEQ // 32])["tokens"]
    _free_card()
    torch.distributed.barrier()          # rank 0 ran (a)'s unsharded work
    torch.cuda.reset_peak_memory_stats(dev)
    walls, losses, moved = [], [], []
    _zero_counts(P)                      # the path's run starts here
    with shd.use_rules(train):
        for w in words[:n_steps]:
            _sync(dev)
            shd.reset_collective_bytes()
            t = time.perf_counter()
            state, m = step(state, P.ingest.fused_batch(
                w[:TP_BF16_BATCH, :seq // 32]))
            losses.append(float(m["loss"]))          # syncs
            walls.append(time.perf_counter() - t)
            moved.append(dict(shd.COLLECTIVE_BYTES))
    launches = _counts(P)                # ... and ends here
    peak = torch.cuda.max_memory_allocated(dev)
    del state, step
    _free_card()
    serve_walls, serve_bytes = [], []
    with torch.no_grad(), shd.use_rules(serve):
        _sync(dev)
        shd.reset_collective_bytes()
        t = time.perf_counter()
        logits, cache = model.prefill({"tokens": prompts},
                                      max_seq=TP_SERVE_SEQ + TP_DECODE)
        tok = logits.argmax(-1, keepdim=True).int()     # syncs
        prefill_s = time.perf_counter() - t
        prefill_bytes = dict(shd.COLLECTIVE_BYTES)
        for _ in range(TP_DECODE):
            shd.reset_collective_bytes()
            t = time.perf_counter()
            logits, cache = model.decode_step(tok, cache)
            tok = logits.argmax(-1, keepdim=True).int()
            serve_walls.append(time.perf_counter() - t)
            serve_bytes.append(dict(shd.COLLECTIVE_BYTES))
    del model, cache, logits
    _free_card()
    return {"params": n_params, "local_params": local, "step_s": walls,
            "losses": losses, "bytes": moved, "peak_mem_GB": peak / 1e9,
            "launches": launches, "prefill_s": prefill_s,
            "prefill_bytes": prefill_bytes, "decode_s": serve_walls,
            "decode_bytes": serve_bytes[-1]}


def _tp_moe(P, train, words: list, seed: int) -> dict:
    """(c): deepseek_v2_lite_16b's dense layer and one MoE layer at full
    width in float32, capacity n_routed / top_k, under ``megatron_sp``:
    one step's gradients, gathered, against the single-card gradients
    of the same tokens (rank 0)."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding as shd
    from repro_torch.train import steps

    dev = torch.device(DEVICE)
    base = P.configs.get_config(MOE_ARCH)
    cfg = dataclasses.replace(
        base, n_layers=TP_MOE_LAYERS, param_dtype=torch.float32,
        compute_dtype=torch.float32, moe=dataclasses.replace(
            base.moe, capacity_factor=base.moe.n_routed / base.moe.top_k))
    model = P.archs.build_model(cfg, remat="full", device=dev)
    state = steps.init_train_state(
        model, torch.Generator(device=dev).manual_seed(seed))
    state = steps.shard_train_state(model, state, train)
    batch = P.ingest.fused_batch(words[0][:1, :TP_MOE_SEQ // 32])
    params = state["params"]
    _sync(dev)
    t = time.perf_counter()
    with shd.use_rules(train):
        loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
    _sync(dev)
    res = {"tp_s": time.perf_counter() - t,
           "tokens": list(batch["tokens"].shape),
           "aux_loss": float(metrics["aux_loss"]),
           "loss": float(metrics["loss"])}
    got = _fs_whole(P, model, dict(zip(params, grads)), train)
    del model, state, grads, params
    _free_card()
    if dist.get_rank() == 0:
        model = P.archs.build_model(cfg, remat="full", device=dev)
        model.init(torch.Generator(device=dev).manual_seed(seed))
        params = dict(model.named_parameters())
        _sync(dev)
        t = time.perf_counter()
        loss, m = model.loss(batch)
        want = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        _sync(dev)
        res.update(single_card_s=time.perf_counter() - t,
                   single_card_loss=float(loss.detach()),
                   single_card_aux=float(m["aux_loss"]),
                   grads=_tp_rel(got, want, TP_GRAD_TOL))
        del model, params, want
    del got
    _free_card()
    return res


def _tp_rank(rank: int, world: int, init: str, tmp: str, seed: int) -> None:
    import torch.distributed as dist
    P = _load_port()
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        from repro_torch.distributed import sharding as shd
        from repro_torch.launch import mesh as lmesh

        mesh = lmesh.make_smoke_mesh((1, TP_RANKS), ("data", "model"))
        train = shd.MeshRules(mesh, strategy="megatron_sp")
        serve = shd.MeshRules(mesh, strategy="tp_sp")
        store = P.core.make_store(8, replicas=2)
        try:
            vol = P.core.GlobalVOL(store)
            P.corpus.build_corpus(vol, P.corpus.CorpusSpec(
                n_seqs=FS_CORPUS_SEQS, seq_len=TRAIN_SEQ,
                vocab_size=P.configs.get_config(TRAIN_ARCH).vocab_size,
                seed=seed), chunk_rows=FS_CORPUS_SEQS)
            words = _fs_batches(P, vol, 0, seed, TP_BF16_STEPS, dp_size=1)
        finally:
            store.close()
        walls = {}
        t = time.perf_counter()
        _zero_counts(P)
        cfg = _tp_cfg(P, TRAIN_ARCH, TP_F32_LAYERS, f32=True)
        res = {"f32": _tp_parity(P, cfg, train, serve, words, seed)}
        res["f32"]["launches"] = _counts(P)
        walls["a_s"] = time.perf_counter() - t
        t = time.perf_counter()
        res["bf16"] = _tp_bf16(P, train, serve, words, seed)
        walls["b_s"] = time.perf_counter() - t
        t = time.perf_counter()
        _zero_counts(P)
        res["moe"] = _tp_moe(P, train, words, seed)
        res["moe"]["launches"] = _counts(P)
        walls["c_s"] = time.perf_counter() - t
        res["walls"] = walls
        (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def tp_path(P, dev, seed: int, card: str) -> dict:
    """Phase 25: ``TP_RANKS`` gloo ranks on this one card run yi_9b's and
    deepseek_v2_lite_16b's layers split over the model axis
    (``MeshRules(strategy="megatron_sp")`` for training, ``"tp_sp"`` for
    serving), against the single-card model."""
    _free_card()
    t0 = time.perf_counter()
    ranks = _spawned(_tp_rank, TP_RANKS, seed, TP_DEADLINE_S, "model axis")
    wall = time.perf_counter() - t0
    a = ranks[0]["f32"]
    b = [r["bf16"] for r in ranks]
    c = ranks[0]["moe"]
    per_step = [{k: v for k, v in x.items() if v} for x in b[0]["bytes"]]
    launches = {k: sum(x["launches"][k] for x in b) for k in KERNELS}
    res = {"ranks": TP_RANKS, "wall_s": wall, "f32": a, "bf16": b,
           "moe": c, "launches": launches}
    print("model axis: " + json.dumps(res), flush=True)
    print(f"model axis (a): {TRAIN_ARCH} {TP_F32_LAYERS} layer in float32 "
          f"under megatron_sp on (data 1, model {TP_RANKS}), "
          f"{TP_F32_STEPS} steps of {a['tokens']} tokens: losses "
          f"{a['losses']} against unsharded {a['unsharded_losses']}; "
          f"gathered params {a['params']}, m {a['m']}, v {a['v']}; tp_sp "
          f"serving of {a['prompts']} prompt tokens and {TP_DECODE} greedy "
          f"decode steps against the single-card model: {a['serve']}  "
          f"[{card}]", flush=True)
    dec = b[0]["decode_s"]
    print(f"model axis (b): {TRAIN_ARCH} {TP_BF16_LAYERS} layers "
          f"({b[0]['params']} params, {b[0]['local_params']} a rank) in "
          f"bf16 under megatron_sp, {TP_BF16_STEPS} packed-ingest steps of "
          f"{TP_BF16_BATCH} x {TRAIN_SEQ} tokens on both ranks: losses "
          f"rank 0 {[round(x, 4) for x in b[0]['losses']]}, rank 1 "
          f"{[round(x, 4) for x in b[1]['losses']]}; step walls (s) rank 0 "
          f"{[round(x, 4) for x in b[0]['step_s']]}, rank 1 "
          f"{[round(x, 4) for x in b[1]['step_s']]}; wire bytes a rank a "
          f"step {per_step}; peak memory "
          f"{[round(x['peak_mem_GB'], 3) for x in b]} GB; tp_sp serving in "
          f"bf16: prefill of {TP_SERVE_BATCH} x {TP_SERVE_SEQ} "
          f"{b[0]['prefill_s'] * 1e3:.3f} ms ({b[0]['prefill_bytes']} B), "
          f"decode {np.mean(dec) * 1e3:.3f} ms a step (median "
          f"{np.median(dec) * 1e3:.3f}; {b[0]['decode_bytes']} B a step); "
          f"bitunpack launches {[x['launches']['bitunpack'] for x in b]}  "
          f"[{card}]", flush=True)
    print(f"model axis (c): {MOE_ARCH} dense + MoE layer in float32 at "
          f"capacity n_routed / top_k under megatron_sp, {c['tokens']} "
          f"tokens, one step's gathered gradients against the single-card "
          f"gradients: {c['grads']}; loss {c['loss']!r} / "
          f"{c['single_card_loss']!r}, aux_loss {c['aux_loss']!r} / "
          f"{c['single_card_aux']!r}; model axis {c['tp_s']:.3f} s, single "
          f"card {c['single_card_s']:.3f} s; "
          f"parts (s) "
          f"{ {k: round(v, 1) for k, v in ranks[0]['walls'].items()} }, "
          f"phase {wall:.1f} s  [{card}]", flush=True)
    print(f"reduced: model axis at {TP_F32_LAYERS} and {TP_BF16_LAYERS} of "
          f"{TRAIN_ARCH}'s 48 layers and {TP_MOE_LAYERS} of {MOE_ARCH}'s 27, "
          f"2 ranks sharing one card over gloo (the production mesh is "
          f"(16, 16) over NCCL)")
    for name, r in (("params", a["params"]), ("m", a["m"]), ("v", a["v"]),
                    ("moe grads", c["grads"])):
        if not r["ok"]:
            raise AssertionError(f"model axis: {name} {r}")
    if not (a["serve"]["within"] and a["serve"]["tokens_equal"]):
        raise AssertionError(f"model axis: serving {a['serve']}")
    if launches != {"bitunpack": TP_RANKS * TP_BF16_STEPS, "filter_agg": 0,
                    "block_agg": 0, "flash_fwd": 0}:
        raise AssertionError(f"model axis launches {launches}")
    for x in b:
        if not all(np.isfinite(x["losses"])) or \
                not x["losses"][-1] < x["losses"][0]:
            raise AssertionError(f"model axis: losses {x['losses']}")
    if b[0]["losses"] != b[1]["losses"]:
        raise AssertionError(f"model axis: ranks report different losses "
                             f"{[x['losses'] for x in b]}")
    if not c["aux_loss"] > 0 or not all(
            r["f32"]["launches"]["bitunpack"] == TP_F32_STEPS + 1
            for r in ranks):
        raise AssertionError(f"model axis: aux {c['aux_loss']}, launches "
                             f"{[r['f32']['launches'] for r in ranks]}")
    return res


# --------------------------------------------------------------------------
# the recurrent families' model axis on one card (phase 26)
# --------------------------------------------------------------------------


def _sign_flips(got: dict, want: dict) -> dict:
    """Entries of two trees with opposite signs, and the largest of them
    over its leaf's largest entry: where Adam's first update, about lr
    times the sign of each gradient entry, parts the two runs by 2 lr."""
    n, worst, at = 0, 0.0, None
    for k, w in want.items():
        w = w.float()
        flip = got[k].float() * w < 0
        n += int(flip.sum())
        if flip.any():
            rel = float(w[flip].abs().max()) / float(w.abs().max())
            if rel >= worst:
                worst, at = rel, k
    return {"entries": n, "largest_rel": worst, "leaf": at}


def _rt_gates(arch: str, a: dict) -> dict:
    """Which of (a)'s comparisons hold: the first step's gradients
    within ``RT_GRAD_TOL`` of each leaf's largest entry; for an arch in
    ``RT_STATE_GATED`` the params and moments after the last step within
    phase 25's tolerances; the served logits within ``RT_LOGIT_TOL``,
    the greedy tokens equal."""
    gates = {"grads": a["grads"]["ok"], "logits": a["serve"]["within"],
             "tokens": a["serve"]["tokens_equal"]}
    if arch in RT_STATE_GATED:
        gates.update({k: a[k]["ok"] for k in ("params", "m", "v")})
    return gates


def _rt_bf16(P, arch: str, train, serve, words: list, seed: int) -> dict:
    """(b): ``arch`` at ``RT_BF16_SERVE_LAYERS`` in bf16 served under
    ``tp_sp`` (prefill of 4 x
    1024 tokens and ``RT_BF16_DECODE`` greedy steps, each timed with its
    wire bytes), then ``RT_BF16_STEPS`` ``tp_dp`` steps of the same two
    4096-token sequences on both ranks at (a)'s depth, timed."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.train import steps

    dev = torch.device(DEVICE)
    cfg = _tp_cfg(P, arch, RT_BF16_SERVE_LAYERS[arch])
    prompts = P.ingest.fused_batch(
        words[0][:TP_SERVE_BATCH, :TP_SERVE_SEQ // 32])["tokens"]
    torch.distributed.barrier()          # rank 0 ran (a)'s unsharded work
    _free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    model = _seeded(P, cfg, dev, seed)[0]
    n_params = sum(p.numel() for p in model.parameters())
    steps.shard_params(model, serve)
    local = sum(p.numel() for p in model.parameters())
    walls, moved = [], []
    with torch.no_grad(), shd.use_rules(serve):
        _sync(dev)
        shd.reset_collective_bytes()
        t = time.perf_counter()
        logits, cache = model.prefill({"tokens": prompts},
                                      max_seq=TP_SERVE_SEQ + RT_BF16_DECODE)
        tok = logits.argmax(-1, keepdim=True).int()     # syncs
        prefill_s = time.perf_counter() - t
        prefill_bytes = dict(shd.COLLECTIVE_BYTES)
        for _ in range(RT_BF16_DECODE):
            shd.reset_collective_bytes()
            t = time.perf_counter()
            logits, cache = model.decode_step(tok, cache)
            tok = logits.argmax(-1, keepdim=True).int()
            walls.append(time.perf_counter() - t)
            moved.append(dict(shd.COLLECTIVE_BYTES))
    cache_bytes = _cache_bytes(cache)
    serve_peak = torch.cuda.max_memory_allocated(dev)
    finite = bool(torch.isfinite(logits).all())
    del model, cache, logits
    _free_card()
    cfg = _tp_cfg(P, arch, RT_LAYERS[arch])
    opt = P.optimizer.OptConfig(lr=TRAIN_LR, warmup_steps=2,
                                total_steps=RT_BF16_STEPS)
    model = P.archs.build_model(cfg, remat="full", device=dev)
    state = steps.init_train_state(
        model, torch.Generator(device=dev).manual_seed(seed))
    state = steps.shard_train_state(model, state, train)
    step = steps.make_train_step(model, opt)
    _free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    step_walls, losses, step_bytes = [], [], []
    _zero_counts(P)                      # the path's run starts here
    with shd.use_rules(train):
        for w in words[:RT_BF16_STEPS]:
            _sync(dev)
            shd.reset_collective_bytes()
            t = time.perf_counter()
            state, m = step(state, P.ingest.fused_batch(w[:RT_BF16_BATCH]))
            losses.append(float(m["loss"]))          # syncs
            step_walls.append(time.perf_counter() - t)
            step_bytes.append(dict(shd.COLLECTIVE_BYTES))
    launches = _counts(P)                # ... and ends here
    train_peak = torch.cuda.max_memory_allocated(dev)
    del model, state, step
    _free_card()
    return {"params": n_params, "local_params": local,
            "prefill_s": prefill_s, "prefill_bytes": prefill_bytes,
            "decode_s": walls, "decode_bytes": moved[-1],
            "cache_bytes": cache_bytes, "serve_peak_GB": serve_peak / 1e9,
            "finite": finite, "step_s": step_walls, "losses": losses,
            "step_bytes": step_bytes, "train_peak_GB": train_peak / 1e9,
            "launches": launches}


def _rt_q8(P, serve, words: list, seed: int) -> dict:
    """(c): yi_9b at full width with ``RT_Q8_LAYERS`` layers in float32,
    its int8 KV cache (the port's ``KV_CACHE_QUANT``) served under
    ``tp_sp`` against the single-card int8 decode (rank 0); the int8
    cache's sequence blocks gathered and compared there."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding as shd
    from repro_torch.train import steps

    dev = torch.device(DEVICE)
    cfg = _tp_cfg(P, TRAIN_ARCH, RT_Q8_LAYERS, f32=True)
    prompts = P.ingest.fused_batch(
        words[0][:TP_SERVE_BATCH, :TP_SERVE_SEQ // 32])["tokens"]
    P.transformer.KV_CACHE_QUANT = True
    try:
        model = _seeded(P, cfg, dev, seed)[0]
        steps.shard_params(model, serve)
        sp = shd.logical_group(serve, "sp")
        shd.reset_collective_bytes()
        _sync(dev)
        t = time.perf_counter()
        with torch.no_grad(), shd.use_rules(serve):
            logits, toks, cache = _tp_serve(model, prompts, TP_DECODE,
                                            with_cache=True)
        _sync(dev)
        res = {"serve_s": time.perf_counter() - t,
               "bytes": dict(shd.COLLECTIVE_BYTES),
               "cache_dtype": str(cache["k"].dtype)}
        mine = {k: shd.all_gather_dim(cache[k], 2, sp.group)
                for k in ("k", "v")}
        del model, cache
        _free_card()
        if dist.get_rank() == 0:
            model = _seeded(P, cfg, dev, seed)[0]
            with torch.no_grad():
                want, want_toks, wcache = _tp_serve(
                    model, prompts, TP_DECODE, with_cache=True)
            off = {k: (mine[k].int() - wcache[k].int()).abs()
                   for k in ("k", "v")}
            flips = sum(int((o > 0).sum()) for o in off.values())
            entries = sum(o.numel() for o in off.values())
            res.update(
                flips=flips, entries=entries,
                max_off=max(int(o.max()) for o in off.values()),
                serve=_tp_check(logits, toks, want, want_toks,
                                TP_LOGIT_TOL))
            del model, want, wcache, off
    finally:
        P.transformer.KV_CACHE_QUANT = False
    del logits, mine
    _free_card()
    return res


def _rt_rank(rank: int, world: int, init: str, tmp: str, seed: int) -> None:
    import torch.distributed as dist
    P = _load_port()
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        from repro_torch.distributed import sharding as shd
        from repro_torch.launch import mesh as lmesh

        mesh = lmesh.make_smoke_mesh((1, RT_RANKS), ("data", "model"))
        train = shd.MeshRules(mesh, strategy="tp_dp")
        serve = shd.MeshRules(mesh, strategy="tp_sp")
        store = P.core.make_store(8, replicas=2)
        try:
            vol = P.core.GlobalVOL(store)
            P.corpus.build_corpus(vol, P.corpus.CorpusSpec(
                n_seqs=FS_CORPUS_SEQS, seq_len=TRAIN_SEQ,
                vocab_size=P.configs.get_config(RT_VOCAB_ARCH).vocab_size,
                seed=seed), chunk_rows=FS_CORPUS_SEQS)
            words = _fs_batches(P, vol, 0, seed,
                                max(RT_BF16_STEPS, TP_F32_STEPS), dp_size=1)
        finally:
            store.close()
        res, walls = {}, {}
        for arch in SSM_ARCHS:
            t = time.perf_counter()
            _zero_counts(P)
            res[f"{arch} f32"] = _tp_parity(
                P, _tp_cfg(P, arch, RT_LAYERS[arch], f32=True), train,
                serve, words, seed, RT_LOGIT_TOL[arch], first_step=True)
            res[f"{arch} f32"]["launches"] = _counts(P)
            walls[f"a {arch}"] = time.perf_counter() - t
        for arch in SSM_ARCHS:
            t = time.perf_counter()
            res[f"{arch} bf16"] = _rt_bf16(P, arch, train, serve, words,
                                           seed)
            walls[f"b {arch}"] = time.perf_counter() - t
        t = time.perf_counter()
        _zero_counts(P)
        res["q8"] = _rt_q8(P, serve, words, seed)
        res["q8"]["launches"] = _counts(P)
        walls["c"] = time.perf_counter() - t
        res["walls"] = walls
        (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def recurrent_tp_path(P, dev, seed: int, card: str) -> dict:
    """Phase 26: ``RT_RANKS`` gloo ranks on this one card run rwkv6_3b's
    and zamba2_2p7b's layers split over the model axis
    (``MeshRules(strategy="tp_dp")`` for training, ``"tp_sp"`` for
    serving) and yi_9b's int8 KV cache under ``tp_sp``, against the
    single-card model."""
    _free_card()
    t0 = time.perf_counter()
    ranks = _spawned(_rt_rank, RT_RANKS, seed, RT_DEADLINE_S,
                     "recurrent model axis")
    wall = time.perf_counter() - t0
    parts = [r[k]["launches"] for r in ranks for k in r if k != "walls"]
    res = {"ranks": RT_RANKS, "wall_s": wall, "rank0": ranks[0],
           "rank1": {k: ranks[1][k] for k in ranks[1] if "bf16" in k},
           "launches": {k: sum(x[k] for x in parts) for k in KERNELS}}
    print("recurrent model axis: " + json.dumps(res), flush=True)
    for arch in SSM_ARCHS:
        a, b = ranks[0][f"{arch} f32"], [r[f"{arch} bf16"] for r in ranks]
        dec = b[0]["decode_s"]
        per_step = [{k: v for k, v in x.items() if v}
                    for x in b[0]["step_bytes"]]
        rel = {k: f"{v['max_rel_err']:.3g} ({v['leaf']})"
               for k, v in a["rel"].items()}
        state = "gated" if arch in RT_STATE_GATED else "shown, not gated"
        print(f"recurrent model axis (a): {arch} {RT_LAYERS[arch]} layers "
              f"in float32 under tp_dp on (data 1, model {RT_RANKS}), "
              f"{TP_F32_STEPS} steps of {a['tokens']} tokens: losses "
              f"{a['losses']} against unsharded {a['unsharded_losses']}; "
              f"first-step gradients (m after one step) {a['grads']}, "
              f"entries of opposite sign {a['sign_flips']}; state after "
              f"{TP_F32_STEPS} steps ({state}): gathered params "
              f"{a['params']}, m {a['m']}, v {a['v']}, worst error over "
              f"its leaf's largest entry {rel}; wire bytes "
              f"{a['train_bytes']}; tp_sp serving of {a['prompts']} prompt "
              f"tokens and {TP_DECODE} greedy decode steps against the "
              f"single-card model: {a['serve']} (within "
              f"{RT_LOGIT_TOL[arch]} of the largest; {a['serve_bytes']} B);"
              f" gates {_rt_gates(arch, a)}  [{card}]", flush=True)
        print(f"recurrent model axis (b): {arch} at "
              f"{RT_BF16_SERVE_LAYERS[arch]} layers ({b[0]['params']} "
              f"params, {b[0]['local_params']} a rank) in bf16 under tp_sp:"
              f" prefill of {TP_SERVE_BATCH} x {TP_SERVE_SEQ} "
              f"{b[0]['prefill_s'] * 1e3:.3f} ms ({b[0]['prefill_bytes']} "
              f"B), {RT_BF16_DECODE} decode steps {np.mean(dec) * 1e3:.3f} "
              f"ms a step (median "
              f"{np.median(dec) * 1e3:.3f}; {b[0]['decode_bytes']} B a "
              f"step), cache {b[0]['cache_bytes']} B a rank, peak "
              f"{[round(x['serve_peak_GB'], 3) for x in b]} GB; tp_dp at "
              f"{RT_LAYERS[arch]} layers, {RT_BF16_STEPS} packed-ingest "
              f"steps of {RT_BF16_BATCH} x {TRAIN_SEQ} tokens on both "
              f"ranks: step walls (s) rank 0 "
              f"{[round(x, 4) for x in b[0]['step_s']]}, rank 1 "
              f"{[round(x, 4) for x in b[1]['step_s']]}; losses "
              f"{[round(x, 4) for x in b[0]['losses']]}; wire bytes a rank "
              f"a step {per_step}; peak "
              f"{[round(x['train_peak_GB'], 3) for x in b]} GB  [{card}]",
              flush=True)
    c = ranks[0]["q8"]
    print(f"recurrent model axis (c): {TRAIN_ARCH} {RT_Q8_LAYERS} layers in "
          f"float32 with the int8 KV cache ({c['cache_dtype']}) under tp_sp:"
          f" {TP_SERVE_BATCH} x {TP_SERVE_SEQ} prompts and {TP_DECODE} "
          f"greedy decode steps against the single-card int8 decode: "
          f"{c['serve']}; quantizer flips {c['flips']} of {c['entries']} "
          f"int8 entries (largest {c['max_off']}); {c['serve_s']:.3f} s, "
          f"{c['bytes']} B; parts (s) "
          f"{ {k: round(v, 1) for k, v in ranks[0]['walls'].items()} }, "
          f"phase {wall:.1f} s  [{card}]", flush=True)
    print(f"reduced: recurrent model axis trained at "
          f"{RT_LAYERS['rwkv6_3b']} of rwkv6_3b's 32 layers and one of "
          f"zamba2_2p7b's 9 groups, served whole; {TRAIN_ARCH}'s int8 cache "
          f"at {RT_Q8_LAYERS} of 48 layers; 2 ranks sharing one card over "
          f"gloo (the production mesh is (16, 16) over NCCL)")
    for arch in SSM_ARCHS:
        a = ranks[0][f"{arch} f32"]
        gates = _rt_gates(arch, a)
        if not all(gates.values()):
            raise AssertionError(f"recurrent model axis: {arch} (a) {gates}")
        for r in ranks:
            f, b = r[f"{arch} f32"], r[f"{arch} bf16"]
            if f["launches"] != {"bitunpack": TP_F32_STEPS + 1,
                                 "filter_agg": 0, "block_agg": 0,
                                 "flash_fwd": 0}:
                raise AssertionError(f"recurrent model axis: {arch} (a) "
                                     f"launches {f['launches']}")
            if b["launches"] != {"bitunpack": RT_BF16_STEPS,
                                 "filter_agg": 0, "block_agg": 0,
                                 "flash_fwd": 0}:
                raise AssertionError(f"recurrent model axis: {arch} (b) "
                                     f"launches {b['launches']}")
            if not (b["finite"] and all(np.isfinite(b["losses"]))
                    and b["losses"] == ranks[0][f"{arch} bf16"]["losses"]):
                raise AssertionError(f"recurrent model axis: {arch} (b) "
                                     f"{b['losses']}, finite {b['finite']}")
            if not all(x["all_reduce"] for x in b["step_bytes"]) or \
                    not b["prefill_bytes"]["all_reduce"]:
                raise AssertionError(f"recurrent model axis: {arch} moved "
                                     "nothing over the model axis")
    if not (c["serve"]["within"] and c["serve"]["tokens_equal"]
            and c["cache_dtype"] == "torch.int8" and c["max_off"] <= 1
            and c["flips"] <= c["entries"] // 1000):
        raise AssertionError(f"recurrent model axis: int8 cache {c}")
    return res


# --------------------------------------------------------------------------
# the examples (phase 28)
# --------------------------------------------------------------------------


def switches(P) -> str:
    """The reference's two module switches in force in the port."""
    return (f"HEAD_TP={P.attention.HEAD_TP} "
            f"XENT_MM={P.layers.XENT_MM}")


def dispatched(P, fn) -> dict:
    """The ATen operators (views aside) that ``fn`` dispatches, by
    overload name, each with its count (``op_analysis.OpCounter``)."""
    with P.op_analysis.OpCounter() as oc:
        fn()
    return {str(f): n for f, n in oc.calls.items()}


def flash_fwd_path(P, dev, seed: int, card: str) -> dict:
    """The inference attention kernel against the block loop at
    ``FF_CHECKS`` (one launch each), then timed at the serving cell's
    shape: device ms a call (CUDA events around one call) beside its
    bound (the causal half's FLOPs at 989 TFLOP/s), the loop's and
    ``scaled_dot_product_attention``'s, with nvcc's registers and
    spills."""
    _free_card()
    ff, attention = P.ff, P.attention
    gen = torch.Generator(device=dev).manual_seed(seed + 11)

    def inputs(B, Sq, Sk, H, K):
        return tuple(torch.randn(shape, generator=gen, device=dev,
                                 dtype=torch.bfloat16)
                     for shape in ((B, Sq, H, 128), (B, Sk, K, 128),
                                   (B, Sk, K, 128)))

    def loop(q, k, v, causal, q_offset):
        with torch.no_grad():
            return attention._flash_fwd(
                q, k, v, causal, q_offset,
                min(attention.FLASH_BLOCK, q.shape[1]),
                min(attention.FLASH_BLOCK, k.shape[1]))[0]

    errs = {}
    before = ff.launches
    for name, (B, Sq, Sk, H, K, causal, off) in FF_CHECKS.items():
        q, k, v = inputs(B, Sq, Sk, H, K)
        got = ff.flash_fwd(q, k, v, causal=causal, q_offset=off)
        want = loop(q, k, v, causal, off)
        torch.cuda.synchronize(dev)
        errs[name] = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), **FF_TOL):
            raise AssertionError(f"flash_fwd {name} {FF_CHECKS[name]}: max "
                                 f"|kernel - loop| {errs[name]!r} outside "
                                 f"{FF_TOL}")
        del q, k, v, got, want
    if ff.launches != before + len(FF_CHECKS):
        raise AssertionError(f"flash_fwd launches {ff.launches - before} "
                             f"for {len(FF_CHECKS)} calls")
    B, S, _, H, K, _, _ = FF_CHECKS["cell"]
    q, k, v = inputs(B, S, S, H, K)
    ms = isolated_ms(lambda: ff.flash_fwd(q, k, v), 20)
    prof_ms, prof_events = device_ms(lambda: ff.flash_fwd(q, k, v), 20)
    plain_ms = isolated_ms(lambda: loop(q, k, v, True, 0), 3)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = isolated_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 20)
    bound = ff.bound_ms(B, S, S, H)
    ptxas = P.build.build_info["flash_fwd"]["ptxas"]
    regs = re.findall(r"Used (\d+) registers", ptxas)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                        r"loads", ptxas)
    res = {"shape": {"B": B, "S": S, "H": H, "K": K, "hd": 128},
           "max_abs_err": errs, "ms": ms, "profiler_ms": prof_ms,
           "profiler_events": prof_events, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound,
           "bound_by": "flops", "roofline": bound / ms,
           "TFLOP_per_s": ff.causal_flops(B, S, S, H) / ms / 1e9,
           "registers": regs, "spills": spills}
    print("flash_fwd: " + json.dumps(res), flush=True)
    print(f"kernel time flash_fwd [prefill attention, B {B}, S {S}, H {H}, "
          f"K {K}, hd 128, causal, bf16]: device {ms:.4f} ms, bound "
          f"{bound:.4f} ms at 989 TFLOP/s ({bound / ms:.1%} of it), loop "
          f"(plain) {plain_ms:.3f} ms, scaled_dot_product_attention "
          f"(library) {library_ms:.4f} ms; profiler {prof_ms:.4f} ms "
          f"({prof_events:.2f} events a call); registers {regs}, spills "
          f"{spills}; max |kernel - loop| {errs}  [{card}]", flush=True)
    return res


def mixed_path(P, dev, seed: int, card: str) -> dict:
    """The mixed product (``layers.mixed_einsum``: bf16 operands, a
    float32 result) on the card: its route, the ATen operators its
    forward and backward dispatch on bf16 card tensors (no copy of an
    operand in the forward); each of the port's products, forward and
    backward, at a small shape against the plain version on the CPU (the
    same products summed in another order; the gradients in bf16, within
    one rounding step); and the loss's head product at starcoder2_7b's
    widths timed beside the upcast float32 product (``XENT_MM =
    "cast"``)."""
    mix = P.layers.mixed_einsum
    a, b = (torch.randn(x, device=dev, dtype=torch.bfloat16,
                        requires_grad=True)
            for x in ((2, 64, 128), (128, 256)))
    box = []
    route = {"forward": dispatched(
                 P, lambda: box.append(mix("bcd,dv->bcv", a, b))),
             "backward": dispatched(P, lambda: box[0].sum().backward())}
    del a, b, box
    if not any("mm" in op for op in route["forward"]) or any(
            "copy" in op for op in route["forward"]):
        raise AssertionError(f"mixed product: forward dispatched "
                             f"{route['forward']}: no product, or a copy "
                             f"of an operand")
    shapes = {"bqhd,bkhd->bhqk": ((2, 512, 8, 128), (2, 512, 8, 128)),
              "bhqk,bkhd->bhqd": ((2, 8, 512, 512), (2, 512, 8, 128)),
              "bkgd,bskd->bkgs": ((8, 4, 9, 128), (8, 4096, 4, 128)),
              "bhr,bsr->bhs": ((8, 16, 512), (8, 4096, 512)),
              "btn,bsn->bts": ((2, 256, 64), (2, 256, 64)),
              "bcd,dv->bcv": ((2, 512, 1024), (1024, 4096))}
    gen = torch.Generator().manual_seed(seed + 11)
    errs = {}
    for spec, (sa, sb) in shapes.items():
        a, b = (torch.randn(x, generator=gen).to(torch.bfloat16)
                for x in (sa, sb))
        want = mix(spec, a.requires_grad_(), b.requires_grad_())
        wg = torch.autograd.grad(want, (a, b), torch.ones_like(want))
        ac, bc = (x.detach().to(dev).requires_grad_() for x in (a, b))
        got = mix(spec, ac, bc)
        gg = torch.autograd.grad(got, (ac, bc), torch.ones_like(got))
        if got.dtype != torch.float32 or any(g.dtype != torch.bfloat16
                                             for g in gg):
            raise AssertionError(f"mixed product {spec}: dtypes "
                                 f"{got.dtype}, {[g.dtype for g in gg]}")
        top = float(want.detach().abs().max())
        err = float((got.cpu() - want.detach()).abs().max())
        # a bf16 gradient within one rounding step of the value, or half
        # a step of the tensor's largest entry (tests/test_torch_switches)
        gok = all(bool(((g.cpu().float() - w.float()).abs()
                        <= 2 ** -7 * w.float().abs()
                        + 2 ** -8 * w.float().abs().max()).all())
                  for g, w in zip(gg, wg))
        errs[spec] = {"max_abs_err": err, "max_abs": top,
                      "grads_within_a_step": gok}
        if not err <= MIXED_TOL * top or not gok:
            raise AssertionError(f"mixed product {spec}: {errs[spec]}")
    M, D, V = MIXED_HEAD
    h = torch.randn((1, M, D), device=dev, dtype=torch.bfloat16)
    head = torch.randn((D, V), device=dev, dtype=torch.bfloat16)
    mixed_ms = cuda_ms(lambda: mix("bcd,dv->bcv", h, head), 10)
    cast_ms = cuda_ms(lambda: h.float() @ head.float(), 3)
    flops = 2 * M * D * V
    del h, head
    _free_card()
    res = {"route": route, "products": errs,
           "head_shape": [M, D, V], "head_mixed_ms": mixed_ms,
           "head_cast_ms": cast_ms,
           "head_mixed_TFLOP_s": flops / mixed_ms / 1e9,
           "head_cast_TFLOP_s": flops / cast_ms / 1e9}
    print("mixed product: " + json.dumps(res), flush=True)
    print(f"mixed product: route {route['forward']} forward, "
          f"{route['backward']} backward; {len(errs)} products "
          f"forward within {MIXED_TOL} of their largest entry of the CPU's "
          f"upcast product, bf16 gradients within one rounding step; the "
          f"head product ({M} x {D}) @ ({D} x {V}): mixed "
          f"{mixed_ms:.4f} ms ({res['head_mixed_TFLOP_s']:.1f} TFLOP/s), "
          f"upcast float32 {cast_ms:.4f} ms "
          f"({res['head_cast_TFLOP_s']:.1f} TFLOP/s)  [{card}]", flush=True)
    return res


def _sc_rank(rank: int, world: int, init: str, tmp: str, seed: int) -> None:
    """Phase 29 (c), one rank: starcoder2_7b built under ``HEAD_TP =
    "head_dim"`` (its specs fixed at build)."""
    import torch.distributed as dist
    P = _load_port()
    P.attention.HEAD_TP = "head_dim"
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        from repro_torch.distributed import sharding as shd
        from repro_torch.launch import mesh as lmesh

        specs = P.archs.build_model(P.configs.get_config(SC_ARCH),
                                    device="meta").SPECS
        if specs[("attn", "wk")] != ("fsdp", None, "tp"):
            raise AssertionError(f"{SC_ARCH} under head_dim: specs {specs}")
        mesh = lmesh.make_smoke_mesh((1, TP_RANKS), ("data", "model"))
        train = shd.MeshRules(mesh, strategy="megatron_sp")
        serve = shd.MeshRules(mesh, strategy="tp_sp")
        store = P.core.make_store(8, replicas=2)
        try:
            vol = P.core.GlobalVOL(store)
            P.corpus.build_corpus(vol, P.corpus.CorpusSpec(
                n_seqs=FS_CORPUS_SEQS, seq_len=TRAIN_SEQ,
                vocab_size=P.configs.get_config(SC_ARCH).vocab_size,
                seed=seed), chunk_rows=FS_CORPUS_SEQS)
            words = _fs_batches(P, vol, 0, seed, TP_F32_STEPS, dp_size=1)
        finally:
            store.close()
        walls = {}
        t = time.perf_counter()
        _zero_counts(P)
        cfg = _tp_cfg(P, SC_ARCH, TP_F32_LAYERS, f32=True)
        res = {"switches": switches(P),
               "f32": _tp_parity(P, cfg, train, serve, words, seed)}
        res["f32"]["launches"] = _counts(P)
        walls["a_s"] = time.perf_counter() - t
        t = time.perf_counter()
        res["bf16"] = _tp_bf16(P, train, serve, words, seed, arch=SC_ARCH,
                               layers=SC_HD_BF16_LAYERS,
                               n_steps=SC_HD_BF16_STEPS, seq=SC_HD_SEQ)
        walls["b_s"] = time.perf_counter() - t
        res["walls"] = walls
        (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def starcoder_path(P, dev, seed: int, card: str) -> dict:
    """Phase 29: starcoder2_7b (a) served whole in bf16 and its float32
    invariant, (b) trained at full width and its flash backward, (c) its
    layers split on the head dimension over 2 gloo ranks."""
    out = {}
    _free_card()
    cfg = P.configs.get_config(SC_ARCH)
    model, init_s = _seeded(P, cfg, dev, seed)
    # GQA with heads of 128 in bf16: flash_fwd once a layer
    res = _serve_run(P, cfg, model, dev, seed, card, flash=cfg.n_layers)
    res["init_s"] = init_s
    del model
    _free_card()
    res["invariant_f32"] = inv = _f32_invariant(
        P, cfg, dev, seed, card, SC_F32_LAYERS, INVARIANT_F32)
    print(f"reduced: {SC_ARCH} float32 invariant gated at {SC_F32_LAYERS} "
          f"of {cfg.n_layers} layers: {SC_F32_WHY}")
    if not (inv["finite"] and inv["within_2e-2"]):
        raise AssertionError(f"{SC_ARCH}: float32 prefill/decode invariant "
                             f"fails rtol/atol {INVARIANT_TOL}: {inv}")
    out[f"{SC_ARCH} serve"] = res
    out[f"{SC_ARCH} train"] = train_path(
        P, dev, seed, card, arch=SC_ARCH, layers=SC_TRAIN_LAYERS,
        tag=f"{SC_ARCH} train", why=SC_TRAIN_WHY, lr=SC_TRAIN_LR)
    out[f"{SC_ARCH} flash"] = flash_path(P, dev, seed, card,
                                         shape=SC_FLASH_SHAPE,
                                         tag=f"{SC_ARCH} flash backward")
    _free_card()
    t0 = time.perf_counter()
    ranks = _spawned(_sc_rank, TP_RANKS, seed, TP_DEADLINE_S,
                     "head_dim model axis")
    wall = time.perf_counter() - t0
    a = ranks[0]["f32"]
    b = [r["bf16"] for r in ranks]
    B, H = TP_F32_BATCH, cfg.n_heads
    pair = B * H * 512 * 512 * 4
    launches = {k: sum(r["f32"]["launches"][k] + r["bf16"]["launches"][k]
                       for r in ranks) for k in KERNELS}
    hd = {"ranks": TP_RANKS, "switches": ranks[0]["switches"],
          "wall_s": wall, "f32": a, "bf16": b,
          "score_all_reduce_bytes": pair, "walls": ranks[0]["walls"],
          "launches": launches}
    out["head_dim model axis"] = hd
    dec = b[0]["decode_s"]
    print("head_dim model axis: " + json.dumps(hd), flush=True)
    print(f"head_dim model axis (a): {SC_ARCH} {TP_F32_LAYERS} layer in "
          f"float32 ({hd['switches']}: wq, wk, wv and wo split on the head "
          f"dimension, {cfg.head_dim // TP_RANKS} of {cfg.head_dim} a rank) "
          f"under megatron_sp on (data 1, model {TP_RANKS}), {TP_F32_STEPS} "
          f"steps of {a['tokens']} tokens: losses {a['losses']} against "
          f"unsharded {a['unsharded_losses']}; gathered params "
          f"{a['params']}, m {a['m']}, v {a['v']}; wire bytes a rank "
          f"(steps) {a['train_bytes']}; tp_sp serving of {a['prompts']} "
          f"prompt tokens and {TP_DECODE} greedy decode steps against the "
          f"single-card model: {a['serve']}, wire bytes "
          f"{a['serve_bytes']}  [{card}]", flush=True)
    print(f"head_dim model axis (b): {SC_ARCH} {SC_HD_BF16_LAYERS} layers "
          f"({b[0]['params']} params, {b[0]['local_params']} a rank) in "
          f"bf16 under megatron_sp, {SC_HD_BF16_STEPS} step of "
          f"{TP_BF16_BATCH} x {SC_HD_SEQ} tokens: losses "
          f"{[x['losses'] for x in b]}, step walls (s) "
          f"{[x['step_s'] for x in b]}, wire bytes a rank "
          f"{b[0]['bytes']} (each block pair's score all-reduce {pair} B "
          f"at batch {B}); peak memory "
          f"{[round(x['peak_mem_GB'], 3) for x in b]} GB; tp_sp prefill of "
          f"{TP_SERVE_BATCH} x {TP_SERVE_SEQ} {b[0]['prefill_s'] * 1e3:.3f} "
          f"ms ({b[0]['prefill_bytes']} B), decode "
          f"{np.mean(dec) * 1e3:.3f} ms a step (median "
          f"{np.median(dec) * 1e3:.3f}; {b[0]['decode_bytes']} B a step); "
          f"parts (s) {ranks[0]['walls']}, phase {wall:.1f} s  [{card}]",
          flush=True)
    print(f"reduced: head_dim model axis at {TP_F32_LAYERS} and "
          f"{SC_HD_BF16_LAYERS} of {SC_ARCH}'s {cfg.n_layers} layers, "
          f"sequences of {SC_HD_SEQ} tokens (each block pair's scores are "
          f"all-reduced through gloo's host staging), 2 ranks sharing one "
          f"card")
    for name, r in (("params", a["params"]), ("m", a["m"]), ("v", a["v"])):
        if not r["ok"]:
            raise AssertionError(f"head_dim model axis: {name} {r}")
    if not (a["serve"]["within"] and a["serve"]["tokens_equal"]):
        raise AssertionError(f"head_dim model axis: serving {a['serve']}")
    if not all(np.isfinite(x["losses"]).all() for x in b) or \
            b[0]["losses"] != b[1]["losses"]:
        raise AssertionError(f"head_dim model axis: losses "
                             f"{[x['losses'] for x in b]}")
    if not launches["bitunpack"] > 0 or launches["filter_agg"] or \
            launches["block_agg"] or launches["flash_fwd"]:
        raise AssertionError(f"head_dim model axis launches {launches}")
    return out


def _example(name: str):
    """``examples/<name>.py`` of this checkout, loaded as a module."""
    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_path(P, dev, seed: int, card: str) -> dict:
    """Phase 28: the three examples through their ``main(argv)`` on the
    card, each under its own wall clock and launch counts (zeroed just
    before it, read just after); every one must launch ``bitunpack``.
    An example's failure fails the script."""
    out_dir = Path(tempfile.mkdtemp(prefix="examples_torch_"))
    argv = {"quickstart_torch": [],
            "serve_pushdown_torch": ["--seed", str(seed)],
            "train_e2e_torch": [
                "--preset", EXAMPLE_E2E_PRESET, "--steps",
                str(EXAMPLE_E2E_STEPS), "--kill-osd-at",
                str(EXAMPLE_E2E_KILL), "--seed", str(seed), "--out",
                str(out_dir / f"train_e2e_torch_{EXAMPLE_E2E_PRESET}.json")]}
    res, total = {}, collections.Counter()
    try:
        for name in EXAMPLES:
            mod = _example(name)
            print(f"example {name} {' '.join(argv[name])}", flush=True)
            _zero_counts(P)
            t = time.perf_counter()
            got = mod.main(argv[name])
            _sync(dev)
            wall = time.perf_counter() - t
            launches = _counts(P)
            res[name] = {"wall_s": wall, "launches": launches, "out": got}
            total.update(launches)
            print(f"example {name}: wall {wall:.3f} s, launches "
                  f"{launches}  [{card}]", flush=True)
            if not launches["bitunpack"]:
                raise AssertionError(f"example {name} launched no "
                                     f"bitunpack: {launches}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    serve, e2e = res["serve_pushdown_torch"]["out"], \
        res["train_e2e_torch"]["out"]
    print(f"examples: quickstart {res['quickstart_torch']['wall_s']:.3f} s "
          f"(tiny LM loss {res['quickstart_torch']['out']['loss_first']:.4f}"
          f" -> {res['quickstart_torch']['out']['loss_last']:.4f}); serve "
          f"{res['serve_pushdown_torch']['wall_s']:.3f} s, "
          f"{serve['tokens']} tokens in {serve['serve_s'] * 1e3:.3f} ms "
          f"({serve['tokens_per_s']:.1f} tokens/s); train_e2e "
          f"{EXAMPLE_E2E_PRESET} ({e2e['params_m']:.1f}M params, float32) "
          f"{res['train_e2e_torch']['wall_s']:.3f} s for {e2e['steps']} "
          f"steps, {e2e['wall_s_per_step'] * 1e3:.3f} ms a step (steps "
          f"3-{e2e['steps']}), loss {e2e['loss_first']:.4f} -> "
          f"{e2e['loss_last']:.4f}, OSD {e2e['killed']['osd']} killed at "
          f"step {e2e['killed']['step']} ({e2e['killed']['objects_moved']} "
          f"replicas moved, {e2e['killed']['objects_lost']} lost); "
          f"bitunpack launches {total['bitunpack']}  [{card}]", flush=True)
    print(f"reduced: train_e2e_torch --preset {EXAMPLE_E2E_PRESET} at "
          f"{EXAMPLE_E2E_STEPS} steps (the example's usage runs 300), OSD "
          f"killed at step {EXAMPLE_E2E_KILL}")
    return {"launches": dict(total), "walls": {
        name: r["wall_s"] for name, r in res.items()}}


# --------------------------------------------------------------------------
# the dry run (phase 27)
# --------------------------------------------------------------------------


def start_dryrun(out: Path) -> list:
    """Phase 27's cells, one ``python -m repro_torch.launch.dryrun``
    subprocess each at nice 19, writing their records into ``out``."""
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    code = ("import os; os.nice(19); "
            "from repro_torch.launch.dryrun import main; main()")
    procs = []
    for arch, shape, mesh, variant in DRYRUN_CELLS:
        log = open(out / f"{arch}.{shape}.{mesh}.{variant}.log", "w")
        procs.append(((arch, shape, mesh, variant), log, subprocess.Popen(
            [sys.executable, "-c", code, "--arch", arch, "--shape", shape,
             "--mesh", mesh, "--variant", variant, "--force", "--out",
             str(out)], env=env, cwd=root, stdout=log,
            stderr=subprocess.STDOUT)))
    return procs


def stop_dryrun(procs: list) -> None:
    for _, log, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def dryrun_path(procs: list, out: Path, started: float, card: str) -> dict:
    """Phase 27: wait for the dry run's cells (at most
    ``DRYRUN_DEADLINE_S`` more), print each record's per-rank peak
    memory, FLOPs, wire bytes and dominant roofline term, and fail if a
    cell failed."""
    deadline = time.monotonic() + DRYRUN_DEADLINE_S
    recs, failed = {}, []
    for (arch, shape, mesh, variant), log, proc in procs:
        try:
            rc = proc.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            rc = None
        mname = "pod2x16x16" if mesh == "multi" else "pod16x16"
        key = f"{arch}.{shape}.{mname}.{variant}.full"
        path = out / f"{key}.json"
        rec = json.loads(path.read_text()) if path.exists() else {}
        recs[key] = rec
        if rc != 0 or not rec.get("ok"):
            log.flush()
            tail = (out / f"{arch}.{shape}.{mesh}.{variant}.log").read_text()
            failed.append((key, rc, rec.get("error"), tail[-2000:]))
            continue
        m, r, c = rec["memory"], rec["roofline"], rec["collective"]
        print(f"dry run {key}: {rec['strategy']} on {rec['n_devices']} fake "
              f"ranks, one rank's step on fake {rec['device']} tensors "
              f"(counted at {rec['scaled']['at']} of {rec['scaled']['units']}"
              f" blocks, {rec['micro']} micro-batches): per-rank peak "
              f"{m['peak_hbm_bytes'] / 1e9:.3f} GB (arguments "
              f"{m['argument_bytes'] / 1e9:.3f} GB), FLOPs a rank "
              f"{rec['hlo_flops_per_dev']:.4e}, bytes a rank "
              f"{rec['hlo_bytes_per_dev']:.4e}, wire bytes a rank "
              f"{c['total']:.4e} ({ {k: v for k, v in c.items() if v and k != 'total'} }); "
              f"roofline compute {r['compute_s']:.4f} s, memory "
              f"{r['memory_s']:.4f} s, collective {r['collective_s']:.4f} s: "
              f"dominant {r['dominant']}; model FLOPs {rec['model_flops_total']:.4e}"
              f" ({rec['useful_flops_ratio']:.3f} of the counted); "
              f"switches {rec['switches']}, not ported: "
              f"{rec['switches_not_ported']}; cell "
              f"{rec['wall_s']:.1f} s  [{card}]", flush=True)
        if rec["switches_not_ported"]:
            failed.append((key, rc, "switches not ported",
                           rec["switches_not_ported"]))
    stop_dryrun(procs)
    print(f"dry run: {len(procs)} cells done {time.perf_counter() - started:.1f}"
          f" s after they started", flush=True)
    if failed:
        raise AssertionError(f"dry run: {len(failed)} cells failed: {failed}")
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    # before CUDA starts: cuBLAS's workspace for the deterministic
    # restart, and growable segments for the full-width train step
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    P = _load_port()
    dev = torch.device(DEVICE)
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    print(f"card: {card}", flush=True)
    start = time.perf_counter()
    dry_dir = Path(tempfile.mkdtemp(prefix="dryrun_torch_"))
    dry = start_dryrun(dry_dir)
    try:
        return _phases(args, P, card, dev, start, dry, dry_dir)
    finally:
        stop_dryrun(dry)
        shutil.rmtree(dry_dir, ignore_errors=True)


def _phases(args, P, card: str, dev, start: float, dry: list,
            dry_dir: Path) -> int:
    """The phases in order, phase 27's subprocesses (``dry``, started by
    ``main``, which stops any left) running beside them."""
    fmt, bu = P.fmt, P.bu
    last = start

    def lap(what: str) -> None:
        nonlocal last
        now = time.perf_counter()
        print(f"wall: {what} {now - last:.1f} s ({now - start:.1f} s in "
              f"all)", flush=True)
        last = now

    t = time.perf_counter()
    P.build.build_all(KERNELS)
    for mod in (bu, P.fa, P.ba, P.ff):
        mod.ensure_built()
    print(f"build: {len(KERNELS)} kernels, one nvcc each at once, "
          f"{time.perf_counter() - t:.2f}s with load", flush=True)
    build_report(P, bu, dev)

    t = time.perf_counter()
    bu_err = kernel_sweep(dev, fmt, bu, P.ref)
    print(f"kernel sweep: bitunpack bits 1..32 x n {list(SWEEP_N)} "
          f"bit-exact vs plain on card, and vs numpy codec to n={CODEC_N} "
          f"({time.perf_counter() - t:.1f}s)", flush=True)
    t = time.perf_counter()
    bu_err = max(bu_err, offset_sweep(dev, fmt, bu))
    print(f"kernel sweep: bitunpack bits 1..32 x n {list(OFFSET_N)} at "
          f"word offsets {list(OFFSETS)} (4-12 bytes past a 16-byte line) "
          f"bit-exact vs plain on card, and vs numpy codec to n=4096 "
          f"({time.perf_counter() - t:.1f}s)", flush=True)
    t = time.perf_counter()
    fa_err, ba_err = agg_sweep(dev, P)
    print(f"kernel sweep: filter_agg (6 comparators, float32/int32 "
          f"columns) and block_agg (bool/uint8/int32 masks) x n "
          f"{list(AGG_SWEEP_N)}, empty selections, NaN, misaligned starts "
          f"vs plain on card: max |err| filter_agg {fa_err!r}, block_agg "
          f"{ba_err!r} ({time.perf_counter() - t:.1f}s)", flush=True)

    lap("build and kernel sweeps")
    ds_rows = 1 << ROWS_LOG2
    obj_rows = len(P.core.plan_partition(
        _events_ds(P.core, "events", ds_rows),
        P.core.PartitionPolicy()).extents[0])
    obj_bits = 7                                   # run in [0, 100)
    rng = np.random.default_rng(2)
    obj_words = _words_tensor(fmt.bitpack_encode(
        _values(rng, obj_bits, obj_rows), obj_bits), obj_bits).to(dev)
    at_obj = kernel_timing(bu, obj_rows, obj_bits, obj_words, 200)
    big_n, ing_bits = 1 << FULL_ROWS_LOG2, 17
    at_width = {}
    for bits in WIDTH_BITS:
        big_words = torch.randint(-(1 << 31), 1 << 31, (big_n // 32, bits),
                                  dtype=torch.int32, device=dev)
        big_out = bu.bitunpack_groups(big_words, bits, big_n)
        torch.cuda.synchronize()
        if not torch.equal(big_out, bu.bitunpack_plain(big_words, bits,
                                                       big_n)):
            raise AssertionError(f"bitunpack differs at 2^"
                                 f"{FULL_ROWS_LOG2} values of {bits} bits")
        del big_out
        at_width[bits] = kernel_timing(bu, big_n, bits, big_words, 20)
        del big_words
    ing_n = INGEST_BATCH * INGEST_SEQ
    ing_words = torch.randint(-(1 << 31), 1 << 31, (ing_n // 32, ing_bits),
                              dtype=torch.int32, device=dev)
    at_ing = kernel_timing(bu, ing_n, ing_bits, ing_words, 200)
    del ing_words
    for name, r in (("main-path object column", at_obj),
                    *((f"2^{FULL_ROWS_LOG2} values", at_width[b])
                      for b in WIDTH_BITS),
                    ("ingest batch 256 x 4096", at_ing)):
        print(f"kernel time bitunpack [{name}] n={r['n']} bitpack{r['bits']} "
              f"({r['GB_per_s']:.0f} GB/s): {timing_line(r)}  [{card}]",
              flush=True)
    split = object_breakdown(dev, fmt, bu, obj_rows, obj_bits)
    print(f"one object column n={obj_rows} bitpack{obj_bits}: H2D "
          f"{split['h2d_ms']:.4f} ms, kernel {split['kernel_ms']:.4f} ms, "
          f"D2H {split['d2h_ms']:.4f} ms  [{card}]", flush=True)

    mixed_path(P, dev, args.seed, card)
    at_ff = flash_fwd_path(P, dev, args.seed, card)
    lap("kernel timings, mixed product, inference attention")
    t = time.perf_counter()
    ev = make_events(dev, ds_rows, args.seed)
    table = {k: v.cpu().numpy() for k, v in ev.items()}
    gen_s = time.perf_counter() - t
    store = P.core.make_store(8, replicas=3)
    try:
        res = main_path(P, store, table)
        res["generate_s"] = gen_s
        print(f"reduced: main path at 2^{ROWS_LOG2} rows of the paper's "
              f"2^{FULL_ROWS_LOG2}")
        print("main path: " + json.dumps(res), flush=True)

        pd = pushdown_path(P, ev, table, res)
        print("device pushdown: " + json.dumps(pd), flush=True)
        del ev
        # the aggregation kernels timed on a 2^28-row table on the card
        tn = 1 << FULL_ROWS_LOG2
        ev = make_events(dev, tn, args.seed + 1)
        mask = ev["hits"] > 20
        f32, i32 = torch.float32, torch.int32
        at_fa = agg_timing(
            lambda: P.fa.filter_agg(ev["e_pt"], ev["run"], "<", 50),
            lambda: P.fa.filter_agg_plain(ev["e_pt"], ev["run"], "<", 50),
            tn, (f32, i32), 20)
        at_ba = agg_timing(lambda: P.ba.block_agg(ev["e_pt"], mask),
                           lambda: P.ba.block_agg_plain(ev["e_pt"], mask),
                           tn, (f32, torch.bool), 20)
        for name, what, r in (
                ("filter_agg", "float32 values, int32 filter", at_fa),
                ("block_agg", "float32 values, bool mask", at_ba)):
            print(f"kernel time {name} [{what}] n={r['n']}: "
                  f"{timing_line(r)}  [{card}]", flush=True)
        del ev, mask

        ing = ingest_path(dev, P)
        print(f"reduced: corpus of {INGEST_SEQS // INGEST_BATCH} steps (a "
              f"training corpus is larger; each step is the full train_4k "
              f"batch)")
        print("packed ingest: " + json.dumps(ing), flush=True)
        print(f"packed ingest: {ing['ms_per_step']:.3f} ms per step, "
              f"client_rx packed {ing['client_rx_packed']} B vs plain "
              f"{ing['client_rx_plain']} B over {INGEST_STEPS} steps, "
              f"bitunpack launches {ing['launches']['bitunpack']}  [{card}]",
              flush=True)
        planes = table_planes(P, store, table, args.seed, card)
    finally:
        store.close()
    del store, table
    gc.collect()
    lap("main path, pushdown, ingest, table planes")
    print(f"reduced: maintenance table at 2^{MAINT_ROWS_LOG2} rows of the "
          f"main path's 2^{ROWS_LOG2} (the script's time limit)")
    planes.update(fresh_planes(P, dev, args.seed, card,
                               maint_rows=1 << MAINT_ROWS_LOG2))
    gc.collect()
    torch.cuda.empty_cache()
    lap("maintenance, checkpoint, KV pages")
    planes["serve"] = serve_path(P, dev, args.seed, card)
    lap("serve")
    planes["train"] = train_path(P, dev, args.seed, card)
    planes["train restart"] = restart_path(P, dev, args.seed, card)
    flash_path(P, dev, args.seed, card)
    lap("train, restart, flash backward")
    planes.update(moe_paths(P, dev, args.seed, card))
    lap("mixture of experts")
    planes.update(ssm_paths(P, dev, args.seed, card))
    lap("recurrent families")
    planes["multi-device"] = multi_device_path(P, dev, args.seed, card)
    lap("multi-device on one card")
    planes["fsdp"] = fsdp_path(P, dev, args.seed, card)
    lap("FSDP on one card")
    planes["model axis"] = tp_path(P, dev, args.seed, card)
    lap("model axis on one card")
    planes["recurrent model axis"] = recurrent_tp_path(P, dev, args.seed,
                                                       card)
    lap("recurrent model axis on one card")
    planes["examples"] = examples_path(P, dev, args.seed, card)
    lap("examples")
    planes.update(starcoder_path(P, dev, args.seed, card))
    lap(f"{SC_ARCH}: serve, train, head_dim model axis")
    dryrun_path(dry, dry_dir, start, card)
    lap("dry run (the rest of its time ran beside the phases above)")

    scans = {"scan": res["launches"],
             "packed ingest": ing["launches"]["bitunpack"],
             **{name: planes[name]["launches"]["bitunpack"]
                for name in PATHS
                if "launches" in planes[name]}}
    launches = {"bitunpack": sum(scans.values()),
                "filter_agg": pd["launches"]["filter_agg"],
                "block_agg": pd["launches"]["block_agg"],
                "flash_fwd": sum(planes[name]["launches"]["flash_fwd"]
                                 for name in PATHS
                                 if "launches" in planes[name])}
    print(f"launches per path: scan bitunpack {res['launches']}; device "
          f"pushdown {pd['launches']}; packed ingest {ing['launches']}; "
          + "; ".join(f"{name} {planes[name]['launches']}"
                      for name in PATHS
                      if "launches" in planes[name])
          + "; checkpoint and KV pages launch no kernel, nor does the flash"
          " backward")
    print(f"card: {card}")
    rows = [("bitunpack", "src/repro/kernels/bitunpack.py:52", bu_err, at_obj),
            ("filter_agg", "src/repro/kernels/filter_agg.py:46", fa_err,
             at_fa),
            ("block_agg", "src/repro/kernels/block_agg.py:32", ba_err, at_ba)]
    kernels = [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/csrc/{name}.cu", "replaces": replaces,
        "launches": launches[name], "max_abs_err": err, "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": "bytes", "library_ms": None}
        for name, replaces, err, r in rows]
    kernels.append({
        "name": "flash_fwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_fwd.cu",
        "replaces": "none: the port's block loop on the inference path "
                    "(src/repro_torch/models/attention.py::_flash_fwd)",
        "launches": launches["flash_fwd"],
        "max_abs_err": at_ff["max_abs_err"]["cell"], "ms": at_ff["ms"],
        "plain_ms": at_ff["plain_ms"], "bound_ms": at_ff["bound_ms"],
        "bound_by": "flops", "library_ms": at_ff["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
