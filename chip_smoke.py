#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's transmit, codec, activity, egress, NoC / DSE, serving, training, distribution, tensor-parallel, expert-parallel, SSD / sequence-parallel and encoder-decoder paths on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (into
``build/repro_torch/``), then runs these phases; any failure exits
non-zero:

1. card: the device name, its name and power limit from ``nvidia-smi``,
   and the kernels' build time;
2. kernel vs plain: every kernel on the card against its plain PyTorch
   version on the same inputs (integer outputs must be bit-exact) —
   ``psu_sort`` over ACC / APP k in {2, 4, 8} x direction x width 4/8 x
   N in {25, 32, 64} at P = 100,003, ``bt_count`` on (400,001, L) streams
   of L in {1, 3, 8, 15, 16, 17, 24} (aligned and one byte past an aligned
   base, uint8 and int32, widths 4 / 8 / 12 / 16), their column slices and
   (2, 100,003) streams, ``psu_stream`` on the paired and the 16-lane
   input-only framings in 'lane' and 'row' packing at N in {16, 32, 64}
   (P = 100,003) and 1,024 (P = 2,001), uint8 aligned and one element past
   an aligned base and int32, and ``bt_axes`` (the
   multi-axis measurement) on jagged (6, 1,001, N) batches over every
   ordering (none, column_major, ACC, APP k in {2, 4, 8}, both directions)
   x every codec (bus-invert partitions None / 4 / 2) x width 4/8 x
   'lane' / 'row' x paired / input-only x ``chunk_packets`` 1 / 7 / none,
   and ``bt_axes_activity`` (its per-wire activity windows) over the same
   matrix with windows of 7 rows, and of 1 and 5,000 rows unchunked, and
   ``quantize_egress`` on m in {1, 255, 256, 300, 100,003} x blocks of
   256 / 64 / 100, aligned and unaligned, and on zero, subnormal, tie and
   clamp blocks (codes and scale bits equal);
3. main path: the quickstart's ``psu_sort`` / ``psu_reorder`` call, the
   Table I rows through ``TxPipeline`` (100,000 uniform paired packets;
   the 24-image conv streams), the Fig. 5 area rows and the Fig. 7 power
   rows, each printed beside the paper's value; every BT total must equal
   the pinned reference total below, and the launch counters must show
   that each row went through its kernel;
3b. codec path: ``compare_streams`` at ``benchmarks/codec_bt.py``'s full
   defaults (6-image conv input and weight streams, the 4-image decode and
   all-reduce demo streams, 16 lanes, orderings none / ACC / APP4 x codecs
   none / bus_invert / bus_invert4 / transition), also in 256-packet
   chunks, and coded ``TxPipeline`` rows on Table I's 100,000 uniform
   pairs; every (data, aux) BT total must equal the pins below, the coded
   rows also the ``bt_count_codecs`` column of their config, and the
   counters must show one ``bt_axes`` launch per stream and per chunk;
3c. activity path: ``benchmarks/codec_bt.py --activity`` at its defaults
   (the 6-image conv input stream under the 12 configs, windows of 32 flit
   rows) through ``bt_count_codecs(..., activity_windows=32)``, whole and in
   256-packet chunks, equal to the plain version and to the per-config
   toggle / level pins below; each config's ``repro_torch.obs`` profile
   must pass its per-wire-sum == gross-BT check and the SAIF text written
   into ``build/`` must equal the pinned digest; then phase 3b's
   ``compare_streams`` again under ``obs.collect()`` / ``obs.tracing()``:
   the ``codec.stream.bt`` series must equal the pins, the dispatch
   counters the launch counters, and the launches those of a run without
   observability (trace in ``build/TRACE_chip_smoke.json``);
3d. egress path: a 2**20-element gradient through ``quantize_egress``,
   its int8 wire permuted by ``egress_permutation`` of a weight vector's
   int8 view (APP k = 4 and ACC, packets of 64) and measured by
   ``bt_count``, equal to the JAX pins (code and scale digests, BT before
   and after), and ``benchmarks/arch_bt.py`` rows 1, 3 and 4 equal to
   theirs; then the same path at the full width of internlm2-1.8b's
   gradient (1,889,107,968 elements, made on the card), each kernel
   against its plain version in chunks, the permutation a bijection, and
   the launch counters showing every kernel of the path;
3e. NoC and DSE path: ``repro_torch.noc.simulate_noc`` at
   ``benchmarks/noc_bt.py``'s defaults (3-image conv-platform flows on
   mesh(4, 4) and ring(8) under five (key, sort_at) designs, the hop
   sweep, the hottest links, the mesh ACC fabric with activity windows of
   32 flits into profiles and SAIF, a bus-invert4 fabric, the looped
   ``bt_count`` baseline), ``fleet_noc.py``'s 1,024-flow fleet on
   mesh(16, 16) with its contention model, and ``dse_sweep.py``'s grid
   through ``repro_torch.dse.evaluate_grid`` (front, knee, mesh4x4 point,
   the multi-axis grid also wire-resolved, ``grid_launch_count``,
   ``fig5/k_sweep`` and ``fig7/psu_power_overhead``), each equal to the JAX
   pins below (``NOC_BT``, ``FLEET``, ``DSE_SWEEP``) and to the plain
   versions, every call with its launch counts checked (one ``bt_axes`` or
   ``bt_axes_activity`` launch per fabric or grid width, one ``psu_sort``
   per ACC / APP source order); then one ring reduce-scatter step of the
   same full-width gradient's int8 wire on ring(8) (8 shards of 3,689,664
   packets of 64 bytes) under none / ACC / APP4, every link's BT equal to
   ``bt_count`` of its shard built independently (``psu_reorder`` -> pack),
   with the expansion's, the one measurement's and the source sort's times
   and the peak device memory;
3f. serving path: ``repro_torch.serve.generate`` under
   ``repro_torch.obs.capture()`` on the smoke configs of internlm2-1.8b,
   qwen3-moe-30b-a3b, zamba2-1.2b, mamba2-370m and whisper-medium at
   float32 (weights drawn by ``serve_inputs``): greedy tokens, stream
   names, the weight stream's sha256, ``benchmarks/model_traffic.py``'s
   four-point grid on it, for internlm2-1.8b its NoC run on mesh(4, 4) and
   its grid with activity windows of 32, and ``benchmarks/arch_bt.py`` row
   2, equal to the JAX pins (``SERVE``) and every measurement to its plain
   version, the KV bytes within one int8 code of the JAX package's
   (``tests/data/serve_kv_pins.npz``) on at most 1 % of the bytes; then
   internlm2-1.8b at full width: 4 requests of 256-token prompts and 16
   greedy new tokens served under capture, the 1,889,107,968-byte weight
   stream equal to ``int8_view`` of each leaf in sorted-key order, the
   weight and the KV workloads each through one ``evaluate_grid`` (one
   ``bt_axes`` launch) against the plain version, ``decode_step`` against
   ``forward`` in float32, the APP-ordered weights against the unordered,
   with prefill, decode, capture, measurement and ``bt_axes`` times and
   the peak device memory;
3g. training path: one ``repro_torch.train.make_train_step`` step under
   ``obs.capture()`` on the smoke configs of internlm2-1.8b,
   qwen3-moe-30b-a3b and mamba2-370m at float32 (weights by
   ``draw_params``, batch 2 x 32 by ``obs.train_batch``): loss and
   ``grad_norm`` within a relative 1e-4 of the JAX pins (``TRAIN``), the
   gradient bytes within one int8 code of the JAX package's
   (``tests/data/train_grad_pins.npz``) on at most 1 % of the bytes,
   ``model_traffic.py``'s train_allreduce grid (activity windows of 32) and
   ring(8) fabric equal to the plain versions and, on the pinned bytes, to
   the pins; ``microbatches=2`` against one batch; a ``train()`` run
   preempted at step 5 and resumed from its checkpoints in ``build/``,
   bitwise equal to a straight run; the reference's trained LeNet
   (``tests/data/lenet_ref.npz``) through ``capture_lenet_conv``, its conv
   and input bytes equal to the reference's and ``model_traffic.py``'s
   lenet_conv grid, mesh(4, 4) fabric and recalibration rows
   (``TxPipeline``) equal to the pins (``LENET``) and the plain versions;
   the port's own LeNet trained 300 steps on the card under a loss bound,
   checkpointed and restored; then internlm2-1.8b at full width: 3 steps of
   ``train()`` on 4 x 256 tokens (losses finite, step 0's batch loss
   lower after them), step wall and device time, a float32
   directional-derivative check of the gradient, one ``capture_train_step``
   whose 1,889,110,016-byte grads stream equals ``int8_view`` of each
   gradient leaf, measured as 16 links under the four points and as a
   ring(8) step under none / ACC / APP4 (plain versions on 2 links and on
   ring link 0), and ``compressed_psum`` (int8 + error feedback) of the
   flat gradient, unordered and through the static egress permutation,
   equal, with the wire's BT both ways and the peak device memory;
3h. distribution path: a one-rank NCCL group and a (1, 1) ("data",
   "model") ``DeviceMesh``; internlm2-1.8b at full width trained 3 steps
   on 4 x 256 tokens by ``repro_torch.launch.step``'s rule-placed step,
   once with ZeRO-1 and once plain, every loss and every param leaf
   bitwise equal to phase 3g's ``train()``, with step wall, device time
   and peak; the step's roofline record (``roofline.collect_from_step``:
   ``FlopCounterMode`` FLOPs, peak memory, the recorded collectives) and
   its ``analyse`` terms with the H100's constants beside the measured
   device time; a one-stage ``pipeline_apply`` over the 24 layers and 4
   microbatches bitwise equal to the sequential stack; ``compressed_psum``
   (int8 + error feedback) of the full gradient over the group, unordered
   and through the egress permutation, equal to ``group=None``, and its
   wire's BT both ways; ``bt_count_axes_sharded`` of that wire as 16
   links over the group equal to the unsharded table (one ``bt_axes``
   launch each) and, on one link, the plain version; then the meta dry
   run (``repro_torch.launch.dryrun``) of internlm2-1.8b's four shapes on
   the 16 x 16 mesh, with the collective term of its placed schedule;
3i. tensor-parallel path: on a new one-rank NCCL group and (1, 1) mesh,
   internlm2-1.8b at full width trained 3 steps on 4 x 256 tokens by the
   placed step through ``repro_torch.launch.tp_model`` (every layer
   counted through it, no collective recorded), every loss and param leaf
   bitwise equal to phase 3g's ``train()``, with step wall, device time
   and peak beside 3h's; the placed greedy ``repro_torch.launch.serve``
   ``generate`` at phase 3f's full-width shapes and weights, tokens equal
   to 3f's; the collective term of every dense dry-run cell
   (internlm2-1.8b, qwen3-4b, codeqwen1.5-7b, gemma-7b x train_4k /
   prefill_32k / decode_32k) on 16 x 16, recorded from the placed step,
   prefill or decode on meta blocks; then internlm2-1.8b at full width
   trained 3 steps by two processes of a gloo group sharing the card on a
   (1, 2) mesh (gloo carries CUDA tensors through ``all_reduce``, the only
   collective of that step; NCCL refuses two ranks on one device), losses
   within 5e-3 of 3g's;
3j. expert-parallel path: granite-moe-3b-a800m at full width (d_model
   1,536, 24 heads, 8 kv heads, 48 experts of which 40 real, top-8, expert
   d_ff 512, vocabulary 49,155) at 8 of its 32 layers (its training
   state at 32 passes the card's memory) trained 3 steps on 4 x 256 tokens
   by ``train()``, then on a new one-rank NCCL group and (1, 1) mesh by the
   placed step through the expert-parallel plan of
   ``repro_torch.launch.tp_model`` (every MoE layer counted through it, no
   collective recorded), every loss and every param leaf's sha256 equal,
   with step wall, device time and peak of both; the placed greedy
   ``generate`` at all 32 layers on 4 x 256 prompts + 16 tokens, tokens and
   log-probabilities equal to ``serve.generate``'s, prefill and decode
   times of both; ``obs.capture_moe_dispatch`` at batch 4 x 256 (4 groups,
   capacity 77, 48 experts) as one link under 3f's four points (one
   ``bt_axes`` launch, equal to the plain version), its ACC / APP
   reductions beside 3f's weights' and 3g's gradient's; the dry run's MoE
   cells (qwen3-moe-30b-a3b prefill_32k / decode_32k on 16 x 16, granite's
   optimized-profile train_4k / prefill_32k on 32 x 8: their collective
   terms; the others' reasons); then the 8-layer model trained 3 steps by
   two gloo ranks sharing the card on a (1, 2) mesh (24 of the 48 experts a
   rank), losses within 5e-3 of ``train()``'s;
3k. attention's contraction split: granite-moe-3b-a800m at full width by
   16 processes of a gloo group sharing the card on a (1, 16) mesh (24
   heads, d_model 1,536: ``wq`` split on its input d, ``wo`` on its output
   d, ``wk`` / ``wv`` whole, 3 of the 48 experts a rank; each rank builds
   its blocks in turn and checks it runs on card 0): every rank's plan; the
   placed greedy ``generate`` at 8 of the 32 layers and float32 compute on
   4 x 256 prompts + 16 tokens (split-K cache), its prefill logits and the
   log-probabilities of the one-process tokens where it was fed them within
   ``CP["tol"]`` of a float32 ``serve.generate`` at the same depth and
   weights, greedy tokens equal up to a near tie; 3 placed steps at 8
   layers in bf16, losses within 5e-3 of ``train()``'s at the same depth;
   each rank's peak, step wall, a step's and a decode's collectives equal to
   ``cp_collectives``; the dry run's granite baseline cells on 16 x 16;
3l. the SSD split over "model" and long_500k's sequence-split cache:
   mamba2-370m (48 layers, d_model 1,024, 32 SSM heads) and zamba2-1.2b
   (38 SSM layers, 64 SSM heads, the shared attention and MLP block of 32
   heads and d_ff 8,192) at full width: their plans on 16 x 16 (the SSM
   heads split, ``in_proj`` on d_model, ``out_proj`` on d_inner, the conv
   tail's channel blocks, the partial leaves); each trained 3 steps on 4 x
   256 tokens by ``train()`` and by the placed step on a one-rank NCCL group
   and a (1, 1) mesh (every SSD layer through ``tp_model.ssd_block``),
   losses and every param leaf's sha256 equal, and its placed greedy
   ``generate`` of 4 x 256 prompts + 16 tokens equal to ``serve.generate``
   (and how far its bf16 logits lie from float32 compute); then both, at
   16 and 14 layers, by two gloo ranks sharing the card on (1, 2) at
   float32 compute, losses within 5e-3 of a float32 ``train()``'s at the
   same depth, prefill logits and the one-process tokens'
   log-probabilities within ``SSD["tol"]`` of a float32
   ``serve.generate``'s, tokens equal up to near ties, a step's and a
   decode step's collectives equal to ``ssd_collectives``; long_500k at
   its published size (one request, 524,288 positions, a bf16 cache,
   positions [0, 262,140) drawn chunk by chunk from seeded generators):
   the one-process ``decode_step`` for 8 greedy steps in bf16, then fed
   those tokens at float32 compute on the same bf16 cache, then zamba2 by
   four gloo ranks on (2, 2) (its 25.77 GB KV cache's sequence over
   "data", 6.44 GB a rank; the writes cross the data ranks' blocks) and
   mamba2 by two on (1, 2), at float32 compute and fed the same tokens,
   logits and written rows within ``SSD["tol"]`` of the float32
   one-process run's, greedy tokens equal up to near ties, collectives
   equal to the closed form; mamba2's long_500k
   SSM-state stream as one link under 3f's four points (one ``bt_axes``
   launch, equal to the plain version); the dry run's eight mamba2 /
   zamba2 cells on 16 x 16;
3m. the encoder-decoder over "model": whisper-medium's plans on 16 x 16
   and 32 x 8 (the encoder's, the decoder's and the cross-attention's
   heads, ``d_ff``, embed and head on d), then whisper-medium at full
   width and depth (24 + 24 layers, 1,500 stub frames a request drawn from
   a seed) trained 3 steps of 4 x 256 decoder tokens by ``train()`` and by
   the placed step on a one-rank NCCL group and a (1, 1) mesh (every
   encoder layer through ``tp_model.layer``, every decoder layer through
   ``tp_model.dec_layer``), losses and every param leaf's sha256 equal,
   and its placed greedy ``generate`` with frames (4 x 256 prompts + 16
   tokens) equal to ``serve.generate``'s; then at 8 + 8 layers and
   float32 compute, a batch of 2, by two gloo ranks sharing the card on
   (1, 2): losses within 5e-3 of a float32 ``train()``'s, prefill logits
   and the one-process tokens' log-probabilities within ``AUDIO["tol"]``,
   tokens equal up to near ties, each rank's cross cache within
   ``AUDIO["cross_tol"]`` of the one-process cache's heads, a step's and a
   decode step's collectives equal to ``audio_collectives``; the
   full-width prefill's cross K/V cache as one link under 3f's four points
   (one ``bt_axes`` launch, equal to the plain version); the dry run of
   whisper-medium's three cells on 16 x 16, equal to the CPU's;
3n. the vlm family over "model": internvl2-26b's serve plans on 16 x 16,
   2 x 16 x 16 and 32 x 8 (heads, kv heads split or replicated with
   ``kv_index``, ``d_ff``, embed and head on d), then internvl2-26b at
   full width and depth (48 layers, bf16 weights, 1,024 stub patch
   embeddings a request drawn from a seed in front of 4 x 256 prompts)
   served on a one-rank NCCL group and a (1, 1) mesh: the placed greedy
   ``generate`` with patches equal to ``serve.generate``'s with them as
   ``inputs_embeds`` (tokens and log-probabilities), on the very weight
   tensors; then at 8 layers and float32 compute, a batch of 2, by two gloo
   ranks sharing the card on (1, 2) (the KV cache on kv heads): prefill
   logits and the one-process tokens' log-probabilities within
   ``VLM["tol"]``, tokens equal up to near ties, each rank's KV cache
   within ``VLM["kv_tol"]`` of the one-process cache's kv heads, a
   prefill's and a decode step's collectives equal to
   ``vlm_collectives``; the full-width prefill's KV cache as one link
   under 3f's four points (one ``bt_axes`` launch, equal to the plain
   version); the dry run of internvl2-26b's two serving cells on 16 x 16,
   equal to the CPU's, and its FSDP train cell's reason;
4. scale and times: ``psu_stream`` on 4,194,304 paired packets and on
   Table I's conv input stream (7,350 packets of 64, 16 lanes),
   ``bt_count`` on a 1 GiB (2**27, 8) stream and ``bt_axes`` on a jagged
   (256, 16,384, 64) batch, the same batch through ``bt_axes_activity``
   with windows of 512 rows (also in 4,096-packet chunks), all generated
   on the card and checked against the plain versions, then CUDA-event
   medians of the kernels, their plain versions and a library call where
   one exists, at the main path's shapes and at the scale shapes (for
   ``quantize_egress``: 2**20 elements and the full-width gradient), and
   each call's device time from the profiler, split by CUDA kernel (for
   ``bt_axes``: the block kernel and the fold; at scale ``bt_axes`` and
   ``bt_axes_activity`` also under subsets of their configs, to show where
   their time goes) and printed beside the time recorded before each
   kernel's redesign (``BEFORE_DEVICE_MS``).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  The full record is also
written to ``build/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks.datagen import conv_streams, im2col, synth_images, uniform_pairs  # noqa: E402
from repro_torch import _obs_hooks, dse, kernels, launch, noc, obs, optim, serve, train  # noqa: E402
from repro_torch._tree import leaves as tree_leaves  # noqa: E402
from repro_torch._tree import leaves_with_path as tree_leaves_with_path  # noqa: E402
from repro_torch._tree import tree_map  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.codec import compare_streams, demo_workloads, format_table  # noqa: E402
from repro_torch.codec import codec_by_name, kernel_config  # noqa: E402
from repro_torch.core import bitonic_area, bucket_map, csn_area, popcount, psu_area  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    CodecVariant,
    Variant,
    _build,
    bt_count,
    bt_count_axes,
    bt_count_codecs,
    psu_reorder,
    psu_sort,
    psu_stream,
)
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import lenet_params_from_reference, params_from_numpy  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMDataset  # noqa: E402
from repro_torch.models import (  # noqa: E402
    decode_step,
    forward,
    init_cache,
    init_params,
    param_shapes,
    prefill,
    unembed,
)
from repro_torch.kernels import quantize_egress  # noqa: E402
from repro_torch.models import lenet  # noqa: E402
from repro_torch.models.layers import decode_attend, torch_dtype  # noqa: E402
from repro_torch.optim.compress import int8_wire  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402
from repro_torch.kernels.axes import max_partitions  # noqa: E402
from repro_torch.noc.fabric import _queue_gather_table  # noqa: E402
from repro_torch.link import LinkPowerModel, LinkSpec, TxPipeline  # noqa: E402
from repro_torch.traffic import (  # noqa: E402
    apply_weight_ordering,
    egress_permutation,
    int8_view,
    stream_bt_report,
    tensor_flit_stream,
)

# --------------------------------------------------------------------------
# Pinned main-path BT totals: (input side, weight side) integers computed
# with the JAX package (``repro``, compiled backend, CPU) at exactly these
# sizes and ``benchmarks/datagen.py`` seeds.  tests/test_torch_link.py
# holds both packages to them.

TABLE1_UNIFORM = {
    "packets": 100_000,
    "elems": 32,
    "seed": 0,
    "bt": {
        "none": (12803695, 12799579),
        "column_major": (12805903, 12796277),
        "acc": (11342485, 12798993),
        "app": (11572722, 12799749),
    },
}
# conv rows: input and weight streams measured separately on a 16-lane
# input-only link (table1_bt._measure_separate), APP k = 4
TABLE1_CONV = {
    "images": 24,
    "lanes": 16,
    "k": 4,
    "bt": {
        "none": (992965, 1815870),
        "column_major": (966224, 1867508),
        "acc": (658854, 1750977),
        "app": (734012, 1719223),
    },
}

# The codec path: (data BT, invert-line BT) of every row of
# ``compare_streams`` at benchmarks/codec_bt.py's defaults, computed with
# the JAX package (compiled backend, CPU).
CODEC_COMPARE = {
    "lanes": 16,
    "conv_images": 6,
    "demo_images": 4,
    "orderings": (Variant("none"), Variant("acc"), Variant("app", 4)),
    "codecs": ("none", "bus_invert", "bus_invert4", "transition"),
    "bt": {
        "conv": {
            "none": (702851, 0),
            "none+bus_invert": (663451, 2973),
            "none+bus_invert4": (630823, 14422),
            "none+transition": (632521, 0),
            "acc": (601882, 0),
            "acc+bus_invert": (595562, 1183),
            "acc+bus_invert4": (554050, 11782),
            "acc+transition": (632519, 0),
            "app4": (613179, 0),
            "app4+bus_invert": (602693, 1382),
            "app4+bus_invert4": (566227, 11008),
            "app4+transition": (632516, 0),
        },
        "decode": {
            "none": (98560, 0),
            "none+bus_invert": (90026, 772),
            "none+bus_invert4": (81810, 3066),
            "none+transition": (98416, 0),
            "acc": (70735, 0),
            "acc+bus_invert": (70719, 2),
            "acc+bus_invert4": (67343, 787),
            "acc+transition": (98421, 0),
            "app4": (74162, 0),
            "app4+bus_invert": (74136, 8),
            "app4+bus_invert4": (70234, 891),
            "app4+transition": (98420, 0),
        },
        "allreduce": {
            "none": (65275, 0),
            "none+bus_invert": (58395, 500),
            "none+bus_invert4": (51023, 2014),
            "none+transition": (64147, 0),
            "acc": (31549, 0),
            "acc+bus_invert": (31549, 0),
            "acc+bus_invert4": (31191, 93),
            "acc+transition": (64146, 0),
            "app4": (34055, 0),
            "app4+bus_invert": (34055, 0),
            "app4+bus_invert4": (33687, 93),
            "app4+transition": (64147, 0),
        },
    },
}
# The activity path: benchmarks/codec_bt.py --activity at its defaults —
# the conv input stream of CODEC_COMPARE under its 12 configs, windows of
# 32 flit rows — computed with the JAX package (compiled backend, CPU).
# Per config label (ordering key + codec + partition, as the bench names
# its profiles): sha256 of the int32 toggles (windows, wires) bytes, sha256
# of the int32 ones (wires,) bytes, the toggle sum and the ones sum.  The
# SAIF digest is of repro.obs.write_saif(..., design="codec_bt") over the
# 12 profiles; stream_bt the codec.stream.bt series of phase 3b's streams.
CODEC_ACTIVITY = {
    "window": 32,
    "windows": 230,
    "wires": 132,
    "configs": {
        "none+none": ("e7bd2632666a97415c8553ecf37c6bc23cac526d8a2801a9953e581015a109c6",
                "a139041650fdc45def3843af810fa4aebc24b56976fca396b918468f3596abdb", 248792, 173803),
        "none+bus_invert": ("f136a1a47f855ee04fa9adb4f2d686894c9fae5c2a51b7ccd87741d1ff2788d1",
                "b9214fc6bff64354e53192d95ae7f97027802ee29a5aeebf8d9cdf9cbeec1523", 247322, 443229),
        "none+bus_invert4": ("48c805d243c1ca218b2f65bbb2e479308736a15176285e491cccadc7e5809752",
                "e3246018bd779c1e8d89955aaca15b3a73edcad66b7bd6c8903d1f72a5020946", 244765, 376016),
        "none+transition": ("669b6afe5fe47f672d6736fc0a60eebf1b007bf8b3565a4a459a52d8b9c79442",
                "c2dabfab3ac3640aa70af916f0b46a009a170f3f6c456d82af18fc53203ca7c3", 173793, 469192),
        "acc+none": ("dcb37b46cd3ab8b1604fb1d6e059c731b1d5aef0b83a3128fbacbbf430d872df",
                "8291385f1497c4cec8a49f8671902fb42d42c82aa194dbde389d3a0dcbb59f8d", 164058, 173803),
        "acc+bus_invert": ("d1266be4af796315fe9b21ef29ec139e7f9f79355dcef6c56ed04547cf730de0",
                "9ffc0bbe6e441788b27f4fcb16d68d7c494faecf2a1af75f04801726b8678232", 164051, 418198),
        "acc+bus_invert4": ("412af450b815a62fe78571a933ece3b3d5113e72a0071b5827e07d7d2c175b15",
                "8215dbf8cbf2cf7cdb2dd2d2e2c3b614c0ef1d7132efcd633af2958535c7881b", 159706, 321448),
        "acc+transition": ("77bb04654db083909f63e48e2bf9336fca5324461bd452b6552d001f33465b1b",
                "14aeba8a9a2fbf2453eb449107bced024b47e12e2a7af3ecf828eb893ab547d9", 173793, 445215),
        "app+none": ("b8713c76cae7ef2961d1bcf9645ec87a43c0c68103a96368540c6ffbad844f2d",
                "ff519b8fa9f6e3e977ad683c7cc40b8ed477ebc965b121375ab6972734f1de0f", 183276, 173803),
        "app+bus_invert": ("3c6dd47a6d94bf91e6fffa171f0e59ee39de05fd1d69e5c316f1cf6767cf84e1",
                "5510e072bdf51e50eee117abe74a1d8d5f71284755f3eb982df254f840ef3136", 183246, 231603),
        "app+bus_invert4": ("7e388cea83bf3eb673a109f42c0254fbea98787550d63d0c7473e2b86bd2025e",
                "76a9eac4b3024fffd062b84bab9a6d67061692280b935f9bd374d4057c5ef388", 178413, 293459),
        "app+transition": ("d996c7df753eaeffbcf2ea248fe26bf340afb31e75768b953f3538c300033716",
                "5225bcac9c598426419e06dfec0a75286be906acffa082abb4cf5c84123eb271", 173791, 472362),
    },
    "saif_sha256": "204eaf549461e38afa419cf33e6321d65244159e498856a0305980589799338a",
    "stream_bt": {"conv[0]": 248792, "conv[1]": 454059, "decode[0]": 98560, "allreduce[0]": 65275},
}
# coded TxPipeline rows on TABLE1_UNIFORM's pairs (paper framing):
# (input BT, weight BT, invert-line BT), JAX package, compiled backend
CODED_TX = {
    ("acc", "bus_invert4"): (10662877, 11010279, 589692),
    ("acc", "transition"): (12798609, 12796850, 0),
    ("app", "bus_invert4"): (10759568, 11010251, 618387),
    ("app", "transition"): (12798608, 12796846, 0),
}

# The egress path (phase 3d), pinned case: a 2**20-element gradient
# quantized to int8 by blocks of 256, its wire image permuted by the static
# popcount order of a 2**20-element weight vector's int8 view (packets of
# 64; APP k = 4 and ACC), and the BT of both wires on 16 byte lanes;
# inputs from egress_inputs().  sha256 of the int8 code bytes and of the
# float32 scale bytes, and (unpermuted, permuted) BT per strategy, computed
# with the JAX package (compiled backend, CPU).  tests/test_torch_traffic.py
# holds both packages to them.
EGRESS = {
    "elems": 1 << 20,
    "block": 256,
    "packet": 64,
    "seed": 0,
    "codes_sha256": "749165d5a9e5d4e407fa1e87092e8a4691c1f16055b5da3da57b904d968d35e3",
    "scales_sha256": "ac7338009796faa7bfbdb4785b1ed24a96e4b3812359497ac5439ac7e8f7b1fb",
    "bt": {"app": (4195461, 4193940), "acc": (4195461, 4195292)},
}
# benchmarks/arch_bt.py rows 1, 3 and 4 (row 2 needs the model zoo), on
# arch_bt_inputs(), JAX package: the weight-stream reports (flits, BT
# unordered, BT ordered) per sign-magnitude / layout / strategy, the MoE
# dispatch rows (BT unordered, BT ordered) and the grad-egress row (BT
# unpermuted, BT permuted).
ARCH_BT = {
    "weights": {
        "sm=0/row/none": (16384, 906573, 906573),
        "sm=0/row/acc": (16384, 906573, 902684),
        "sm=0/row/app": (16384, 906573, 903432),
        "sm=0/col/none": (16384, 969492, 969492),
        "sm=0/col/acc": (16384, 969492, 910345),
        "sm=0/col/app": (16384, 969492, 926674),
        "sm=1/row/none": (16384, 388058, 388058),
        "sm=1/row/acc": (16384, 388058, 385688),
        "sm=1/row/app": (16384, 388058, 387109),
        "sm=1/col/none": (16384, 436161, 436161),
        "sm=1/col/acc": (16384, 436161, 402746),
        "sm=1/col/app": (16384, 436161, 422296),
    },
    "moe_dispatch": (50281, 50185),
    "grad_egress": (262549, 262204),
}
# the full-width egress gradient: the flat parameter vector of this config
EGRESS_ARCH = "internlm2-1.8b"


def egress_inputs(m: int = EGRESS["elems"], seed: int = EGRESS["seed"]):
    """(gradient, weights), float32 numpy: g = N(0, 1) scaled per block of
    256 by a lognormal(0, 2) factor, w = N(0, 1)."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=m).reshape(-1, 256) * rng.lognormal(0, 2, size=(m // 256, 1))
    w = rng.normal(size=m)
    return g.reshape(-1).astype(np.float32), w.astype(np.float32)


def arch_bt_inputs() -> dict:
    """benchmarks/arch_bt.py's float inputs of rows 1, 3 and 4, drawn in its
    order from np.random.default_rng(0) (row 2 draws nothing from it), as
    float32 — what its jnp.asarray makes of them."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(1024, 256)) * rng.lognormal(0, 1.0, (1024, 1))
    toks = rng.normal(size=(256, 128)) * rng.lognormal(0, 0.8, (256, 1))
    wflat = rng.normal(size=(64 * 1024,))
    g = rng.normal(size=(64 * 1024,))
    return {k: v.astype(np.float32) for k, v in
            (("weights", w), ("tokens", toks), ("wflat", wflat), ("grad", g))}


# the paper's values, printed beside the port's rows
PAPER_UNIFORM = {"none": (63.072, 0.0), "column_major": (54.011, 14.366),
                 "acc": (50.346, 20.177), "app": (50.896, 19.305)}
PAPER_INPUT = {"none": 31.035, "column_major": 26.004, "acc": 22.333, "app": 22.887}
PAPER_AREA = {("app", 25): 2193.0, ("app", 49): 6928.0, "reduction_n25": 35.4}
PAPER_POWER = {"acc": {"bt": 20.42, "link_power": 18.27},
               "app": {"bt": 19.50, "link_power": 16.48}}

STRATS = ("none", "column_major", "acc", "app")

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and the CUDA-core rate
MEM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12

KERNELS = {
    "psu_sort": {
        "source": "src/repro_torch/kernels/csrc/psu.cu",
        "replaces": "src/repro/kernels/psu.py:117",
    },
    "bt_count": {
        "source": "src/repro_torch/kernels/csrc/btcount.cu",
        "replaces": "src/repro/kernels/btcount.py:33",
    },
    "psu_stream": {
        "source": "src/repro_torch/kernels/csrc/stream.cu",
        "replaces": "src/repro/kernels/axes.py:519",
    },
    "bt_axes": {
        "source": "src/repro_torch/kernels/csrc/axes.cu",
        "replaces": "src/repro/kernels/axes.py:519",
    },
    "bt_axes_activity": {
        "source": "src/repro_torch/kernels/csrc/axes.cu",
        "replaces": "src/repro/kernels/axes.py:519 (mode d)",
    },
    "quantize_egress": {
        "source": "src/repro_torch/kernels/csrc/quantize.cu",
        "replaces": "src/repro/kernels/quantize.py:31",
    },
}

# Each kernel's device time (ms, torch.profiler) at its phase-4 shapes —
# main, scale and, where there is one, a third (egress; for psu_stream the
# Table I conv stream) — on an NVIDIA H100 80GB HBM3 at 700 W before its
# redesign (PERF.md's kernel table): psu_sort, bt_axes and quantize_egress
# with their first versions; bt_count, bt_axes_activity and psu_stream
# with the versions their redesign replaced (psu_stream's conv time: that
# version under this script's conv case).  Phase 4 prints them beside its
# own.
BEFORE_DEVICE_MS = {
    "psu_sort": (0.0019584, 1.145806, 12.1694994),
    "bt_count": (0.00545, 0.5865, 0.1385),
    "psu_stream": (0.0434, 1.717, 0.01203),
    "bt_axes": (0.130239, 5.9027808),
    "bt_axes_activity": (0.0743, 21.95),
    "quantize_egress": (0.0033098, 4.0300034),
}

# phase 4's third case of a kernel when it is not the egress path's
THIRD_CASE = {"psu_stream": "conv"}

SCALE_PACKETS = 4_194_304
SCALE_BT_ROWS = 2**27
# the jagged multi-axis batch: links x packets x bytes (256 MiB of uint8),
# input-only 16-lane links, and its 14 configs (the 12 of the codec path,
# column_major + gray, descending ACC + sign-magnitude)
SCALE_AXES = (256, 16_384, 64)
SCALE_WINDOW = 512  # flit rows per activity window at scale: 128 windows
SCALE_AXES_CONFIGS = tuple(
    CodecVariant(*o, c, part)
    for o in CODEC_COMPARE["orderings"]
    for c, part in (("none", None), ("bus_invert", None), ("bus_invert", 4), ("transition", None))
) + (CodecVariant("column_major", None, False, "gray"),
     CodecVariant("acc", None, True, "sign_magnitude"))


def log(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest absolute difference of two integer tensors (0 = bit-exact);
    a shape or dtype mismatch fails."""
    if a.shape != b.shape or a.dtype != b.dtype:
        fail(f"shape/dtype differ: {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """Least time the card could take: bytes over HBM rate vs integer ops
    over the CUDA-core rate, in ms, with which one bounds."""
    t_bytes = bytes_moved / MEM_BYTES_PER_S * 1e3
    t_ops = ops / CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def axes_work(xb, vb, configs) -> dict:
    """Work of one ``bt_axes`` measurement.  Bytes: each valid packet byte
    read once, valid counts and totals.  Operations: per valid byte ~4 per
    distinct sorted ordering (key, rank, scatter) and ~3 per config (code,
    XOR-popcount, add)."""
    nl, npk, nb = xb.shape
    vbytes = int(vb.clamp(0, npk).sum()) * nb
    sorted_orderings = {c.ordering for c in configs if c.key in ("acc", "app")}
    return {
        "shape": [nl, npk, nb, "input-only 16 lanes", f"{len(configs)} configs"],
        "bytes": vbytes + nl * 8 + nl * len(configs) * 12,
        "ops": vbytes * (4 * len(sorted_orderings) + 3 * len(configs)),
    }


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, names: tuple[str, ...], reps: int = 5) -> tuple[float | None, dict]:
    """Device time per call of the kernels whose names contain one of
    ``names``, from ``torch.profiler`` (None when it records none), and
    the same split by kernel (``repro::<kernel>`` or the matched name)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split: dict[str, float] = {}
    for ev in prof.key_averages():
        hit = [n for n in names if n in ev.key]
        t = getattr(ev, "self_device_time_total", 0)
        if hit and t:
            own = re.search(r"repro::(\w+)", ev.key)
            key = own.group(1) if own else hit[0]
            split[key] = split.get(key, 0.0) + t / reps / 1e3
    total = sum(split.values())
    return (total if total else None), split


def wall_ms(fn, reps: int = 10) -> float:
    """Host wall time per call of ``fn`` over ``reps`` back-to-back calls
    ended by one synchronize: the rate a caller sees."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def input_only_spec(strat: str, elems: int, lanes: int = 16, k: int = 4) -> LinkSpec:
    """One PE's input-side link: all lanes carry one stream's bytes."""
    return LinkSpec(width_bits=8 * lanes, flits_per_packet=elems // lanes,
                    input_lanes=lanes, weight_lanes=0, key=strat, k=k)


# ------------------------------------------------------------------ phase 1


def phase_card() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"device: {name} (count {torch.cuda.device_count()}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log("nvidia-smi name, power.limit:")
    log(smi)
    seconds, build_log = _build.timed_build()
    log(f"kernels built and loaded in {seconds:.1f} s")
    for line in build_log.splitlines():  # per kernel: name, registers, spills
        if any(w in line for w in ("entry function", "registers", "spill")):
            log("  ptxas:", line.strip())
    return {"name": name, "smi": smi, "build_s": seconds}


# ------------------------------------------------------------------ phase 2


def phase_kernels(dev: torch.device, p: int = 100_003, t: int = 400_001,
                  pa: int = 1001) -> dict:
    """Every kernel against its plain version on the card; returns the
    largest absolute difference per kernel (must be 0)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    errs = {"psu_sort": 0, "bt_count": 0, "psu_stream": 0, "bt_axes": 0, "bt_axes_activity": 0,
            "quantize_egress": 0}

    def rand(shape, dtype=torch.uint8, hi=256):
        return torch.randint(0, hi, shape, generator=gen, device=dev, dtype=dtype)

    cases = 0
    for n in (25, 32, 64):
        x8 = rand((p, n))
        x32 = rand((p, n), torch.int32, 1 << 16)
        for width in (4, 8):
            for k in (None, 2, 4, 8):
                if k is not None and k > width + 1:
                    continue
                for desc in (False, True):
                    for x in (x8, x32) if (width, desc) == (8, False) else (x8,):
                        got = psu_sort(x, width=width, k=k, descending=desc)
                        ref = psu_sort(x, width=width, k=k, descending=desc, backend="torch")
                        e = max(max_err(got[0], ref[0]), max_err(got[1], ref[1]))
                        errs["psu_sort"] = max(errs["psu_sort"], e)
                        cases += 1
                        if e:
                            fail(f"psu_sort N={n} W={width} k={k} desc={desc} {x.dtype}: err {e}")
    log(f"psu_sort: {cases} cases at P={p} bit-exact")

    # bt_count: contiguous streams (aligned and one byte past an aligned
    # base) of odd and even lane counts, int32 streams, column slices (row
    # strided, at even and odd offsets) and a short wide stream
    cases = 0
    for lanes in (1, 3, 8, 15, 16, 17, 24):
        flat8 = rand((t * lanes + 1,))
        s8 = flat8[: t * lanes].view(t, lanes)
        s32 = rand((t, lanes), torch.int32, 1 << 16)
        views = [s8, flat8[1:].view(t, lanes), s32]
        if lanes >= 8:
            views += [s8[:, : lanes // 2], s8[:, lanes // 2:], s8[:, 1:], s32[:, lanes // 2:]]
        for width in (4, 8, 12, 16) if lanes in (8, 16) else (8,):
            for v in views:
                got, ref = bt_count(v, width=width), bt_count(v, width=width, backend="torch")
                e = max_err(got, ref)
                errs["bt_count"] = max(errs["bt_count"], e)
                cases += 1
                if e:
                    fail(f"bt_count {tuple(v.shape)} stride {v.stride()} {v.dtype} "
                         f"offset {v.storage_offset()} W={width}: err {e}")
    wide = rand((2, 100_004))
    for v in (wide, wide[:, 1:], wide.view(-1)[1: 1 + 2 * 100_003].view(2, 100_003),
              rand((2, 100_003), torch.int32, 1 << 16)):
        got, ref = bt_count(v), bt_count(v, backend="torch")
        e = max_err(got, ref)
        errs["bt_count"] = max(errs["bt_count"], e)
        cases += 1
        if e:
            fail(f"bt_count short wide {tuple(v.shape)} stride {v.stride()}: err {e}")
    log(f"bt_count: {cases} cases at T={t} bit-exact (lanes 1-24, unaligned bases, int32, "
        f"column slices, (2, 100,003))")

    # psu_stream: the paired and 16-lane input-only framings, 16-byte and
    # 1,024-element packets (P = 2,001: a few packets a tile, so many
    # tiles), uint8 aligned and one element past an aligned base (the
    # element-wise load path) and int32
    cases = 0
    for n, il, paired, pn in ((32, 8, True, p), (64, 16, False, p), (16, 8, True, p),
                              (1024, 32, True, 2_001)):
        flat_x, flat_w = rand((pn * n + 1,)), rand((pn * n + 1,))
        views = {"u8": (flat_x[: pn * n].view(pn, n), flat_w[: pn * n].view(pn, n)),
                 "u8+1": (flat_x[1:].view(pn, n), flat_w[1:].view(pn, n)),
                 "i32": (rand((pn, n), torch.int32, 1 << 16), rand((pn, n), torch.int32, 1 << 16))}
        for view, (x, w) in views.items():
            for pack in ("lane", "row"):
                for width, k, desc in ((8, None, False), (8, 4, False), (8, 4, True),
                                       (8, 2, False), (4, None, True), (4, 4, False)):
                    kw = dict(width=width, k=k, descending=desc, input_lanes=il, pack=pack)
                    ww = w if paired else None
                    got = psu_stream(x, ww, **kw)
                    ref = psu_stream(x, ww, backend="torch", **kw)
                    e = max(max_err(a, b) for a, b in zip(got, ref))
                    errs["psu_stream"] = max(errs["psu_stream"], e)
                    cases += 1
                    if e:
                        fail(f"psu_stream ({pn}, {n}) {view} il={il} paired={paired} {pack} "
                             f"W={width} k={k} desc={desc}: err {e}")
    log(f"psu_stream: {cases} cases at P={p} (N = 16, 32, 64) and 2,001 (N = 1,024), uint8 "
        f"aligned and unaligned, int32, bit-exact")

    # bt_axes: jagged links (valid 0, P and past P among them) x the whole
    # ordering x codec grid, each chunking against the unchunked plain version
    links = 6  # pa is no multiple of the kernel's packets per block
    valid = torch.tensor([0, pa, 1, 500, pa + 40, 777], device=dev)
    orderings = [("none", None, False), ("column_major", None, False), ("acc", None, False),
                 ("acc", None, True), ("app", 2, False), ("app", 2, True), ("app", 4, False),
                 ("app", 4, True), ("app", 8, False), ("app", 8, True)]
    codecs = [("none", None), ("gray", None), ("sign_magnitude", None), ("transition", None),
              ("bus_invert", None), ("bus_invert", 4), ("bus_invert", 2)]
    cases = acases = 0
    for n, il, paired, pack in ((32, 8, True, "lane"), (32, 8, True, "row"),
                                (64, 16, False, "lane"), (64, 16, False, "row")):
        x, w = rand((links, pa, n)), rand((links, pa, n))
        for width in (4, 8):
            configs = tuple(CodecVariant(*o, c, part) for o in orderings for c, part in codecs
                            if (o[1] or 0) <= width + 1)
            kw = dict(configs=configs, width=width, input_lanes=il, pack=pack)
            ww = w if paired else None
            ref = bt_count_axes(x, ww, valid, backend="torch", **kw)
            for chunk in (None, 1, 7):
                got = bt_count_axes(x, ww, valid, chunk_packets=chunk, **kw)
                e = max_err(got, ref)
                errs["bt_axes"] = max(errs["bt_axes"], e)
                cases += 1
                if e:
                    bad = (got != ref).nonzero()[:4].tolist()
                    fail(f"bt_axes N={n} il={il} paired={paired} {pack} W={width} "
                         f"chunk={chunk}: err {e} at (link, config, column) {bad}")
            # the activity mode: windows of 7 rows in every chunking, and
            # one-row and longer-than-the-stream windows unchunked
            for window, chunks in ((7, (None, 1, 7)), (1, (None,)), (5000, (None,))):
                aref = bt_count_axes(x, ww, valid, backend="torch", activity_windows=window, **kw)
                for chunk in chunks:
                    got = bt_count_axes(x, ww, valid, chunk_packets=chunk,
                                        activity_windows=window, **kw)
                    for field, a, b in zip(aref._fields, got, aref):
                        e = max_err(a, b)
                        errs["bt_axes_activity"] = max(errs["bt_axes_activity"], e)
                        if e:
                            bad = (a != b).nonzero()[:4].tolist()
                            fail(f"bt_axes_activity {field} N={n} il={il} paired={paired} "
                                 f"{pack} W={width} window={window} chunk={chunk}: err {e} "
                                 f"at {bad}")
                    acases += 1
    log(f"bt_axes: {cases} cases of {len(orderings)} orderings x {len(codecs)} codecs at "
        f"({links}, {pa}, N) bit-exact")
    log(f"bt_axes_activity: {acases} cases of the same grid (bt, toggles, ones) bit-exact")

    # quantize_egress: lognormal-scaled blocks over ragged lengths and block
    # sizes (float4 and scalar paths), then the edge blocks, also unaligned
    special = torch.from_numpy(quantizer_edge_cases()).to(dev)
    cases = 0
    for m in (1, 255, 256, 300, 100_003):
        x = torch.randn(m + 1, generator=gen, device=dev)
        x *= torch.exp(2 * torch.randn(m + 1, generator=gen, device=dev))
        for block in (256, 64, 100):
            for v in (x[:m], x[1:], special):  # x[1:] is not 16-byte aligned
                got = quantize_egress(v, block=block)
                ref = quantize_egress(v, block=block, backend="torch")
                e = max(max_err(got[0], ref[0]),
                        max_err(got[1].view(torch.int32), ref[1].view(torch.int32)))
                errs["quantize_egress"] = max(errs["quantize_egress"], e)
                cases += 1
                if e or got[2] != ref[2]:
                    fail(f"quantize_egress m={v.shape[0]} block={block}: err {e} "
                         f"(codes, scale bits) or padded size {got[2]} vs {ref[2]}")
    log(f"quantize_egress: {cases} cases (m up to 100,003, blocks 256 / 64 / 100, zero, "
        f"subnormal, tie and clamp blocks) bit-exact, scales by their bits")
    torch.cuda.synchronize()
    return errs


def quantizer_edge_cases() -> np.ndarray:
    """Blocks of 256 float32 that pin the quantizer's edges: all zero
    (with -0.0), amax 1e-37 and +-1e-40 (scale flushed to 0, codes 0), a
    subnormal beside a scale just above the smallest normal, amax 127 (scale
    exactly 1) with half-way ties and +-127 clamps, and N(0, 1) with its
    +-amax pair."""
    rng = np.random.default_rng(3)
    b = np.zeros((7, 256), np.float32)
    b[0, ::2] = -0.0
    b[1] = np.where(rng.random(256) < 0.5, -1e-37, 1e-37)
    b[2] = np.where(rng.random(256) < 0.5, np.float32(-1e-40), np.float32(1e-40))
    b[3, 0], b[3, 1], b[3, 2] = 1.5e-36, 1e-38, -1e-36
    b[4, :254] = np.arange(254) - 126.5  # x.5 ties under scale 1
    b[4, 254], b[4, 255] = -127.0, 127.0
    b[5] = rng.normal(size=256)
    b[5, 7] = -np.abs(b[5]).max()
    b[6] = rng.normal(size=256) * 1e30
    return b.reshape(-1)


# ------------------------------------------------------------------ phase 3


def phase_main(dev: torch.device) -> dict:
    """The port's main path through its user entry points; checks every BT
    total against the pins and returns the rows plus the launch counts."""
    rows = {}
    kernels.reset_launch_counts()

    def through(kernel: str, row: str, fn):
        """Run one main-path row; it must launch ``kernel`` and no other."""
        before = kernels.launch_counts()
        out = fn()
        delta = {k: v - before[k] for k, v in kernels.launch_counts().items()}
        if delta[kernel] < 1 or any(v for k, v in delta.items() if k != kernel):
            fail(f"{row}: launches {delta}, expected the {kernel} kernel only")
        return out

    # the quickstart's first call: one 16-byte packet through the PSU
    rng = np.random.default_rng(0)
    packet = torch.from_numpy(rng.integers(0, 256, (1, 16), dtype=np.uint8)).to(dev)
    order, rank = through("psu_sort", "quickstart", lambda: psu_sort(packet, k=4))
    ordered = through("psu_sort", "quickstart", lambda: psu_reorder(packet, k=4))
    ref_order, ref_rank = psu_sort(packet, k=4, backend="torch")
    ref_ordered = psu_reorder(packet, k=4, backend="torch")
    e = max(max_err(order, ref_order), max_err(rank, ref_rank), max_err(ordered, ref_ordered))
    pc = [bin(int(v)).count("1") * 4 // 9 for v in ordered[0].tolist()]
    if e or pc != sorted(pc):
        fail(f"quickstart psu_sort/psu_reorder: err {e} vs plain, or not bucket-monotone")
    log(f"quickstart APP order: {order[0].tolist()}")
    rows["quickstart_order"] = order[0].tolist()

    # Table I, paired uniform framing (the paper's 100k packets)
    u = TABLE1_UNIFORM
    inp, wgt = uniform_pairs(u["packets"], u["elems"], seed=u["seed"])
    inp, wgt = torch.from_numpy(inp).to(dev), torch.from_numpy(wgt).to(dev)
    path = {"none": "bt_count", "column_major": "bt_count", "acc": "psu_stream",
            "app": "psu_stream"}
    reps = {
        s: through(path[s], f"table1/uniform/{s}",
                   lambda s=s: TxPipeline(LinkSpec(key=s)).measure(inp, wgt))
        for s in STRATS
    }
    for s, r in reps.items():
        if (r.input_bt, r.weight_bt) != u["bt"][s]:
            fail(f"table1/uniform/{s}: BT {(r.input_bt, r.weight_bt)} != pinned {u['bt'][s]}")
        if r.num_flits != u["packets"] * 4 or r.fused != (s in ("acc", "app")):
            fail(f"table1/uniform/{s}: {r.num_flits} flits, fused={r.fused}")
        red = r.reduction_vs(reps["none"]) * 100
        rows[f"table1/uniform/{s}"] = {"bt_per_flit": r.overall_bt_per_flit, "red_pct": red,
                                       "input_bt": r.input_bt, "weight_bt": r.weight_bt}
        log(f"table1/uniform/{s:12s} bt/flit={r.overall_bt_per_flit:.3f} red={red:.2f}% "
            f"fused={int(r.fused)} | paper bt/flit={PAPER_UNIFORM[s][0]} "
            f"red={PAPER_UNIFORM[s][1]}%")

    # Table I, conv traffic (24 LeNet-like images), sides measured apart
    c = TABLE1_CONV
    streams = conv_streams(n_images=c["images"])
    streams_cm = conv_streams(n_images=c["images"], column_major=True)
    per_flit = {}
    for s in STRATS:
        src, key = (streams_cm, "none") if s == "column_major" else (streams, s)
        got = []
        for side in src:
            x = torch.from_numpy(side).to(dev)
            pipe = TxPipeline(input_only_spec(key, x.shape[-1], c["lanes"], c["k"]))
            got.append(through(path[s], f"table1/conv/{s}", lambda: pipe.measure(x)))
        bts = tuple(r.input_bt for r in got)
        if bts != c["bt"][s]:
            fail(f"table1/conv/{s}: BT {bts} != pinned {c['bt'][s]}")
        per_flit[s] = tuple(r.overall_bt_per_flit for r in got)
    base_i, base_w = per_flit["none"]
    for s in STRATS:
        bi, bw = per_flit[s]
        red = 100 * (1 - (bi + bw) / (base_i + base_w))
        in_red = 100 * (1 - bi / base_i)
        paper_in_red = 100 * (1 - PAPER_INPUT[s] / PAPER_INPUT["none"])
        rows[f"table1/conv/{s}"] = {"in": bi, "wt": bw, "overall_red_pct": red,
                                    "input_red_pct": in_red}
        log(f"table1/conv/{s:12s} in={bi:.3f} (paper {PAPER_INPUT[s]}) wt={bw:.3f} "
            f"overall_red={red:.2f}% input_red={in_red:.2f}% "
            f"(paper input_red={paper_in_red:.2f}%)")

    # Fig. 5: the closed-form area model
    for n in (25, 49):
        designs = {"bitonic": bitonic_area(n), "csn": csn_area(n),
                   "acc_psu": psu_area(n), "app_psu": psu_area(n, k=4)}
        for name, a in designs.items():
            log(f"fig5/N{n}/{name:8s} popcount={a.popcount:.0f}um2 sort={a.sort:.0f}um2 "
                f"total={a.total:.0f}um2")
        acc, app = designs["acc_psu"], designs["app_psu"]
        red = 100 * (1 - app.total / acc.total)
        rows[f"fig5/N{n}"] = {"acc": acc.total, "app": app.total, "red_pct": red}
        log(f"fig5/N{n}/reduction overall={red:.1f}% | paper app={PAPER_AREA[('app', n)]}um2"
            + (f" red={PAPER_AREA['reduction_n25']}%" if n == 25 else ""))
        if abs(app.total - PAPER_AREA[("app", n)]) > 1.0:
            fail(f"fig5/N{n}: APP area {app.total} off its anchor")
    if round(rows["fig5/N25"]["red_pct"], 1) != PAPER_AREA["reduction_n25"]:
        fail("fig5: APP vs ACC reduction at N=25 is not 35.4%")

    # Fig. 7: link power from the measured conv BT reductions
    model = LinkPowerModel()
    for s in ("acc", "app"):
        bt_red = rows[f"table1/conv/{s}"]["overall_red_pct"] / 100
        link_red = model.power_reduction(bt_red) * 100
        rows[f"fig7/{s}"] = {"bt_red_pct": bt_red * 100, "link_power_red_pct": link_red}
        log(f"fig7/{s} bt_red={bt_red * 100:.2f}% (paper {PAPER_POWER[s]['bt']}%) "
            f"link_power_red={link_red:.2f}% (paper {PAPER_POWER[s]['link_power']}%)")

    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    # psu_sort: quickstart sort + reorder; bt_count: uniform none and
    # column_major (2 halves each) + conv none and column_major (2 sides
    # each); psu_stream: uniform acc/app + conv acc/app (2 sides each)
    expected = {k: 0 for k in counts} | {"psu_sort": 2, "bt_count": 8, "psu_stream": 6}
    log(f"main-path launches: {counts} (expected {expected})")
    if counts != expected:
        fail(f"main-path launch counts {counts} != {expected}")
    return {"rows": rows, "launches": counts}


# ------------------------------------------------------------------ phase 3b


def phase_codec(dev: torch.device) -> dict:
    """The codec path: ordering vs coding vs both through
    ``compare_streams``, and coded ``TxPipeline`` rows; checks every
    (data, aux) BT total against the pins and returns the rows plus the
    launch counts."""
    cc = CODEC_COMPARE
    inp, wgt = conv_streams(n_images=cc["conv_images"])
    demo = demo_workloads(images=cc["demo_images"], device=dev)
    workloads = {
        "conv": (torch.from_numpy(inp).to(dev), torch.from_numpy(wgt).to(dev)),
        "decode": demo["decode"],
        "allreduce": demo["allreduce"],
    }
    rows = {}
    kernels.reset_launch_counts()
    expected = {k: 0 for k in kernels.launch_counts()}

    def launched(what: str, want: dict) -> None:
        got = kernels.launch_counts()
        for k, v in want.items():
            expected[k] += v
        if got != expected:
            fail(f"{what}: launch counts {got} != {expected}")

    for name, streams in workloads.items():
        for chunk in (None, 256):
            table = compare_streams(
                streams, cc["lanes"], orderings=cc["orderings"], codecs=cc["codecs"],
                workload=name, chunk_packets=chunk,
            )
            calls = sum(1 if chunk is None else -(-int(s.shape[0]) // chunk) for s in streams)
            launched(f"codec/{name} chunk={chunk}", {"bt_axes": calls})
            got = {r.label: (r.data_bt, r.aux_bt) for r in table}
            if got != cc["bt"][name]:
                bad = {k: (v, cc["bt"][name].get(k)) for k, v in got.items()
                       if v != cc["bt"][name].get(k)}
                fail(f"codec/{name} chunk={chunk}: rows differ from the pins {bad}")
        log(format_table(table))
        for r in table:
            rows[f"codec/{name}/{r.label}"] = {
                "data_bt": r.data_bt, "aux_bt": r.aux_bt, "net_red_pct": 100 * r.bt_reduction,
                "power_red_pct": 100 * r.power_reduction, "energy_pj": r.energy_pj,
            }
            log(f"codec/{name}/{r.label:18s} data_bt={r.data_bt} aux_bt={r.aux_bt} "
                f"| reference {cc['bt'][name][r.label]}")
        log(f"codec/{name}: {len(table)} rows equal the pins, unchunked and in 256-packet "
            f"chunks ({len(streams)} stream(s))")

    # coded TxPipeline rows on Table I's uniform pairs (the paper framing)
    u = TABLE1_UNIFORM
    ui, uw = (torch.from_numpy(a).to(dev)
              for a in uniform_pairs(u["packets"], u["elems"], seed=u["seed"]))
    for (key, codec), pin in CODED_TX.items():
        spec = LinkSpec(key=key, codec=codec)
        rep = TxPipeline(spec).measure(ui, uw)
        launched(f"tx/{key}+{codec}", {"bt_count": 2})
        col = bt_count_codecs(ui, uw, configs=(kernel_config(spec),), input_lanes=8)[0]
        launched(f"tx/{key}+{codec} column", {"bt_axes": 1})
        got = (rep.input_bt, rep.weight_bt, rep.aux_bt)
        if got != pin or tuple(col.tolist()) != pin or rep.fused:
            fail(f"tx/{key}+{codec}: TxPipeline {got}, bt_count_codecs {col.tolist()}, "
                 f"pinned {pin}, fused={rep.fused}")
        rows[f"tx/uniform/{key}+{codec}"] = {
            "input_bt": rep.input_bt, "weight_bt": rep.weight_bt, "aux_bt": rep.aux_bt,
            "extra_wires": rep.extra_wires, "energy_pj": rep.energy_pj,
        }
        log(f"tx/uniform/{key}+{codec:11s} (in, wt, aux)={got} extra_wires={rep.extra_wires} "
            f"energy={rep.energy_pj:.2f} pJ = bt_count_codecs column = reference")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"codec-path launches: {counts}")
    return {"rows": rows, "launches": counts}


# ------------------------------------------------------------------ phase 3c


def _codec_configs() -> tuple[CodecVariant, ...]:
    """The codec path's 12 (ordering, codec) configs in grid order."""
    cc = CODEC_COMPARE
    return tuple(
        CodecVariant(o.key, o.k, o.descending, codec_by_name(c).scheme,
                     codec_by_name(c).partition)
        for o in cc["orderings"] for c in cc["codecs"]
    )


def _sha256(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().to(torch.int32).contiguous().numpy().tobytes()).hexdigest()


def _leaf_sha256(t: torch.Tensor) -> str:
    """The sha256 of a tensor's bytes."""
    return hashlib.sha256(t.detach().contiguous().view(torch.uint8).cpu().numpy()).hexdigest()


def phase_activity(dev: torch.device) -> dict:
    """The activity path: per-wire windows of the conv stream under the
    codec grid, into profiles and SAIF; then the codec path under
    observability.  Checks everything against the pins and returns the
    rows, the launch counts and the largest kernel-vs-plain difference."""
    ca, cc = CODEC_ACTIVITY, CODEC_COMPARE
    inp, wgt = conv_streams(n_images=cc["conv_images"])
    x = torch.from_numpy(inp).to(dev)
    configs = _codec_configs()
    kw = dict(configs=configs, input_lanes=cc["lanes"], activity_windows=ca["window"])
    kernels.reset_launch_counts()
    whole = bt_count_codecs(x, None, **kw)
    chunked = bt_count_codecs(x, None, chunk_packets=256, **kw)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    chunks = -(-x.shape[0] // 256)
    want = {k: 0 for k in counts} | {"bt_axes_activity": 1 + chunks}
    log(f"activity-path launches: {counts} (expected {want})")
    if counts != want:
        fail(f"activity path: launch counts {counts} != {want}")
    plain = bt_count_codecs(x, None, backend="torch", **kw)
    err = 0
    for field, a, b, c in zip(plain._fields, whole, chunked, plain):
        e = max(max_err(a, c), max_err(b, c))
        err = max(err, e)
        if e:
            fail(f"activity path {field}: kernel (whole / 256-packet chunks) vs plain err {e}")
    nwires = ca["wires"]
    if tuple(whole.toggles.shape) != (len(configs), ca["windows"], nwires):
        fail(f"activity path: toggles {tuple(whole.toggles.shape)}")
    p, n = x.shape
    duration = p * (n // cc["lanes"])
    profiles, rows = [], {}
    bt = whole.bt.sum(-1).tolist()
    for ci, cfg in enumerate(configs):
        label = f"{cfg.key}+{cfg.codec}" + (f"{cfg.partition}" if cfg.partition else "")
        got = (_sha256(whole.toggles[ci]), _sha256(whole.ones[ci]),
               int(whole.toggles[ci].sum()), int(whole.ones[ci].sum()))
        if got != ca["configs"][label]:
            fail(f"activity/{label}: {got} != pinned {ca['configs'][label]}")
        prof = obs.profile_from_arrays(label, whole.toggles[ci], whole.ones[ci],
                                       window_flits=ca["window"], duration_flits=duration,
                                       data_lanes=cc["lanes"])
        prof.check(bt[ci])  # per-wire sum == gross BT
        profiles.append(prof)
        hot = prof.hottest_wires(1)[0]
        rows[f"activity/{label}"] = {"toggles": got[2], "ones": got[3], "hot_wire": hot[0],
                                     "hot_wire_toggles": hot[1]}
        log(f"activity/{label:18s} toggles={got[2]} (= gross BT) ones={got[3]} "
            f"hot wire {hot[0]} x{hot[1]} | equals the reference's digests")
    out = ROOT / "build"
    text = obs.write_saif(str(out / "ACTIVITY_codec_bt.saif"), profiles, design="codec_bt")
    obs.write_wires_csv(str(out / "ACTIVITY_codec_bt_wires.csv"), profiles)
    saif = hashlib.sha256(text.encode()).hexdigest()
    if saif != ca["saif_sha256"]:
        fail(f"activity SAIF digest {saif} != the reference's {ca['saif_sha256']}")
    log(f"activity SAIF ({len(profiles)} profiles x {nwires} wires, {ca['windows']} windows of "
        f"{ca['window']} flits) equals the reference's text: sha256 {saif}")

    # phase 3b's comparison under observability, against one without it
    demo = demo_workloads(images=cc["demo_images"], device=dev)
    workloads = {"conv": (x, torch.from_numpy(wgt).to(dev)), "decode": demo["decode"],
                 "allreduce": demo["allreduce"]}

    def compare_all():
        for name, streams in workloads.items():
            compare_streams(streams, cc["lanes"], orderings=cc["orderings"],
                            codecs=cc["codecs"], workload=name)
        torch.cuda.synchronize()

    compare_all()  # warm: the timed runs below start from the same state
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    compare_all()
    wall_off = (time.perf_counter() - t0) * 1e3
    off = kernels.launch_counts()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with obs.collect() as reg, obs.tracing() as tracer:
        compare_all()
    wall_on = (time.perf_counter() - t0) * 1e3
    on = kernels.launch_counts()
    if on != off:
        fail(f"launches with observability {on} != without {off}")
    series = {s.labels["stream"]: int(s.value) for s in reg.series("codec.stream.bt")}
    if series != ca["stream_bt"]:
        fail(f"codec.stream.bt series {series} != pinned {ca['stream_bt']}")
    calls = reg.value("kernel.dispatch.calls", entry="bt_count_axes", backend="cuda")
    obs_launches = sum(s.value for s in reg.series("kernel.launches"))
    if calls != on["bt_axes"] or obs_launches != sum(on.values()):
        fail(f"kernel.dispatch calls {calls} / launches {obs_launches} != launch counters {on}")
    tracer.write(str(out / "TRACE_chip_smoke.json"), metadata={"phase": "3c"})
    log(f"obs: codec.stream.bt {series} = pins; kernel.dispatch calls {calls}, launches "
        f"{obs_launches} = launch counters {on} = without observability; "
        f"{len(tracer.events)} trace events -> build/TRACE_chip_smoke.json")
    log(f"obs: the 4 streams' comparison took {wall_off:.3f} ms of host wall without "
        f"observability and {wall_on:.3f} ms collecting and tracing (one run each)")
    return {"rows": rows, "launches": counts, "max_abs_err": err, "saif_sha256": saif,
            "stream_bt": series, "obs_launches": on, "wall_ms_obs_off": wall_off,
            "wall_ms_obs_on": wall_on}


# ------------------------------------------------------------------ phase 3d


def _bt_sum(s: torch.Tensor, backend: str | None = None, rows: int = 1 << 23) -> int:
    """Exact BT of a (T, L) stream as a Python int: the int32 counts of row
    chunks of at most ``rows`` rows (2**23 rows x 16 lanes cannot pass
    2**31 flips), overlapping by one row."""
    return sum(int(bt_count(s[r0: r0 + rows + 1], backend=backend))
               for r0 in range(0, max(s.shape[0] - 1, 0), rows))


def _wire(codes: torch.Tensor) -> torch.Tensor:
    """The int8 wire image as (T, 16) uint8 flits (a view)."""
    return tensor_flit_stream(codes.view(torch.uint8))


def _permute(codes: torch.Tensor, perm: torch.Tensor, step: int = 1 << 27) -> torch.Tensor:
    """codes[perm], gathered in chunks: an int64 index of the whole
    permutation would take 8 bytes per element."""
    out = torch.empty_like(codes)
    for a in range(0, perm.shape[0], step):
        out[a: a + step] = codes[perm[a: a + step].to(torch.int64)]
    return out


def full_gradient(m: int, dev: torch.device) -> tuple[torch.Tensor, torch.Generator]:
    """The full-width flat gradient, made on the card: N(0, 1) scaled by
    lognormal(0, 2) per quantizer block (seed 14), and its generator."""
    gen = torch.Generator(device=dev).manual_seed(14)
    g = torch.randn(m, generator=gen, device=dev)
    block = EGRESS["block"]
    nb = m // block
    g[: nb * block].view(nb, block).mul_(
        torch.empty((nb, 1), device=dev).log_normal_(0, 2, generator=gen))
    return g, gen


def phase_egress(dev: torch.device, full: bool = True) -> dict:
    """The gradient-egress path: quantize -> static popcount permutation ->
    BT, at the pinned size against the JAX pins (and benchmarks/arch_bt.py
    rows 1, 3 and 4), then at the full width of EGRESS_ARCH's gradient
    against the plain versions.  Returns the rows and the launch counts."""
    e = EGRESS
    rows = {}
    kernels.reset_launch_counts()

    # (i) the pinned case
    g, w = (torch.from_numpy(a).to(dev) for a in egress_inputs())
    codes, scales, mp = quantize_egress(g, block=e["block"])
    digests = (hashlib.sha256(codes.cpu().numpy().tobytes()).hexdigest(),
               hashlib.sha256(scales.cpu().numpy().astype("<f4").tobytes()).hexdigest())
    if mp != e["elems"] or digests != (e["codes_sha256"], e["scales_sha256"]):
        fail(f"egress quantizer: padded size {mp}, digests {digests} != the JAX pins")
    w8 = int8_view(w)
    for strat, pin in e["bt"].items():
        perm, inv = egress_permutation(w8, packet=e["packet"], strategy=strat, k=4)
        got = (int(bt_count(_wire(codes))), int(bt_count(_wire(_permute(codes, perm)))))
        if got != pin:
            fail(f"egress/{strat}: BT {got} != pinned {pin}")
        red = 100 * (1 - got[1] / got[0])
        rows[f"egress/{strat}"] = {"bt": got[0], "bt_perm": got[1], "red_pct": red}
        log(f"egress/{strat} 2**20 grads: codes and scales = JAX digests, bt={got[0]} "
            f"bt_perm={got[1]} red={red:.3f}% = reference")

    # benchmarks/arch_bt.py rows 1, 3 and 4 on its own inputs
    a = {k: torch.from_numpy(v).to(dev) for k, v in arch_bt_inputs().items()}
    for key, pin in ARCH_BT["weights"].items():
        sm, layout, strat = key.split("/")
        rep = stream_bt_report("w", a["weights"], strat, sign_magnitude=sm == "sm=1",
                               layout=layout)
        got = (rep.num_flits, int(rep.bt_none), int(rep.bt_ordered))
        if got != pin:
            fail(f"arch_bt/weights/{key}: {got} != pinned {pin}")
        rows[f"arch_bt/weights/{key}"] = {"bt_per_flit": got[2] / got[0],
                                          "red_pct": 100 * rep.reduction}
    t8 = int8_view(a["tokens"])
    spec = LinkSpec(flits_per_packet=1, input_lanes=16, weight_lanes=0, key="row_bucket",
                    encode="sign_magnitude", pack="row", k=4)
    got = tuple(TxPipeline(sp).measure_rows(t8, "moe_dispatch").total_bt
                for sp in (dataclasses.replace(spec, key="none"), spec))
    if got != ARCH_BT["moe_dispatch"]:
        fail(f"arch_bt/moe_dispatch: {got} != pinned {ARCH_BT['moe_dispatch']}")
    rows["arch_bt/moe_dispatch/app"] = {"bt": got[0], "bt_ordered": got[1]}
    perm, _ = egress_permutation(int8_view(a["wflat"]), packet=64)
    gg = int8_view(a["grad"])
    got = (int(bt_count(_wire(gg))), int(bt_count(_wire(_permute(gg, perm)))))
    if got != ARCH_BT["grad_egress"]:
        fail(f"arch_bt/grad_egress: {got} != pinned {ARCH_BT['grad_egress']}")
    rows["arch_bt/grad_egress/static_perm"] = {"bt": got[0], "bt_perm": got[1]}
    log(f"arch_bt rows 1, 3, 4: {len(ARCH_BT['weights'])} weight-stream reports, the MoE "
        f"dispatch pair {ARCH_BT['moe_dispatch']} and the grad-egress pair "
        f"{ARCH_BT['grad_egress']} = reference")
    del g, w, w8, codes, scales, a

    # (ii) full width: the flat gradient of EGRESS_ARCH, made on the card
    m = get_config(EGRESS_ARCH).param_count() if full else 64 * 1000 + 3
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    g, gen = full_gradient(m, dev)
    nb = m // e["block"]
    codes, scales, mp = quantize_egress(g, block=e["block"])
    step = 1 << 26  # plain check in row chunks of 2**18 blocks
    err = 0
    for a0 in range(0, m, step):
        qc, sc, _ = quantize_egress(g[a0: a0 + step], block=e["block"], backend="torch")
        b0 = a0 // e["block"]
        err = max(err, max_err(codes[a0: a0 + qc.shape[0]], qc),
                  max_err(scales[b0: b0 + sc.shape[0]].view(torch.int32), sc.view(torch.int32)))
    if err or mp != m + (-m) % e["block"]:
        fail(f"egress full width: quantizer err {err} vs plain, padded size {mp}")
    del g
    w = torch.randn(m, generator=gen, device=dev)
    w8 = int8_view(w)
    del w
    perm, inv = egress_permutation(w8, packet=e["packet"])
    pstep = (1 << 19) * e["packet"]  # plain check in chunks of 2**19 packets
    for a0 in range(0, m, pstep):
        rp, ri = egress_permutation(w8[a0: a0 + pstep], packet=e["packet"], backend="torch")
        err = max(err, max_err(perm[a0: a0 + pstep] - a0, rp),
                  max_err(inv[a0: a0 + pstep] - a0, ri))
        # a bijection: every inv[perm[i]] == i, with perm inside [0, m)
        pc = perm[a0: a0 + pstep]
        ok = bool(((pc >= 0) & (pc < m)).all()) and torch.equal(
            inv[pc.to(torch.int64)], torch.arange(a0, a0 + pc.shape[0], dtype=torch.int32,
                                                  device=dev))
        if not ok:
            fail(f"egress full width: perm is no bijection in [{a0}, {a0 + pstep})")
    if err:
        fail(f"egress full width: permutation err {err} vs plain")
    del w8, inv
    wire = codes[:m]
    permuted = _permute(wire, perm)
    del perm
    bt = (_bt_sum(_wire(wire)), _bt_sum(_wire(permuted)))
    plain = (_bt_sum(_wire(wire), "torch"), _bt_sum(_wire(permuted), "torch"))
    if bt != plain:
        fail(f"egress full width: BT {bt} vs plain {plain}")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    red = 100 * (1 - bt[1] / bt[0])
    flits = m // 16
    rows["egress/full"] = {"arch": EGRESS_ARCH, "elems": m, "blocks": nb, "packets": m // 64,
                           "flits": flits, "bt": bt[0], "bt_perm": bt[1], "red_pct": red,
                           "peak_bytes": peak, "seconds": seconds}
    log(f"egress/full {EGRESS_ARCH}: {m} grads, {mp // e['block']} quantizer blocks, "
        f"{m // 64} packets, {flits} flits: codes, scales, perm (a bijection) and BT equal the "
        f"plain versions; bt={bt[0]} bt_perm={bt[1]} red={red:.4f}% (uncorrelated grads: "
        f"expected ~0); peak {peak} bytes allocated; {seconds:.1f} s")
    del codes, scales, wire, permuted
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    chunks = -(-(flits - 1) // (1 << 23))
    # quantizer: pinned + full; psu_sort: the two pinned strategies, arch_bt
    # row 4, full; bt_count: 2 per pinned strategy, 2 per weight report, 2
    # for the MoE dispatch, 2 for row 4, and the full width's chunks x 2
    expected = {k: 0 for k in counts} | {
        "quantize_egress": 2, "psu_sort": 4,
        "bt_count": 2 * len(e["bt"]) + 2 * len(ARCH_BT["weights"]) + 4 + 2 * chunks,
    }
    log(f"egress-path launches: {counts} (expected {expected})")
    if counts != expected:
        fail(f"egress-path launch counts {counts} != {expected}")
    return {"rows": rows, "launches": counts, "max_abs_err": err}


# ------------------------------------------------------------------ phase 3e
# The NoC fabric and the design-space sweep.  Pins from the JAX package
# (``repro``, compiled backend, CPU) on the same inputs:
# benchmarks/noc_bt.py's defaults (NOC_BT), benchmarks/fleet_noc.py's
# (FLEET) and benchmarks/dse_sweep.py's with fig5_area.py's k sweep and
# fig7_power.py's sorting-unit overhead row (DSE_SWEEP).  Digests are of
# ``links_digest`` / ``evals_digest`` below and of the SAIF text of
# ``write_saif(..., design="noc_bt")``; tests/test_torch_noc.py and
# tests/test_torch_dse.py hold both packages to them.

NOC_FABRICS = (("mesh", (4, 4), 0, tuple(r for r in range(16) if r % 4)),  # PEs off col 0
               ("ring", (8,), 0, tuple(range(1, 8))))
NOC_DESIGNS = (("none", "source"), ("acc", "source"), ("app", "source"), ("acc", "hop"),
               ("none", "hop"))

NOC_BT = {
    "n_images": 3,
    "max_hops": 6,
    "window": 32,  # flit rows per activity window (noc_bt.py --activity)
    # per fabric and (key, sort_at): total BT, active links, flit hops,
    # links_digest of the (link, bt_input, bt_weight) rows
    "designs": {
        "mesh4x4": {
            "none-source": [1220904, 12, 25704,
                           "9017c710f71cb230431ac63329d15c6303035e02c4de56d602e56777aa743a72"],
            "acc-source": [1112357, 12, 25704,
                          "ca4882ba71471029c46ac0a59098137abd6a221987c7a864990eb874e2264a70"],
            "app-source": [1136002, 12, 25704,
                          "b7bc615d54683a403f5cf71d12910698cbb5220223ecbfa5dee230c7b5232065"],
            "acc-hop": [1102142, 12, 25704,
                       "b57b4dccbe0c329094b040201f130e141e3e6afe4b60366a19f625512429c47c"],
            "none-hop": [1210317, 12, 25704,
                        "88663cefbe273b3b170086b00004c4fa42fb9918ac07a8e571f6775b38300522"],
        },
        "ring1x8": {
            "none-source": [790267, 7, 16776,
                           "603c9051ba8dfd1b55e73e5b8750dd787551e2ef91150ab586bbd49a18922c79"],
            "acc-source": [723532, 7, 16776,
                          "b25a82168e12d98570029be383ac0b358687ff48de382b5150da8809a258743c"],
            "app-source": [738142, 7, 16776,
                          "4dd082a40c8d7cfc549025f6b357d5739c310c1506406060ae05dec397927a65"],
            "acc-hop": [716012, 7, 16776,
                       "b424945404d2524a5ec121101dcfc271eb64eb373ad7ef6e573dc0df40406970"],
            "none-hop": [788440, 7, 16776,
                        "52ddee229f98c4b716411e633f362dcea2e218e449f2d8b6bf656e44994f0908"],
        },
    },
    # the mesh acc/source fabric's top 3 links: (link, gross BT)
    "hot_links": [[0, 317991], [2, 212197], [5, 105994]],
    # the hop sweep: (hops, BT none, BT acc) of one paired unicast flow
    "hops": [[1, 18544, 16632], [2, 37088, 33264], [3, 55632, 49896], [4, 74176, 66528],
             [5, 92720, 83160], [6, 111264, 99792]],
    "saif_sha256": "c02f3ce1099df82e56bfade5d2c497263bc706f987d7b51a844a5707a0fe4e9b",
    "coded": [1006867, 24196],  # mesh acc + bus_invert4: (total BT, aux BT)
}

FLEET = {
    "users": 16, "layers": 16, "shards": 4, "rows": 16, "cols": 16,
    "plan": [1024, 240, 64],  # flows, active links, distinct queues
    "bt": {"none": 4703297, "acc": 4150346, "app": 4231682},  # source-sorted fabrics
    "latency": [9110.0, 3342.0, 240],  # max / mean flow latency (ns), contended links
}

DSE_SWEEP = {
    "conv_images": 8,
    "ks": (2, 4, 8),
    "ns": (25, 49),
    "window": 32,  # activity windows of the axis grid's wire-resolved run
    "bt": {  # label: (total BT, aux BT)
        "none@N25": [929378, 0], "acc@N25": [797027, 0], "app-k2@N25": [874104, 0],
        "app-k4@N25": [812190, 0], "app-k8@N25": [800413, 0], "column_major@N25": [967505, 0],
        "bitonic@N25": [797027, 0], "csn@N25": [797027, 0], "none@N49": [929378, 0],
        "acc@N49": [797027, 0], "app-k2@N49": [874104, 0], "app-k4@N49": [812190, 0],
        "app-k8@N49": [800413, 0], "column_major@N49": [967505, 0], "bitonic@N49": [797027, 0],
        "csn@N49": [797027, 0],
    },
    "evals_sha256": "c0a9f47c0b937f22d5ad62dd11d956ea2c5d074c5ff34a3b8a2783a5bac54b0e",
    "front": ["none@N25", "acc@N25", "app-k2@N25", "app-k4@N25", "app-k8@N25", "bitonic@N25",
              "none@N49"],  # the 3-objective front of the whole grid
    "knee": "app-k4@N25",  # of the area x BT plane at N = 25
    "noc_point_sha256": "d824d2e1df2adfc84940992f7e45f9f1205ae1faba772a39ffd46d22e0c633b4",
    "axis_sha256": "4f0b4ba951071be77747a21d2f0dd325bcf32f93ebe8531be4549779abbfb275",
    "axis_activity_sha256": "a3a19445b44cb5bb3113cce00935d7e1c9bdadef0e48dcbe79ec8ea1a52efb55",
    "grid_launches": 1,
    "fig5_k_sweep": {"k2": "total=1703um2", "k4": "total=2193um2", "k8": "total=3126um2"},
    "fig7_psu_power_overhead": "app/acc area ratio=0.646 -> overhead reduction=35.4%",
}


def links_digest(report) -> str:
    """sha256 of a NoC report's per-link (link, bt_input, bt_weight) rows."""
    rows = [[s.link, s.bt_input, s.bt_weight] for s in report.links]
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def evals_digest(evals) -> str:
    """sha256 of every measured and derived field of DSE evaluations (floats
    by their exact repr)."""
    rows = [[e.label, e.total_bt, e.aux_bt, e.num_flits, e.bt_reduction, e.area_reduction,
             e.link_power_reduction, e.energy_pj, e.noc_bt_reduction, e.noc_active_links,
             e.noc_latency_ns, e.extra_wires,
             None if e.per_wire_bt is None else list(e.per_wire_bt)] for e in evals]
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def noc_conv_inputs(n_images: int) -> tuple[list[np.ndarray], np.ndarray]:
    """noc_bt.py's conv-platform payloads: each image's im2col patches and
    one output channel's kernel bytes."""
    kernel = np.random.default_rng(0).integers(0, 256, (25,), dtype=np.uint8)
    return [np.ascontiguousarray(im2col(img, 5)) for img in synth_images(n_images, seed=7)], kernel


def noc_hop_inputs(max_hops: int) -> tuple[np.ndarray, np.ndarray, list[int]]:
    """noc_bt.py's hop sweep: 96 paired 32-byte packets and the mesh(4, 4)
    routers at XY distance 1..max_hops from router 0 (capped at the
    diameter)."""
    rng = np.random.default_rng(1)
    img = synth_images(1, seed=11)[0]
    pkts = np.ascontiguousarray(im2col(img, 5).reshape(-1)[: 96 * 32].reshape(96, 32))
    wgts = rng.integers(0, 256, pkts.shape, dtype=np.uint8)
    hops = range(1, min(max_hops, 6) + 1)
    return pkts, wgts, [4 * max(0, h - 3) + min(h, 3) for h in hops]


def fleet_weights() -> np.ndarray:
    """fleet_noc.py's weight tensor (its int8 wire image is itself)."""
    return np.random.default_rng(0).integers(0, 256, (1 << 16,), dtype=np.uint8)


def dse_grid(ks, ns, mod=dse) -> tuple:
    """dse_sweep.py's grid: the k sweep, column-major and the comparator
    families at each sort width (``mod``: the package building the points)."""
    points = []
    for n in ns:
        points.extend(mod.k_sweep(n=n, width=8, ks=ks))
        points.append(mod.DesignPoint(n=n, width=8, k=None, ordering="column_major"))
        points.append(mod.DesignPoint(family="bitonic", n=n, width=8, k=None, ordering="acc"))
        points.append(mod.DesignPoint(family="csn", n=n, width=8, k=None, ordering="acc"))
    return tuple(points)


def dse_axis_points(n: int, ks, mod=dse) -> tuple:
    """dse_sweep.py's full multi-axis grid: the k sweep, a bus-invert4
    point and a mesh4x4 point."""
    return tuple(mod.k_sweep(n=n, width=8, ks=ks)) + (
        mod.DesignPoint(n=n, ordering="acc", k=None, codec="bus_invert4"),
        mod.DesignPoint(n=n, ordering="app", k=4, topology="mesh4x4"),
    )


def _device_total_ms(fn, reps: int = 3, top: int = 6) -> tuple[float | None, dict]:
    """Device time per call of every CUDA kernel ``fn`` launches
    (``torch.profiler``; None when it records none), and the ``top``
    kernels' shares of it by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages()
           if str(getattr(ev, "device_type", "")).endswith("CUDA") and ev.self_device_time_total]
    evs.sort(key=lambda ev: -ev.self_device_time_total)
    total = sum(ev.self_device_time_total for ev in evs)
    split = {ev.key[:80]: ev.self_device_time_total / reps / 1e3 for ev in evs[:top]}
    return (total / reps / 1e3 if total else None), split


class _PathLaunches:
    """The launch counts of one path's calls: each call runs with every
    count set to 0 just before it and read just after (checks between the
    calls launch nothing that counts)."""

    def __init__(self):
        self.total = {k: 0 for k in kernels.launch_counts()}

    def run(self, what: str, fn, expect: dict):
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = kernels.launch_counts()
        want = {k: 0 for k in got} | expect
        if got != want:
            fail(f"{what}: launches {got} != {want}")
        for k, v in got.items():
            self.total[k] += v
        return out


def _same_links(a, b, what: str) -> None:
    if [dataclasses.astuple(s) for s in a.links] != [dataclasses.astuple(s) for s in b.links]:
        fail(f"{what}: link rows differ from the plain version's")


def _sorts(key: str) -> dict:
    """psu_sort launches of a fabric's source order: one for acc / app."""
    return {"psu_sort": 1} if key in ("acc", "app") else {}


def phase_noc(dev: torch.device, full: bool = True) -> dict:
    """The NoC fabric and the design-space sweep: (a) benchmarks/noc_bt.py,
    (b) fleet_noc.py and (c) dse_sweep.py at their defaults against the JAX
    pins and the plain versions, (d) one ring all-reduce step of
    EGRESS_ARCH's whole int8 gradient against independent per-shard
    ``bt_count`` measurements.  Returns rows, times and the launch counts."""
    t_phase = time.perf_counter()
    lc = _PathLaunches()
    rows: dict = {}
    nb = NOC_BT

    # (a) the paper's NoC: conv-platform traffic on a mesh and a ring
    patches, kernel = noc_conv_inputs(nb["n_images"])
    kt = torch.from_numpy(kernel).to(dev)
    mesh_flows = None
    for kind, args, src, pes in NOC_FABRICS:
        topo = getattr(noc, kind)(*args)
        tname = f"{topo.kind}{topo.rows}x{topo.cols}"
        flows = [f for pt in patches for f in noc.conv_platform_flows(
            torch.from_numpy(pt).to(dev), kt, topo, src, pes, LinkSpec())]
        if kind == "mesh":
            mesh_topo, mesh_flows = topo, flows
        base = None
        for key, sort_at in NOC_DESIGNS:
            spec = LinkSpec(key=key)
            watch = (kind, key, sort_at) == ("mesh", "acc", "source")
            with (obs.collect() if watch else contextlib.nullcontext()) as reg:
                rep = lc.run(f"noc/{tname}/{key}-{sort_at}", lambda: noc.simulate_noc(
                    topo, flows, spec, sort_at=sort_at), {"bt_axes": 1} | _sorts(key))
            _same_links(rep, noc.simulate_noc(topo, flows, spec, sort_at=sort_at,
                                              backend="torch"), f"noc/{tname}/{key}-{sort_at}")
            got = [rep.total_bt, rep.active_links, rep.total_flit_hops, links_digest(rep)]
            pin = nb["designs"][tname][f"{key}-{sort_at}"]
            if got != pin:
                fail(f"noc/{tname}/{key}-{sort_at}: {got} != pinned {pin}")
            if base is None:
                base = rep
            rows[f"noc/{tname}/{key}-{sort_at}"] = {
                "bt": rep.total_bt, "red_pct": 100 * rep.reduction_vs(base),
                "links": rep.active_links, "flit_hops": rep.total_flit_hops,
                "energy_nj": rep.energy_pj / 1e3}
            if reg is not None:
                hot = [[r["link"], r["gross_bt"]] for r in obs.top_links(reg, 3)]
                if hot != nb["hot_links"]:
                    fail(f"noc hot links {hot} != pinned {nb['hot_links']}")
                rows["noc/hot_links"] = hot
        log(f"noc/{tname}: {len(flows)} conv flows, 5 designs x (total BT, active links, flit "
            "hops, per-link digest) = reference and = the plain versions; "
            + " ".join(f"{k}={rows[f'noc/{tname}/{k}']['red_pct']:.2f}%"
                       for k in ("acc-source", "app-source", "acc-hop")))
    # the hop sweep: one paired unicast flow at XY distance 1..max_hops
    pkts, wgts, dests = noc_hop_inputs(nb["max_hops"])
    pk, wg = torch.from_numpy(pkts).to(dev), torch.from_numpy(wgts).to(dev)
    hops = []
    for dst in dests:
        flow = [noc.TrafficFlow("sweep", 0, (dst,), pk, wg)]
        bt = [lc.run(f"noc/hops to {dst}", lambda: noc.simulate_noc(
            mesh_topo, flow, LinkSpec(key=key)), {"bt_axes": 1} | _sorts(key)).total_bt
            for key in ("none", "acc")]
        hops.append([noc.hop_count(mesh_topo, 0, dst), *bt])
    if hops != nb["hops"]:
        fail(f"noc hop sweep {hops} != pinned {nb['hops']}")
    rows["noc/hops"] = hops
    # the mesh acc/source fabric wire by wire, into profiles and SAIF
    w = nb["window"]
    rep = lc.run("noc activity", lambda: noc.simulate_noc(
        mesh_topo, mesh_flows, LinkSpec(key="acc"), activity_windows=w),
        {"bt_axes_activity": 1, "psu_sort": 1})
    plain = noc.simulate_noc(mesh_topo, mesh_flows, LinkSpec(key="acc"), activity_windows=w,
                             backend="torch")
    _same_links(rep, plain, "noc activity")
    if not all(np.array_equal(a, b) for a, b in zip(rep.wire_toggles + rep.wire_ones,
                                                     plain.wire_toggles + plain.wire_ones)):
        fail("noc activity: wire arrays differ from the plain version's")
    profiles = obs.profiles_from_noc(rep)
    for p, s in zip(profiles, rep.links):
        p.check(s.gross_bt)
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    text = obs.write_saif(str(out / "ACTIVITY_noc_bt.saif"), profiles, design="noc_bt")
    saif = hashlib.sha256(text.encode()).hexdigest()
    if saif != nb["saif_sha256"]:
        fail(f"noc SAIF digest {saif} != the reference's {nb['saif_sha256']}")
    # one coded fabric: a bus-invert4 encoder at every link's egress
    coded = LinkSpec(key="acc", codec="bus_invert4")
    rep = lc.run("noc coded", lambda: noc.simulate_noc(mesh_topo, mesh_flows, coded),
                 {"bt_axes": 1, "psu_sort": 1})
    _same_links(rep, noc.simulate_noc(mesh_topo, mesh_flows, coded, backend="torch"),
                "noc coded")
    if [rep.total_bt, rep.total_aux_bt] != nb["coded"]:
        fail(f"noc coded: {[rep.total_bt, rep.total_aux_bt]} != pinned {nb['coded']}")
    # noc_bt's looped baseline: two bt_count launches per link
    ls = lc.run("noc expand", lambda: noc.expand_link_streams(
        mesh_topo, mesh_flows, LinkSpec(key="acc")), {"psu_sort": 1})
    il = LinkSpec().input_lanes
    fused = lc.run("noc fused", lambda: kernels.bt_count_links(ls.streams, input_lanes=il),
                   {"bt_axes": 1})
    looped = lc.run("noc looped", lambda: torch.stack([torch.stack([
        bt_count(ls.streams[i, :, :il]), bt_count(ls.streams[i, :, il:])])
        for i in range(ls.streams.shape[0])]), {"bt_count": 2 * ls.streams.shape[0]})
    if not torch.equal(fused, looped):
        fail("noc: bt_count_links differs from the looped bt_count baseline")
    log(f"noc hop sweep {hops}, hot links {rows['noc/hot_links']}, activity ({len(profiles)} "
        f"links, windows of {w}: per-wire sums = gross BT, SAIF sha256 {saif}), bus_invert4 "
        f"fabric {nb['coded']}, fused = looped over {ls.streams.shape[0]} links: = reference")

    # (b) the fleet: users x layers x shards multicast flows on mesh(16, 16)
    fl = FLEET
    topo = noc.mesh(fl["rows"], fl["cols"])
    spec = LinkSpec(input_lanes=16, weight_lanes=0, key="acc")
    flows = noc.fleet_decode_flows(torch.from_numpy(fleet_weights()).to(dev), topo,
                                   users=fl["users"], layers=fl["layers"], shards=fl["shards"],
                                   spec=spec)
    plan = noc.compile_fabric(topo, [(f.src, f.dsts) for f in flows])
    got = [len(flows), plan.active_links, plan.num_queues]
    if got != fl["plan"]:
        fail(f"fleet plan {got} != pinned {fl['plan']}")
    fleet_bt = {}
    for key in ("none", "acc", "app"):
        sk = dataclasses.replace(spec, key=key)
        rep = lc.run(f"fleet/{key}", lambda: noc.simulate_noc(topo, flows, sk),
                     {"bt_axes": 1} | _sorts(key))
        _same_links(rep, noc.simulate_noc(topo, flows, sk, backend="torch"), f"fleet/{key}")
        fleet_bt[key] = rep.total_bt
    if fleet_bt != fl["bt"]:
        fail(f"fleet BT {fleet_bt} != pinned {fl['bt']}")
    lat = noc.fabric_latency(plan, [f.inputs.shape[0] * spec.flits_per_packet for f in flows])
    got = [lat.max_latency_ns, lat.mean_latency_ns, lat.contended_links]
    if got != fl["latency"]:
        fail(f"fleet latency {got} != pinned {fl['latency']}")
    rows["fleet"] = {"plan": fl["plan"], "bt": fleet_bt, "latency": got}
    log(f"fleet mesh{fl['rows']}x{fl['cols']}: flows/active links/queues {fl['plan']}, BT "
        f"{fleet_bt}, latency max/mean/contended {got} = reference")

    # (c) the design-space sweep on dse_sweep.py's conv streams
    ds = DSE_SWEEP
    inp, wgt = (torch.from_numpy(a).to(dev) for a in conv_streams(n_images=ds["conv_images"]))
    workload = dse.Workload("conv", (inp, wgt), lanes=16)
    points = dse_grid(ds["ks"], ds["ns"])
    evals = lc.run("dse grid", lambda: dse.evaluate_grid(points, workload), {"bt_axes": 1})
    plain = dse.evaluate_grid(points, workload, backend="torch")
    if [dataclasses.asdict(e) for e in evals] != [dataclasses.asdict(e) for e in plain]:
        fail("dse grid: evaluations differ from the plain version's")
    got = {e.label: [e.total_bt, e.aux_bt] for e in evals}
    if got != ds["bt"] or evals_digest(evals) != ds["evals_sha256"]:
        fail(f"dse grid: {got} / {evals_digest(evals)} != the pins")
    front = [e.label for e in dse.pareto_front(evals)]
    plane = [e for e in evals if e.point.n == ds["ns"][0]]
    knee = dse.knee_point(dse.pareto_front(plane, dse.AREA_BT_OBJECTIVES),
                          dse.AREA_BT_OBJECTIVES).label
    if front != ds["front"] or knee != ds["knee"]:
        fail(f"dse front {front} / knee {knee} != pinned {ds['front']} / {ds['knee']}")
    noc_pt = dse.DesignPoint(ordering="app", k=4, topology="mesh4x4")
    ne = lc.run("dse noc point", lambda: dse.evaluate_grid(
        (noc_pt,), dse.Workload("conv", (inp,), lanes=16)), {"bt_axes": 1})
    if evals_digest(ne) != ds["noc_point_sha256"]:
        fail("dse mesh4x4 point differs from the reference's")
    axis = dse_axis_points(ds["ns"][0], ds["ks"])
    ae = lc.run("dse axis grid", lambda: dse.evaluate_grid(axis, workload), {"bt_axes": 1})
    aw = lc.run("dse axis grid, activity", lambda: dse.evaluate_grid(
        axis, workload, activity_windows=ds["window"]), {"bt_axes_activity": 1})
    launches = lc.run("dse grid_launch_count", lambda: dse.grid_launch_count(axis, workload),
                      {"bt_axes": 1})
    if [evals_digest(ae), evals_digest(aw), launches] != [
            ds["axis_sha256"], ds["axis_activity_sha256"], ds["grid_launches"]]:
        fail(f"dse axis grid {[evals_digest(ae), evals_digest(aw), launches]} != the pins")
    plain = dse.evaluate_grid(axis, workload, activity_windows=ds["window"], backend="torch")
    if [dataclasses.asdict(e) for e in aw] != [dataclasses.asdict(e) for e in plain]:
        fail("dse axis grid with activity differs from the plain version's")
    fig5 = {f"k{pt.k}": f"total={pt.area().total:.0f}um2" for pt in dse.k_sweep(
        n=25, width=8, ks=(2, 4, 8), include_baseline=False, include_precise=False)}
    red = dse.area_reduction(dse.DesignPoint(n=25, width=8, k=4, ordering="app"))
    fig7 = f"app/acc area ratio={1 - red:.3f} -> overhead reduction={100 * red:.1f}%"
    if fig5 != ds["fig5_k_sweep"] or fig7 != ds["fig7_psu_power_overhead"]:
        fail(f"fig5/k_sweep {fig5} / fig7/psu_power_overhead {fig7!r} != the reference's rows")
    rows["dse"] = {"points": len(evals), "front": front, "knee": knee,
                   "noc_point": {"bt_red": ne[0].noc_bt_reduction,
                                 "links": ne[0].noc_active_links},
                   "grid_launches": launches, "fig5/k_sweep": fig5,
                   "fig7/psu_power_overhead": fig7}
    log(f"dse sweep: {len(evals)} points = reference (BT, floats by digest) and = plain; "
        f"front {front}; knee {knee}; mesh4x4 point {ne[0].noc_active_links} links "
        f"bt_red={100 * ne[0].noc_bt_reduction:.2f}%; axis grid (+activity) = reference, "
        f"{launches} launch; fig5/k_sweep {fig5}; fig7/psu_power_overhead {fig7} (paper 37.3% "
        "power, 35.4% area)")
    del inp, wgt, workload

    # (d) full width: one ring reduce-scatter step of EGRESS_ARCH's int8 gradient
    m = get_config(EGRESS_ARCH).param_count() if full else 64 * 8000 + 3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    g, _ = full_gradient(m, dev)
    codes = lc.run("full quantize", lambda: quantize_egress(g, block=EGRESS["block"])[0],
                   {"quantize_egress": 1})
    del g
    ring = noc.ring(8)
    spec0 = LinkSpec(input_lanes=16, weight_lanes=0, k=4)
    flows = noc.ring_allreduce_flows(codes[:m], ring, spec=spec0)
    shard = (m // 64) // 8
    if [f.inputs.shape[0] for f in flows] != [shard] * 7 + [m // 64 - 7 * shard]:
        fail(f"full ring: shard packets {[f.inputs.shape[0] for f in flows]}")
    full_rows = {}
    for key in ("none", "acc", "app"):
        spec = dataclasses.replace(spec0, key=key)
        t1 = time.perf_counter()
        rep = lc.run(f"full ring {key}", lambda: noc.simulate_noc(ring, flows, spec),
                     {"bt_axes": 1} | _sorts(key))
        call_s = time.perf_counter() - t1
        by_link = {s.link: s for s in rep.links}
        for f in flows:
            s = by_link[noc.unicast_links(ring, f.src, f.dsts[0])[0]]
            pk = f.inputs if key == "none" else psu_reorder(
                f.inputs, k=4 if key == "app" else None)
            stream = pk.reshape(-1, 16, 4).transpose(1, 2).reshape(-1, 16)
            bt = _bt_sum(stream)
            if [s.bt_input, s.bt_weight, s.num_flits] != [bt, 0, stream.shape[0]]:
                fail(f"full ring {key} link {s.link}: {[s.bt_input, s.bt_weight, s.num_flits]} "
                     f"!= independent bt_count {[bt, 0, stream.shape[0]]}")
        head = stream[: 1 << 22][None]
        plain = int(kernels.bt_count_links(head, backend="torch")[0, 0])
        if plain != _bt_sum(head[0]) or plain != int(kernels.bt_count_links(head)[0, 0]):
            fail(f"full ring {key}: bt_count_links on 2**22 rows differs from plain / bt_count")
        full_rows[key] = {"bt": rep.total_bt, "links": rep.active_links,
                          "flit_hops": rep.total_flit_hops, "call_s": call_s}
    base = full_rows["none"]["bt"]
    log(f"full ring {EGRESS_ARCH}: {m} int8 codes, 8 shards of {shard} packets, "
        f"{shard * 4} flits a link; every link's BT = independent bt_count of psu_reorder -> "
        f"pack -> stream; " + " ".join(
            f"{k}: bt={r['bt']} red={100 * (1 - r['bt'] / base):.4f}% ({r['call_s']:.2f} s)"
            for k, r in full_rows.items()))
    # times at this shape: the expansion, the one measurement, the sort
    spec = dataclasses.replace(spec0, key="app")
    plan = noc.compile_fabric(ring, [(f.src, f.dsts) for f in flows])
    batch = noc.FlowBatch.from_flows(flows, spec)
    fs = noc.expand_fabric(plan, batch, spec)
    t, lanes = int(fs.streams.shape[1]), int(fs.streams.shape[2])
    links_bytes = sum(fs.lengths) * lanes
    lb, lby = bound(links_bytes, sum(max(n - 1, 0) for n in fs.lengths) * lanes * 3)
    pkts = batch.inputs.view(-1, 64)

    def measure():
        return kernels.bt_count_links(fs.streams, input_lanes=16, lengths=fs.lengths)

    def sort():
        return psu_sort(pkts, k=4)

    plain_links = []  # the plain version's per-link rows of its timed call

    def measure_plain():
        plain_links[:] = [kernels.bt_count_links(
            fs.streams[i: i + 1], input_lanes=16, lengths=fs.lengths[i: i + 1], backend="torch")
            for i in range(len(fs.lengths))]

    sb, sby = bound(pkts.numel() * 9, pkts.numel() * 4)
    times = {
        "expand_fabric": {"shape": [len(flows), shard, 64],
                          "wall_ms": wall_ms(lambda: noc.expand_fabric(plan, batch, spec), reps=3)},
        # the plain versions link by link and in 2**19-packet chunks, as
        # phase 3d checks the sort (whole, their temporaries would not fit)
        "bt_count_links": {"shape": [len(fs.lengths), t, lanes], "bytes": links_bytes,
                           "bound_ms": lb, "bound_by": lby, "ms": time_ms(measure, reps=5),
                           "plain_ms": time_ms(measure_plain, reps=1, warmup=1),
                           "library_ms": None},
        "psu_sort": {"shape": list(pkts.shape), "bound_ms": sb, "bound_by": sby,
                     "ms": time_ms(sort, reps=5),
                     "plain_ms": time_ms(lambda: [psu_sort(pkts[a: a + (1 << 19)], k=4,
                                                           backend="torch")
                                                  for a in range(0, pkts.shape[0], 1 << 19)],
                                         reps=1, warmup=1)},
    }
    got = measure()
    if not torch.equal(torch.cat(plain_links), got):
        fail(f"full ring: bt_count_links {got.tolist()} != plain per link "
             f"{torch.cat(plain_links).tolist()}")
    del plain_links
    times["expand_fabric"]["device_ms"], times["expand_fabric"]["device_split"] = (
        _device_total_ms(lambda: noc.expand_fabric(plan, batch, spec)))
    # the queue gather a ring step skips (each queue is one whole flow):
    # its table built on the card, and the batch's index_select by it
    table = _queue_gather_table(plan, batch.counts, batch.inputs.shape[1], dev)[0].reshape(-1)
    if not torch.equal(table, torch.arange(table.numel(), device=dev)):
        fail("full ring: the queue gather table is not the identity")
    times["expand_fabric"]["table_ms"] = time_ms(
        lambda: _queue_gather_table(plan, batch.counts, batch.inputs.shape[1], dev), reps=5)
    times["expand_fabric"]["gather_ms"] = time_ms(lambda: pkts.index_select(0, table), reps=5)
    del table
    # the kernels' device time split by kernel (for bt_axes: block kernel and fold)
    for name, fn, names in (("bt_count_links", measure, ("bt_axes",)),
                            ("psu_sort", sort, ("psu_sort_kernel",))):
        times[name]["device_ms"], times[name]["device_split"] = device_ms(fn, names)
    del fs, batch, flows, codes
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    # the library call for the sort, after the path's peak is read: its
    # int64 result alone is 8 bytes an element
    keys = bucket_map(popcount(pkts, 8), 8, 4).to(torch.uint8)
    times["psu_sort"]["library_ms"] = time_ms(
        lambda: torch.argsort(keys, dim=-1, stable=True), reps=5)
    del keys, pkts
    torch.cuda.empty_cache()
    rows["noc/full_ring"] = {"arch": EGRESS_ARCH, "elems": m, "shard_packets": shard,
                             "rows": full_rows, "times": times, "peak_bytes": peak,
                             "seconds": seconds}
    for name, r in times.items():
        log(f"time noc full ring {name} {r['shape']}: " + " ".join(
            f"{k}={v}" for k, v in r.items() if k != "shape"))
    log(f"full ring: peak {peak} bytes allocated; {seconds:.1f} s")
    seconds = time.perf_counter() - t_phase
    log(f"noc/dse-path launches: {lc.total}; phase 3e {seconds:.1f} s")
    return {"rows": rows, "launches": lc.total, "max_abs_err": 0, "seconds": seconds}


# ------------------------------------------------------------------ phase 3f

# The serving path at smoke size: these configs at dtype float32, weights
# drawn by serve_inputs(), batch 2, prompt 8, 4 greedy new tokens (whisper:
# 8 stub frames), captured and measured as benchmarks/model_traffic.py
# measures serve_decode: its four design points (SERVE_POINTS) on the
# weight workload (64-byte packets, 16 lanes), windows of 32 rows, and
# decode_weight_flows on mesh(4, 4) from router 0 to routers 1-3 with an
# input-only 16-lane link.  The pins are the JAX package's (tests/
# test_torch_serve.py holds both packages to them): greedy tokens, the
# weight stream's byte count and sha256, the stream names in order, the
# grid totals (data BT, invert-line BT) per point, and for SERVE_ARCH the
# NoC run (none BT, ACC BT, ACC active links, ACC flit hops, ACC per-link
# digest), the grid with activity windows (evals_digest) and
# benchmarks/arch_bt.py row 2's report (flits, BT unordered, BT APP) of
# layer 0's streamed MLP tensor.  KV bytes depend on float rounding: the
# JAX package's are in SERVE_KV_PINS, and the port's must lie within
# ``kv_codes`` int8 codes of them with at most ``kv_share`` of the bytes
# differing.
SERVE_ARCHS = ("internlm2-1.8b", "qwen3-moe-30b-a3b", "zamba2-1.2b", "mamba2-370m",
               "whisper-medium")
SERVE_ARCH = "internlm2-1.8b"
SERVE_POINTS = (dse.DesignPoint(ordering="none", k=None), dse.DesignPoint(ordering="acc", k=None),
                dse.DesignPoint(ordering="app", k=4),
                dse.DesignPoint(ordering="app", k=4, codec="bus_invert"))
SERVE_KV_PINS = ROOT / "tests" / "data" / "serve_kv_pins.npz"
SERVE = {
    "batch": 2, "prompt": 8, "new_tokens": 4, "frames": 8, "seed": 0,
    "elems": 64, "lanes": 16, "window": 32, "noc_dsts": (1, 2, 3),
    "kv_codes": 1, "kv_share": 0.01,
    "pins": {
        "internlm2-1.8b": {
            "tokens": [[40, 217, 164, 223], [29, 235, 32, 29]],
            "names": ["weights"] + ["kv"] * 4,
            "weights_bytes": 106752,
            "weights_sha256": "570477b56649f37c01b42ed67c36696a48cb63b6d8b5127779f71f247eac7667",
            "grid": {"none@N25": [426708, 0], "acc@N25": [319131, 0],
                     "app-k4@N25": [332233, 0], "app-k4+bus_invert@N25": [331939, 74]},
            "noc": [1280124, 957393, 3, 20016,
                    "44c6ad0484a64a61a1086707f478db05a51d4505a6d3c4742f12e2836d8df5fc"],
            "activity_sha256": "b468d5240b90d0ed9c0237675702e0c545cfebd9fd972f744dbdfd7d728f1aa6",
            "arch_bt_row2": [512, 28965, 28965],
        },
        "qwen3-moe-30b-a3b": {
            "tokens": [[147, 225, 202, 181], [2, 171, 230, 9]],
            "names": ["weights"] + ["kv"] * 4,
            "weights_bytes": 255296,
            "weights_sha256": "4679ed9f6078f778539f0ae98760ae5d3b3e10d5dd632635ed44700405b17cbd",
            "grid": {"none@N25": [1020863, 0], "acc@N25": [747605, 0],
                     "app-k4@N25": [778708, 0], "app-k4+bus_invert@N25": [778296, 108]},
            "arch_bt_row2": [2048, 111202, 111202],
        },
        "zamba2-1.2b": {
            "tokens": [[45, 88, 196, 219], [110, 105, 107, 249]],
            "names": ["weights"] + ["kv"] * 4,
            "weights_bytes": 214488,
            "weights_sha256": "22dbafe359869c945b3b92ff66e39dcad4e9dac207cc01c168129372e37f688f",
            "grid": {"none@N25": [856777, 0], "acc@N25": [634676, 0],
                     "app-k4@N25": [659922, 0], "app-k4+bus_invert@N25": [659524, 97]},
        },
        "mamba2-370m": {
            "tokens": [[43, 81, 87, 27], [17, 115, 22, 76]],
            "names": ["weights"] + ["kv"] * 4,
            "weights_bytes": 120800,
            "weights_sha256": "b658080231e0a243afbcadc0a759f3deb30cce95343e4ef217ac88b5773f2a5c",
            "grid": {"none@N25": [482509, 0], "acc@N25": [355164, 0],
                     "app-k4@N25": [369222, 0], "app-k4+bus_invert@N25": [369064, 37]},
            "arch_bt_row2": [512, 28246, 28246],
        },
        "whisper-medium": {
            "tokens": [[192, 125, 125, 125], [84, 209, 227, 237]],
            "names": ["weights"] + ["kv"] * 4,
            "weights_bytes": 197248,
            "weights_sha256": "f938fdd310f091f03179182d20f2236ad0f50e80df68a932d2ad24c3946b262a",
            "grid": {"none@N25": [788823, 0], "acc@N25": [592404, 0],
                     "app-k4@N25": [614451, 0], "app-k4+bus_invert@N25": [614119, 99]},
        },
    },
}
# The full-width serving run: SERVE_ARCH's own config (24 layers, d_model
# 2,048, bf16 compute, f32 parameters, chunked_skip attention at chunk
# 1,024), weights from init_params with a seeded CUDA generator, 4 requests
# of 256-token prompts and 16 greedy new tokens; the weight stream is every
# parameter of two or more dimensions (final_norm is 1-D) and each KV
# stream 24 layers x 4 x 8 heads x 128 x (k, v) bytes.
SERVE_FULL = {"requests": 4, "prompt": 256, "new_tokens": 16, "seed": 0,
              "weight_bytes": 1_889_107_968, "kv_bytes": 196_608, "f32_steps": 2, "split": 16,
              "f32_rel_tol": 2e-3, "ordered_rel_tol": 0.05}


def serve_inputs(arch: str, seed: int = SERVE["seed"]) -> tuple:
    """Smoke-size serving inputs for both packages: (config at float32,
    numpy weights for every leaf of the port's ``param_shapes``, prompts,
    stub frames or None).  Each leaf is drawn in sorted-key order from one
    numpy generator: normal x 0.02 for the embedding, normal / sqrt(fan-in)
    for a matrix, 1 + 0.1 x normal for a norm gain or skip, 0.1 x normal
    for any other vector."""
    cfg = smoke_config(arch, dtype="float32")
    rng = np.random.default_rng(seed)
    params = draw_params(cfg, rng)
    prompts = rng.integers(0, cfg.vocab, (SERVE["batch"], SERVE["prompt"])).astype(np.int32)
    frames = None
    if cfg.family in ("encdec", "audio"):
        frames = rng.standard_normal((SERVE["batch"], SERVE["frames"], cfg.d_model),
                                     dtype=np.float32)
    return cfg, params, prompts, frames


def draw_params(cfg, rng: np.random.Generator) -> dict:
    """numpy weights for every leaf of the port's ``param_shapes(cfg)``,
    drawn in sorted-key order from ``rng`` (``serve_inputs``' recipe)."""

    def draw(tree: dict, path: tuple) -> dict:
        out = {}
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                out[k] = draw(v, path + (k,))
                continue
            stacked = bool(path) and path[0] in ("layers", "enc_layers", "trailing")
            per = tuple(v.shape[1:]) if stacked else tuple(v.shape)
            x = rng.standard_normal(tuple(v.shape), dtype=np.float32)
            if k == "embed":
                x *= 0.02
            elif len(per) == 1:
                x = x * 0.1 + (1.0 if ("norm" in k or k == "d_skip") else 0.0)
            else:
                fan = per[0] * per[1] if k == "wo" else per[1] if len(per) == 3 and \
                    path[-1] == "moe" else per[0]
                x /= np.sqrt(fan)
            out[k] = x.astype(np.float32)
        return out

    return draw(param_shapes(cfg), ())


def arch_bt_row2_tensor(params: dict, cfg) -> torch.Tensor:
    """benchmarks/arch_bt.py row 2's tensor: layer 0's streamed MLP weight
    (dense down projection, MoE experts' down projections as rows, or the
    SSD output projection)."""
    layer = params["layers"]
    if "mlp" in layer:
        return layer["mlp"]["down"][0]
    if "moe" in layer:
        return layer["moe"]["down"][0].reshape(-1, cfg.d_model)
    return layer["ssd"]["out_proj"][0]


def serve_smoke(arch: str, dev: torch.device, session=None) -> tuple:
    """The port's serving path on ``serve_inputs(arch)``: ``generate``
    under ``obs.capture()``.  Returns (cfg, params, session, result)."""
    cfg, params_np, prompts, frames = serve_inputs(arch)
    params = params_from_numpy(params_np, dev)
    kw = {} if frames is None else {"frames": torch.from_numpy(frames).to(dev)}
    with obs.capture(session) as sess:
        res = serve.generate(params, cfg, torch.from_numpy(prompts).to(dev), SERVE["new_tokens"],
                             **kw)
    return cfg, params, sess, res


def serve_grid(sess, **kw):
    """model_traffic.py's grid on a session's serve_decode weight stream."""
    wl = sess.workload("serve_decode", elems=SERVE["elems"], lanes=SERVE["lanes"],
                       names=["weights"])
    return dse.evaluate_grid(SERVE_POINTS, wl, **kw)


def serve_noc(weights: torch.Tensor, key: str, **kw):
    """model_traffic.py's serve_decode fabric: the weight stream multicast on
    mesh(4, 4) from router 0 to SERVE['noc_dsts'], sorted at the source."""
    spec = input_only_spec(key, SERVE["elems"], SERVE["lanes"])
    topo = noc.mesh(4, 4)
    flows = noc.decode_weight_flows(weights.view(torch.int8), topo, 0, SERVE["noc_dsts"], spec)
    return noc.simulate_noc(topo, flows, spec, sort_at="source", **kw)


def kv_bytes(sess) -> np.ndarray:
    """Every serve_decode KV stream's bytes, concatenated, on the host."""
    return np.concatenate([s.data.cpu().numpy() for s in sess.get("serve_decode", "kv")])


def kv_differ(got: np.ndarray, want: np.ndarray) -> tuple[int, float]:
    """(largest int8 code difference, share of bytes that differ)."""
    if got.shape != want.shape:
        fail(f"KV bytes: {got.shape} != pinned {want.shape}")
    d = np.abs(got.view(np.int8).astype(np.int16) - want.view(np.int8).astype(np.int16))
    return int(d.max(initial=0)), float((d != 0).mean()) if d.size else 0.0


def _sorted_tensor_leaves(tree: dict, path: str = "") -> list:
    """(path, tensor) in sorted-key order at every level."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _sorted_tensor_leaves(v, f"{path}{k}/") if isinstance(v, dict) else [
            (f"{path}{k}", v)]
    return out


def phase_serve(dev: torch.device, full: bool = True, handoff: dict | None = None) -> dict:
    """The serving path: (a) the smoke configs through ``serve.generate``
    under capture against the JAX pins, every measurement against its
    plain version; (b) SERVE_ARCH at full width (at smoke width with
    ``full=False``): served, captured, the weight stream checked byte for
    byte, measured through ``bt_axes``, decode held against the forward and
    the ordered weights against the unordered.  Returns the rows, times
    and launch counts."""
    t_phase = time.perf_counter()
    lc = _PathLaunches()
    sv = SERVE
    rows: dict = {}
    kv_pins = np.load(SERVE_KV_PINS)
    worst = (0, 0.0)
    for arch in SERVE_ARCHS:
        pin = sv["pins"][arch]
        cfg, params, sess, res = lc.run(f"serve/{arch}", lambda: serve_smoke(arch, dev), {})
        names = [s.name for s in sess.streams]
        (w,) = sess.get("serve_decode", "weights")
        got = {"tokens": res.tokens.tolist(), "names": names, "weights_bytes": w.num_bytes,
               "weights_sha256": hashlib.sha256(w.data.cpu().numpy().tobytes()).hexdigest()}
        evals = lc.run(f"serve/{arch} grid", lambda: serve_grid(sess), {"bt_axes": 1})
        if [dataclasses.asdict(e) for e in evals] != [
                dataclasses.asdict(e) for e in serve_grid(sess, backend="torch")]:
            fail(f"serve/{arch}: grid differs from the plain version's")
        got["grid"] = {e.label: [e.total_bt, e.aux_bt] for e in evals}
        if arch == SERVE_ARCH:
            base = lc.run("serve noc none", lambda: serve_noc(w.data, "none"), {"bt_axes": 1})
            acc = lc.run("serve noc acc", lambda: serve_noc(w.data, "acc"),
                         {"bt_axes": 1, "psu_sort": 1})
            for key, rep in (("none", base), ("acc", acc)):
                _same_links(rep, serve_noc(w.data, key, backend="torch"), f"serve noc {key}")
            got["noc"] = [base.total_bt, acc.total_bt, acc.active_links, acc.total_flit_hops,
                          links_digest(acc)]
            act = lc.run("serve activity", lambda: serve_grid(
                sess, activity_windows=sv["window"]), {"bt_axes_activity": 1})
            if [dataclasses.asdict(e) for e in act] != [dataclasses.asdict(e) for e in serve_grid(
                    sess, activity_windows=sv["window"], backend="torch")]:
                fail("serve activity: grid differs from the plain version's")
            got["activity_sha256"] = evals_digest(act)
        if arch in ("internlm2-1.8b", "qwen3-moe-30b-a3b", "mamba2-370m"):
            t = arch_bt_row2_tensor(params, cfg)
            rep = lc.run(f"serve/{arch} arch_bt row 2", lambda: stream_bt_report(
                arch, t, "app", sign_magnitude=True, layout="col"), {"bt_count": 2})
            got["arch_bt_row2"] = [rep.num_flits, int(rep.bt_none), int(rep.bt_ordered)]
            plain = stream_bt_report(arch, t.cpu(), "app", sign_magnitude=True, layout="col")
            if [plain.num_flits, int(plain.bt_none), int(plain.bt_ordered)] != got[
                    "arch_bt_row2"]:
                fail(f"serve/{arch}: arch_bt row 2 differs from the plain version's (CPU)")
        if got != pin:
            fail(f"serve/{arch}: {got} != pinned {pin}")
        codes, share = kv_differ(kv_bytes(sess), kv_pins[arch])
        if codes > sv["kv_codes"] or share > sv["kv_share"]:
            fail(f"serve/{arch}: KV bytes differ from the JAX package's by up to {codes} codes "
                 f"in {100 * share:.3f}% of bytes (allowed {sv['kv_codes']}, "
                 f"{100 * sv['kv_share']}%)")
        worst = max(worst, (codes, share))
        rows[f"serve/{arch}"] = {**got, "kv_max_codes": codes, "kv_share": share}
        red = {e.label: round(100 * e.bt_reduction, 4) for e in evals}
        log(f"serve/{arch}: tokens {got['tokens']}, {len(names)} streams, weights "
            f"{w.num_bytes} bytes = reference (sha256, grid BT {red} %)"
            + (", noc + activity + arch_bt row 2 = reference" if "noc" in got else "")
            + f"; KV within {codes} code(s), {100 * share:.3f}% of bytes differ")
    rows["serve/kv_worst"] = {"codes": worst[0], "share": worst[1]}

    rows["serve/full"] = _serve_full(dev, lc, full, handoff)
    seconds = time.perf_counter() - t_phase
    log(f"serve-path launches: {lc.total}; phase 3f {seconds:.1f} s")
    return {"rows": rows, "launches": lc.total, "max_abs_err": 0, "seconds": seconds}


def _weight_tap_ms(params: dict) -> float:
    """CUDA-event time of one ``serve.weights`` tap under capture: the int8
    view of every leaf written into one stream."""
    def tap():
        with obs.capture():
            _obs_hooks.tap("serve.weights", params=params)

    return time_ms(tap, reps=3, warmup=1)


def _serve_full(dev: torch.device, lc: _PathLaunches, full: bool,
                handoff: dict | None = None) -> dict:
    """Phase 3f (b): SERVE_ARCH served at full width under capture; its
    greedy tokens and log-probabilities go into ``handoff`` for phase 3i."""
    sf = SERVE_FULL
    cfg = get_config(SERVE_ARCH) if full else smoke_config(SERVE_ARCH, attn_impl="chunked_skip",
                                                           attn_chunk=8)
    nreq, plen, new = sf["requests"], sf["prompt"] if full else 64, sf["new_tokens"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(sf["seed"])
    params = init_params(cfg, gen, dev)
    prompts = torch.randint(0, cfg.vocab, (nreq, plen), generator=gen, device=dev)
    out: dict = {"arch": cfg.name, "requests": nreq, "prompt": plen, "new_tokens": new}

    # serve under capture; the model path launches none of the port's kernels
    res = serve.generate(params, cfg, prompts, new)  # warm-up, and the run without capture
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = serve.generate(params, cfg, prompts, new)
    torch.cuda.synchronize()
    out["generate_s"] = time.perf_counter() - t1
    with obs.capture() as sess:
        cap = lc.run("serve full", lambda: serve.generate(params, cfg, prompts, new), {})
    out["capture_ms"] = _weight_tap_ms(params)
    if not torch.equal(cap.tokens, res.tokens):
        fail("serve full: tokens under capture differ from the run without it")
    if handoff is not None:  # phase 3i's placed generate is held to these
        handoff.update(serve_tokens=res.tokens.cpu(), serve_logprobs=res.logprobs.cpu(),
                       serve_generate_s=out["generate_s"])
    prefill_fn = serve.make_prefill_fn(cfg, plen + new)
    decode_fn = serve.make_decode_fn(cfg)
    logits, cache = prefill_fn(params, prompts)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    out.update(_serve_times(lambda: prefill_fn(params, prompts),
                            lambda: decode_fn(params, cache, tok)))
    out["decode_tokens_per_s"] = nreq / out["decode_ms_per_token"] * 1e3
    out["generate_tokens_per_s"] = nreq * new / out["generate_s"]
    del logits, cache

    # the captured streams: names, sizes, and the weight bytes leaf by leaf
    names = [s.name for s in sess.streams]
    if names != ["weights"] + ["kv"] * new:
        fail(f"serve full: streams {names}")
    (w,) = sess.get("serve_decode", "weights")
    kvs = sess.get("serve_decode", "kv")
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    want_kv = cfg.n_layers * nreq * hkv * hd * 2
    if full and (w.num_bytes, want_kv) != (sf["weight_bytes"], sf["kv_bytes"]):
        fail(f"serve full: {w.num_bytes} weight bytes, {want_kv} KV bytes a step")
    if any(s.num_bytes != want_kv for s in kvs):
        fail(f"serve full: KV streams of {[s.num_bytes for s in kvs]} bytes, not {want_kv}")
    at = 0
    for path, leaf in _sorted_tensor_leaves(params):
        if leaf.dim() < 2:
            continue
        mine = int8_view(leaf).reshape(-1).view(torch.uint8)
        if not torch.equal(w.data[at: at + mine.numel()], mine):
            fail(f"serve full: weight stream bytes of {path} differ from int8_view")
        at += mine.numel()
    if at != w.num_bytes:
        fail(f"serve full: weight stream {w.num_bytes} bytes, leaves {at}")

    # measure: the weight workload and the KV workload, each one bt_axes
    # launch.  A link's BT is int32, as in the reference, and the weight
    # stream as one link carries ~7e9 transitions, so its totals wrap; the
    # reductions come from the same bytes as SERVE_FULL["split"] contiguous
    # links (independent links: the seams between them are not counted)
    meas = {}
    wls = {name: sess.workload("serve_decode", elems=SERVE["elems"], lanes=SERVE["lanes"],
                               names=[name]) for name in ("weights", "kv")}
    wls["weights_split"] = dse.Workload("weights_split", tuple(
        wls["weights"].streams[0].tensor_split(sf["split"])), lanes=SERVE["lanes"])
    for name, wl in wls.items():
        t1 = time.perf_counter()
        ev = lc.run(f"serve full {name} grid", lambda: dse.evaluate_grid(SERVE_POINTS, wl),
                    {"bt_axes": 1})
        ms = (time.perf_counter() - t1) * 1e3
        # the plain version in chunks of 2**20 packets over all links: its
        # rank one-hots would not fit whole
        plain = dse.evaluate_grid(SERVE_POINTS, wl, backend="torch",
                                  chunk_packets=max(1, (1 << 20) // len(wl.streams)))
        if [dataclasses.asdict(e) for e in ev] != [dataclasses.asdict(e) for e in plain]:
            fail(f"serve full {name}: grid differs from the plain version's")
        del plain
        meas[name] = {"streams": len(wl.streams), "packets": sum(s.shape[0] for s in wl.streams),
                      "measure_ms": ms, "bt": {e.label: [e.total_bt, e.aux_bt] for e in ev},
                      "red_pct": {e.label: 100 * e.bt_reduction for e in ev}}
    out["measure"] = meas

    # bt_axes at the serving weight shape: (1, P, 64) under the grid's 4 configs
    pk = w.data[: w.num_bytes // 64 * 64].reshape(1, -1, 64)
    configs = dse.evaluate._configs_by_width(SERVE_POINTS)[8]
    work = axes_work(pk, torch.tensor([pk.shape[1]]), configs)
    b_ms, b_by = bound(work["bytes"], work["ops"])

    def measure():
        return bt_count_axes(pk, None, configs=configs, input_lanes=SERVE["lanes"])

    got = measure()
    ref = bt_count_axes(pk, None, configs=configs, input_lanes=SERVE["lanes"], backend="torch",
                        chunk_packets=1 << 20)
    if not torch.equal(got, ref):
        fail("serve full: bt_axes at the weight shape differs from the plain version")
    t = {"shape": list(pk.shape) + [f"{len(configs)} configs"], "bytes": work["bytes"],
         "ops": work["ops"], "bound_ms": b_ms, "bound_by": b_by, "ms": time_ms(measure, reps=5),
         "plain_ms": time_ms(lambda: bt_count_axes(
             pk, None, configs=configs, input_lanes=SERVE["lanes"], backend="torch",
             chunk_packets=1 << 20), reps=1, warmup=0),
         "library_ms": None}
    t["device_ms"], t["device_split"] = device_ms(measure, ("bt_axes",))
    out["bt_axes"] = t
    del pk, got, ref

    # decode against the forward, in float32, for f32_steps steps
    c32 = dataclasses.replace(cfg, dtype="float32")
    with torch.no_grad():
        logits, cache = prefill(params, c32, prompts, plen + sf["f32_steps"])
        toks, dec = [], []
        for _ in range(sf["f32_steps"]):
            toks.append(torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32))
            logits, cache = decode_step(params, c32, cache, toks[-1])
            dec.append(logits[:, 0])
        h, _ = forward(params, c32, tokens=torch.cat([prompts, *toks], dim=1))
        want = unembed(params, c32, h[:, plen: plen + sf["f32_steps"]])
    del cache, h
    dec = torch.stack(dec, dim=1)
    rel = float((dec - want).abs().max() / want.abs().max())
    if not rel <= sf["f32_rel_tol"]:
        fail(f"serve full: f32 decode logits differ from the forward's by {rel:.3g} of max|logit|"
             f" (allowed {sf['f32_rel_tol']})")
    out["f32_decode_rel_err"] = rel
    del dec, want

    # weight ordering: a numeric no-op up to summation order (bf16 here)
    ordered = apply_weight_ordering(params, cfg, "app")
    with torch.no_grad():
        a, _ = prefill_fn(params, prompts)
        b, _ = prefill_fn(ordered, prompts)
    rel = float((a.float() - b.float()).abs().max() / a.float().abs().max())
    if not rel <= sf["ordered_rel_tol"]:
        fail(f"serve full: ordered-weight prefill logits differ by {rel:.3g} of max|logit| "
             f"(allowed {sf['ordered_rel_tol']})")
    same = float((serve.generate(ordered, cfg, prompts, new).tokens == res.tokens)
                 .float().mean())
    out["ordered_prefill_rel_err"], out["ordered_same_token_share"] = rel, same
    del ordered, a, b
    torch.cuda.synchronize()
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["seconds"] = time.perf_counter() - t0
    del params, sess
    torch.cuda.empty_cache()
    log(f"serve full {cfg.name}: {nreq} requests x {plen}-token prompts + {new} greedy tokens; "
        f"prefill {out['prefill_ms']:.2f} ms, decode {out['decode_ms_per_token']:.3f} ms/token "
        f"({out['decode_tokens_per_s']:.1f} tokens/s; generate {out['generate_tokens_per_s']:.1f} "
        f"tokens/s), capture {out['capture_ms']:.1f} ms; weights {w.num_bytes} bytes = int8_view "
        f"leaf by leaf, {len(kvs)} KV streams of {want_kv} bytes")
    log(f"serve full device time: prefill {out['prefill_device_ms']} ms "
        f"{out['prefill_device_split']}; decode {out['decode_device_ms']} ms "
        f"{out['decode_device_split']}")
    for name, m in meas.items():
        log(f"serve full {name}: {m['streams']} stream(s), {m['packets']} packets, grid = plain, "
            f"{m['measure_ms']:.1f} ms; reductions " + " ".join(
                f"{k}={v:.4f}%" for k, v in m["red_pct"].items()))
    log(f"time serve bt_axes {t['shape']}: " + " ".join(
        f"{k}={v}" for k, v in t.items() if k != "shape"))
    log(f"serve full: f32 decode vs forward rel err {out['f32_decode_rel_err']:.3g}; ordered "
        f"weights prefill rel err {rel:.3g}, same greedy tokens {100 * same:.1f}%; peak "
        f"{out['peak_bytes']} bytes; {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------------------ phase 3g

# The training path at smoke size: TRAIN_ARCHS' smoke configs at dtype
# float32, weights drawn by draw_params (serve_inputs' recipe) and the batch
# by obs.train_batch, both from the seed (batch 2, 32 tokens: model_traffic
# .py's capture_train_step shapes).  One make_train_step step under
# obs.capture() with AdamWConfig(warmup_steps=1, total_steps=10), as
# capture_train_step takes it; its train_allreduce grads stream measured as
# benchmarks/model_traffic.py measures it: the four points of SERVE_POINTS
# with activity windows of 32 rows (64-byte packets, 16 lanes), and
# ring_allreduce_flows on ring(8) through simulate_noc with an input-only
# 16-lane link, none and ACC sorted at the source.  The pins are the JAX
# package's (tests/test_torch_train_step.py holds both packages to them):
# loss and grad_norm within ``rel_tol``, the stream names and byte count,
# the grid totals (data BT, invert-line BT) and activity digest, the ring's
# (none BT, ACC BT, ACC per-link digest).  Gradient bytes depend on float
# rounding: the JAX package's are in TRAIN_GRAD_PINS, and the port's must
# lie within ``grad_codes`` int8 codes of them on at most ``grad_share`` of
# the bytes; where they equal the pinned bytes the measurements must equal
# the pins too (they always equal the plain versions).
TRAIN_ARCHS = ("internlm2-1.8b", "qwen3-moe-30b-a3b", "mamba2-370m")
TRAIN_GRAD_PINS = ROOT / "tests" / "data" / "train_grad_pins.npz"
TRAIN = {
    "batch": 2, "seq": 32, "seed": 0, "elems": 64, "lanes": 16, "window": 32, "ring": 8,
    "opt": {"warmup_steps": 1, "total_steps": 10},
    "rel_tol": 1e-4, "grad_codes": 1, "grad_share": 0.01,
    # train() on the smoke internlm2-1.8b: checkpoints every 3 steps,
    # preempted at step 5, resumed; final params bitwise equal to a run
    # without the preemption
    "restart": {"arch": "internlm2-1.8b", "steps": 8, "every": 3, "fail_at": 5,
                "data": {"seq_len": 32, "global_batch": 8, "seed": 1, "noise": 0.05},
                "opt": {"peak_lr": 2e-3, "warmup_steps": 3, "total_steps": 40}},
    "pins": {
        "internlm2-1.8b": {
            "loss": 5.876974105834961, "grad_norm": 13.552249908447266,
            "names": ["grads"], "grads_bytes": 106816,
            "grid": {"none@N25": [363855, 0], "acc@N25": [207336, 0],
                     "app-k4@N25": [222619, 0], "app-k4+bus_invert@N25": [221665, 72]},
            "activity_sha256": "00576c863d247af3a8e127d9e1c3343badc208e88ef42f6d8b977d7cf81de3c5",
            "ring": [363425, 207040,
                     "84dc72ffab1aacc499fe943aeaaea2c2264625a11d65e26447deccc704739bd8"],
        },
        "qwen3-moe-30b-a3b": {
            "loss": 5.9482927322387695, "grad_norm": 14.36476993560791,
            "names": ["grads"], "grads_bytes": 255360,
            "grid": {"none@N25": [953364, 0], "acc@N25": [418590, 0],
                     "app-k4@N25": [462936, 0], "app-k4+bus_invert@N25": [461930, 71]},
            "activity_sha256": "84012336e75a4b5692f1983b07548ca3a0fda4778c47138494f2b86c17375dc9",
            "ring": [952952, 418426,
                     "f7435d1e52e18422f9f9d652f64f78e2496b9293ea205eece5f35f1e38c76c62"],
        },
        "mamba2-370m": {
            "loss": 4.866202354431152, "grad_norm": 4.690311431884766,
            "names": ["grads"], "grads_bytes": 120864,
            "grid": {"none@N25": [469552, 0], "acc@N25": [179913, 0],
                     "app-k4@N25": [203795, 0], "app-k4+bus_invert@N25": [203635, 18]},
            "activity_sha256": "51c3891f2f65fea83b9b77c3a8096b7dca695da5096c13e48b7279c6cafbb2b4",
            "ring": [469097, 179713,
                     "c8a39855854f3783445d67320ba29e408ff1bd4599136b5cffbe84a9a4b056a2"],
        },
    },
}
# LeNet with the reference's trained weights: repro.models.lenet.
# train_lenet(300) params and its 8 capture images (jax.random draws),
# kept in LENET_REF with the bytes the reference's capture_lenet_conv
# recorded from them; measured as model_traffic.py measures lenet_conv:
# the four-point grid with windows of 32 rows, conv_platform_flows on
# mesh(4, 4) from router 0 to the routers r % 4 != 0 (conv1's trained
# kernel bytes on the weight lanes, im2col patches of synth_images(1,
# seed=7) on the input lanes, LinkSpec() framing, none vs ACC sorted at the
# source), and the recalibration rows: TxPipeline over input-only 16-lane
# links of the captured inputs and the conv1 + conv2 kernels, BT per flit
# under none / ACC / APP (k = 4), and the overall reductions beside
# model_traffic.py's SYNTHETIC_OVERALL and PAPER_OVERALL.  The port's own
# LeNet (train_lenet(300, 64) with its generator) must end under
# ``loss_bound``, set from the reference's final loss (``pins``).
LENET_REF = ROOT / "tests" / "data" / "lenet_ref.npz"
LENET = {
    "steps": 300, "batch": 64, "images": 8, "patch_seed": 7, "window": 32,
    "noc_pes": tuple(r for r in range(16) if r % 4),
    "synthetic_overall": {"acc": 14.21, "app": 12.66},
    "paper_overall": {"acc": 20.42, "app": 19.50},
    # about 26x the reference's final loss (pins), two orders of magnitude
    # under chance (ln 10 = 2.303): a different generator sees other batches
    "loss_bound": 0.02,
    "pins": {
        "final_loss": 0.0007744004251435399,
        "grid": {"none@N25": [40999, 0], "acc@N25": [31939, 0],
                 "app-k4@N25": [32863, 0], "app-k4+bus_invert@N25": [32821, 8]},
        "activity_sha256": "5d5ed9588992693ffdf1b205d844b981c449a321bb9652b53cb18abf76143942",
        "noc": [426413, 381704,
                "03d2ae8f489e4132bf8dffab10db23f2589c2bf0457016526a31ba0ffaef2e72"],
        "recalib": {
            "bt_per_flit": {"none": [60.7734375, 64.73717948717949],
                            "acc": [47.544921875, 49.38461538461539],
                            "app": [48.79296875, 51.37179487179487]},
            "captured_red": {"acc": 22.771842266127628, "app": 20.194190717725203},
        },
    },
}
# internlm2-1.8b uncut (phase 3f's config): train() for 3 steps of
# DataConfig(vocab 92,544, seq_len 256, global_batch 4) with AdamWConfig(
# warmup_steps=1, total_steps=10); a directional-derivative check in
# float32 on 1 x 64 tokens (central difference of the loss along g/|g| at
# step h against |g|); one capture_train_step at full width, its
# 1,889,110,016-byte grads stream (every leaf, final_norm too) measured as
# 16 links (one link would wrap the int32 BT counters) under the four
# points and as one ring reduce-scatter step on ring(8) under none / ACC /
# APP4, the plain versions
# on 2 of the 16 links and on ring link 0; then compressed_psum(int8_ef) of
# the flat gradient, one replica, unordered and with the static egress
# permutation of the trained weights' int8 bytes.
TRAIN_FULL = {"steps": 3, "seq_len": 256, "global_batch": 4, "seed": 0, "split": 16,
              "plain_links": 2, "fd_tokens": 64, "fd_h": 1e-2, "fd_rel_tol": 0.02,
              "grad_bytes": 1_889_110_016}


def train_inputs(arch: str, seed: int = TRAIN["seed"]) -> tuple:
    """Smoke-size training inputs for both packages: (config at float32,
    numpy weights from ``draw_params``, numpy batch from
    ``obs.train_batch``), all from ``seed``."""
    cfg = smoke_config(arch, dtype="float32")
    params = draw_params(cfg, np.random.default_rng(seed))
    batch = {k: v.numpy() for k, v in
             obs.train_batch(cfg, TRAIN["batch"], TRAIN["seq"], seed, "cpu").items()}
    return cfg, params, batch


def train_smoke(arch: str, dev: torch.device, microbatches: int = 1) -> tuple:
    """The port's train step on ``train_inputs(arch)`` under
    ``obs.capture()``: (session, metrics as floats)."""
    cfg, params_np, batch = train_inputs(arch)
    params = params_from_numpy(params_np, dev)
    step = train.make_train_step(cfg, optim.AdamWConfig(**TRAIN["opt"]), microbatches)
    data = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    with obs.capture() as sess:
        _, _, metrics = step(params, optim.init(params), data)
    return sess, {k: float(v) for k, v in metrics.items()}


def train_grid(sess, **kw):
    """model_traffic.py's grid (windows of 32 rows) on the grads stream."""
    wl = sess.workload("train_allreduce", elems=TRAIN["elems"], lanes=TRAIN["lanes"])
    return dse.evaluate_grid(SERVE_POINTS, wl, activity_windows=TRAIN["window"], **kw)


def train_ring(grads: torch.Tensor, key: str, **kw):
    """model_traffic.py's train_allreduce fabric: one ring reduce-scatter
    step of the grads bytes on ring(8), sorted at the source."""
    spec = input_only_spec(key, TRAIN["elems"], TRAIN["lanes"])
    topo = noc.ring(TRAIN["ring"])
    flows = noc.ring_allreduce_flows(grads.view(torch.int8), topo, spec=spec)
    return noc.simulate_noc(topo, flows, spec, sort_at="source", **kw)


def train_rows(sess, **kw) -> dict:
    """The train_allreduce measurements that are pinned: grid totals and
    activity digest, the ring fabric's (none BT, ACC BT, ACC per-link
    digest)."""
    evals = train_grid(sess, **kw)
    (g,) = sess.get("train_allreduce", "grads")
    base, acc = train_ring(g.data, "none", **kw), train_ring(g.data, "acc", **kw)
    return {"grid": {e.label: [e.total_bt, e.aux_bt] for e in evals},
            "activity_sha256": evals_digest(evals),
            "ring": [base.total_bt, acc.total_bt, links_digest(acc)]}


def pinned_grads_session(arch: str, dev: torch.device):
    """A capture session holding the JAX package's pinned gradient bytes
    of ``arch`` (TRAIN_GRAD_PINS) as its train_allreduce grads stream."""
    sess = obs.CaptureSession()
    data = np.load(TRAIN_GRAD_PINS)[arch]
    sess._add_bytes("train_allreduce", "grads", torch.from_numpy(data.copy()).to(dev),
                    (data.size,), "train.grads", {})
    return sess


def lenet_reference(dev: torch.device) -> tuple:
    """LENET_REF on ``dev``: (the reference's trained LeNet tree, its 8
    capture images, the bytes its capture recorded by stream name)."""
    ref = np.load(LENET_REF)
    tree: dict = {}
    for key in ref.files:
        if key.startswith("params/"):
            _, layer, leaf = key.split("/")
            tree.setdefault(layer, {})[leaf] = ref[key]
    images = torch.from_numpy(ref["images"]).to(dev)
    want = {k.split("/")[1]: ref[k] for k in ref.files if k.startswith("bytes/")}
    return lenet_params_from_reference(tree, dev), images, want


def lenet_patches() -> np.ndarray:
    """model_traffic.py's conv-platform input patches: im2col of one
    synth_images image (seed 7), 5 x 5 windows."""
    return im2col(synth_images(1, seed=LENET["patch_seed"])[0], 5)


def lenet_grid(sess, **kw):
    """model_traffic.py's lenet_conv grid (windows of 32 rows) over its
    captured streams."""
    wl = sess.workload("lenet_conv", elems=TRAIN["elems"], lanes=TRAIN["lanes"])
    return dse.evaluate_grid(SERVE_POINTS, wl, activity_windows=LENET["window"], **kw)


def lenet_noc(sess, key: str, **kw):
    """model_traffic.py's lenet_conv fabric: conv1's kernel bytes and the
    patches on mesh(4, 4) from router 0 to the PEs off column 0."""
    kernel = sess.scenario_bytes("lenet_conv", ["conv1"])
    patches = torch.from_numpy(lenet_patches()).to(kernel.device)
    topo = noc.mesh(4, 4)
    flows = noc.conv_platform_flows(patches, kernel, topo, 0, LENET["noc_pes"], LinkSpec())
    return noc.simulate_noc(topo, flows, dataclasses.replace(LinkSpec(), key=key),
                            sort_at="source", **kw)


def lenet_recalib(sess) -> dict:
    """model_traffic.py's recalibration rows: BT per flit of the captured
    inputs and of the conv1 + conv2 kernels, each on its own input-only
    link through TxPipeline, under none / ACC / APP (k = 4), and the
    overall reductions in percent."""
    inp = sess.packets("lenet_conv", TRAIN["elems"], names=["inputs"])
    wgt = sess.packets("lenet_conv", TRAIN["elems"], names=["conv1", "conv2"])
    bt = {key: [TxPipeline(input_only_spec(key, TRAIN["elems"], TRAIN["lanes"]),
                           device=x.device).measure(x).overall_bt_per_flit for x in (inp, wgt)]
          for key in ("none", "acc", "app")}
    base = sum(bt["none"])
    return {"bt_per_flit": bt,
            "captured_red": {k: 100 * (1 - sum(bt[k]) / base) for k in ("acc", "app")}}


def lenet_rows(sess) -> dict:
    """The lenet_conv measurements that are pinned: grid totals and
    activity digest, the fabric's (none BT, ACC BT, ACC per-link digest),
    the recalibration rows."""
    evals = lenet_grid(sess)
    base, acc = lenet_noc(sess, "none"), lenet_noc(sess, "acc")
    return {"grid": {e.label: [e.total_bt, e.aux_bt] for e in evals},
            "activity_sha256": evals_digest(evals),
            "noc": [base.total_bt, acc.total_bt, links_digest(acc)],
            "recalib": lenet_recalib(sess)}


def _grads_differ(got: np.ndarray, want: np.ndarray, what: str) -> tuple[int, float]:
    """(largest int8 code difference, share of bytes that differ) of two
    gradient streams; fails beyond TRAIN's allowance."""
    codes, share = kv_differ(got, want)
    if codes > TRAIN["grad_codes"] or share > TRAIN["grad_share"]:
        fail(f"{what}: gradient bytes differ by up to {codes} codes in "
             f"{100 * share:.3f}% of bytes (allowed {TRAIN['grad_codes']}, "
             f"{100 * TRAIN['grad_share']}%)")
    return codes, share


def _close(got: float, want: float, tol: float, what: str) -> float:
    rel = abs(got - want) / max(abs(want), 1e-30)
    if not rel <= tol:
        fail(f"{what}: {got} vs {want}, relative difference {rel:.3g} > {tol}")
    return rel


def phase_train(dev: torch.device, full: bool = True, handoff: dict | None = None) -> dict:
    """The training path: (i) the smoke configs' train step under capture
    against the JAX pins, its measurements against their plain versions,
    microbatching and a train() restart; (ii) the reference's trained LeNet
    captured and measured against the JAX pins; (iii) the port's own LeNet
    trained, checkpointed and restored; (iv) internlm2-1.8b trained at full
    width (at smoke width with ``full=False``), its gradient checked,
    captured and measured; its losses and a host copy of its trained
    params go into ``handoff`` for phase 3h.  Returns the rows, times and
    launch counts."""
    t_phase = time.perf_counter()
    lc = _PathLaunches()
    tr = TRAIN
    rows: dict = {}
    grad_pins = np.load(TRAIN_GRAD_PINS)
    worst = (0, 0.0)

    # (i) smoke training pins
    for arch in TRAIN_ARCHS:
        pin = tr["pins"][arch]
        sess, metrics = lc.run(f"train/{arch}", lambda: train_smoke(arch, dev), {})
        rel = max(_close(metrics[k], pin[k], tr["rel_tol"], f"train/{arch} {k}")
                  for k in ("loss", "grad_norm"))
        (g,) = sess.get("train_allreduce", "grads")
        got = {"names": [s.name for s in sess.streams], "grads_bytes": g.num_bytes}
        gb = g.data.cpu().numpy()
        codes, share = _grads_differ(gb, grad_pins[arch], f"train/{arch} vs the JAX package")
        worst = max(worst, (codes, share))
        # one grid (activity windows) and two fabrics (one ACC source sort)
        # on the port's bytes, then on the JAX package's pinned bytes
        launches = {"bt_axes_activity": 1, "bt_axes": 2, "psu_sort": 1}
        meas = lc.run(f"train/{arch} measurements", lambda: train_rows(sess), launches)
        if meas != train_rows(sess, backend="torch"):
            fail(f"train/{arch}: grid or ring differs from the plain version's")
        on_pins = lc.run(f"train/{arch} measurements of the pinned bytes",
                         lambda: train_rows(pinned_grads_session(arch, dev)), launches)
        exact = bool(np.array_equal(gb, grad_pins[arch]))
        if got != {k: pin[k] for k in got} or on_pins != {k: pin[k] for k in on_pins} or (
                exact and meas != on_pins):
            fail(f"train/{arch}: {got | meas} (pinned bytes: {on_pins}) != pinned {pin}")
        rows[f"train/{arch}"] = {**got, **meas, **metrics, "metrics_rel_err": rel,
                                 "grad_max_codes": codes, "grad_share": share,
                                 "bytes_equal_pins": exact}
        base = meas["grid"]["none@N25"][0]
        red = {k: round(100 * (1 - sum(v) / base), 4) for k, v in meas["grid"].items()}
        log(f"train/{arch}: loss {metrics['loss']:.6f} grad_norm {metrics['grad_norm']:.6f} "
            f"(JAX within {rel:.2g}); grads {g.num_bytes} bytes within {codes} code(s), "
            f"{100 * share:.3f}% differ" + (" (= JAX bytes)" if exact else "")
            + f"; grid BT {red} % and ring(8) none/ACC = plain; on the JAX bytes = pins")
    rows["train/grad_worst"] = {"codes": worst[0], "share": worst[1]}

    # microbatches=2 against microbatches=1
    arch = TRAIN_ARCHS[0]
    one, m1 = train_smoke(arch, dev)
    two, m2 = lc.run("train microbatches=2", lambda: train_smoke(arch, dev, microbatches=2), {})
    rel = max(_close(m2[k], m1[k], tr["rel_tol"], f"microbatches=2 {k}")
              for k in ("loss", "grad_norm"))
    codes, share = _grads_differ(two.streams[0].data.cpu().numpy(),
                                 one.streams[0].data.cpu().numpy(), "microbatches=2 vs 1")
    rows["train/microbatches"] = {"rel_err": rel, "grad_max_codes": codes, "grad_share": share}
    log(f"train microbatches=2 vs 1 ({arch}): loss / grad_norm within {rel:.2g}, grads within "
        f"{codes} code(s) on {100 * share:.3f}% of bytes")

    rows["train/restart"] = _train_restart(dev, lc)
    rows["train/lenet_ref"] = _lenet_ref(dev, lc)
    rows["train/lenet_port"] = _lenet_port(dev, lc, rows["train/lenet_ref"])
    rows["train/full"] = _train_full(dev, lc, full, handoff)
    seconds = time.perf_counter() - t_phase
    log(f"train-path launches: {lc.total}; phase 3g {seconds:.1f} s")
    return {"rows": rows, "launches": lc.total, "max_abs_err": 0, "seconds": seconds}


def _train_restart(dev: torch.device, lc: _PathLaunches) -> dict:
    """train() preempted and resumed from its checkpoints in build/: final
    params bitwise equal to a run without the preemption."""
    import shutil

    rs = TRAIN["restart"]
    cfg = smoke_config(rs["arch"])
    dcfg = DataConfig(vocab=cfg.vocab, **rs["data"])
    ocfg = optim.AdamWConfig(**rs["opt"])
    dirs = [ROOT / "build" / f"train_ckpt_{tag}" for tag in ("straight", "resumed")]
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)

    def loop(d, fail_at=None):
        return train.TrainLoopConfig(steps=rs["steps"], checkpoint_every=rs["every"],
                                     checkpoint_dir=str(d), fail_at_step=fail_at)

    t0 = time.perf_counter()
    straight = lc.run("train straight", lambda: train.train(cfg, dcfg, ocfg, loop(dirs[0]),
                                                            device=dev), {})
    try:
        train.train(cfg, dcfg, ocfg, loop(dirs[1], rs["fail_at"]), device=dev)
        fail("train restart: the simulated preemption did not fire")
    except train.SimulatedPreemption:
        pass
    kept = CheckpointManager(str(dirs[1])).all_steps()
    resumed = lc.run("train resumed", lambda: train.train(cfg, dcfg, ocfg, loop(dirs[1]),
                                                          device=dev), {})
    a = _sorted_tensor_leaves(straight["params"])
    b = _sorted_tensor_leaves(resumed["params"])
    if [p for p, _ in a] != [p for p, _ in b] or not all(
            torch.equal(x, y) for (_, x), (_, y) in zip(a, b)):
        fail("train restart: resumed final params differ from the straight run's")
    losses = [m["loss"] for m in straight["log"]]
    if not losses[-1] < losses[0]:
        fail(f"train restart: the straight run's loss did not fall: {losses}")
    if [m["loss"] for m in resumed["log"]] != losses[rs["every"]:]:
        fail("train restart: the resumed run's losses differ from the straight run's")
    out = {"checkpoints_at_preemption": kept, "losses": losses,
           "resumed_from": rs["every"], "seconds": time.perf_counter() - t0}
    log(f"train restart ({rs['arch']} smoke): checkpoints {kept} when preempted at step "
        f"{rs['fail_at']}, resumed from step {rs['every']}: final params bitwise equal, losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    return out


def _lenet_ref(dev: torch.device, lc: _PathLaunches) -> dict:
    """Phase 3g (ii): the reference's trained LeNet captured and measured."""
    params, images, want = lenet_reference(dev)
    sess = lc.run("lenet capture", lambda: obs.capture_lenet_conv(
        params=params, images=images, device=dev), {})
    names = [s.name for s in sess.streams]
    if names != ["conv1", "conv2", "inputs"]:
        fail(f"lenet capture: streams {names}")
    for s in sess.streams:
        if not np.array_equal(s.data.cpu().numpy(), want[s.name]):
            fail(f"lenet capture: {s.name} bytes differ from the reference's")
    # 1 grid (activity), 2 fabrics (1 sort), TxPipeline: none staged
    # (bt_count), ACC / APP fused (psu_stream), two links each
    got = lc.run("lenet measurements", lambda: lenet_rows(sess),
                 {"bt_axes_activity": 1, "bt_axes": 2, "psu_sort": 1, "bt_count": 2,
                  "psu_stream": 4})
    if [dataclasses.asdict(e) for e in lenet_grid(sess)] != [
            dataclasses.asdict(e) for e in lenet_grid(sess, backend="torch")]:
        fail("lenet grid differs from the plain version's")
    for key in ("none", "acc"):
        _same_links(lenet_noc(sess, key), lenet_noc(sess, key, backend="torch"),
                    f"lenet noc {key}")
    cpu_sess = obs.CaptureSession()
    for s in sess.streams:
        cpu_sess._add_bytes(s.scenario, s.name, s.data.cpu(), s.source_shape, s.kind, s.meta)
    if lenet_recalib(cpu_sess) != got["recalib"]:
        fail("lenet recalibration rows differ from the plain version's (CPU)")
    pin = LENET["pins"]
    if got != {k: pin[k] for k in got}:
        fail(f"lenet_conv on the reference's weights: {got} != pinned {pin}")
    red = got["recalib"]["captured_red"]
    log(f"lenet_conv (reference weights): conv1/conv2/inputs bytes = reference; grid, activity, "
        f"mesh(4, 4) fabric and recalibration rows = JAX pins = plain; captured_red ACC "
        f"{red['acc']:.2f}% APP {red['app']:.2f}% (synthetic {LENET['synthetic_overall']}, "
        f"paper {LENET['paper_overall']})")
    return got


def _lenet_port(dev: torch.device, lc: _PathLaunches, ref: dict) -> dict:
    """Phase 3g (iii): the port's own LeNet trained on the card,
    checkpointed and restored, and its recalibration rows."""
    import shutil

    ck = ROOT / "build" / "lenet_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    t0 = time.perf_counter()
    params, info = lc.run("lenet train", lambda: lenet.train_lenet(
        steps=LENET["steps"], batch=LENET["batch"], ckpt_dir=str(ck), device=dev), {})
    train_s = time.perf_counter() - t0
    if info["restored"] or not info["final_loss"] < LENET["loss_bound"]:
        fail(f"lenet train: {info} (final loss bound {LENET['loss_bound']})")
    back, info2 = lenet.train_lenet(ckpt_dir=str(ck), device=dev)
    if not info2["restored"] or info2["final_loss"] != info["final_loss"] or not all(
            torch.equal(x, y) for (_, x), (_, y) in zip(_sorted_tensor_leaves(params),
                                                        _sorted_tensor_leaves(back))):
        fail(f"lenet restore: {info2}, params equal to the trained ones expected")
    sess = obs.capture_lenet_conv(params=back, device=dev)
    rec = lc.run("lenet port recalibration", lambda: lenet_recalib(sess),
                 {"bt_count": 2, "psu_stream": 4})
    out = {"final_loss": info["final_loss"], "train_s": train_s, "restored": True, **rec}
    log(f"lenet (port, trained on the card, {LENET['steps']} steps x {LENET['batch']}): final "
        f"loss {info['final_loss']:.5f} < {LENET['loss_bound']} (reference "
        f"{LENET['pins']['final_loss']:.5f}), {train_s:.1f} s; restored from build/ with equal "
        f"params; captured_red ACC {rec['captured_red']['acc']:.2f}% APP "
        f"{rec['captured_red']['app']:.2f}% (reference weights: "
        f"{ref['recalib']['captured_red']['acc']:.2f}% / "
        f"{ref['recalib']['captured_red']['app']:.2f}%)")
    return out


def _flat_int8(tree: dict) -> torch.Tensor:
    """The int8 view of every leaf of a tree, in sorted-key order, as one
    flat int8 vector (the capture stream's bytes)."""
    parts = [int8_view(t).reshape(-1) for _, t in _sorted_tensor_leaves(tree)]
    return torch.cat(parts)


def _train_full(dev: torch.device, lc: _PathLaunches, full: bool,
                handoff: dict | None = None) -> dict:
    """Phase 3g (iv): SERVE_ARCH trained at full width, its gradient
    checked, captured and measured."""
    tf = TRAIN_FULL
    cfg = get_config(SERVE_ARCH) if full else smoke_config(SERVE_ARCH)
    seq, gb = (tf["seq_len"], tf["global_batch"]) if full else (64, 4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=gb, seed=tf["seed"])
    ocfg = optim.AdamWConfig(warmup_steps=1, total_steps=10)
    out: dict = {"arch": cfg.name, "steps": tf["steps"], "tokens_per_step": seq * gb}

    res = lc.run("train full", lambda: train.train(
        cfg, dcfg, ocfg, train.TrainLoopConfig(steps=tf["steps"], seed=tf["seed"]), device=dev),
        {})
    log_ = res["log"]
    losses = [m["loss"] for m in log_]
    norms = [m["grad_norm"] for m in log_]
    if not all(np.isfinite(losses + norms)):
        fail(f"train full: losses {losses} grad norms {norms}")
    params, opt_state = res["params"], res["opt_state"]
    del res
    if handoff is not None:  # phase 3h's placed steps are held to these
        handoff.update(losses=losses, params=[t.cpu() for t in tree_leaves(params)])
    loss_fn = train.make_loss_fn(cfg)
    batch0 = {k: torch.from_numpy(v).to(dev)
              for k, v in SyntheticLMDataset(dcfg).global_batch(0).items()}
    with torch.no_grad():
        after = float(loss_fn(params, batch0))
    if not after < losses[0]:
        fail(f"train full: step 0's batch loss {losses[0]} before, {after} after "
             f"{tf['steps']} steps")
    out.update(losses=losses, grad_norms=norms, step0_loss_after=after,
               step_wall_ms=[1e3 * m["sec"] for m in log_])
    # the step's times: wall (CUDA events) and the card's busy time inside it
    step_fn = train.make_train_step(cfg, ocfg, donate=True)

    def one_step():
        return step_fn(params, opt_state, batch0)

    out["step_ms"] = time_ms(one_step, reps=2, warmup=1)
    out["step_device_ms"], out["step_device_split"] = _device_total_ms(one_step, reps=2)
    out["tokens_per_s"] = seq * gb / out["step_ms"] * 1e3
    torch.cuda.synchronize()
    out["train_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    del opt_state, step_fn
    w8 = _flat_int8(params)  # the static egress permutation's weight bytes

    # the gradient check, in float32 on 1 x fd_tokens tokens
    c32 = dataclasses.replace(cfg, dtype="float32")
    loss32 = train.make_loss_fn(c32)
    fd_batch = {k: v[:1, : tf["fd_tokens"]] for k, v in batch0.items()}
    _, grads = value_and_grad(loss32, params, fd_batch)
    gnorm = float(optim.global_norm(grads))
    h = tf["fd_h"]
    side = []
    with torch.no_grad():
        for sign in (1.0, -2.0):  # p + h u, then p - h u
            for p, d in zip(tree_leaves(params), tree_leaves(grads)):
                p.add_(d, alpha=sign * h / gnorm)
            side.append(float(loss32(params, fd_batch)))
    del grads, params
    fd = (side[0] - side[1]) / (2 * h)
    fd_rel = abs(fd - gnorm) / gnorm
    if not fd_rel <= tf["fd_rel_tol"]:
        fail(f"train full: directional derivative {fd} vs |g| {gnorm} (rel {fd_rel:.3g} > "
             f"{tf['fd_rel_tol']})")
    out.update(fd_grad_norm=gnorm, fd_derivative=fd, fd_rel_err=fd_rel)

    # one capture_train_step at full width; the gradient tree is read from
    # the train.grads payload as the tap records it
    cap_mod = sys.modules["repro_torch.obs.capture"]
    seen = {}

    def spy(kind, payload):
        if kind == "train.grads":
            seen["grads"] = payload["grads"]
        type(cap_mod._TAP).tap(cap_mod._TAP, kind, payload)

    cap_mod._TAP.tap = spy
    try:
        t1 = time.perf_counter()
        sess = lc.run("train full capture", lambda: obs.capture_train_step(
            cfg, batch=gb, seq=seq, seed=tf["seed"], device=dev), {})
        out["capture_step_s"] = time.perf_counter() - t1
    finally:
        del cap_mod._TAP.tap
    grads = seen.pop("grads")
    names = [s.name for s in sess.streams]
    (g,) = sess.get("train_allreduce", "grads")
    out["grads_bytes"] = g.num_bytes
    if names != ["grads"] or (full and g.num_bytes != tf["grad_bytes"]):
        fail(f"train full: streams {names}, {g.num_bytes} grads bytes")
    at = 0
    for path, leaf in _sorted_tensor_leaves(grads):
        mine = int8_view(leaf).reshape(-1).view(torch.uint8)
        if not torch.equal(g.data[at: at + mine.numel()], mine):
            fail(f"train full: grads stream bytes of {path} differ from int8_view")
        at += mine.numel()
    if at != g.num_bytes:
        fail(f"train full: grads stream {g.num_bytes} bytes, leaves {at}")
    flat = torch.cat([t.reshape(-1) for _, t in _sorted_tensor_leaves(grads)])
    del grads

    # measure: 16 links under the four points; the plain version on 2 of them
    pk = g.data[: g.num_bytes // 64 * 64].view(-1, 64)
    links = pk.tensor_split(tf["split"])
    meas = {}
    t1 = time.perf_counter()
    ev = lc.run("train full grid", lambda: dse.evaluate_grid(
        SERVE_POINTS, dse.Workload("grads_split", tuple(links), lanes=TRAIN["lanes"])),
        {"bt_axes": 1})
    meas["grid_ms"] = (time.perf_counter() - t1) * 1e3
    sub = dse.Workload("grads_sub", tuple(links[: tf["plain_links"]]), lanes=TRAIN["lanes"])
    got = lc.run("train full grid subset", lambda: dse.evaluate_grid(SERVE_POINTS, sub),
                 {"bt_axes": 1})
    plain = dse.evaluate_grid(SERVE_POINTS, sub, backend="torch",
                              chunk_packets=max(1, (1 << 20) // tf["plain_links"]))
    if [dataclasses.asdict(e) for e in got] != [dataclasses.asdict(e) for e in plain]:
        fail(f"train full: grid on {tf['plain_links']} links differs from the plain version's")
    meas["grid"] = {e.label: [e.total_bt, e.aux_bt] for e in ev}
    meas["red_pct"] = {e.label: 100 * e.bt_reduction for e in ev}
    del links, sub, got, plain

    # one ring reduce-scatter step on ring(8); ring link 0 against the plain
    # source order and BT (2**19-packet chunks)
    ring = {}
    for key in ("none", "acc", "app"):
        t1 = time.perf_counter()
        rep = lc.run(f"train full ring {key}", lambda: train_ring(g.data, key),
                     {"bt_axes": 1} | _sorts(key))
        ms = (time.perf_counter() - t1) * 1e3
        topo = noc.ring(TRAIN["ring"])
        f0 = noc.ring_allreduce_flows(g.data.view(torch.int8), topo,
                                      spec=input_only_spec(key, 64, 16))[0]
        k = {"none": None, "acc": None, "app": 4}[key]
        pk0 = f0.inputs if key == "none" else torch.cat([
            psu_reorder(f0.inputs[a: a + (1 << 19)], k=k, backend="torch")
            for a in range(0, f0.inputs.shape[0], 1 << 19)])
        bt0 = _bt_sum(pk0.reshape(-1, 16, 4).transpose(1, 2).reshape(-1, 16), "torch")
        s0 = {s.link: s for s in rep.links}[noc.unicast_links(topo, f0.src, f0.dsts[0])[0]]
        if s0.bt_input != bt0:
            fail(f"train full ring {key}: link 0 BT {s0.bt_input} != plain {bt0}")
        ring[key] = {"bt": rep.total_bt, "ms": ms}
        del pk0
    meas["ring"] = ring
    meas["ring_red_pct"] = {k: 100 * (1 - r["bt"] / ring["none"]["bt"]) for k, r in ring.items()}
    out["measure"] = meas
    del pk

    # compressed_psum(int8_ef), one replica: unordered, then through the
    # static egress permutation of the trained weights' bytes
    ccfg = optim.CompressionConfig(mode="int8_ef")
    ocfg8 = dataclasses.replace(ccfg, use_egress_ordering=True)
    del g, sess
    err0 = torch.zeros((), device=dev).expand(flat.shape[0])  # a zero buffer, no bytes
    t1 = time.perf_counter()
    unordered, _ = lc.run("compressed_psum", lambda: optim.compressed_psum(flat, err0, ccfg), {})
    out["psum_ms"] = (time.perf_counter() - t1) * 1e3
    m = flat.shape[0]
    perm, inv = lc.run("egress permutation", lambda: egress_permutation(w8[:m], packet=64),
                       {"psu_sort": 1})
    del w8
    pad = (-m) % ccfg.block  # the wire's padding to whole blocks stays in place
    if pad:
        tail = torch.arange(m, m + pad, dtype=torch.int32, device=dev)
        perm, inv = torch.cat([perm, tail]), torch.cat([inv, tail])
    ordered, _ = lc.run("compressed_psum ordered", lambda: optim.compressed_psum(
        flat, err0, ocfg8, perm=perm, inv_perm=inv), {})
    if not torch.equal(ordered, unordered):
        fail("train full: compressed_psum through the egress permutation differs from unordered")
    del ordered, unordered, inv
    wire, _, _ = int8_wire(flat, err0, ccfg)
    del flat, err0
    permuted = _permute(wire, perm)[:m]
    wire = wire[:m]
    del perm
    wbt = lc.run("compressed wire BT", lambda: (_bt_sum(_wire(wire)), _bt_sum(_wire(permuted))),
                 {"bt_count": 2 * -(-(m // 16 - 1) // (1 << 23))})
    out["wire_bt"] = {"unordered": wbt[0], "ordered": wbt[1],
                      "red_pct": 100 * (1 - wbt[1] / wbt[0])}
    del wire, permuted
    torch.cuda.synchronize()
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    log(f"train full {cfg.name}: {tf['steps']} steps of {gb} x {seq} tokens; losses "
        + " ".join(f"{x:.4f}" for x in losses) + f", grad norms "
        + " ".join(f"{x:.3f}" for x in norms)
        + f"; step 0's batch {losses[0]:.4f} -> {after:.4f}; step {out['step_ms']:.1f} ms wall "
        f"(CUDA events), {out['step_device_ms']} ms device, {out['tokens_per_s']:.0f} tokens/s; "
        f"training peak {out['train_peak_bytes']} bytes")
    log(f"train full step device split: {out['step_device_split']}")
    log(f"train full gradient check (float32, 1 x {tf['fd_tokens']} tokens, h={h}): "
        f"central difference {fd:.6g} vs |g| {gnorm:.6g} (rel {fd_rel:.3g})")
    log(f"train full capture: grads {out['grads_bytes']} bytes = int8_view leaf by "
        f"leaf; grid on {tf['split']} links {meas['grid_ms']:.1f} ms (= plain on "
        f"{tf['plain_links']}): " + " ".join(f"{k}={v:.4f}%" for k, v in meas["red_pct"].items())
        + "; ring(8) " + " ".join(f"{k}: bt={r['bt']} ({r['ms']:.0f} ms)"
                                  for k, r in ring.items())
        + f" (link 0 = plain); compressed_psum {out['psum_ms']:.1f} ms, ordered = unordered, "
        f"wire BT {wbt[0]} -> {wbt[1]} ({out['wire_bt']['red_pct']:.4f}%)")
    log(f"train full: peak {out['peak_bytes']} bytes; {out['seconds']:.1f} s")
    return out


def _compare_reductions(serve_path: dict, train_path: dict) -> None:
    """The ACC / APP / composed BT reductions of internlm2-1.8b's real
    gradient (phase 3g) beside its served weight stream's (phase 3f), both
    as 16 links of the same run."""
    w = serve_path["rows"]["serve/full"]["measure"]["weights_split"]["red_pct"]
    g = train_path["rows"]["train/full"]["measure"]["red_pct"]
    log("full width BT reductions, gradient (3g) vs served weights (3f), 16 links each: "
        + " ".join(f"{k}: {g[k]:.4f}% vs {w[k]:.4f}%" for k in g))


# ------------------------------------------------------------------ phase 3h

# The distribution path at full width on a one-rank NCCL group: the
# rule-placed step (plain and ZeRO-1) against phase 3g's steps, the
# compressed all-reduce and the sharded link axis over the group, a
# one-stage pipeline, the step's roofline with the H100's constants and the
# meta dry run of SERVE_ARCH's shapes on the 16 x 16 production mesh.
DIST = {"links": 16, "micro": 4, "plain_packets": 1 << 19,
        "configs": (CodecVariant("none"), CodecVariant("acc"), CodecVariant("app", 4))}


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def phase_dist(dev: torch.device, full: bool = True, handoff: dict | None = None) -> dict:
    """Phase 3h: a one-rank process group (NCCL on the card) and a (1, 1)
    ("data", "model") mesh; (a) SERVE_ARCH trained 3 steps by the
    rule-placed step, plain and ZeRO-1, losses and params against phase
    3g's ``train()`` (``handoff``); (e) the step's roofline record; (d) a
    one-stage ``pipeline_apply`` over all layers against the sequential
    stack; (b) ``compressed_psum`` of the full gradient over the group
    against ``group=None``, unordered and egress-ordered, and its wire's
    BT; (c) ``bt_count_axes_sharded`` of that wire as 16 links against the
    unsharded table; then the meta dry run.  Returns rows and launches."""
    import torch.distributed as dist

    t_phase = time.perf_counter()
    lc = _PathLaunches()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = launch.make_smoke_mesh(device=dev.type)
        rows = _dist_path(dev, lc, mesh, dist.group.WORLD, full, handoff or {})
    finally:
        dist.destroy_process_group()
    rows["dist/dryrun"] = _dist_dryrun()
    seconds = time.perf_counter() - t_phase
    log(f"dist-path launches: {lc.total}; phase 3h {seconds:.1f} s ({backend}, world 1)")
    return {"rows": rows, "launches": lc.total, "max_abs_err": 0, "seconds": seconds}


def _placed_run(dev, lc, mesh, cfg, dcfg, ocfg, handoff: dict, what: str,
                full: bool, extra: dict | None = None) -> tuple:
    """Three placed steps from ``train()``'s initial weights and batches
    (``extra`` joins each, as in :func:`train_one_process`), held to phase
    3g's losses and params; returns (row, params, opt state, step, step 0's
    batch)."""
    from repro_torch.launch.step import make_placed_train_step, place_state

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(TRAIN_FULL["seed"]), dev)
    p, o = place_state(cfg, mesh, params, optim.init(params))
    del params
    step = make_placed_train_step(cfg, ocfg, mesh)
    data = SyntheticLMDataset(dcfg)
    losses, walls = [], []

    def batch_of(i):
        return {k: torch.as_tensor(v).to(dev)
                for k, v in {**data.global_batch(i), **(extra or {})}.items()}

    for i in range(TRAIN_FULL["steps"]):
        batch = batch_of(i)
        t1 = time.perf_counter()
        p, o, m = lc.run(f"{what} step {i}", lambda: step(p, o, batch), {})
        walls.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(m["loss"]))
    row = {"losses": losses, "step_wall_ms": walls,
           "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    # the one-process run's params: host copies, or each leaf's sha256
    want, mine = handoff.get("losses"), tree_leaves(p)
    theirs = handoff.get("params", handoff.get("sha256"))
    if full and (want is None or theirs is None or len(theirs) != len(mine)):
        fail(f"{what}: the one-process run handed over {len(theirs or [])} param leaves and "
             f"losses {want}; the placed step has {len(mine)} leaves")
    if want is not None and losses != want:
        fail(f"{what}: losses {losses} != the one-process run's {want}")
    if theirs is not None:
        same = ((lambda a, b: torch.equal(a.to_local().cpu(), b)) if "params" in handoff
                else (lambda a, b: _leaf_sha256(a.to_local()) == b))
        differ = sum(int(not same(a, b)) for a, b in zip(mine, theirs))
        if differ:
            fail(f"{what}: {differ} param leaves differ from the one-process run's after "
                 f"{TRAIN_FULL['steps']} steps")
    row["equal_to_3g"] = want is not None and theirs is not None
    return row, p, o, step, batch_of(0)


def _dist_path(dev, lc, mesh, group, full: bool, handoff: dict) -> dict:
    from repro_torch import roofline
    from repro_torch.launch.pipeline import make_pipe_mesh, pipeline_apply, stack_stages
    from repro_torch.models.transformer import _attn_layer, _layer, _positions, embed_tokens
    from repro_torch.train.step import accumulate, make_loss_fn

    tf = TRAIN_FULL
    cfg = get_config(SERVE_ARCH) if full else smoke_config(SERVE_ARCH)
    seq, gb = (tf["seq_len"], tf["global_batch"]) if full else (64, 4)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=gb, seed=tf["seed"])
    ocfg = optim.AdamWConfig(warmup_steps=1, total_steps=10)
    rows: dict = {}

    # (a) ZeRO-1, then plain: three steps each, equal to phase 3g's
    zcfg = dataclasses.replace(cfg, zero1=True)
    rows["dist/zero1"], p, o, _, _ = _placed_run(dev, lc, mesh, zcfg, dcfg, ocfg, handoff,
                                                 "dist zero1", full)
    del p, o
    torch.cuda.empty_cache()
    row, p, o, step, batch0 = _placed_run(dev, lc, mesh, cfg, dcfg, ocfg, handoff, "dist plain",
                                          full)

    def one_step():
        return step(p, o, batch0)

    row["step_ms"] = time_ms(one_step, reps=2, warmup=1)
    row["step_device_ms"], row["step_device_split"] = _device_total_ms(one_step, reps=2)
    rows["dist/plain"] = row
    for what, r in (("zero1", rows["dist/zero1"]), ("plain", row)):
        log(f"dist (a) {cfg.name} placed step, {what}: losses "
            + " ".join(f"{x:.6f}" for x in r["losses"])
            + (" = phase 3g's, params bitwise equal" if r["equal_to_3g"] else "")
            + "; step wall " + " ".join(f"{x:.1f}" for x in r["step_wall_ms"])
            + f" ms; peak {r['peak_bytes']} bytes")
    log(f"dist (a) plain step: {row['step_ms']:.1f} ms wall (CUDA events), "
        f"{row['step_device_ms']} ms device; split {row['step_device_split']}")

    # (e) the step's roofline record with the H100's constants
    rec = lc.run("dist roofline step", lambda: roofline.collect_from_step(
        step, p, o, batch0, arch=cfg.name, shape=f"train_{gb}x{seq}", kind="train",
        mesh_desc="1x1", num_devices=1, cfg=cfg, device=dev), {})
    terms = roofline.analyse(rec, seq, gb, cfg)
    dev_ms = row["step_device_ms"] or row["step_ms"]
    rows["dist/roofline"] = {
        "record": {k: v for k, v in rec.items() if k != "collective_ops"},
        "compute_s": terms.compute_s, "memory_floor_s": terms.memory_floor_s,
        "collective_s": terms.collective_s, "bound_s": terms.bound_s,
        "dominant": terms.dominant, "roofline_fraction": terms.roofline_fraction,
        "model_flops": terms.model_flops_per_device, "useful_ratio": terms.useful_ratio,
        "measured_ms": dev_ms, "measured_fraction": terms.measured_fraction(dev_ms / 1e3)}
    log(f"dist (e) roofline of the placed step (H100 SXM: {roofline.PEAK_FLOPS:.3g} FLOP/s, "
        f"{roofline.HBM_BW:.3g} B/s, link {roofline.ICI_BW:.3g} B/s): FLOPs "
        f"{rec['hlo_flops_per_device']:.4e} counted ({rec['cost_source']}), model "
        f"{terms.model_flops_per_device:.4e} (useful {terms.useful_ratio:.3f}); compute "
        f"{terms.compute_s * 1e3:.3f} ms, memory floor {terms.memory_floor_s * 1e3:.3f} ms "
        f"({rec.get('peak_bytes_per_device')} bytes), collective {terms.collective_s * 1e3:.3f} "
        f"ms ({rec['collectives']}); bound {terms.bound_s * 1e3:.3f} ms ({terms.dominant}), "
        f"roofline fraction {terms.roofline_fraction:.4f}; against the measured {dev_ms} ms "
        f"device step: {rows['dist/roofline']['measured_fraction']:.4f}")

    # (d) a one-stage pipeline over every layer, 4 microbatches
    whole = {k: v.to_local() for k, v in p.items() if k != "layers"}
    layers = tree_map(lambda t: t.to_local(), p["layers"])
    with torch.no_grad():
        h = embed_tokens(whole, cfg, batch0["tokens"])
        micro = h.reshape(DIST["micro"], gb // DIST["micro"], seq, -1)
        pos = _positions(seq, h.device)

        def stage_fn(sp, x):
            for i in range(tree_leaves(sp)[0].shape[0]):
                x = _attn_layer(_layer(sp, i), x, cfg, pos)
            return x

        t1 = time.perf_counter()
        piped = lc.run("dist pipeline", lambda: pipeline_apply(
            stage_fn, stack_stages(layers, 1), micro, make_pipe_mesh(1, dev.type)), {})
        pipe_ms = (time.perf_counter() - t1) * 1e3
        seq_out = torch.stack([stage_fn(layers, micro[i]) for i in range(DIST["micro"])])
    if not torch.equal(piped, seq_out):
        fail("dist (d): the one-stage pipeline differs from the sequential stack")
    rows["dist/pipeline"] = {"shape": list(micro.shape), "ms": pipe_ms, "equal": True}
    log(f"dist (d) one-stage pipeline_apply over {tree_leaves(layers)[0].shape[0]} layers x "
        f"{DIST['micro']} microbatches {list(micro.shape)}: = sequential stack bitwise "
        f"({pipe_ms:.1f} ms)")
    del h, micro, piped, seq_out

    # the full gradient at the trained weights, and their int8 bytes
    plain = {**whole, "layers": layers}
    del o, step, one_step, whole, layers, p
    _, grads = accumulate(make_loss_fn(cfg), plain, batch0)
    flat = torch.cat([g.reshape(-1) for g in tree_leaves(grads)])
    del grads
    w8 = _flat_int8(plain)
    del plain
    torch.cuda.empty_cache()
    rows["dist/psum"], wire = _dist_psum(dev, lc, group, flat, w8)
    del w8, flat
    rows["dist/axes"] = _dist_axes(lc, group, wire)
    del wire
    torch.cuda.synchronize()
    rows["dist/peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    log(f"dist: peak {rows['dist/peak_bytes']} bytes since the plain run began")
    torch.cuda.empty_cache()
    return rows


def _dist_psum(dev, lc, group, flat: torch.Tensor, w8: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """(b) compressed_psum(int8_ef) of the full gradient over the group,
    unordered and through the egress permutation of the weights' bytes,
    against group=None; the wire's BT both ways through bt_count.
    Returns the row and the unordered int8 wire."""
    m = flat.shape[0]
    ccfg = optim.CompressionConfig(mode="int8_ef")
    ocfg8 = dataclasses.replace(ccfg, use_egress_ordering=True)
    err0 = torch.zeros((), device=dev).expand(m)  # a zero buffer, no bytes
    ref = optim.compressed_psum(flat, err0, ccfg)
    t1 = time.perf_counter()
    got = lc.run("dist compressed_psum", lambda: optim.compressed_psum(flat, err0, ccfg, group), {})
    out = {"elems": m, "psum_ms": (time.perf_counter() - t1) * 1e3}
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
        fail("dist (b): compressed_psum over the group differs from group=None")
    del got
    perm, inv = lc.run("dist egress permutation", lambda: egress_permutation(w8[:m], packet=64),
                       {"psu_sort": 1})
    pad = (-m) % ccfg.block
    if pad:
        tail = torch.arange(m, m + pad, dtype=torch.int32, device=dev)
        perm, inv = torch.cat([perm, tail]), torch.cat([inv, tail])
    t1 = time.perf_counter()
    got = lc.run("dist compressed_psum ordered", lambda: optim.compressed_psum(
        flat, err0, ocfg8, group, perm=perm, inv_perm=inv), {})
    out["psum_ordered_ms"] = (time.perf_counter() - t1) * 1e3
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
        fail("dist (b): ordered compressed_psum over the group differs from group=None")
    del got, ref, inv
    wire, _, _ = int8_wire(flat, err0, ccfg)
    permuted = _permute(wire, perm)[:m]
    wire = wire[:m]
    del perm
    wbt = lc.run("dist wire BT", lambda: (_bt_sum(_wire(wire)), _bt_sum(_wire(permuted))),
                 {"bt_count": 2 * -(-(m // 16 - 1) // (1 << 23))})
    del permuted
    out["wire_bt"] = {"unordered": wbt[0], "ordered": wbt[1],
                      "red_pct": 100 * (1 - wbt[1] / wbt[0])}
    log(f"dist (b) compressed_psum(int8_ef) of the {m}-element gradient over the "
        f"{group_name(group)} group = group=None, unordered ({out['psum_ms']:.1f} ms) and "
        f"egress-ordered ({out['psum_ordered_ms']:.1f} ms); wire BT {wbt[0]} -> {wbt[1]} "
        f"({out['wire_bt']['red_pct']:.4f}%)")
    return out, wire


def group_name(group) -> str:
    import torch.distributed as dist

    return f"{dist.get_backend(group)} {dist.get_world_size(group)}-rank"


def _dist_axes(lc, group, wire: torch.Tensor) -> dict:
    """(c) the gradient's int8 wire as 16 equal links through the sharded
    link axis over the group (one bt_axes launch), against the unsharded
    table and, on one link, the plain version."""
    nl = DIST["links"]
    pk = wire.shape[0] // (nl * 64)
    x = wire[: nl * pk * 64].view(nl, pk, 64)
    kw = dict(configs=DIST["configs"], input_lanes=16)
    t1 = time.perf_counter()
    sharded = lc.run("dist sharded link axis", lambda: kernels.bt_count_axes_sharded(
        x, group=group, **kw), {"bt_axes": 1})
    ms = (time.perf_counter() - t1) * 1e3
    whole = lc.run("dist unsharded link axis", lambda: bt_count_axes(x, **kw), {"bt_axes": 1})
    plain = bt_count_axes(x[:1], backend="torch", chunk_packets=DIST["plain_packets"], **kw)
    if not torch.equal(sharded, whole) or not torch.equal(sharded[:1], plain):
        fail("dist (c): the sharded link axis differs from the unsharded table or the plain "
             "version")
    tot = sharded.sum(dim=0)[:, 0].tolist()
    out = {"shape": [nl, pk, 64], "ms": ms, "bt": tot,
           "red_pct": [100 * (1 - t / tot[0]) for t in tot]}
    log(f"dist (c) bt_count_axes_sharded of the int8 wire as {nl} links x {pk} packets over "
        f"the {group_name(group)} group ({ms:.1f} ms): = unsharded table, link 0 = plain; "
        f"BT none/ACC/APP4 {tot} ({', '.join(f'{r:.4f}%' for r in out['red_pct'])})")
    return out


def _dist_dryrun() -> dict:
    """The meta dry run of SERVE_ARCH's four shapes on the 16 x 16 mesh."""
    from repro_torch import roofline
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun

    out = {}
    for shape in SHAPES:
        rec = dryrun.run_cell(SERVE_ARCH, shape, False, verbose=False)
        if rec["status"] == "ok":
            sp = SHAPES[shape]
            t = roofline.analyse(rec, sp.seq_len, sp.global_batch)
            rec.update(compute_s=t.compute_s, memory_floor_s=t.memory_floor_s,
                       collective_s=t.collective_s, dominant=t.dominant,
                       roofline_fraction=t.roofline_fraction)
            log(f"dist dry run {SERVE_ARCH} x {shape} [16x16]: {rec['kind']}, argument bytes "
                f"{rec['argument_bytes_per_device']}/device, FLOPs {rec['global_flops']:.4e} "
                f"global (model {rec['model_flops_global']:.4e}); compute "
                f"{t.compute_s * 1e3:.3f} ms, memory floor {t.memory_floor_s * 1e3:.3f} ms, "
                f"collective {t.collective_s * 1e3:.3f} ms ({rec['collectives']}), "
                f"{t.dominant}-bound; {rec['seconds']} s on the host")
        else:
            log(f"dist dry run {SERVE_ARCH} x {shape}: {rec['status']} ({rec['reason']})")
        out[shape] = rec
    return out


# ------------------------------------------------------------------ phase 3i

# The tensor-parallel "model" axis: the dense forward on each rank's
# blocks (launch/tp_model.py), placed serving (launch/serve.py) and the dry
# run's collective term.  One card gives a one-rank NCCL group; the real
# split runs in (d) as two processes of a gloo group sharing the card.
TP = {"dense": ("internlm2-1.8b", "qwen3-4b", "codeqwen1.5-7b", "gemma-7b"),
      "cells": ("train_4k", "prefill_32k", "decode_32k"), "ranks": 2,
      "loss_tol": 5e-3,  # a bf16 forward split two ways (tests/test_torch_tp.py's REF_TOL)
      "rank_timeout": 600}


def phase_tp(dev: torch.device, full: bool = True, handoff: dict | None = None,
             dist_path: dict | None = None) -> dict:
    """Phase 3i: (a) SERVE_ARCH trained by the tensor-parallel placed step on
    a one-rank NCCL group and a (1, 1) mesh, every loss and param bitwise
    equal to phase 3g's ``train()`` and its times beside 3h's; (b) the placed
    greedy ``generate`` at phase 3f's full-width shapes, tokens equal to
    3f's; (c) the collective term of every dense dry-run cell on 16 x 16;
    (d) SERVE_ARCH trained by the same step split over "model" by two
    processes of a gloo group on the one card, losses against 3g's.
    Returns rows and launches."""
    import torch.distributed as dist

    t_phase = time.perf_counter()
    lc = _PathLaunches()
    handoff = handoff or {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = launch.make_smoke_mesh(device=dev.type)
        rows = {"tp/step": _tp_step(dev, lc, mesh, full, handoff, dist_path or {}),
                "tp/generate": _tp_generate(dev, lc, mesh, full, handoff)}
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    rows["tp/two_ranks"] = _tp_two_ranks(dev, full, handoff, meanwhile=lambda: rows.update(
        {"tp/dryrun": _tp_dryrun(dist_path or {})}))
    seconds = time.perf_counter() - t_phase
    log(f"tp-path launches: {lc.total}; phase 3i {seconds:.1f} s ({backend}, world 1; gloo, "
        f"world {TP['ranks']})")
    return {"rows": rows, "launches": lc.total, "max_abs_err": 0, "seconds": seconds}


def _tp_step(dev, lc, mesh, full: bool, handoff: dict, dist_path: dict) -> dict:
    """(a) Three placed steps through the tensor-parallel forward, held to
    phase 3g; every layer runs through ``tp_model.layer``, and a one-rank
    group issues no collective."""
    from repro_torch.launch import tp_model
    from repro_torch.roofline import record_collectives

    tf = TRAIN_FULL
    cfg = get_config(SERVE_ARCH) if full else smoke_config(SERVE_ARCH)
    seq, gb = (tf["seq_len"], tf["global_batch"]) if full else (64, 4)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=gb, seed=tf["seed"])
    ocfg = optim.AdamWConfig(warmup_steps=1, total_steps=10)
    plan = tp_model.make_plan(cfg, mesh)
    if (plan.attn, plan.kv, plan.mlp, plan.embed, plan.head) != (
            "heads", "heads", True, "vocab", "vocab"):
        fail(f"tp (a): the plan of {cfg.name} on (1, 1) is {plan}")
    calls = [0]
    layer = tp_model.layer

    def counted(*a, **k):
        calls[0] += 1
        return layer(*a, **k)

    tp_model.layer = counted
    try:
        with record_collectives() as ops:
            row, p, o, step, batch0 = _placed_run(dev, lc, mesh, cfg, dcfg, ocfg, handoff,
                                                  "tp", full)
    finally:
        tp_model.layer = layer
    if calls[0] != cfg.n_layers * tf["steps"] or ops:
        fail(f"tp (a): {calls[0]} layers through tp_model.layer (want "
             f"{cfg.n_layers * tf['steps']}), collectives {ops} on a one-rank group")

    def one_step():
        return step(p, o, batch0)

    row["step_ms"] = time_ms(one_step, reps=2, warmup=1)
    row["step_device_ms"], row["step_device_split"] = _device_total_ms(one_step, reps=2)
    row["tp_layers"] = calls[0]
    h = dist_path.get("rows", {}).get("dist/plain", {})
    log(f"tp (a) {cfg.name} tensor-parallel placed step on (1, 1): losses "
        + " ".join(f"{x:.6f}" for x in row["losses"])
        + (" = phase 3g's, params bitwise equal" if row["equal_to_3g"] else "")
        + f"; {calls[0]} layers through tp_model, no collective; step "
        f"{row['step_ms']:.1f} ms wall (CUDA events), {row['step_device_ms']} ms device, peak "
        f"{row['peak_bytes']} bytes (3h's placed step: {h.get('step_ms', 0):.1f} ms, "
        f"{h.get('step_device_ms')} ms, {h.get('peak_bytes')} bytes)")
    del p, o, step, one_step, batch0
    torch.cuda.empty_cache()
    return row


def _tp_generate(dev, lc, mesh, full: bool, handoff: dict) -> dict:
    """(b) The placed greedy ``generate`` at phase 3f's full-width shapes and
    weights: tokens equal to 3f's."""
    from repro_torch.launch import serve as placed

    sf = SERVE_FULL
    cfg = get_config(SERVE_ARCH) if full else smoke_config(SERVE_ARCH, attn_impl="chunked_skip",
                                                           attn_chunk=8)
    nreq, plen, new = sf["requests"], sf["prompt"] if full else 64, sf["new_tokens"]
    gen = torch.Generator(device=dev).manual_seed(sf["seed"])
    params = init_params(cfg, gen, dev)
    prompts = torch.randint(0, cfg.vocab, (nreq, plen), generator=gen, device=dev)
    local = placed.shard_params(cfg, mesh, params)
    mode = placed.kv_mode(cfg, mesh, nreq, plen + new)
    placed.generate(local, cfg, mesh, prompts, new)  # warm-up
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = lc.run("tp generate", lambda: placed.generate(local, cfg, mesh, prompts, new), {})
    seconds = time.perf_counter() - t1
    want = handoff.get("serve_tokens")
    if full and want is None:
        fail("tp (b): phase 3f handed over no tokens")
    if want is not None and not torch.equal(res.tokens.cpu(), want):
        fail("tp (b): the placed generate's tokens differ from phase 3f's")
    lp = handoff.get("serve_logprobs")
    lp_err = None if lp is None else float((res.logprobs.cpu() - lp).abs().max())
    out = {"requests": nreq, "prompt": plen, "new_tokens": new, "cache": mode,
           "generate_s": seconds, "tokens_equal_3f": want is not None, "logprob_max_err": lp_err}
    log(f"tp (b) placed generate of {cfg.name}, {nreq} x {plen} prompts + {new} tokens, cache "
        f"{mode}: tokens = phase 3f's, log-probabilities within {lp_err}; {seconds:.3f} s "
        f"(3f's generate: {handoff.get('serve_generate_s', 0):.3f} s)")
    del params, local, res
    torch.cuda.empty_cache()
    return out


def _tp_dryrun(dist_path: dict) -> dict:
    """(c) The collectives one device issues in every dense cell on the
    16 x 16 mesh (the placed step, prefill or decode on meta blocks over
    stand-in groups), their wire bytes and collective term; SERVE_ARCH's
    beside phase 3h's compute term."""
    from repro_torch import roofline
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh

    mesh = AbstractMesh((16, 16), ("data", "model"))
    h = dist_path.get("rows", {}).get("dist/dryrun", {})
    out = {}
    for arch in TP["dense"]:
        for shape in TP["cells"]:
            t1 = time.perf_counter()
            ops = dryrun.placed_collectives(launch.build_case(arch, shape), mesh)
            summary = roofline.summarize_collectives(ops)
            wire = roofline.wire_bytes(ops)
            rec = {"collectives": summary, "wire_bytes_per_device": wire,
                   "collective_s": wire / roofline.ICI_BW, "host_s": time.perf_counter() - t1}
            compute = h.get(shape, {}).get("compute_s") if arch == SERVE_ARCH else None
            if compute is not None:
                rec["compute_s"] = compute
            if not ops or wire <= 0:
                fail(f"tp (c): {arch} x {shape} records no collective")
            out[f"{arch}/{shape}"] = rec
            log(f"tp (c) dry run {arch} x {shape} [16x16]: {summary}; wire "
                f"{wire:.6g} bytes/device, collective {rec['collective_s'] * 1e3:.3f} ms"
                + (f" against compute {compute * 1e3:.3f} ms (3h)" if compute is not None else "")
                + f"; {rec['host_s']:.1f} s on the host")
    return out


def tp_rank(rank: int, world: int, port: int, out: str, full: str, device: str,
            arch: str = SERVE_ARCH, layers: str = "0") -> None:
    """Phase 3i (d) and 3j (e), one rank of a ``world``-rank gloo group on
    ``device`` ("cuda": card 0, which must be visible; "cpu" for a
    rehearsal): ``arch`` (at full width with ``layers`` layers, all for 0;
    its smoke config when not ``full``) trained TRAIN_FULL["steps"] steps by
    the placed step on a (1, world) mesh; writes its losses, times, device,
    collectives and a MoE's local expert count to ``out`` (``full`` "1" or
    "0" and ``layers`` as strings, from its command line)."""
    import torch.distributed as dist

    full, layers = full == "1", int(layers)
    dev = _rank_device(device, "tp (d)", rank)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        mesh = launch.make_smoke_mesh(device=dev.type)
        cfg = (get_config(arch, **({"n_layers": layers} if layers else {})) if full
               else smoke_config(arch))
        res = {"rank": rank, "device": str(dev), **_rank_train(dev, mesh, cfg, full)}
    finally:
        dist.destroy_process_group()
    Path(out).write_text(json.dumps(res))


def _rank_device(device: str, tag: str, rank: int) -> torch.device:
    """A rank's device: card 0 for "cuda" (raising when CUDA is not
    available), else the CPU of a rehearsal."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{tag} rank {rank}: asked for the card, but CUDA is not available")
    return torch.device("cuda", 0) if device == "cuda" else torch.device(device)


def _rank_train(dev, mesh, cfg, full: bool, extra: dict | None = None,
                batch: int | None = None) -> dict:
    """One rank of a gloo group trains ``cfg`` TRAIN_FULL["steps"] steps by
    the placed step on ``mesh`` from ``train()``'s initial weights and
    batches (``extra`` and ``batch`` as :func:`train_one_process`'s); the
    ranks build their state in turn, so the whole weights and moments of
    one rank at a time stand beside the blocks of the others.  Returns its
    losses, step walls, step 0's collectives (summarised and listed), peak
    and parameter blocks."""
    import torch.distributed as dist

    from repro_torch.launch.step import make_placed_train_step, place_state
    from repro_torch.roofline import record_collectives, summarize_collectives

    tf = TRAIN_FULL
    seq, gb = (tf["seq_len"], tf["global_batch"]) if full else (64, 4)
    gb = batch or gb
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            host = tree_map(lambda t: t.cpu(), init_params(
                cfg, torch.Generator(device=dev).manual_seed(tf["seed"]), dev))
            params = _to_card(host, dev)
            del host
            p, o = place_state(cfg, mesh, params, optim.init(params))
            del params
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            _rank_log(f"built its training state: {_card_memory(dev)}")
        dist.barrier()
    step = make_placed_train_step(cfg, optim.AdamWConfig(warmup_steps=1, total_steps=10), mesh)
    data = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=gb,
                                         seed=tf["seed"]))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, walls, ops = [], [], []
    for i in range(tf["steps"]):
        batch = {k: torch.as_tensor(v).to(dev)
                 for k, v in {**data.global_batch(i), **(extra or {})}.items()}
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        with record_collectives() as rec:
            p, o, m = step(p, o, batch)
            losses.append(float(m["loss"]))
        walls.append((time.perf_counter() - t1) * 1e3)
        ops = ops or rec
        _rank_log(f"step {i}: loss {losses[-1]:.6f}, {walls[-1]:.0f} ms")
    blocks = [tuple(x.to_local().shape) for x in tree_leaves(p)]
    out = {"losses": losses, "step_wall_ms": walls, "collectives": summarize_collectives(ops),
           "ops": _ops_list(ops),
           "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
           "local_params": int(sum(math.prod(b) for b in blocks)),
           "params": int(sum(x.numel() for x in tree_leaves(p))),
           "experts": (p["layers"]["moe"]["gate"].to_local().shape[-3]
                       if cfg.family == "moe" else None),
           "attn_blocks": {k: list(v.to_local().shape[1:])
                           for k, v in p["layers"].get("attn", {}).items()}}
    del p, o, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _to_card(host, dev):
    """Host tensors onto ``dev`` after emptying its allocator's cache, once
    nothing built on the card is alive: a rank keeps its blocks of a whole
    model built there, and a block left in a segment split from the build's
    freed temporaries pins the segment (4.5 GiB at granite's width, which
    ran 16 ranks out of memory)."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return tree_map(lambda t: t.to(dev), host)


def _rank_log(msg: str) -> None:
    """A line in this rank's log, with the time since the group started."""
    import torch.distributed as dist

    print(f"rank {dist.get_rank()} at {time.perf_counter() - _T0:.1f} s: {msg}", flush=True)


_T0 = time.perf_counter()


def _card_memory(dev) -> dict:
    """This process's allocated and reserved bytes and the card's free bytes."""
    if dev.type != "cuda":
        return {}
    return {"allocated": torch.cuda.memory_allocated(dev),
            "reserved": torch.cuda.memory_reserved(dev),
            "card_free": torch.cuda.mem_get_info(dev)[0]}


def _ops_list(ops: list) -> list:
    """Recorded collectives as sorted [kind, bytes, group] rows."""
    return sorted([o["kind"], o["bytes"], o["group"]] for o in ops)


def _spawn_ranks(tag: str, n: int, call: str, args: list, meanwhile=None) -> tuple[list, float]:
    """``n`` processes of a gloo group, each running ``chip_smoke.<call>(rank,
    n, port, out, *args)`` (``args`` strings); each writes a JSON result.
    ``meanwhile()``, host work that needs no card (a dry run on meta
    tensors), runs here while they do.  A rank that exits non-zero or
    outlives TP["rank_timeout"] fails the phase.  Returns the results in
    rank order and the wall seconds."""
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    port = _free_port()
    stem = tag.split()[0]
    outs = [build / f"{stem}_rank{r}.json" for r in range(n)]
    logs = [build / f"{stem}_rank{r}.log" for r in range(n)]
    for f in outs:
        f.unlink(missing_ok=True)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            f"chip_smoke.{call}(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), "
            "*sys.argv[5:])")
    t1 = time.perf_counter()
    procs, codes = [], None
    try:
        for r in range(n):
            with open(logs[r], "w") as lf:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code, str(ROOT), str(r), str(n), str(port),
                     str(outs[r]), *map(str, args)],
                    stdout=lf, stderr=subprocess.STDOUT, cwd=ROOT))
        deadline = time.monotonic() + TP["rank_timeout"]
        if meanwhile is not None:
            meanwhile()
        codes = [p.wait(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t1
    if codes is None or any(codes):
        for r in range(n):
            log(f"{tag} rank {r} exited {procs[r].returncode}:\n" + logs[r].read_text()[-3000:])
        fail(f"{tag}: the {n} ranks exited {[p.returncode for p in procs]}"
             + ("" if codes else f" (killed after {TP['rank_timeout']} s)"))
    return [json.loads(f.read_text()) for f in outs], seconds


def _tp_two_ranks(dev, full: bool, handoff: dict, arch: str = SERVE_ARCH, layers: int = 0,
                  tag: str = "tp (d)", meanwhile=None) -> dict:
    """3i (d), 3j (e): two processes of a gloo group on ``dev``'s type (the
    one card; the CPU in a rehearsal) train ``arch`` on a (1, 2) mesh.
    gloo carries CUDA tensors through ``all_reduce`` and ``all_gather``,
    the collectives this step issues there (the TP pair, a MoE's router
    gather, the loss's MAX and SUM, the norm; the one-rank "data" mean is
    skipped).  NCCL refuses two ranks on one device.  Each rank reports its
    device, which must be ``dev``'s, and on the card its peak; losses
    against the one-process run's (``handoff``); ``meanwhile`` as
    :func:`_spawn_ranks`'."""
    n = TP["ranks"]
    ranks, seconds = _spawn_ranks(tag, n, "tp_rank", [int(full), dev.type, arch, layers],
                                  meanwhile)
    want_dev = "cuda:0" if dev.type == "cuda" else dev.type
    if any(r["device"] != want_dev for r in ranks) or (dev.type == "cuda" and any(
            not r["peak_bytes"] for r in ranks)):
        fail(f"{tag}: the ranks ran on {[r['device'] for r in ranks]} with peaks "
             f"{[r['peak_bytes'] for r in ranks]}, not on {want_dev}")
    want = handoff.get("losses")
    if full and want is None:
        fail(f"{tag}: the one-process run handed over no losses")
    errs = [max(abs(a - b) for a, b in zip(r["losses"], want)) for r in ranks] if want else []
    if any(r["losses"] != ranks[0]["losses"] for r in ranks[1:]) or any(
            e > TP["loss_tol"] for e in errs):
        fail(f"{tag}: losses {[r['losses'] for r in ranks]} against the one-process {want}")
    if not ranks[0]["params"] / n <= ranks[0]["local_params"] < ranks[0]["params"]:
        fail(f"{tag}: a rank holds {ranks[0]['local_params']} of {ranks[0]['params']} params")
    out = {"ranks": ranks, "loss_max_err": max(errs) if errs else None, "seconds": seconds}
    log(f"{tag} {arch} split over 'model' by {n} gloo ranks on {want_dev}: losses "
        + " ".join(f"{x:.6f}" for x in ranks[0]["losses"])
        + f" (the one-process run's within {out['loss_max_err']}); a rank holds "
        f"{ranks[0]['local_params']} of {ranks[0]['params']} params"
        + (f", {ranks[0]['experts']} experts a layer" if ranks[0]["experts"] else "")
        + "; step wall "
        + " / ".join(" ".join(f"{x:.0f}" for x in r["step_wall_ms"]) for r in ranks)
        + f" ms; peak {[r['peak_bytes'] for r in ranks]} bytes; collectives of a step "
        f"{ranks[0]['collectives']}; {seconds:.1f} s")
    return out


# ------------------------------------------------------------------ phase 3j

# Expert parallelism over "model" for the MoE family: the experts and the
# router split over "model" (launch/tp_model.py's MoE block), placed
# serving and the dry run's MoE cells.  granite-moe-3b-a800m at full width
# (48 experts, 40 of them real, top-8); trained at 8 of its 32 layers:
# params, gradients, m and v of all 32 take 63.7 GB, and AdamW's
# temporaries on the largest leaf (4.83 GB) and the activations pass the
# card's 80 GB; 16 layers fit too, and 8 keep the whole
# script, phase 3k's 16 ranks included, inside its time limit.
# Served at all 32.  Its dispatch buffers are captured at
# batch 4 x 256 tokens (4 groups of 256, capacity 77).  The dry run's MoE
# cells: those the placed schedule models (qwen3-moe-30b-a3b's serving on
# 16 x 16; granite's optimized-profile cells on 32 x 8) and those it does
# not, with the reason (granite's baseline cells are phase 3k's).
EP = {"arch": "granite-moe-3b-a800m", "train_layers": 8, "dispatch": (4, 256),
      "modelled": (("qwen3-moe-30b-a3b", "prefill_32k", False),
                   ("qwen3-moe-30b-a3b", "decode_32k", False),
                   ("granite-moe-3b-a800m", "train_4k", True),
                   ("granite-moe-3b-a800m", "prefill_32k", True)),
      "unmodelled": (("qwen3-moe-30b-a3b", "train_4k"),)}


def _ep_cfg(full: bool, layers: int = 0):
    """EP["arch"] at full width (``layers`` of its layers, all for 0), or its
    smoke config."""
    if not full:
        return smoke_config(EP["arch"])
    return get_config(EP["arch"], **({"n_layers": layers} if layers else {}))


def phase_ep(dev: torch.device, full: bool = True, serve_path: dict | None = None,
             train_path: dict | None = None) -> dict:
    """Phase 3j: (a) EP["arch"] at EP["train_layers"] layers trained by the one-process
    ``train()``, then by the placed step through the expert-parallel plan
    on a one-rank NCCL group and a (1, 1) mesh, every loss and param leaf
    bitwise equal; (b) the placed greedy ``generate`` at 32 layers, tokens
    and log-probabilities equal to ``serve.generate``'s; (c) its dispatch
    buffers as one link under the four points, ``bt_axes`` against its
    plain version, the reductions beside phases 3f's and 3g's; (d) the dry
    run's MoE cells; (e) (a)'s model split over "model" by two gloo ranks
    sharing the card, losses within 5e-3 of (a)'s.  Returns rows and
    launches."""
    import torch.distributed as dist

    t_phase = time.perf_counter()
    lc = _PathLaunches()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    one = _ep_train_one_process(dev, lc, full)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = launch.make_smoke_mesh(device=dev.type)
        rows = {"ep/train": _ep_step(dev, lc, mesh, full, one),
                "ep/generate": _ep_generate(dev, lc, mesh, full)}
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    rows["ep/dispatch"] = _ep_dispatch(dev, lc, full, serve_path or {}, train_path or {})
    rows["ep/two_ranks"] = _tp_two_ranks(
        dev, full, one, EP["arch"], EP["train_layers"], tag="ep (e)",
        meanwhile=lambda: rows.update({"ep/dryrun": _dryrun_cells("ep (d)", EP["modelled"],
                                                                  EP["unmodelled"])}))
    experts = rows["ep/two_ranks"]["ranks"][0]["experts"]
    want = _ep_cfg(full).moe.padded_experts // TP["ranks"]
    if any(r["experts"] != want for r in rows["ep/two_ranks"]["ranks"]):
        fail(f"ep (e): the ranks hold {experts} experts a layer, not {want}")
    seconds = time.perf_counter() - t_phase
    log(f"ep-path launches: {lc.total}; phase 3j {seconds:.1f} s ({backend}, world 1; gloo, "
        f"world {TP['ranks']})")
    return {"rows": rows, "launches": lc.total, "max_abs_err": 0, "seconds": seconds}


def _ep_train_one_process(dev, lc, full: bool) -> dict:
    """(a), first half: ``train()`` of EP["arch"] at EP["train_layers"]
    layers."""
    return train_one_process(dev, lc, _ep_cfg(full, EP["train_layers"]), full, "ep (a)")


def train_one_process(dev, lc, cfg, full: bool, what: str, timed: bool = True,
                      digests: bool = True, extra: dict | None = None,
                      batch: int | None = None) -> dict:
    """``train()`` of ``cfg`` for TRAIN_FULL["steps"] steps: its losses, with
    ``digests`` each param leaf's sha256, with ``timed`` its step's wall and
    device time; its peak.  ``extra`` (tensors, an encoder-decoder's
    ``frames``) joins every batch; ``batch`` overrides the global batch.
    Its state is freed."""
    tf = TRAIN_FULL
    seq, gb = (tf["seq_len"], tf["global_batch"]) if full else (64, 4)
    gb = batch or gb
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=gb, seed=tf["seed"])
    ocfg = optim.AdamWConfig(warmup_steps=1, total_steps=10)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    res = lc.run(f"{what} train()", lambda: train.train(
        cfg, dcfg, ocfg, train.TrainLoopConfig(steps=tf["steps"], seed=tf["seed"]),
        batch_transform=(lambda b: {**b, **extra}) if extra else None, device=dev), {})
    losses = [m["loss"] for m in res["log"]]
    if not all(np.isfinite(losses)):
        fail(f"{what}: train() losses {losses}")
    params, opt_state = res["params"], res["opt_state"]
    out = {"arch": cfg.name, "layers": cfg.n_layers, "losses": losses,
           "step_wall_ms": [1e3 * m["sec"] for m in res["log"]],
           "sha256": [_leaf_sha256(t) for t in tree_leaves(params)] if digests else None,
           "n_params": int(sum(t.numel() for t in tree_leaves(params)))}
    del res
    out["step_ms"], out["step_device_ms"] = None, None
    if timed:
        step_fn = train.make_train_step(cfg, ocfg, donate=True)
        batch0 = {k: torch.as_tensor(v).to(dev)
                  for k, v in {**SyntheticLMDataset(dcfg).global_batch(0), **(extra or {})}.items()}

        def one_step():
            return step_fn(params, opt_state, batch0)

        out["step_ms"] = time_ms(one_step, reps=2, warmup=1)
        out["step_device_ms"], out["step_device_split"] = _device_total_ms(one_step, reps=2)
        del step_fn, one_step
    torch.cuda.synchronize()
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    del params, opt_state
    torch.cuda.empty_cache()
    log(f"{what} {cfg.name} at {cfg.n_layers} layers ({out['n_params']} params), train() on "
        f"{gb} x {seq} tokens: losses " + " ".join(f"{x:.6f}" for x in losses)
        + (f"; step {out['step_ms']:.1f} ms wall (CUDA events), {out['step_device_ms']} ms "
           f"device" if timed else "") + f", peak {out['peak_bytes']} bytes")
    return out


def _ep_step(dev, lc, mesh, full: bool, one: dict) -> dict:
    """(a), second half: three placed steps through the expert-parallel
    plan on a (1, 1) mesh, held to ``train()``'s losses and leaf digests;
    every MoE layer runs the expert-parallel block ``tp_model.moe_block``
    (on one rank as on many: the plan has no one-rank fork), and a one-rank
    group issues no collective."""
    from repro_torch.launch import tp_model
    from repro_torch.roofline import record_collectives

    tf = TRAIN_FULL
    cfg = _ep_cfg(full, EP["train_layers"])
    seq, gb = (tf["seq_len"], tf["global_batch"]) if full else (64, 4)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=gb, seed=tf["seed"])
    ocfg = optim.AdamWConfig(warmup_steps=1, total_steps=10)
    plan = tp_model.make_plan(cfg, mesh)
    if plan.experts != (0, cfg.moe.padded_experts) or plan.split:
        fail(f"ep (a): the plan of {cfg.name} on (1, 1) is {plan}")
    calls = [0]
    moe_block = tp_model.moe_block

    def counted(*a, **k):
        calls[0] += 1
        return moe_block(*a, **k)

    tp_model.moe_block = counted
    try:
        with record_collectives() as ops:
            row, p, o, step, batch0 = _placed_run(dev, lc, mesh, cfg, dcfg, ocfg, one, "ep (a)",
                                                  full)
    finally:
        tp_model.moe_block = moe_block
    if calls[0] != cfg.n_layers * tf["steps"] or ops:
        fail(f"ep (a): {calls[0]} MoE layers through tp_model.moe_block (want "
             f"{cfg.n_layers * tf['steps']}), collectives {ops} on a one-rank group")

    def one_step():
        return step(p, o, batch0)

    row["step_ms"] = time_ms(one_step, reps=2, warmup=1)
    row["step_device_ms"], row["step_device_split"] = _device_total_ms(one_step, reps=2)
    row["moe_layers"] = calls[0]
    row["one_process"] = {k: v for k, v in one.items() if k != "sha256"}
    log(f"ep (a) {cfg.name} placed step through the expert-parallel plan on (1, 1): losses "
        + " ".join(f"{x:.6f}" for x in row["losses"])
        + (" = train()'s, every param leaf's sha256 equal" if row["equal_to_3g"] else "")
        + f"; {calls[0]} MoE layers through the expert-parallel tp_model.moe_block, no "
        f"collective; step "
        f"{row['step_ms']:.1f} ms wall (CUDA events), {row['step_device_ms']} ms device, peak "
        f"{row['peak_bytes']} bytes (train(): {one['step_ms']:.1f} ms, "
        f"{one['step_device_ms']} ms, {one['peak_bytes']} bytes)")
    del p, o, step, one_step, batch0
    torch.cuda.empty_cache()
    return row


def serve_reference(dev, lc, cfg, what: str, full: bool = True, timed: bool = True,
                    floor: bool = False, frames: torch.Tensor | None = None,
                    requests: int | None = None, patches: torch.Tensor | None = None) -> tuple:
    """``serve.generate`` of ``cfg`` on SERVE_FULL's requests, prompts and
    new tokens (weights and prompts from its seed), greedy: (the run a
    placed one is held to: prompts, tokens, log-probabilities, the
    prefill's last-position logits and the top-2 logit margin at each
    generated position with the one-process tokens fed back in, and with
    ``floor`` how far the same prefill and teacher-forced log-probabilities
    at float32 compute lie from them, the bf16 noise floor; the weights;
    the one-process times of a prefill and a decode step when ``timed``).
    An encoder-decoder's ``frames`` go with the prompts, a vlm's
    ``patches`` in front of them (``inputs_embeds``); ``requests``
    overrides SERVE_FULL's."""
    sf = SERVE_FULL
    nreq, new = requests or sf["requests"], sf["new_tokens"]
    plen = sf["prompt"] if full else 64
    gen = torch.Generator(device=dev).manual_seed(sf["seed"])
    params = init_params(cfg, gen, dev)
    prompts = torch.randint(0, cfg.vocab, (nreq, plen), generator=gen, device=dev)
    want = lc.run(f"{what} generate",
                  lambda: serve.generate(params, cfg, prompts, new, frames=frames,
                                         inputs_embeds=patches), {})
    extra = patches.shape[1] if patches is not None else 0
    prefill_fn = serve.make_prefill_fn(cfg, extra + plen + new)
    decode_fn = serve.make_decode_fn(cfg)
    logits, cache = prefill_fn(params, prompts, frames=frames, inputs_embeds=patches)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    times = _serve_times(lambda: prefill_fn(params, prompts, frames=frames,
                                            inputs_embeds=patches),
                         lambda: decode_fn(params, cache, tok)) if timed else None
    margins, lg, tf_cache = [], logits, cache
    with torch.no_grad():
        for t in range(new):
            top2 = torch.topk(lg[:, -1].to(torch.float32), 2, dim=-1).values
            margins.append(top2[:, 0] - top2[:, 1])
            if t + 1 < new:
                lg, tf_cache = decode_fn(params, tf_cache, want.tokens[:, t: t + 1].to(torch.int32))
    ref = {"prompts": prompts.cpu(), "tokens": want.tokens.cpu(), "logprobs": want.logprobs.cpu(),
           "prefill_logits": logits[:, -1].to(torch.float32).cpu(),
           "margins": torch.stack(margins, dim=1).cpu()}
    del logits, cache, lg, tf_cache
    if floor:
        ref["floor"] = torch.tensor(_serve_floor(params, dataclasses.replace(cfg, dtype="float32"),
                                                 prompts, ref, plen + new))
    return ref, params, times


@torch.no_grad()
def _serve_floor(params, cfg32, prompts, ref: dict, max_len: int) -> float:
    """The largest difference between a bf16 run's prefill logits and
    log-probabilities of its own tokens (``ref``) and the same at float32
    compute, its tokens fed back in: the bf16 noise floor of that run."""
    logits, cache = serve.make_prefill_fn(cfg32, max_len)(params, prompts)
    decode_fn = serve.make_decode_fn(cfg32)
    toks = ref["tokens"].to(prompts.device)
    err = float((logits[:, -1].to(torch.float32).cpu() - ref["prefill_logits"]).abs().max())
    for t in range(toks.shape[1]):
        lp = torch.log_softmax(logits[:, -1].to(torch.float32), dim=-1)
        got = torch.take_along_dim(lp, toks[:, t: t + 1].long(), dim=-1)[:, 0].cpu()
        err = max(err, float((got - ref["logprobs"][:, t]).abs().max()))
        if t + 1 < toks.shape[1]:
            logits, cache = decode_fn(params, cache, toks[:, t: t + 1].to(torch.int32))
    return err


def _ep_generate(dev, lc, mesh, full: bool) -> dict:
    """(b) EP["arch"] at all its layers: the placed greedy ``generate`` on
    the (1, 1) mesh against ``serve.generate`` on the same weights and
    prompts (phase 3f's shapes); prefill and decode times of both."""
    from repro_torch.launch import serve as placed
    from repro_torch.launch import tp_model

    cfg = _ep_cfg(full)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ref, params, times = serve_reference(dev, lc, cfg, "ep", full)
    prompts = ref["prompts"].to(dev)
    want = SimpleNamespace(tokens=ref["tokens"].to(dev), logprobs=ref["logprobs"].to(dev))
    nreq, plen = prompts.shape
    new = want.tokens.shape[1]
    tok = want.tokens[:, :1].to(torch.int32)
    out: dict = {"arch": cfg.name, "layers": cfg.n_layers, "requests": nreq, "prompt": plen,
                 "new_tokens": new, "one_process": times}

    local = placed.shard_params(cfg, mesh, params)
    plan = tp_model.make_plan(cfg, mesh, "serve")
    mode = placed.kv_mode(cfg, mesh, nreq, plen + new)
    res = lc.run("ep placed generate", lambda: placed.generate(local, cfg, mesh, prompts, new), {})
    if not torch.equal(res.tokens, want.tokens):
        fail("ep (b): the placed generate's tokens differ from serve.generate's")
    if not torch.equal(res.logprobs, want.logprobs):
        fail("ep (b): the placed generate's log-probabilities differ from serve.generate's")
    with torch.no_grad():
        logits, cache = placed.prefill(local, plan, prompts, plen + new, mode)
        out["placed"] = _serve_times(
            lambda: placed.prefill(local, plan, prompts, plen + new, mode),
            lambda: placed.decode_step(local, plan, cache, tok, mode))
    torch.cuda.synchronize()
    out.update(cache=mode, tokens_equal=True, logprobs_equal=True,
               peak_bytes=torch.cuda.max_memory_allocated(dev))
    del params, local, logits, cache, res, want
    torch.cuda.empty_cache()
    o, pl = out["one_process"], out["placed"]
    log(f"ep (b) {cfg.name} at {cfg.n_layers} layers, placed greedy generate of {nreq} x {plen} "
        f"prompts + {new} tokens on (1, 1), cache {mode}: tokens and log-probabilities equal to "
        f"serve.generate's; prefill {pl['prefill_ms']:.2f} ms ({pl['prefill_device_ms']} ms "
        f"device), decode {pl['decode_ms_per_token']:.3f} ms/token ({pl['decode_device_ms']} ms "
        f"device) (serve.generate's: {o['prefill_ms']:.2f} ms ({o['prefill_device_ms']} ms), "
        f"{o['decode_ms_per_token']:.3f} ms/token ({o['decode_device_ms']} ms)); peak "
        f"{out['peak_bytes']} bytes")
    log(f"ep (b) device split: placed decode {pl['decode_device_split']}; serve.generate's "
        f"decode {o['decode_device_split']}")
    return out


def _serve_times(prefill_fn, decode_fn) -> dict:
    """Prefill and one decode step: CUDA-event medians and the card's busy
    time inside each (the rest of the wall is host work)."""
    out = {"prefill_ms": time_ms(prefill_fn, reps=3, warmup=1),
           "decode_ms_per_token": time_ms(decode_fn, reps=5, warmup=1)}
    out["prefill_device_ms"], out["prefill_device_split"] = _device_total_ms(prefill_fn)
    out["decode_device_ms"], out["decode_device_split"] = _device_total_ms(decode_fn)
    return out


def _ep_dispatch(dev, lc, full: bool, serve_path: dict, train_path: dict) -> dict:
    """(c) ``obs.capture_moe_dispatch`` of EP["arch"] at full width: its
    dispatch buffers' int8 bytes as one link under the four points of 3f
    (one ``bt_axes`` launch), equal to the plain version; the ACC / APP
    reductions beside 3f's weights' and 3g's gradient's."""
    cfg = _ep_cfg(full)
    b, s = EP["dispatch"] if full else (2, 32)
    sess = obs.capture_moe_dispatch(cfg, batch=b, seq=s, seed=0, device=dev)
    (st,) = sess.get("moe_dispatch", "expert_in")
    gs = min(cfg.moe.group_size, b * s)
    g, c = b * s // gs, min(math.ceil(gs * cfg.moe.top_k * cfg.moe.capacity_factor
                                      / cfg.moe.num_experts), gs)
    if tuple(st.source_shape) != (g, cfg.moe.padded_experts, c, cfg.d_model):
        fail(f"ep (c): dispatch buffers {st.source_shape}, not "
             f"{(g, cfg.moe.padded_experts, c, cfg.d_model)}")
    wl = sess.workload("moe_dispatch", elems=SERVE["elems"], lanes=SERVE["lanes"])
    t1 = time.perf_counter()
    ev = lc.run("ep dispatch grid", lambda: dse.evaluate_grid(SERVE_POINTS, wl), {"bt_axes": 1})
    ms = (time.perf_counter() - t1) * 1e3
    plain = dse.evaluate_grid(SERVE_POINTS, wl, backend="torch", chunk_packets=1 << 20)
    if [dataclasses.asdict(e) for e in ev] != [dataclasses.asdict(e) for e in plain]:
        fail("ep (c): the dispatch grid differs from the plain version's")
    red = {e.label: 100 * e.bt_reduction for e in ev}
    out = {"shape": list(st.source_shape), "bytes": st.num_bytes, "packets": wl.streams[0].shape[0],
           "measure_ms": ms, "bt": {e.label: [e.total_bt, e.aux_bt] for e in ev},
           "red_pct": red}
    w = serve_path.get("rows", {}).get("serve/full", {}).get("measure", {}).get(
        "weights_split", {}).get("red_pct", {})
    gr = train_path.get("rows", {}).get("train/full", {}).get("measure", {}).get("red_pct", {})
    log(f"ep (c) {cfg.name} dispatch buffers {tuple(st.source_shape)} ({st.num_bytes} int8 bytes, "
        f"{out['packets']} packets of {SERVE['elems']}) as one link, grid = plain, {ms:.1f} ms; "
        "reductions " + " ".join(f"{k}={v:.4f}%" for k, v in red.items())
        + "; beside 3f's weights " + " ".join(f"{k}={v:.4f}%" for k, v in w.items())
        + " and 3g's gradient " + " ".join(f"{k}={v:.4f}%" for k, v in gr.items()))
    del sess, wl
    return out


def _dryrun_cells(tag: str, modelled, unmodelled) -> dict:
    """3j (d), 3k (e): the collectives one device issues in each cell the
    placed schedule models ((arch, shape, optimized profile?)), their wire
    bytes and collective term, and the reason of each cell it does not
    ((arch, shape) on 16 x 16)."""
    from repro_torch import roofline
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.specs import OPTIMIZED_PROFILES

    out = {}
    for arch, shape, optimized in modelled:
        over, mesh_shape = (OPTIMIZED_PROFILES[(arch, shape)][:2] if optimized
                            else ({}, (16, 16)))
        mesh = AbstractMesh(tuple(mesh_shape), ("data", "model"))
        desc = "x".join(map(str, mesh_shape)) + (", optimized" if optimized else "")
        t1 = time.perf_counter()
        case = launch.build_case(arch, shape, **over)
        reason = dryrun.collectives_reason(case, mesh)
        if reason:
            fail(f"{tag}: {arch} x {shape} [{desc}] is not modelled: {reason}")
        ops = dryrun.placed_collectives(case, mesh)
        summary = roofline.summarize_collectives(ops)
        wire = roofline.wire_bytes(ops)
        rec = {"mesh": desc, "collectives": summary, "wire_bytes_per_device": wire,
               "collective_s": wire / roofline.ICI_BW, "host_s": time.perf_counter() - t1}
        if not ops or wire <= 0:
            fail(f"{tag}: {arch} x {shape} records no collective")
        out[f"{arch}/{shape}/{desc}"] = rec
        log(f"{tag} dry run {arch} x {shape} [{desc}]: {summary}; wire {wire:.6g} bytes/device, "
            f"collective {rec['collective_s'] * 1e3:.3f} ms; {rec['host_s']:.1f} s on the host")
    mesh = AbstractMesh((16, 16), ("data", "model"))
    for arch, shape in unmodelled:
        reason = dryrun.collectives_reason(launch.build_case(arch, shape), mesh)
        if not reason:
            fail(f"{tag}: {arch} x {shape} [16x16] gives no reason")
        out[f"{arch}/{shape}/16x16"] = {"mesh": "16x16", "collectives_reason": reason}
        log(f"{tag} dry run {arch} x {shape} [16x16]: not modelled: {reason}")
    return out


# ------------------------------------------------------------------ phase 3k

# Attention's contraction split over "model" (launch/tp_model.py's
# contracted_qkv / contracted_out): where "model" divides d_model but not
# the heads, wq splits on its input d and wo on its output d.  granite-moe-
# 3b-a800m (24 heads, d_model 1,536, 8 kv heads) takes it on the baseline
# 16 x 16 mesh, and 16 is the smallest "model" axis that divides 1,536 and
# not 24, so 16 processes of a gloo group share the card on a (1, 16) mesh
# (8 with the smoke config of a CPU rehearsal: its 4 heads on 8 ranks).
# Served and trained at CP["layers"] = 8 of the 32 layers (each gloo
# collective among 16 processes takes ~70-90 ms, so 16 tokens at 32 layers
# took 228 s), against a one-process ``serve.generate`` and ``train()`` at
# the same depth: a rank holds 1/16 of wq, wo, the router and the embedding
# and head (split on d: 16 does not divide 49,155), wk / wv whole and 3 of
# the 48 experts.  Training runs the config's bf16, its losses held to
# ``loss_tol``.  Serving computes in float32 (CP["serve_dtype"]) against a
# float32 ``serve.generate``: in bf16 the 16 ranks sum the head's partial
# logits and the MoE combine where the one-process products round once, so
# a routing near-tie can flip one of a token's 8 experts, and bf16 rounding
# alone put the one-process run's logits at 4 layers 0.876 from the same
# run at float32 compute, wider than any gate that would catch a wrong
# share.  ``tol`` holds the placed forward against the
# one-process one (logits and log-probabilities, absolute); a top-2 margin
# under 2 tol is a near tie (two logits each within tol can swap there).
CP = {"arch": "granite-moe-3b-a800m", "ranks": 16, "rehearsal_ranks": 8, "layers": 8,
      "serve_dtype": "float32", "tol": 0.25, "loss_tol": 5e-3,  # losses: as 3i(d) and 3j(e)
      "modelled": tuple(("granite-moe-3b-a800m", s, False)
                        for s in ("train_4k", "prefill_32k", "decode_32k"))}


def lm_collectives(cfg, plan, rows: int, seq: int, embedded: int, train: bool) -> list:
    """The "model"-axis collectives one rank issues around a split stack on
    a mesh with one data rank: the embedding's sum or gather of
    ``embedded`` tokens (of the params), the head's (vocab: in training the
    loss's MAX and SUM and its input's gradient sum; d: the partial logits,
    of each request's last position out of training, and in training its
    input's gradient sum; per loss chunk of the ``rows`` x ``seq``
    positions) and, in training, the partial leaves' gradient sums and the
    norm's split squares."""
    m = plan.model.size
    c = torch_dtype(cfg.dtype).itemsize
    p = torch_dtype(cfg.param_dtype).itemsize
    d = cfg.d_model
    ops = {"vocab": [("all-reduce", embedded * d * p, m)],
           "d": [("all-gather", embedded * d * p, m)], "whole": []}[plan.embed]
    chunk = cfg.logits_chunk
    nc = seq // chunk if train and chunk and seq % chunk == 0 and seq > chunk else 1
    ct = rows * seq // nc if train else rows
    if plan.head == "vocab" and train:
        ops += [("all-reduce", ct * 4, m), ("all-reduce", 2 * ct * 4, m),
                ("all-reduce", ct * d * c, m)] * nc
    elif plan.head == "d":
        ops += [("all-reduce", ct * cfg.vocab * c, m)] * nc
        if train:
            ops += [("all-reduce", ct * d * c, m)] * nc
    if train:
        ops += [("all-reduce", x.numel() * p, m)
                for path, x in tree_leaves_with_path(param_shapes(cfg)) if path in plan.partial]
        ops.append(("all-reduce", 4, m))
    return ops


def cp_collectives(cfg, plan, rows: int, seq: int, mode: str | None = None) -> list:
    """The "model"-axis collectives one rank issues under attention's
    contraction split on a mesh with one data rank, as sorted (kind, bytes,
    group) rows: a placed train step of ``rows`` x ``seq`` tokens (``mode``
    None), or a decode step of ``rows`` requests with the cache placed by
    ``mode`` ("seq" or "whole").  Per layer: the queries' float32 sum and
    the output's gather (backward: the sums of ``do`` and of the query
    columns' ``dx``); split-K's MAX and SUM; the MLP's pair, or the MoE's
    router gather and combine (backward: the sums of ``xg`` and
    ``top_p``).  Then :func:`lm_collectives` of the tokens."""
    m = plan.model.size
    c = torch_dtype(cfg.dtype).itemsize
    d, hd, h = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads
    train = mode is None
    t = rows * (seq if train else 1)
    act = ("all-reduce", t * d * c, m)
    layer = [("all-reduce", t * h * hd * 4, m), ("all-gather", t * d * c, m)]
    if train:
        layer += [("all-reduce", t * h * hd * c, m), act]
    elif mode == "seq":
        layer += [("all-reduce", rows * h * 4, m), ("all-reduce", rows * h * (hd + 1) * 4, m)]
    if cfg.family == "moe":
        layer += [("all-gather", d * cfg.moe.padded_experts * c, m), act]
        if train:
            layer += [act, ("all-reduce", t * cfg.moe.top_k * 4, m)]
    elif plan.mlp:
        layer += [act] * (2 if train else 1)
    return sorted(layer * cfg.n_layers + lm_collectives(cfg, plan, rows, seq, t, train))


def ssd_collectives(cfg, plan, rows: int, seq: int, mode: str | None = None,
                    sp: int = 1) -> list:
    """The collectives one rank issues running the ssm or hybrid family's
    SSD split (``launch/tp_model.py``) on a mesh with one data rank, as
    sorted (kind, bytes, group) rows: a placed train step of ``rows`` x
    ``seq`` tokens (``mode`` None), or a decode step of ``rows`` requests
    with the KV cache placed by ``mode`` ("heads" or "whole"; "none" with no
    KV cache) and its sequence split over ``sp`` data ranks.  Per SSD layer,
    under "heads": the projection's and the output's float32 sums, the
    gated norm's squares (summed forward and backward; backward: the
    projection's and the input's sums); under "whole" with the projections
    split: the projection's and the output's float32 sums (backward: the
    core output's and the input's sums); in decode, the activated conv row's
    gather when the cache splits the conv tail.  Per use of a hybrid's
    shared block: attention split on heads and the MLP on ``d_ff``, each one
    sum forward and one backward (in decode, SP's MAX and SUM over the data
    ranks).  Then :func:`lm_collectives` of the tokens."""
    from repro_torch.models.ssd import ssm_dims

    m = plan.model.size
    c = torch_dtype(cfg.dtype).itemsize
    d = cfg.d_model
    d_inner, n_heads, _, g, n = ssm_dims(cfg)
    width = 2 * d_inner + 2 * g * n + n_heads
    train = mode is None
    t = rows * (seq if train else 1)
    act = ("all-reduce", t * d * c, m)
    ssd = []
    if plan.ssd_split:
        ssd += [("all-reduce", t * width * 4, m), ("all-reduce", t * d * 4, m)]
        if plan.ssd == "heads":
            ssd += [("all-reduce", t * 4, m)] * (2 if train else 1)
        if train:
            ssd += [act, ("all-reduce", t * (width if plan.ssd == "heads" else d_inner) * c, m)]
    if not train and plan.conv:
        ssd.append(("all-gather", t * (d_inner + 2 * g * n) * c, m))
    ops = ssd * cfg.n_layers
    if cfg.family == "hybrid":
        if plan.attn not in ("heads", "whole") or plan.kv_index is not None or mode == "seq":
            raise ValueError(f"{cfg.name}: the closed form covers attention split on its heads "
                             f"with its kv heads, not {plan.attn} / {plan.kv} / {mode}")
        shared = [act] * ((plan.attn == "heads") + plan.mlp) * (2 if train else 1)
        if sp > 1:
            hl = plan.local.n_heads
            shared += [("all-reduce", rows * hl * 4, sp),
                       ("all-reduce", rows * hl * (cfg.resolved_head_dim + 1) * 4, sp)]
        ops += shared * (cfg.n_layers // cfg.shared_attn_every)
    ops += lm_collectives(cfg, plan, rows, seq, t, train)
    return sorted(o for o in ops if o[2] > 1)


def _cp_serve_cfg(full: bool):
    """The config 3k serves: CP["layers"] of EP["arch"] at CP["serve_dtype"]."""
    return dataclasses.replace(_ep_cfg(full, CP["layers"]), dtype=CP["serve_dtype"])


def phase_cp(dev: torch.device, full: bool = True) -> dict:
    """Phase 3k: CP["arch"] served and trained at CP["layers"] layers by
    CP["ranks"] processes of a gloo group sharing the card on a
    (1, CP["ranks"]) mesh, through attention's contraction split: (a) the
    plan on every rank; (b) at CP["serve_dtype"] compute, the placed
    prefill's last-position logits, the log-probabilities of the one-process
    tokens and the greedy tokens against ``serve.generate`` at the same
    depth and compute (run here first); (c) 3 placed steps against a
    one-process ``train()`` at the same depth (run here first); (d) each rank's peak, step wall, and
    a step's and a decode's collectives equal to :func:`cp_collectives`;
    (e) the dry run's granite baseline cells on 16 x 16.  Returns rows and
    launches."""
    from repro_torch.launch import tp_model
    from repro_torch.launch.mesh import AbstractMesh

    t_phase = time.perf_counter()
    lc = _PathLaunches()
    cfg, scfg = _ep_cfg(full, CP["layers"]), _cp_serve_cfg(full)
    one = train_one_process(dev, lc, cfg, full, "cp", timed=False, digests=False)
    ref, params, _ = serve_reference(dev, lc, scfg, f"cp {scfg.dtype}", full, timed=False)
    del params
    n = CP["ranks"] if full else CP["rehearsal_ranks"]
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    ref_path = build / "cp_serve_ref.npz"
    np.savez(ref_path, **{k: v.numpy() for k, v in ref.items()})
    torch.cuda.empty_cache()
    log(f"cp: before the ranks start, {_card_memory(dev)}")
    dry = {}
    ranks, seconds = _spawn_ranks("cp (b)", n, "cp_rank", [int(full), dev.type, ref_path],
                                  lambda: dry.update(rows=_dryrun_cells("cp (e)", CP["modelled"],
                                                                        ())))
    want_dev = "cuda:0" if dev.type == "cuda" else dev.type
    if any(r["device"] != want_dev for r in ranks) or (dev.type == "cuda" and any(
            not (r["serve"]["peak_bytes"] and r["train"]["peak_bytes"]) for r in ranks)):
        fail(f"cp: the ranks ran on {[r['device'] for r in ranks]}, not on {want_dev}")
    mesh = AbstractMesh((1, n), ("data", "model"))
    rows = {"cp/plan": _cp_plan(ranks, scfg, cfg, n),
            "cp/serve": _cp_serve(ranks, ref, n),
            "cp/train": _cp_train(ranks, one),
            "cp/records": _cp_records(ranks, scfg, cfg, tp_model.make_plan(scfg, mesh, "serve"),
                                      tp_model.make_plan(cfg, mesh), ref, full),
            "cp/seconds": seconds}
    rows["cp/dryrun"] = dry["rows"]
    seconds = time.perf_counter() - t_phase
    log(f"cp-path launches: {lc.total}; phase 3k {seconds:.1f} s (gloo, world {n})")
    return {"rows": rows, "launches": lc.total, "max_abs_err": 0, "seconds": seconds}


def cp_rank(rank: int, world: int, port: int, out: str, full: str, device: str,
            ref_path: str) -> None:
    """Phase 3k, one rank of a ``world``-rank gloo group on ``device``
    ("cuda": card 0; "cpu" for a rehearsal) and a (1, world) mesh: its plans,
    the placed serving of CP["arch"] at CP["layers"] layers and
    CP["serve_dtype"] compute against the one-process run in ``ref_path``
    (its weights rebuilt from the same seed), then its placed training at
    the same depth; writes the results to ``out``."""
    import torch.distributed as dist

    from repro_torch.launch import tp_model

    full = full == "1"
    dev = _rank_device(device, "cp", rank)
    torch.set_num_threads(1)  # 16 processes share the host's cores
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        mesh = launch.make_smoke_mesh(device=dev.type)
        cfg, tcfg = _cp_serve_cfg(full), _ep_cfg(full, CP["layers"])
        plans = {"serve": tp_model.make_plan(cfg, mesh, "serve"),
                 "train": tp_model.make_plan(tcfg, mesh)}
        res = {"rank": rank, "device": str(dev),
               "plan": {k: {"attn": pl.attn, "kv": pl.kv, "experts": list(pl.experts),
                            "partial": sorted(pl.partial)} for k, pl in plans.items()},
               "serve": _cp_rank_serve(dev, mesh, cfg, plans["serve"], ref_path)}
        res["train"] = _rank_train(dev, mesh, tcfg, full)
    finally:
        dist.destroy_process_group()
    Path(out).write_text(json.dumps(res))


def _cp_rank_serve(dev, mesh, cfg, plan, ref_path: str,
                   frames: torch.Tensor | None = None,
                   patches: torch.Tensor | None = None) -> dict:
    """One rank's placed serving: the weights built from SERVE_FULL["seed"]
    in turn (each rank keeps its blocks), then the prefill, one decode step
    fed the one-process run's first token (its collectives; the log-
    probabilities of the one-process tokens 0 and 1), and the greedy
    ``generate``.  A decode step is ~194 collectives, each tens of ms among
    16 gloo processes here, so no second, teacher-forced pass is run:
    ``generate``'s own inputs are the one-process tokens up to a request's
    first divergence.  An encoder-decoder's ``frames`` go with the prompts,
    and the prefill's cross cache (the rank's kv heads) is held to the
    one-process cache's heads of the layers ``ref_path`` keeps
    (``cross_layers``, ``cross_k``, ``cross_v``); a vlm's ``patches`` go in
    front of them, and the prefill's KV cache split on kv heads is held so
    (``kv_layers``, ``k``, ``v``).  The prefill's collectives are
    recorded too."""
    import torch.distributed as dist

    from repro_torch.launch import serve as placed
    from repro_torch.launch.tp import gather_from_model
    from repro_torch.roofline import record_collectives

    def whole(lg):  # the last position's logits of every vocabulary block, float32
        lg = lg[:, -1].to(torch.float32)
        return gather_from_model(lg, plan.model, -1) if plan.head == "vocab" else lg

    ref = {k: torch.from_numpy(v) for k, v in np.load(ref_path).items()}
    prompts, want = ref["prompts"].to(dev), ref["tokens"].to(dev)
    nreq, plen = prompts.shape
    new = want.shape[1]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            gen = torch.Generator(device=dev).manual_seed(SERVE_FULL["seed"])
            params = init_params(cfg, gen, dev)
            drawn = torch.randint(0, cfg.vocab, (nreq, plen), generator=gen, device=dev)
            if not torch.equal(drawn, prompts):
                raise RuntimeError("cp (b): the rebuilt weights' generator draws other prompts")
            host = tree_map(lambda t: t.cpu(), placed.shard_params(cfg, mesh, params))
            del params, drawn
            local = _to_card(host, dev)
            del host
            _rank_log(f"built its serving blocks: {_card_memory(dev)}")
        dist.barrier()
    _rank_log("every rank has built its serving blocks")
    build_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    extra = patches.shape[1] if patches is not None else 0
    mode = placed.kv_mode(cfg, mesh, nreq, extra + plen + new)
    out = {"cache": mode, "blocks": {k: list(v.shape[1:]) for k, v in local["layers"].get(
               "attn", local["layers"].get("ssd", {})).items()},
           "local_params": int(sum(t.numel() for t in tree_leaves(local)))}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    with torch.no_grad():
        sync()
        t1 = time.perf_counter()
        with record_collectives() as pre:
            logits, cache = placed.prefill(local, plan, prompts, extra + plen + new, mode,
                                           frames=frames, patches=patches)
        sync()
        out["prefill_ms"] = (time.perf_counter() - t1) * 1e3
        out["prefill_ops"] = _ops_list(pre)
        first = whole(logits)
        out["prefill_err"] = float((first.cpu() - ref["prefill_logits"]).abs().max())
        for tag, (kk, kv) in (("cross", ("cross_k", "cross_v")), ("kv", ("k", "v"))):
            if f"{tag}_layers" not in ref:
                continue
            # the rank's kv heads of the one-process cache at the layers kept
            hk = cache[kk].shape[3]
            h0 = plan.model.index * hk
            out[f"{tag}_err"] = max(float((cache[key][ref[f"{tag}_layers"]].to(torch.float32).cpu()
                                           - ref[key][..., h0: h0 + hk, :]).abs().max())
                                    for key in (kk, kv))
            out[f"{tag}_shape"] = list(cache[kk].shape)
        sync()
        t1 = time.perf_counter()
        with record_collectives() as ops:
            logits, _ = placed.decode_step(local, plan, cache, want[:, :1].to(torch.int32), mode)
        sync()
        out["decode_ms"] = (time.perf_counter() - t1) * 1e3
        out["decode_ops"] = _ops_list(ops)
        tf = [torch.take_along_dim(torch.log_softmax(lg, dim=-1), want[:, t: t + 1].long(),
                                   dim=-1)[:, 0] for t, lg in enumerate((first, whole(logits)))]
        out["tf_logprobs"] = torch.stack(tf, dim=1).cpu().tolist()
        _rank_log(f"prefill {out['prefill_ms']:.0f} ms, a decode step {out['decode_ms']:.0f} ms")
        del logits, cache, first
        sync()
        t1 = time.perf_counter()
        res = placed.generate(local, cfg, mesh, prompts, new, frames=frames, patches=patches)
        sync()
        out["generate_s"] = time.perf_counter() - t1
        out["tokens"] = res.tokens.cpu().tolist()
        out["logprobs"] = res.logprobs.cpu().tolist()
        _rank_log(f"generate {out['generate_s']:.1f} s")
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    out["build_peak_bytes"] = build_peak
    del local, res
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _range(xs: list, fmt: str = "{:.1f}") -> str:
    """``min-max`` of the ranks' values, or "not measured"."""
    xs = [x for x in xs if x is not None]
    return f"{fmt.format(min(xs))}-{fmt.format(max(xs))}" if xs else "not measured"


def _cp_plan(ranks: list, cfg, tcfg, n: int) -> dict:
    """(a) Every rank's plan: the contraction split, whole kv and no partial
    attention leaf, E/n experts, wq / wo blocks of 1/n, whole wk / wv."""
    e = cfg.moe.padded_experts // n
    d, h, hd, hkv = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim, cfg.n_kv_heads
    want = {"wq": [d // n, h, hd], "wo": [h, hd, d // n], "wk": [d, hkv, hd], "wv": [d, hkv, hd]}
    for r in ranks:
        for mode, pl in r["plan"].items():
            if (pl["attn"], pl["kv"], pl["experts"][1] - pl["experts"][0]) != (
                    "contraction", "whole", e) or any("['attn']" in x for x in pl["partial"]):
                fail(f"cp (a): rank {r['rank']}'s {mode} plan is {pl}")
            if pl["experts"][0] != r["rank"] * e:
                fail(f"cp (a): rank {r['rank']} holds experts {pl['experts']}")
        for what, blocks in (("serving", r["serve"]["blocks"]), ("training", r["train"]["attn_blocks"])):
            if {k: blocks[k] for k in want} != want:
                fail(f"cp (a): rank {r['rank']}'s {what} attention blocks are {blocks}, not {want}")
    log(f"cp (a) {cfg.name} on (1, {n}), every rank: attention split on its contraction "
        f"(wq {want['wq']}, wo {want['wo']} of {cfg.n_layers} and {tcfg.n_layers} layers; wk / wv "
        f"whole {want['wk']}; no partial attention leaf), {e} of "
        f"{cfg.moe.padded_experts} experts a layer")
    return {"attn": "contraction", "experts": e, "blocks": want}


def _cp_serve(ranks: list, ref: dict, n: int, tol: float = CP["tol"],
              tag: str = "cp (b)") -> dict:
    """(b) The placed serving against the one-process run: the prefill's
    logits within CP["tol"] on every rank; the greedy tokens equal up to
    each request's first divergence, which must sit at a near tie
    (one-process top-2 margin under 2 tol); the log-probabilities of the
    one-process tokens within CP["tol"] where the placed run was fed them
    (positions 0 and 1 on their own, and ``generate``'s up to a request's
    first divergence); the near ties counted.  ``tol``: CP["tol"], or
    another phase's."""
    want, margins = ref["tokens"].tolist(), ref["margins"]
    sv = [r["serve"] for r in ranks]
    if any(s["tokens"] != sv[0]["tokens"] for s in sv[1:]):
        fail(f"{tag}: the ranks' greedy tokens differ")
    ties = int((margins < 2 * tol).sum())
    diverged, fed = [], []
    for b, (got, w) in enumerate(zip(sv[0]["tokens"], want)):
        t = next((i for i, (x, y) in enumerate(zip(got, w)) if x != y), len(w))
        if t < len(w):
            if float(margins[b, t]) >= 2 * tol:
                fail(f"{tag}: request {b}'s greedy token {t} is {got[t]}, the one-process {w[t]}, "
                     f"at a top-2 margin of {float(margins[b, t])}")
            diverged.append([b, t])
        fed.append(t)
    lp = ref["logprobs"]
    errs = {"prefill_err": max(s["prefill_err"] for s in sv),
            "logprob_err": max(max(abs(x - float(lp[b, t])) for b, row in enumerate(s["tf_logprobs"])
                                   for t, x in enumerate(row)) for s in sv)}
    gen_errs = [abs(s["logprobs"][b][t] - float(lp[b, t])) for s in sv
                for b in range(len(want)) for t in range(fed[b])]
    errs["logprob_err"] = max([errs["logprob_err"]] + gen_errs)
    if any(e > tol for e in errs.values()):
        fail(f"{tag}: prefill logits / log-probabilities of the one-process tokens off by "
             f"{errs} (tolerance {tol})")
    out = {"cache": sv[0]["cache"], "tol": tol, **errs, "near_ties": ties,
           "diverged": diverged, "generate_s": [s["generate_s"] for s in sv],
           "prefill_ms": [s["prefill_ms"] for s in sv],
           "decode_ms": [s["decode_ms"] for s in sv],
           "peak_bytes": [s["peak_bytes"] for s in sv],
           "build_peak_bytes": [s["build_peak_bytes"] for s in sv],
           "local_params": sv[0]["local_params"]}
    log(f"{tag} placed greedy generate of {len(want)} x {ref['prompts'].shape[1]} prompts + "
        f"{len(want[0])} tokens by {n} ranks, cache {out['cache']}: prefill logits within "
        f"{errs['prefill_err']:.6g}, the one-process tokens' log-probabilities within "
        f"{errs['logprob_err']:.6g} (tolerance {tol}); tokens equal"
        + (f" up to near ties at (request, position) {diverged}" if diverged else "")
        + f"; {ties} of {margins.numel()} positions are near ties (margin < {2 * tol}); a rank "
        f"holds {out['local_params']} params; prefill {_range(out['prefill_ms'])} ms, a decode "
        f"step {_range(out['decode_ms'])} ms, generate "
        f"{_range(out['generate_s'], '{:.2f}')} s; peak {_range(out['peak_bytes'], '{:.0f}')} "
        f"bytes serving, {_range(out['build_peak_bytes'], '{:.0f}')} bytes in its build turn")
    return out


def _cp_train(ranks: list, one: dict) -> dict:
    """(c) The ranks' losses equal across ranks and within CP["loss_tol"] of
    the one-process ``train()``'s."""
    tr = [r["train"] for r in ranks]
    want = one["losses"]
    if any(t["losses"] != tr[0]["losses"] for t in tr[1:]):
        fail(f"cp (c): the ranks' losses differ: {[t['losses'] for t in tr]}")
    err = max(abs(a - b) for a, b in zip(tr[0]["losses"], want))
    if err > CP["loss_tol"]:
        fail(f"cp (c): losses {tr[0]['losses']} against train()'s {want}")
    out = {"losses": tr[0]["losses"], "one_process": want, "loss_max_err": err,
           "step_wall_ms": [t["step_wall_ms"] for t in tr],
           "peak_bytes": [t["peak_bytes"] for t in tr], "local_params": tr[0]["local_params"],
           "params": tr[0]["params"], "collectives": tr[0]["collectives"]}
    walls = [w for t in tr for w in t["step_wall_ms"][1:]]
    log(f"cp (c) {one['arch']} at {one['layers']} layers trained by {len(tr)} ranks: losses "
        + " ".join(f"{x:.6f}" for x in out["losses"]) + f" (train()'s within {err:.3g}); a rank "
        f"holds {out['local_params']} of {out['params']} params; step wall {_range(walls)} ms "
        f"(first {_range([t['step_wall_ms'][0] for t in tr])}); peak "
        f"{_range(out['peak_bytes'], '{:.0f}')} bytes")
    return out


def _cp_records(ranks: list, cfg, tcfg, splan, tplan, ref: dict, full: bool) -> dict:
    """(d) A decode step's and a train step's recorded collectives on every
    rank equal to :func:`cp_collectives`."""
    tf = TRAIN_FULL
    seq, gb = (tf["seq_len"], tf["global_batch"]) if full else (64, 4)
    nreq = ref["prompts"].shape[0]
    want = {"decode": [list(o) for o in cp_collectives(cfg, splan, nreq, 1,
                                                          ranks[0]["serve"]["cache"])],
            "step": [list(o) for o in cp_collectives(tcfg, tplan, gb, seq)]}
    for r in ranks:
        for k, got in (("decode", r["serve"]["decode_ops"]), ("step", r["train"]["ops"])):
            if got != want[k]:
                fail(f"cp (d): rank {r['rank']}'s {k} collectives differ from the closed form: "
                     f"{len(got)} recorded, {len(want[k])} expected")
    out = {k: {"count": len(v), "bytes": sum(o[1] for o in v)} for k, v in want.items()}
    log(f"cp (d) recorded collectives = the closed form on every rank: a decode step "
        f"{out['decode']['count']} ({out['decode']['bytes']} bytes), a train step "
        f"{out['step']['count']} ({out['step']['bytes']} bytes); step 0's "
        f"{ranks[0]['train']['collectives']}")
    return out


# ------------------------------------------------------------------ phase 3l

# The SSD split over "model" (launch/tp_model.py's ssd_block / ssd_decode:
# in_proj split on d_model, out_proj on d_inner, the SSM core on a rank's
# heads) and long_500k's sequence-split cache (launch/serve.py: the KV
# sequence over "data", merged as split-K merges over "model").  Both
# models at full width: mamba2-370m (48 layers, d_model 1,024, 32 SSM
# heads, vocabulary 50,280, ~368 M params) and zamba2-1.2b (38 SSM layers,
# 64 SSM heads, the shared block of 32 heads and d_ff 8,192, vocabulary
# 32,000, ~1.17 B params, ~19 GB of training state).  long_500k at its
# published size: one request, 524,288 positions; zamba2's KV cache, k and
# v of (6, 1, 524,288, 32, 64) bf16, is 25.77 GB whole and 6.44 GB a rank
# on (2, 2).  Positions [0, fill) are drawn chunk by chunk from seeded
# generators, so a rank draws only its own block; the decode steps start
# at fill, and their writes cross from data rank 0's block to rank 1's.
# The gloo ranks' train and serve runs of (b), (c) compute in float32, at
# SSD["pair_layers"] layers (the script's time limit: the pair's gloo
# collectives through host memory took ~130 s at full depth), against a
# float32 ``train()`` and ``serve.generate`` at the same depth, with fixed
# gates: losses within ``loss_tol``, logits and log-probabilities within
# ``tol``.  At bf16 and full depth the pair lay further off (losses 3.8e-2
# and 8.0e-2, prefill logits 0.80 and 1.68) than these gates allow; bf16
# rounding alone moves these random-weight stacks far (zamba2's step-0 loss
# 10.818048 in bf16, 10.827139 in float32; (b) logs how far the one-process
# bf16 serving lies from float32 compute at full depth), but how much of
# the pair's bf16 gap is rounding was not measured.  long_500k keeps its
# published bf16 cache (a float32 one would not fit twice); the one-process
# decode and the ranks compute in float32 on it, fed the same tokens, and
# are held to ``tol`` (logits and written rows, absolute).  With keys and
# values drawn at random, a decode query's softmax over 262,140 positions
# is near uniform and its output near zero, so the logits would barely
# move if the SP merge dropped a data rank's block.  So the merge is also
# held directly, before the decode steps: a seeded unit-normal query over
# all 524,288 positions of layer 0's cache (data rank 0's block holds the
# drawn rows, data rank 1's only zero rows, which carry ~38 % of the
# softmax's weight), each rank's merged output against the one-process
# attention over the whole cache, the largest difference over the largest
# output within ``merge_tol`` (float32 on both sides, only the summation
# order differs; dropping a block moves it by ~0.6 or 1).
SSD = {"archs": ("mamba2-370m", "zamba2-1.2b"), "ranks": 2, "tol": 0.25, "loss_tol": 5e-3,
       "merge_tol": 1e-3,
       "compare_dtype": "float32", "pair_layers": {"mamba2-370m": 16, "zamba2-1.2b": 14},
       "long": {"len": 524_288, "fill": 262_140, "steps": 8, "chunk": 4096, "seed": 7,
                "mesh": {"mamba2-370m": (1, 2), "zamba2-1.2b": (2, 2)}},
       "rehearsal_long": {"len": 64, "fill": 30, "steps": 4, "chunk": 8, "seed": 7,
                          "mesh": {"mamba2-370m": (1, 2), "zamba2-1.2b": (2, 2)}},
       "modelled": tuple((a, s, False) for a in ("mamba2-370m", "zamba2-1.2b")
                         for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"))}


def _ssd_cfg(arch: str, full: bool, **over):
    return get_config(arch, **over) if full else smoke_config(arch, **over)


def _ssd_pair_cfg(arch: str, full: bool):
    """The config the gloo pair runs and its one-process runs are held to:
    float32 compute, at SSD["pair_layers"] layers at full width (zamba2's 14
    keep two groups of six SSM layers, two uses of the shared block and two
    trailing layers)."""
    over = {"n_layers": SSD["pair_layers"][arch]} if full else {}
    return _ssd_cfg(arch, full, dtype=SSD["compare_dtype"], **over)


def _ssd_long(full: bool) -> dict:
    return SSD["long"] if full else SSD["rehearsal_long"]


def phase_ssd(dev: torch.device, full: bool = True, serve_path: dict | None = None,
              train_path: dict | None = None) -> dict:
    """Phase 3l: (a) both models' plans on 16 x 16; (b), (c) each model at
    full width trained 3 steps by ``train()`` and by the placed step on a
    one-rank NCCL group and a (1, 1) mesh (every SSD layer through
    ``tp_model.ssd_block``), losses and every param leaf's sha256 equal, and
    its placed greedy ``generate`` equal to ``serve.generate``; then split
    over "model" by two gloo ranks sharing the card on (1, 2), at float32
    compute against float32 one-process runs: losses within
    SSD["loss_tol"], prefill logits and the one-process tokens'
    log-probabilities within SSD["tol"], greedy tokens equal up to near
    ties, a step's and a decode step's collectives equal to
    :func:`ssd_collectives`; (d) long_500k: the one-process ``decode_step``
    at 524,288 positions in bf16, then fed its tokens at float32 compute,
    then zamba2 by four gloo ranks on (2, 2) (the KV sequence over "data")
    and mamba2 by two on (1, 2) at float32 compute, logits, written rows
    and tokens against the float32 run; (e) mamba2's long_500k SSM-state stream as one
    link under 3f's four points (one ``bt_axes`` launch); (f) the dry run's
    eight mamba2 / zamba2 cells on 16 x 16.  Returns rows and launches."""
    import torch.distributed as dist

    t_phase = time.perf_counter()
    lc = _PathLaunches()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rows: dict = {"ssd/plan": _ssd_plans()}

    def mark(what: str) -> None:
        log(f"ssd: {what} done at {time.perf_counter() - t_phase:.1f} s")

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1)
    refs = {}
    try:
        mesh = launch.make_smoke_mesh(device=dev.type)
        for arch in SSD["archs"]:
            cfg = _ssd_cfg(arch, full)
            # train() runs the (1, 1) step's op sequence (bitwise), so only
            # the placed step is timed
            one = train_one_process(dev, lc, cfg, full, "ssd (b)", timed=False)
            rows[f"ssd/{arch}/train"] = _ssd_step(dev, lc, mesh, cfg, full, one)
            rows[f"ssd/{arch}/generate"] = _ssd_generate(dev, lc, mesh, cfg, full)
            mark(f"{arch} on (1, 1)")
    finally:
        dist.destroy_process_group()
    for arch in SSD["archs"]:  # the float32 runs the gloo ranks are held to
        cfg = _ssd_pair_cfg(arch, full)
        one = train_one_process(dev, lc, cfg, full, f"ssd (b) {SSD['compare_dtype']}",
                                timed=False, digests=False)
        ref, params, _ = serve_reference(dev, lc, cfg, "ssd", full, timed=False)
        del params
        refs[arch] = {"train": one, "serve": ref}
        np.savez(build / f"ssd_serve_{arch}.npz", **{k: v.numpy() for k, v in ref.items()})
        mark(f"{arch}'s float32 runs")
    long = {arch: _ssd_long_reference(dev, lc, arch, full) for arch in SSD["archs"]}
    mark("the long_500k one-process runs")
    rows["ssd/state_stream"] = _ssd_state_stream(lc, long["mamba2-370m"].pop("session"),
                                                 serve_path or {}, train_path or {})
    torch.cuda.empty_cache()
    log(f"ssd: before the ranks start, {_card_memory(dev)}")
    def dry_run():
        rows["ssd/dryrun"] = _dryrun_cells("ssd (f)", SSD["modelled"], ())

    pair, seconds = _spawn_ranks("ssd (b)", SSD["ranks"], "ssd_rank",
                                 [int(full), dev.type, "pair"], dry_run)
    rows["ssd/pair_seconds"] = seconds
    mark("the pair of ranks")
    for arch in SSD["archs"]:
        rows[f"ssd/{arch}/two_ranks"] = _ssd_two_ranks(pair, arch, refs[arch], full)
    dn, mn = _ssd_long(full)["mesh"]["zamba2-1.2b"]
    quad, seconds = _spawn_ranks("ssd (d)", dn * mn, "ssd_rank", [int(full), dev.type, "long"])
    rows["ssd/quad_seconds"] = seconds
    mark("the four ranks")
    for arch, ranks in (("mamba2-370m", pair), ("zamba2-1.2b", quad)):
        rows[f"ssd/{arch}/long"] = _ssd_long_check(ranks, arch, long[arch], full)
    seconds = time.perf_counter() - t_phase
    log(f"ssd-path launches: {lc.total}; phase 3l {seconds:.1f} s ({backend}, world 1; gloo, "
        f"worlds {SSD['ranks']} and {dn * mn})")
    return {"rows": rows, "launches": lc.total, "max_abs_err": 0, "seconds": seconds}


def _ssd_plans() -> dict:
    """(a) Both full configs' plans on the baseline 16 x 16 mesh: the SSM
    heads split ("heads", 2 and 4 a rank), the conv tail's channel blocks,
    the partial leaves; zamba2's shared block on its heads and d_ff."""
    from repro_torch.launch import tp_model
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.ssd import ssm_dims

    mesh = AbstractMesh((16, 16), ("data", "model"))
    out = {}
    for arch in SSD["archs"]:
        cfg = get_config(arch)
        d_inner, heads, hd, g, n = ssm_dims(cfg)
        for mode in ("train", "serve"):
            pl = tp_model.make_plan(cfg, mesh, mode)
            want = (pl.ssd, pl.ssd_heads, pl.conv) == ("heads", (0, heads // 16), True) and (
                {p.rsplit("['", 1)[-1].rstrip("']") for p in pl.partial}
                == {"conv_w", "conv_b", "a_log", "dt_bias", "d_skip", "norm_w"})
            if cfg.family == "hybrid":
                want = want and (pl.attn, pl.kv, pl.mlp) == ("heads", "heads", True)
            if not want:
                fail(f"ssd (a): the {mode} plan of {arch} on 16 x 16 is {pl}")
        out[arch] = {"heads": heads // 16, "d_inner_block": d_inner // 16,
                     "conv_block": (d_inner + 2 * g * n) // 16, "partial": sorted(pl.partial),
                     "attn": pl.attn if cfg.family == "hybrid" else None}
        log(f"ssd (a) {arch} on 16 x 16: SSD split on heads, {heads // 16} of {heads} heads a "
            f"rank (out_proj rows {d_inner // 16} = {heads // 16} x {hd}), the conv tail's "
            f"{out[arch]['conv_block']} of {d_inner + 2 * g * n} channels a rank, "
            f"{len(pl.partial)} partial leaves"
            + (f"; the shared block's {cfg.n_heads // 16} heads and "
               f"{cfg.d_ff // 16} of d_ff {cfg.d_ff} a rank" if cfg.family == "hybrid" else ""))
    return out


def _ssd_step(dev, lc, mesh, cfg, full: bool, one: dict) -> dict:
    """(b), (c): three placed steps on the (1, 1) mesh, held to
    ``train()``'s losses and leaf digests; every SSD layer runs through
    ``tp_model.ssd_block``, and a one-rank group issues no collective."""
    from repro_torch.launch import tp_model
    from repro_torch.roofline import record_collectives

    tf = TRAIN_FULL
    seq, gb = (tf["seq_len"], tf["global_batch"]) if full else (64, 4)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=gb, seed=tf["seed"])
    ocfg = optim.AdamWConfig(warmup_steps=1, total_steps=10)
    plan = tp_model.make_plan(cfg, mesh)
    if plan.ssd != "heads" or plan.split:
        fail(f"ssd (b): the plan of {cfg.name} on (1, 1) is {plan}")
    calls = [0]
    ssd_block = tp_model.ssd_block

    def counted(*a, **k):
        calls[0] += 1
        return ssd_block(*a, **k)

    tp_model.ssd_block = counted
    try:
        with record_collectives() as ops:
            row, p, o, step, batch0 = _placed_run(dev, lc, mesh, cfg, dcfg, ocfg, one,
                                                  "ssd (b)", full)
    finally:
        tp_model.ssd_block = ssd_block
    if calls[0] != cfg.n_layers * tf["steps"] or ops:
        fail(f"ssd (b): {calls[0]} SSD layers through tp_model.ssd_block (want "
             f"{cfg.n_layers * tf['steps']}), collectives {ops} on a one-rank group")

    def one_step():
        return step(p, o, batch0)

    row["step_ms"] = time_ms(one_step, reps=2, warmup=1)
    row["step_device_ms"], row["step_device_split"] = _device_total_ms(one_step, reps=2)
    row["ssd_layers"] = calls[0]
    row["one_process"] = {k: v for k, v in one.items() if k != "sha256"}
    log(f"ssd (b) {cfg.name} placed step through the SSD plan on (1, 1): losses "
        + " ".join(f"{x:.6f}" for x in row["losses"])
        + (" = train()'s, every param leaf's sha256 equal" if row["equal_to_3g"] else "")
        + f"; {calls[0]} SSD layers through tp_model.ssd_block, no collective; step "
        f"{row['step_ms']:.1f} ms wall (CUDA events), {row['step_device_ms']} ms device, peak "
        f"{row['peak_bytes']} bytes (train(): peak {one['peak_bytes']} bytes)")
    del p, o, step, one_step, batch0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return row


def _ssd_generate(dev, lc, mesh, cfg, full: bool) -> dict:
    """(b), (c): the placed greedy ``generate`` on the (1, 1) mesh against
    ``serve.generate`` (phase 3f's shapes): tokens and log-probabilities
    equal; prefill and decode times of the placed run (``serve.generate``
    runs the same op sequence on one rank); how far ``serve.generate``'s
    prefill logits and log-probabilities lie from the same at float32
    compute (the bf16 noise floor of the one-process run)."""
    from repro_torch.launch import serve as placed
    from repro_torch.launch import tp_model

    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    ref, params, _ = serve_reference(dev, lc, cfg, "ssd", full, timed=False, floor=True)
    prompts, want = ref["prompts"].to(dev), ref["tokens"].to(dev)
    nreq, plen = prompts.shape
    new = want.shape[1]
    local = placed.shard_params(cfg, mesh, params)
    plan = tp_model.make_plan(cfg, mesh, "serve")
    mode = placed.kv_mode(cfg, mesh, nreq, plen + new)
    res = lc.run("ssd placed generate", lambda: placed.generate(local, cfg, mesh, prompts, new),
                 {})
    if not torch.equal(res.tokens, want):
        fail(f"ssd (b): {cfg.name}'s placed generate's tokens differ from serve.generate's")
    if not torch.equal(res.logprobs.cpu(), ref["logprobs"]):
        fail(f"ssd (b): {cfg.name}'s placed log-probabilities differ from serve.generate's")
    tok = want[:, :1].to(torch.int32)
    with torch.no_grad():
        logits, cache = placed.prefill(local, plan, prompts, plen + new, mode)
        pl = _serve_times(lambda: placed.prefill(local, plan, prompts, plen + new, mode),
                          lambda: placed.decode_step(local, plan, cache, tok, mode))
    out = {"arch": cfg.name, "requests": nreq, "prompt": plen, "new_tokens": new, "cache": mode,
           "tokens_equal": True, "logprobs_equal": True, "placed": pl,
           "bf16_floor": float(ref["floor"]),
           "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None}
    del params, local, logits, cache, res
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"ssd (b) {cfg.name} placed greedy generate of {nreq} x {plen} prompts + {new} tokens "
        f"on (1, 1): tokens and log-probabilities equal to serve.generate's; prefill "
        f"{pl['prefill_ms']:.2f} ms ({pl['prefill_device_ms']} ms device), decode "
        f"{pl['decode_ms_per_token']:.3f} ms/token ({pl['decode_device_ms']} ms device); peak "
        f"{out['peak_bytes']} bytes; serve.generate's prefill logits and log-probabilities lie "
        f"{out['bf16_floor']:.4g} from the same at float32 compute")
    return out


def long_cache(cfg, dev, L: dict, mesh=None) -> dict:
    """The long_500k decode cache of ``cfg`` (one request, ``L["len"]``
    positions) holding positions [0, ``L["fill"]``): the whole cache, or
    with ``mesh`` this rank's blocks by ``cache_shardings``.  The keys and
    values are drawn chunk by chunk of ``L["chunk"]`` positions, chunk i
    from a generator seeded ``L["seed"]`` + i (every kv head; the rank
    keeps its own), so a rank draws only the chunks of its block; the SSM
    states and conv tails are drawn whole (they are small) and cut."""
    from repro_torch.launch.sharding import cache_shardings
    from repro_torch.launch.step import _region

    shapes = init_cache(cfg, 1, L["len"], device="meta")
    sh = cache_shardings(cfg, mesh, shapes) if mesh is not None else None
    out: dict = {"pos": torch.tensor(L["fill"], dtype=torch.int32, device=dev)}
    for j, (path, meta) in enumerate(tree_leaves_with_path(
            {k: v for k, v in shapes.items() if k != "pos"})):
        spec = dict(tree_leaves_with_path({k: v for k, v in sh.items() if k != "pos"}))[path] \
            if sh is not None else None
        region = (_region(meta.shape, spec.placements(), mesh) if spec is not None
                  else tuple(slice(0, n) for n in meta.shape))
        if path in ("['k']", "['v']"):
            continue
        gen = torch.Generator(device=dev).manual_seed(L["seed"] * 1000 + j)
        t = torch.randn(meta.shape, generator=gen, device=dev, dtype=torch.float32)
        _set(out, path, t[region].to(meta.dtype).contiguous())
        del t
    if "k" in shapes:
        meta = shapes["k"]
        kv_sh = sh["k"] if sh is not None else None
        region = (_region(meta.shape, kv_sh.placements(), mesh) if kv_sh is not None
                  else tuple(slice(0, n) for n in meta.shape))
        a, b = region[2].start, region[2].stop
        k = torch.zeros(tuple(r.stop - r.start for r in region), dtype=meta.dtype, device=dev)
        v = torch.zeros_like(k)
        c = L["chunk"]
        for i in range(a // c, -(-min(b, L["fill"]) // c)):
            gen = torch.Generator(device=dev).manual_seed(L["seed"] + i)
            kv = torch.randn((2, *meta.shape[:2], c, *meta.shape[3:]), generator=gen,
                             device=dev, dtype=torch.float32)
            kv[:, :, :, max(0, L["fill"] - i * c):] = 0
            kv = kv[:, region[0], region[1], :, region[3], region[4]].to(meta.dtype)
            k[:, :, i * c - a: (i + 1) * c - a] = kv[0]
            v[:, :, i * c - a: (i + 1) * c - a] = kv[1]
            del kv
        out["k"], out["v"] = k, v
    return out


def _set(tree: dict, path: str, t: torch.Tensor) -> None:
    """``tree`` at keystr ``path`` (created on the way) set to ``t``."""
    keys = [k.strip("'") for k in path[1:-1].split("][")]
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = t


def _long_tokens(cfg, dev, L: dict) -> torch.Tensor:
    """The first token of the long_500k decode, from its seed."""
    gen = torch.Generator(device=dev).manual_seed(L["seed"])
    return torch.randint(0, cfg.vocab, (1, 1), generator=gen, device=dev).to(torch.int32)


def _long_weights(cfg, dev):
    """The serving weights of the long_500k decode (SERVE_FULL's seed)."""
    return init_params(cfg, torch.Generator(device=dev).manual_seed(SERVE_FULL["seed"]), dev)


def _merge_probe(cfg, dev, L: dict) -> tuple:
    """The seeded float32 unit-normal query (1, 1, heads, head_dim) that
    holds the SP merge at long_500k's size, and its position: the cache's
    last, so every position is attended."""
    gen = torch.Generator(device=dev).manual_seed(L["seed"] + 1)
    q = torch.randn((1, 1, cfg.n_heads, cfg.resolved_head_dim), generator=gen, device=dev)
    return q, torch.tensor(L["len"] - 1, device=dev)


@torch.no_grad()
def _long_decode(dev, lc, cfg, ccfg, L: dict, params, tokens=None, probe: bool = False) -> dict:
    """L["steps"] one-process ``decode_step`` s of ``cfg`` from position
    L["fill"] of a fresh ``long_cache`` of ``ccfg`` (its dtype), greedy or
    fed ``tokens``: tokens, logits (float32, host), top-2 margins, the keys
    and values written at each position (host), step times, the cache's
    bytes, peak; for the ssm family the capture session of the SSM-state
    stream after the first step; with ``probe`` and a KV cache, the
    attention output of :func:`_merge_probe` over layer 0 of the cache as
    drawn.  The cache is freed."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.perf_counter()
    cache = long_cache(ccfg, dev, L)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out: dict = {"fill_s": time.perf_counter() - t1, "tokens": [], "logits": [], "margins": [],
                 "rows_k": [], "rows_v": [], "step_ms": [], "session": None}
    out["kv_bytes"] = sum(cache[k].numel() * cache[k].element_size() for k in ("k", "v")
                          if k in cache)
    out["ssm_bytes"] = sum(t.numel() * t.element_size() for key in ("ssm", "ssm_trailing")
                           if key in cache for t in tree_leaves(cache[key]))
    if probe and "k" in cache:
        q, at = _merge_probe(cfg, dev, L)
        out["probe"] = decode_attend(q, cache["k"][0], cache["v"][0], at).cpu()
    tok = _long_tokens(cfg, dev, L)
    for s in range(L["steps"]):
        if tokens is not None:
            tok = torch.tensor([[int(tokens[s])]], dtype=torch.int32, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, cache = lc.run(f"ssd (d) {cfg.name} decode_step {s}",
                               lambda: decode_step(params, cfg, cache, tok), {})
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t1) * 1e3)
        lf = logits[:, -1].to(torch.float32)
        top2 = torch.topk(lf, 2, dim=-1).values
        out["tokens"].append(tok[0, 0].item())
        out["logits"].append(lf.cpu())
        out["margins"].append(float(top2[0, 0] - top2[0, 1]))
        if "k" in cache:
            at = L["fill"] + s
            out["rows_k"].append(cache["k"][:, :, at].to(torch.float32).cpu())
            out["rows_v"].append(cache["v"][:, :, at].to(torch.float32).cpu())
        if s == 0 and cfg.family == "ssm" and tokens is None:
            with obs.capture() as out["session"]:
                _obs_hooks.tap("serve.kv", cache=cache, step=0)
        tok = torch.argmax(lf, dim=-1)[:, None].to(torch.int32)
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    del cache, logits
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _ssd_long_reference(dev, lc, arch: str, full: bool) -> dict:
    """(d) The one-process ``decode_step`` of ``arch`` at long_500k's size,
    greedy in bf16, L["steps"] steps from position L["fill"]; then the same
    steps fed its tokens at float32 compute on a fresh bf16 cache of the
    same draws, the run the ranks are held to: its logits, written rows,
    greedy tokens and top-2 margins saved to ``build/ssd_long_<arch>.npz``,
    and how far the bf16 run lies from it.  For the ssm family, the capture
    session of the SSM-state stream after the bf16 run's first step (phase
    (e)).  Each whole cache and its new copy are freed before the next."""
    cfg = _ssd_cfg(arch, full)
    L = _ssd_long(full)
    params = _long_weights(cfg, dev)
    one = _long_decode(dev, lc, cfg, cfg, L, params)
    f32 = _long_decode(dev, lc, _ssd_cfg(arch, full, dtype="float32"), cfg, L, params,
                       tokens=one["tokens"], probe=True)
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    logits = torch.cat(f32["logits"])
    ref = {"tokens": np.array(one["tokens"]), "logits": logits.numpy(),
           "greedy": torch.argmax(logits, dim=-1).numpy(), "margins": np.array(f32["margins"])}
    bf16_gap = {"logits": float((torch.cat(one["logits"]) - logits).abs().max())}
    if one["rows_k"]:
        ref.update(rows_k=torch.stack(f32["rows_k"]).numpy(),
                   rows_v=torch.stack(f32["rows_v"]).numpy(), probe=f32["probe"].numpy())
        bf16_gap["rows"] = max(float((torch.stack(one[k]) - torch.stack(f32[k])).abs().max())
                               for k in ("rows_k", "rows_v"))
    np.savez(ROOT / "build" / f"ssd_long_{arch}.npz", **ref)
    row = {"arch": arch, "len": L["len"], "fill": L["fill"], "steps": L["steps"],
           "kv_bytes": one["kv_bytes"], "ssm_bytes": one["ssm_bytes"], "fill_s": one["fill_s"],
           "step_ms": one["step_ms"], "f32_step_ms": f32["step_ms"],
           "peak_bytes": one["peak_bytes"], "f32_peak_bytes": f32["peak_bytes"],
           "tokens": one["tokens"], "margins": f32["margins"], "bf16_gap": bf16_gap, "ref": ref,
           "session": one["session"]}
    log(f"ssd (d) {arch} one-process decode_step at {L['len']} positions from {L['fill']}: "
        f"cache {one['kv_bytes']} KV bytes + {one['ssm_bytes']} SSM bytes (filled in "
        f"{one['fill_s']:.1f} s), {L['steps']} bf16 steps of "
        + " ".join(f"{x:.1f}" for x in one["step_ms"])
        + f" ms, tokens {one['tokens']}, peak {one['peak_bytes']} bytes; fed them at float32 "
        f"compute, steps " + " ".join(f"{x:.1f}" for x in f32["step_ms"])
        + f" ms, peak {f32['peak_bytes']} bytes, greedy {ref['greedy'].tolist()}; the bf16 "
        f"run's logits lie {bf16_gap['logits']:.4g} from it"
        + (f", its written rows {bf16_gap['rows']:.4g}" if "rows" in bf16_gap else ""))
    return row


def _ssd_state_stream(lc, sess, serve_path: dict, train_path: dict) -> dict:
    """(e) mamba2's long_500k SSM-state stream (``serve.kv``'s capture of the
    cache's ``ssm`` leaves after a decode step) as one link under 3f's four
    points (one ``bt_axes`` launch), equal to the plain version; its ACC /
    APP reductions beside 3f's weights' and 3g's gradient's."""
    (st,) = sess.get("serve_decode", "kv")
    wl = sess.workload("serve_decode", elems=SERVE["elems"], lanes=SERVE["lanes"], names=["kv"])
    t1 = time.perf_counter()
    ev = lc.run("ssd state grid", lambda: dse.evaluate_grid(SERVE_POINTS, wl),
                {"bt_axes": 1} if st.data.is_cuda else {})
    ms = (time.perf_counter() - t1) * 1e3
    plain = dse.evaluate_grid(SERVE_POINTS, wl, backend="torch", chunk_packets=1 << 20)
    if [dataclasses.asdict(e) for e in ev] != [dataclasses.asdict(e) for e in plain]:
        fail("ssd (e): the state-stream grid differs from the plain version's")
    red = {e.label: 100 * e.bt_reduction for e in ev}
    out = {"bytes": st.num_bytes, "packets": wl.streams[0].shape[0], "measure_ms": ms,
           "bt": {e.label: [e.total_bt, e.aux_bt] for e in ev}, "red_pct": red}
    w = serve_path.get("rows", {}).get("serve/full", {}).get("measure", {}).get(
        "weights_split", {}).get("red_pct", {})
    gr = train_path.get("rows", {}).get("train/full", {}).get("measure", {}).get("red_pct", {})
    log(f"ssd (e) mamba2-370m long_500k SSM-state stream ({st.num_bytes} int8 bytes, "
        f"{out['packets']} packets of {SERVE['elems']}) as one link, grid = plain, {ms:.1f} ms; "
        "reductions " + " ".join(f"{k}={v:.4f}%" for k, v in red.items())
        + "; beside 3f's weights " + " ".join(f"{k}={v:.4f}%" for k, v in w.items())
        + " and 3g's gradient " + " ".join(f"{k}={v:.4f}%" for k, v in gr.items()))
    return out


def ssd_rank(rank: int, world: int, port: int, out: str, full: str, device: str,
             job: str) -> None:
    """Phase 3l, one rank of a ``world``-rank gloo group on ``device``
    ("cuda": card 0; "cpu" for a rehearsal).  ``job`` "pair": on a (1, 2)
    mesh, each model trained 3 steps and served against its one-process
    run (``build/ssd_serve_<arch>.npz``), then mamba2's long_500k decode;
    "long": zamba2's long_500k decode on the (data, model) mesh of
    SSD["long"].  Writes the results to ``out``."""
    import torch.distributed as dist

    from repro_torch.launch import tp_model
    from repro_torch.launch.mesh import _device_mesh

    full = full == "1"
    dev = _rank_device(device, "ssd", rank)
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    res: dict = {"rank": rank, "device": str(dev)}
    try:
        if job == "pair":
            mesh = launch.make_smoke_mesh(device=dev.type)
            for arch in SSD["archs"]:
                cfg = _ssd_pair_cfg(arch, full)
                plan = tp_model.make_plan(cfg, mesh, "serve")
                res[arch] = {"train": _rank_train(dev, mesh, cfg, full),
                             "serve": _cp_rank_serve(dev, mesh, cfg, plan,
                                                     ROOT / "build" / f"ssd_serve_{arch}.npz"),
                             "plan": {"ssd": plan.ssd, "heads": list(plan.ssd_heads),
                                      "conv": plan.conv}}
            res["mamba2-370m"]["long"] = _rank_long(dev, mesh, "mamba2-370m", full)
        else:
            shape = _ssd_long(full)["mesh"]["zamba2-1.2b"]
            mesh = _device_mesh(shape, ("data", "model"), dev.type)
            res["zamba2-1.2b"] = {"long": _rank_long(dev, mesh, "zamba2-1.2b", full)}
    finally:
        dist.destroy_process_group()
    Path(out).write_text(json.dumps(res))


@torch.no_grad()
def _rank_long(dev, mesh, arch: str, full: bool) -> dict:
    """One rank's long_500k decode: its weight blocks and bf16 cache blocks
    built in turn, then L["steps"] placed decode steps at float32 compute
    fed the one-process tokens; the whole logits (every vocabulary block)
    of each step against the one-process float32 run's, the rows it writes
    against its, its greedy tokens, the first step's collectives, times and
    peak."""
    import torch.distributed as dist

    from repro_torch.launch import serve as placed
    from repro_torch.launch import tp_model
    from repro_torch.launch.tp import gather_from_model
    from repro_torch.roofline import record_collectives

    cfg, cfg32 = _ssd_cfg(arch, full), _ssd_cfg(arch, full, dtype="float32")
    L = _ssd_long(full)
    ref = dict(np.load(ROOT / "build" / f"ssd_long_{arch}.npz"))
    plan = tp_model.make_plan(cfg32, mesh, "serve")
    mode, sp = placed.kv_mode(cfg, mesh, 1, L["len"]), placed.sp_group(cfg, mesh, 1, L["len"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.perf_counter()
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            host = tree_map(lambda t: t.cpu(), placed.shard_params(cfg, mesh,
                                                                   _long_weights(cfg, dev)))
            local = _to_card(host, dev)
            del host
            cache = long_cache(cfg, dev, L, mesh)
            _rank_log(f"built its {arch} long_500k blocks: {_card_memory(dev)}")
        dist.barrier()
    build_s = time.perf_counter() - t1
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    out: dict = {"mode": mode, "sp": sp.size, "cache_shapes": {
        k: list(v.shape) for k, v in tree_leaves_with_path({k: v for k, v in cache.items()
                                                             if k != "pos"})},
                 "build_s": build_s, "step_ms": [], "logit_err": [], "tokens": [],
                 "row_err": [], "rows_written": 0}
    kv_blocks = None
    if "k" in cache:
        kv_blocks = (sp.index * cache["k"].shape[2], (sp.index + 1) * cache["k"].shape[2])
        hk = cache["k"].shape[3]
        h0 = plan.model.index * hk if mode == "heads" else 0
    if kv_blocks is not None and sp.size > 1:  # the SP merge itself, on the cache as drawn
        r = cfg.n_heads // cfg.n_kv_heads
        q, at = _merge_probe(cfg32, dev, L)
        got = placed._attend_split(q[:, :, h0 * r: (h0 + hk) * r], cache["k"][0], cache["v"][0],
                                   at, kv_blocks[0], sp).cpu()
        want = torch.from_numpy(ref["probe"])[:, :, h0 * r: (h0 + hk) * r]
        out["merge_err"] = float((got - want).abs().max() / want.abs().max())
    for s in range(L["steps"]):
        tok = torch.tensor([[int(ref["tokens"][s])]], dtype=torch.int32, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        with record_collectives() as ops:
            logits, cache = placed.decode_step(local, plan, cache, tok, mode, sp)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t1) * 1e3)
        if s == 0:
            out["ops"] = _ops_list(ops)
        lf = logits[:, -1].to(torch.float32)
        if plan.head == "vocab":
            lf = gather_from_model(lf, plan.model, -1)
        out["logit_err"].append(float((lf.cpu() - torch.from_numpy(ref["logits"][s: s + 1]))
                                      .abs().max()))
        out["tokens"].append(int(torch.argmax(lf, dim=-1)[0]))
        at = L["fill"] + s
        if kv_blocks is not None and kv_blocks[0] <= at < kv_blocks[1]:
            for key in ("k", "v"):
                got = cache[key][:, :, at - kv_blocks[0]].to(torch.float32).cpu()
                want = torch.from_numpy(ref[f"rows_{key}"][s])[:, :, h0: h0 + hk]
                out["row_err"].append(float((got - want).abs().max()))
            out["rows_written"] += 1
        _rank_log(f"{arch} long_500k step {s}: {out['step_ms'][-1]:.0f} ms, logits within "
                  f"{out['logit_err'][-1]:.4g}")
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    del local, cache, logits
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _ssd_two_ranks(ranks: list, arch: str, ref: dict, full: bool) -> dict:
    """(b), (c), the gloo half: two ranks on (1, 2) against the one-process
    runs: losses, the placed serving (as 3k's ``_cp_serve``), and a train
    step's and a decode step's collectives equal to the closed form."""
    from repro_torch.launch import tp_model
    from repro_torch.launch.mesh import AbstractMesh

    cfg = _ssd_pair_cfg(arch, full)
    mesh = AbstractMesh((1, SSD["ranks"]), ("data", "model"))
    tf = TRAIN_FULL
    seq, gb = (tf["seq_len"], tf["global_batch"]) if full else (64, 4)
    tr = [r[arch]["train"] for r in ranks]
    want = ref["train"]["losses"]
    if any(t["losses"] != tr[0]["losses"] for t in tr[1:]):
        fail(f"ssd (b) {arch}: the ranks' losses differ: {[t['losses'] for t in tr]}")
    loss_err = max(abs(a - b) for a, b in zip(tr[0]["losses"], want))
    if loss_err > SSD["loss_tol"]:
        fail(f"ssd (b) {arch}: losses {tr[0]['losses']} against train()'s {want} (tolerance "
             f"{SSD['loss_tol']})")
    plan = tp_model.make_plan(cfg, mesh, "serve")
    nreq = ref["serve"]["prompts"].shape[0]
    mode = ranks[0][arch]["serve"]["cache"]
    closed = {"decode": [list(o) for o in ssd_collectives(cfg, plan, nreq, 1, mode)],
              "step": [list(o) for o in ssd_collectives(cfg, tp_model.make_plan(cfg, mesh),
                                                        gb, seq)]}
    for r in ranks:
        for k, got in (("decode", r[arch]["serve"]["decode_ops"]),
                       ("step", r[arch]["train"]["ops"])):
            if got != closed[k]:
                fail(f"ssd (b) {arch}: rank {r['rank']}'s {k} collectives differ from the closed "
                     f"form: {len(got)} recorded, {len(closed[k])} expected")
    serving = _cp_serve([r[arch] for r in ranks], ref["serve"], SSD["ranks"], SSD["tol"],
                        f"ssd (b) {arch}")
    walls = [w for t in tr for w in t["step_wall_ms"][1:]]
    out = {"losses": tr[0]["losses"], "one_process": want, "loss_max_err": loss_err,
           "loss_tol": SSD["loss_tol"],
           "step_wall_ms": [t["step_wall_ms"] for t in tr],
           "peak_bytes": [t["peak_bytes"] for t in tr], "local_params": tr[0]["local_params"],
           "params": tr[0]["params"], "serve": serving,
           "collectives": {k: {"count": len(v), "bytes": sum(o[1] for o in v)}
                           for k, v in closed.items()}}
    log(f"ssd (b) {arch} at {cfg.n_layers} layers, float32, split over 'model' by "
        f"{SSD['ranks']} gloo ranks: losses "
        + " ".join(f"{x:.6f}" for x in out["losses"]) + f" (train()'s within {loss_err:.3g}, "
        f"tolerance {SSD['loss_tol']}); "
        f"a rank holds {out['local_params']} of {out['params']} params; step wall "
        f"{_range(walls)} ms; peak {_range(out['peak_bytes'], '{:.0f}')} bytes; collectives = "
        f"the closed form: a train step {out['collectives']['step']}, a decode step "
        f"{out['collectives']['decode']}")
    return out


def _ssd_long_check(ranks: list, arch: str, one: dict, full: bool) -> dict:
    """(d) The ranks' long_500k decode against the one-process run, both at
    float32 compute: every step's logits within SSD["tol"], the written
    rows within it, the greedy tokens equal up to near ties (a top-2 margin
    under 2 SSD["tol"]), the first step's collectives equal to the closed
    form; the writes must have crossed the data ranks' blocks."""
    from repro_torch.launch import tp_model
    from repro_torch.launch.mesh import AbstractMesh

    cfg = _ssd_cfg(arch, full, dtype="float32")
    L = _ssd_long(full)
    shape = L["mesh"][arch]
    lg = [r[arch]["long"] for r in ranks]
    tol = SSD["tol"]
    errs = [max(x["logit_err"]) for x in lg]
    rows = [max(x["row_err"]) if x["row_err"] else 0.0 for x in lg]
    if max(errs) > tol or max(rows) > tol:
        fail(f"ssd (d) {arch}: logits within {errs}, written rows within {rows} (tolerance "
             f"{tol})")
    merge = [x["merge_err"] for x in lg if "merge_err" in x]
    if lg[0]["sp"] > 1 and (len(merge) != len(lg) or max(merge) > SSD["merge_tol"]):
        fail(f"ssd (d) {arch}: the SP merge of the probe query lies {merge} of the largest "
             f"output from the one-process attention (tolerance {SSD['merge_tol']})")
    ties = []
    for x in lg:
        for s, (got, w) in enumerate(zip(x["tokens"], one["ref"]["greedy"].tolist())):
            if got != w:
                if one["margins"][s] >= 2 * tol:
                    fail(f"ssd (d) {arch}: step {s}'s greedy token {got}, the one-process {w}, "
                         f"at a top-2 margin of {one['margins'][s]}")
                ties.append(s)
    mesh = AbstractMesh(shape, ("data", "model"))
    mode = lg[0]["mode"]
    closed = [list(o) for o in ssd_collectives(cfg, tp_model.make_plan(cfg, mesh, "serve"), 1, 1,
                                               mode, sp=lg[0]["sp"])]
    for r, x in zip(ranks, lg):
        if x["ops"] != closed:
            fail(f"ssd (d) {arch}: rank {r['rank']}'s decode collectives differ from the closed "
                 f"form: {len(x['ops'])} recorded, {len(closed)} expected")
    written = [x["rows_written"] for x in lg]
    if "k" in init_cache(cfg, 1, 1, device="meta") and (
            not all(written) or sum(written) != L["steps"] * shape[1]):
        fail(f"ssd (d) {arch}: the ranks wrote {written} rows; the writes must cross the data "
             f"ranks' blocks")
    out = {"mesh": list(shape), "mode": mode, "sp": lg[0]["sp"], "tol": tol,
           "logit_err": max(errs), "row_err": max(rows),
           "merge_err": max(merge) if merge else None, "near_ties": sorted(set(ties)),
           "rows_written": written, "step_ms": [x["step_ms"] for x in lg],
           "build_s": [x["build_s"] for x in lg], "peak_bytes": [x["peak_bytes"] for x in lg],
           "cache_shapes": lg[0]["cache_shapes"],
           "collectives": {"count": len(closed), "bytes": sum(o[1] for o in closed)},
           "one_process": {k: v for k, v in one.items() if k not in ("ref", "session")}}
    steps = [s for x in lg for s in x["step_ms"][1:]]
    log(f"ssd (d) {arch} long_500k on {tuple(shape)} ({len(ranks)} gloo ranks, KV {mode}"
        + (f", its sequence over {lg[0]['sp']} data ranks" if lg[0]["sp"] > 1 else "")
        + f"): {L['steps']} steps from {L['fill']} at float32 compute, logits within "
        f"{max(errs):.4g}, written rows within {max(rows):.4g} of the one-process float32 run's "
        f"(tolerance {tol}), rows written per rank {written}"
        + (f", the SP merge of the probe query within {max(merge):.4g} of its largest output "
           f"(tolerance {SSD['merge_tol']})" if merge else "") + "; tokens "
        f"equal" + (f" up to near ties at steps {sorted(set(ties))}" if ties else "")
        + f"; a step {_range(steps)} ms (first {_range([x['step_ms'][0] for x in lg])}); "
        f"builds {_range(out['build_s'])} s; peak {_range(out['peak_bytes'], '{:.0f}')} bytes "
        f"a rank; a step's collectives = the closed form ({len(closed)})")
    return out


# ------------------------------------------------------------------ phase 3m

# GSPMD's "model" axis for the audio family (launch/tp_model.py's encode /
# cross_kv / cross_block / dec_layer): whisper-medium's bidirectional
# encoder, its decoder's self-attention and its cross-attention split on
# heads, every MLP on d_ff, embed and head on d (16 heads a layer; the
# vocabulary of 51,865 divides no "model" axis).  At full width and depth
# (24 + 24 layers, d_model 1,024, 0.81 B params, ~13 GB with float32 AdamW
# state) it trains whole on the card, so (b) runs it uncut.  The gloo
# pair (c) runs AUDIO["pair_layers"] encoder and decoder layers at float32
# compute and a batch of AUDIO["pair_batch"] (the time limit).  Each
# request carries ENC_FRAMES stub frame embeddings (the conv frontend is a
# stub, as in the reference), drawn on the card from AUDIO["frames_seed"].
# ``dryrun`` pins one device's collectives of whisper-medium's three cells
# on 16 x 16 as the CPU's meta run records them (count and result bytes
# per kind).
AUDIO = {"arch": "whisper-medium", "frames_seed": 11, "ranks": 2, "pair_layers": 8,
         "pair_batch": 2, "compare_dtype": "float32", "tol": 0.25, "loss_tol": 5e-3,
         "cross_tol": 1e-3, "rehearsal_frames": 48,
         "modelled": tuple(("whisper-medium", s, False)
                           for s in ("train_4k", "prefill_32k", "decode_32k")),
         "dryrun": {"train_4k": {"all-reduce": [270, 31_230_579_208],
                                 "all-gather": [1, 268_435_456]},
                    "prefill_32k": {"all-reduce": [121, 9_958_795_876],
                                    "all-gather": [1, 134_217_728]},
                    "decode_32k": {"all-reduce": [73, 2_009_488], "all-gather": [1, 16_384]}}}


def _audio_cfg(full: bool, layers: int = 0, **over):
    """whisper-medium (with ``layers`` encoder and decoder layers, all for
    0), or its smoke config in a rehearsal."""
    if not full:
        return smoke_config(AUDIO["arch"], **over)
    return get_config(AUDIO["arch"], **({"n_layers": layers, "n_enc_layers": layers}
                                        if layers else {}), **over)


def _audio_pair_cfg(full: bool):
    """The config the gloo pair runs and its one-process runs are held to."""
    return _audio_cfg(full, AUDIO["pair_layers"], dtype=AUDIO["compare_dtype"])


def audio_frames(cfg, rows: int, full: bool, dev) -> torch.Tensor:
    """``rows`` requests' stub frame embeddings (rows, ENC_FRAMES, d_model),
    float32 unit normals drawn on ``dev`` from AUDIO["frames_seed"] (48
    frames in a rehearsal)."""
    from repro_torch.launch.specs import ENC_FRAMES

    gen = torch.Generator(device=dev).manual_seed(AUDIO["frames_seed"])
    n = ENC_FRAMES if full else AUDIO["rehearsal_frames"]
    return torch.randn((rows, n, cfg.d_model), generator=gen, device=dev)


def audio_collectives(cfg, plan, rows: int, seq: int, enc: int, kind: str = "train") -> list:
    """The "model"-axis collectives one rank issues running the
    encoder-decoder split on heads (``launch/tp_model.py``) on a mesh with
    one data rank, as sorted (kind, bytes, group) rows: a placed train step
    of ``rows`` x ``seq`` decoder tokens, a prefill of them, or a decode
    step of ``rows`` requests, with ``enc`` frames a request.  Per encoder
    layer (``rows`` x ``enc`` tokens) and per decoder layer: each split
    block's output sum (attention, cross-attention, MLP), and in training
    its input's gradient sum; in training the encoder output's gradient
    sum once (``encode``'s ``copy_to_model``).  Then :func:`lm_collectives`
    of the decoder tokens."""
    m = plan.model.size
    c = torch_dtype(cfg.dtype).itemsize
    d = cfg.d_model
    train = kind == "train"
    n = 2 if train else 1
    t = rows * (1 if kind == "decode" else seq)
    heads = plan.attn == "heads"
    ops = [("all-reduce", t * d * c, m)] * ((2 * heads + plan.mlp) * n * cfg.n_layers)
    if kind != "decode":
        te = rows * enc
        ops += [("all-reduce", te * d * c, m)] * ((heads + plan.mlp) * n * cfg.n_enc_layers)
        if train and heads:
            ops.append(("all-reduce", te * d * c, m))
    ops += lm_collectives(cfg, plan, rows, seq, t, train)
    return sorted(o for o in ops if o[2] > 1)


def phase_audio(dev: torch.device, full: bool = True, serve_path: dict | None = None,
                train_path: dict | None = None) -> dict:
    """Phase 3m: (a) whisper-medium's plans on 16 x 16 and 32 x 8; (b)
    whisper-medium at full width and depth trained 3 steps of 4 x 256
    decoder tokens (1,500 frames a request) by ``train()`` and by the
    placed step on a one-rank NCCL group and a (1, 1) mesh (every encoder
    layer through ``tp_model.layer``, every decoder layer through
    ``tp_model.dec_layer``), losses and every param leaf's sha256 equal,
    and its placed greedy ``generate`` with frames equal to
    ``serve.generate``'s (tokens and log-probabilities); (c) then split
    over "model" by two gloo ranks sharing the card on (1, 2), at
    AUDIO["pair_layers"] + AUDIO["pair_layers"] layers and float32 compute
    against float32 one-process runs: losses within AUDIO["loss_tol"],
    prefill logits and the one-process tokens' log-probabilities within
    AUDIO["tol"], greedy tokens equal up to near ties, each rank's cross
    cache within AUDIO["cross_tol"] of the one-process cache's heads, a
    step's and a decode step's collectives equal to
    :func:`audio_collectives`; (d) (b)'s prefill cross K/V cache as one
    link under 3f's four points (one ``bt_axes`` launch); (e) the dry run
    of whisper-medium's three cells on 16 x 16, run while (c)'s ranks do,
    equal to the CPU's.  Returns rows and launches."""
    import torch.distributed as dist

    t_phase = time.perf_counter()
    lc = _PathLaunches()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rows: dict = {"audio/plan": _audio_plans()}

    def mark(what: str) -> None:
        log(f"audio: {what} done at {time.perf_counter() - t_phase:.1f} s")

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = launch.make_smoke_mesh(device=dev.type)
        cfg = _audio_cfg(full)
        gb = TRAIN_FULL["global_batch"] if full else 4
        extra = {"frames": audio_frames(cfg, gb, full, dev)}
        # train() runs the (1, 1) step's op sequence (bitwise), so only the
        # placed step is timed
        one = train_one_process(dev, lc, cfg, full, "audio (b)", timed=False, extra=extra)
        rows["audio/train"] = _audio_step(dev, lc, mesh, cfg, full, one, extra)
        del extra
        rows["audio/generate"], cross = _audio_generate(dev, lc, mesh, cfg, full)
        mark("whisper-medium on (1, 1)")
    finally:
        dist.destroy_process_group()
    rows["audio/cross_stream"] = _audio_cross_stream(lc, cross, serve_path or {},
                                                     train_path or {})
    del cross
    pcfg = _audio_pair_cfg(full)
    nb = AUDIO["pair_batch"]
    frames = audio_frames(pcfg, nb, full, dev)
    one = train_one_process(dev, lc, pcfg, full, f"audio (c) {AUDIO['compare_dtype']}",
                            timed=False, digests=False, extra={"frames": frames}, batch=nb)
    ref = _audio_pair_reference(dev, lc, pcfg, full, frames)
    del frames
    mark("the float32 one-process runs")
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    def dry_run():
        rows["audio/dryrun"] = _audio_dryrun()

    pair, seconds = _spawn_ranks("audio (c)", AUDIO["ranks"], "audio_rank",
                                 [int(full), dev.type], dry_run)
    rows["audio/pair_seconds"] = seconds
    mark("the pair of ranks")
    rows["audio/two_ranks"] = _audio_two_ranks(pair, {"train": one, "serve": ref}, full, dev)
    seconds = time.perf_counter() - t_phase
    log(f"audio-path launches: {lc.total}; phase 3m {seconds:.1f} s ({backend}, world 1; gloo, "
        f"world {AUDIO['ranks']})")
    return {"rows": rows, "launches": lc.total, "max_abs_err": 0, "seconds": seconds}


def _audio_plans() -> dict:
    """(a) whisper-medium's train and serve plans on 16 x 16 and 32 x 8:
    the encoder's, the decoder's and the cross-attention's heads split (a
    rank's share of the 16), ``d_ff`` a rank, embed and head on "d", no
    partial leaf; the cross leaves among the split ones."""
    from repro_torch.launch import tp_model
    from repro_torch.launch.mesh import AbstractMesh

    cfg = get_config(AUDIO["arch"])
    out = {}
    for shape in ((16, 16), (32, 8)):
        m = shape[1]
        mesh = AbstractMesh(shape, ("data", "model"))
        for mode in ("train", "serve"):
            pl = tp_model.make_plan(cfg, mesh, mode)
            names = {p.rsplit("['", 1)[-1].rstrip("']") for p in pl.split
                     if "['cross_attn']" in p}
            if ((pl.attn, pl.kv, pl.mlp, pl.embed, pl.head, pl.partial,
                 pl.local.n_heads, pl.local.n_kv_heads) != (
                    "heads", "heads", True, "d", "d", frozenset(), cfg.n_heads // m,
                    cfg.n_kv_heads // m) or names != {"wq", "wk", "wv", "wo"}
                    or not any(p.startswith("['enc_layers']") for p in pl.split)):
                fail(f"audio (a): the {mode} plan of {cfg.name} on {shape} is {pl}")
        out["x".join(map(str, shape))] = {"heads": cfg.n_heads // m, "d_ff": cfg.d_ff // m,
                                          "embed": pl.embed, "head": pl.head,
                                          "partial": sorted(pl.partial)}
        log(f"audio (a) {cfg.name} on {shape[0]} x {m}: the encoder's, the decoder's and the "
            f"cross-attention's {cfg.n_heads // m} of {cfg.n_heads} heads a rank, "
            f"{cfg.d_ff // m} of d_ff {cfg.d_ff}, embed and head on d ({cfg.d_model // m} of "
            f"{cfg.d_model}; vocab {cfg.vocab}), no partial leaf")
    return out


def _audio_step(dev, lc, mesh, cfg, full: bool, one: dict, extra: dict) -> dict:
    """(b): three placed steps on the (1, 1) mesh, held to ``train()``'s
    losses and leaf digests; every encoder layer runs through
    ``tp_model.layer`` (bidirectional), every decoder layer through
    ``tp_model.dec_layer``, and a one-rank group issues no collective."""
    from repro_torch.launch import tp_model
    from repro_torch.roofline import record_collectives

    tf = TRAIN_FULL
    seq, gb = (tf["seq_len"], tf["global_batch"]) if full else (64, 4)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=gb, seed=tf["seed"])
    ocfg = optim.AdamWConfig(warmup_steps=1, total_steps=10)
    plan = tp_model.make_plan(cfg, mesh)
    if plan.attn != "heads" or plan.split:
        fail(f"audio (b): the plan of {cfg.name} on (1, 1) is {plan}")
    calls = {"layer": 0, "dec_layer": 0}
    fns = {k: getattr(tp_model, k) for k in calls}

    def counted(name):
        def fn(*a, **k):
            calls[name] += 1
            return fns[name](*a, **k)
        return fn

    for k in calls:
        setattr(tp_model, k, counted(k))
    try:
        with record_collectives() as ops:
            row, p, o, step, batch0 = _placed_run(dev, lc, mesh, cfg, dcfg, ocfg, one,
                                                  "audio (b)", full, extra)
    finally:
        for k, fn in fns.items():
            setattr(tp_model, k, fn)
    want = {"layer": cfg.n_enc_layers * tf["steps"], "dec_layer": cfg.n_layers * tf["steps"]}
    if calls != want or ops:
        fail(f"audio (b): {calls} layers through tp_model (want {want}), collectives {ops} on a "
             f"one-rank group")

    def one_step():
        return step(p, o, batch0)

    row["step_ms"] = time_ms(one_step, reps=2, warmup=1)
    row["step_device_ms"], row["step_device_split"] = _device_total_ms(one_step, reps=2)
    row["layers"] = calls
    row["frames"] = list(batch0["frames"].shape)
    row["one_process"] = {k: v for k, v in one.items() if k != "sha256"}
    log(f"audio (b) {cfg.name} placed step through the encoder-decoder plan on (1, 1), {gb} x "
        f"{seq} decoder tokens and {row['frames'][1]} frames a request: losses "
        + " ".join(f"{x:.6f}" for x in row["losses"])
        + (" = train()'s, every param leaf's sha256 equal" if row["equal_to_3g"] else "")
        + f"; {calls['layer']} encoder layers through tp_model.layer, {calls['dec_layer']} "
        f"decoder layers through tp_model.dec_layer, no collective; step {row['step_ms']:.1f} ms "
        f"wall (CUDA events), {row['step_device_ms']} ms device, peak {row['peak_bytes']} bytes "
        f"(train(): peak {one['peak_bytes']} bytes)")
    del p, o, step, one_step, batch0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return row


def _audio_generate(dev, lc, mesh, cfg, full: bool) -> tuple[dict, torch.Tensor]:
    """(b): the placed greedy ``generate`` with frames on the (1, 1) mesh
    against ``serve.generate`` with the same frames (phase 3f's requests,
    prompts and new tokens): tokens and log-probabilities equal; prefill
    and decode times and peak.  Also returns the placed prefill's cross
    K/V cache, flat (``cross_k`` then ``cross_v``), for (d)."""
    from repro_torch.launch import serve as placed
    from repro_torch.launch import tp_model

    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    frames = audio_frames(cfg, SERVE_FULL["requests"], full, dev)
    ref, params, _ = serve_reference(dev, lc, cfg, "audio", full, timed=False, frames=frames)
    prompts, want = ref["prompts"].to(dev), ref["tokens"].to(dev)
    nreq, plen = prompts.shape
    new = want.shape[1]
    local = placed.shard_params(cfg, mesh, params)
    plan = tp_model.make_plan(cfg, mesh, "serve")
    mode = placed.kv_mode(cfg, mesh, nreq, plen + new)
    cross = placed.cross_mode(cfg, mesh, nreq, frames.shape[1])
    res = lc.run("audio placed generate",
                 lambda: placed.generate(local, cfg, mesh, prompts, new, frames=frames), {})
    if not torch.equal(res.tokens, want):
        fail(f"audio (b): {cfg.name}'s placed generate's tokens differ from serve.generate's")
    if not torch.equal(res.logprobs.cpu(), ref["logprobs"]):
        fail(f"audio (b): {cfg.name}'s placed log-probabilities differ from serve.generate's")
    tok = want[:, :1].to(torch.int32)
    with torch.no_grad():
        logits, cache = placed.prefill(local, plan, prompts, plen + new, mode, frames=frames)
        pl = _serve_times(lambda: placed.prefill(local, plan, prompts, plen + new, mode,
                                                 frames=frames),
                          lambda: placed.decode_step(local, plan, cache, tok, mode))
    out = {"arch": cfg.name, "requests": nreq, "prompt": plen, "frames": frames.shape[1],
           "new_tokens": new, "cache": mode, "cross_cache": cross,
           "cross_shape": list(cache["cross_k"].shape), "tokens_equal": True,
           "logprobs_equal": True, "placed": pl,
           "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None}
    kv = torch.cat([cache["cross_k"].reshape(-1), cache["cross_v"].reshape(-1)])
    del params, local, logits, cache, res
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"audio (b) {cfg.name} placed greedy generate of {nreq} x {plen} prompts + {new} tokens "
        f"with {frames.shape[1]} frames a request on (1, 1): tokens and log-probabilities equal "
        f"to serve.generate's; cross cache {out['cross_shape']} ({cross}); prefill "
        f"{pl['prefill_ms']:.2f} ms ({pl['prefill_device_ms']} ms device), decode "
        f"{pl['decode_ms_per_token']:.3f} ms/token ({pl['decode_device_ms']} ms device); peak "
        f"{out['peak_bytes']} bytes")
    return out, kv


def _audio_cross_stream(lc, kv: torch.Tensor, serve_path: dict, train_path: dict) -> dict:
    """(d) (b)'s prefill cross K/V cache (every decoder layer's keys, then
    values) as one link, its int8 view under 3f's four points (one
    ``bt_axes`` launch), equal to the plain version; its ACC / APP
    reductions beside 3f's weights' and 3g's gradient's."""
    sess = obs.CaptureSession("audio")
    st = sess.add("serve_prefill", "cross_kv", kv)
    wl = sess.workload("serve_prefill", elems=SERVE["elems"], lanes=SERVE["lanes"])
    t1 = time.perf_counter()
    ev = lc.run("audio cross grid", lambda: dse.evaluate_grid(SERVE_POINTS, wl),
                {"bt_axes": 1} if st.data.is_cuda else {})
    ms = (time.perf_counter() - t1) * 1e3
    plain = dse.evaluate_grid(SERVE_POINTS, wl, backend="torch", chunk_packets=1 << 20)
    if [dataclasses.asdict(e) for e in ev] != [dataclasses.asdict(e) for e in plain]:
        fail("audio (d): the cross-cache grid differs from the plain version's")
    red = {e.label: 100 * e.bt_reduction for e in ev}
    out = {"bytes": st.num_bytes, "packets": wl.streams[0].shape[0], "measure_ms": ms,
           "bt": {e.label: [e.total_bt, e.aux_bt] for e in ev}, "red_pct": red}
    w = serve_path.get("rows", {}).get("serve/full", {}).get("measure", {}).get(
        "weights_split", {}).get("red_pct", {})
    gr = train_path.get("rows", {}).get("train/full", {}).get("measure", {}).get("red_pct", {})
    log(f"audio (d) the cross K/V cache ({st.num_bytes} int8 bytes, {out['packets']} packets of "
        f"{SERVE['elems']}) as one link, grid = plain, {ms:.1f} ms; reductions "
        + " ".join(f"{k}={v:.4f}%" for k, v in red.items())
        + "; beside 3f's weights " + " ".join(f"{k}={v:.4f}%" for k, v in w.items())
        + " and 3g's gradient " + " ".join(f"{k}={v:.4f}%" for k, v in gr.items()))
    del sess, wl
    return out


@torch.no_grad()
def _audio_pair_reference(dev, lc, cfg, full: bool, frames: torch.Tensor) -> dict:
    """(c) The one-process serving the pair is held to (``serve_reference``
    of ``cfg`` with ``frames``, AUDIO["pair_batch"] requests) and its
    prefill's cross cache at the first and the last decoder layer, all
    saved to ``build/audio_serve.npz``."""
    ref, params, _ = serve_reference(dev, lc, cfg, "audio (c)", full, timed=False,
                                     frames=frames, requests=frames.shape[0])
    plen, new = ref["prompts"].shape[1], ref["tokens"].shape[1]
    _, cache = serve.make_prefill_fn(cfg, plen + new)(params, ref["prompts"].to(dev),
                                                      frames=frames)
    keep = torch.tensor([0, cfg.n_layers - 1])
    saved = {k: v.numpy() for k, v in ref.items()}
    saved["cross_layers"] = keep.numpy()
    for key in ("cross_k", "cross_v"):
        saved[key] = cache[key][keep.to(dev)].to(torch.float32).cpu().numpy()
    np.savez(ROOT / "build" / "audio_serve.npz", **saved)
    del params, cache
    return ref


def audio_rank(rank: int, world: int, port: int, out: str, full: str, device: str) -> None:
    """Phase 3m (c), one rank of a ``world``-rank gloo group on ``device``
    ("cuda": card 0; "cpu" for a rehearsal) and a (1, world) mesh: the
    pair's config trained 3 steps by the placed step, then served against
    the one-process run in ``build/audio_serve.npz`` (its weights rebuilt
    from the same seed, the frames redrawn); writes the results to
    ``out``."""
    import torch.distributed as dist

    from repro_torch.launch import tp_model

    full = full == "1"
    dev = _rank_device(device, "audio", rank)
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        mesh = launch.make_smoke_mesh(device=dev.type)
        cfg = _audio_pair_cfg(full)
        plan = tp_model.make_plan(cfg, mesh, "serve")
        frames = audio_frames(cfg, AUDIO["pair_batch"], full, dev)
        res = {"rank": rank, "device": str(dev),
               "plan": {"attn": plan.attn, "kv": plan.kv, "heads": plan.local.n_heads,
                        "embed": plan.embed, "head": plan.head, "partial": sorted(plan.partial)},
               "train": _rank_train(dev, mesh, cfg, full, extra={"frames": frames},
                                    batch=AUDIO["pair_batch"]),
               "serve": _cp_rank_serve(dev, mesh, cfg, plan, ROOT / "build" / "audio_serve.npz",
                                       frames=frames)}
    finally:
        dist.destroy_process_group()
    Path(out).write_text(json.dumps(res))


def _audio_two_ranks(ranks: list, ref: dict, full: bool, dev) -> dict:
    """(c), the gloo half: two ranks on (1, 2) against the float32
    one-process runs: each rank on the card, losses, the placed serving (as
    3k's ``_cp_serve``), each rank's cross cache against the one-process
    cache's heads, and a train step's and a decode step's collectives equal
    to the closed form."""
    from repro_torch.launch import tp_model
    from repro_torch.launch.mesh import AbstractMesh

    n = AUDIO["ranks"]
    cfg = _audio_pair_cfg(full)
    mesh = AbstractMesh((1, n), ("data", "model"))
    tf = TRAIN_FULL
    seq, nb = (tf["seq_len"] if full else 64), AUDIO["pair_batch"]
    want_dev = "cuda:0" if dev.type == "cuda" else dev.type
    if any(r["device"] != want_dev for r in ranks) or (dev.type == "cuda" and any(
            not t["train"]["peak_bytes"] for t in ranks)):
        fail(f"audio (c): the ranks ran on {[r['device'] for r in ranks]}, not on {want_dev}")
    if any(r["plan"]["heads"] != cfg.n_heads // n or r["plan"]["partial"] for r in ranks):
        fail(f"audio (c): the ranks' plans are {[r['plan'] for r in ranks]}")
    tr = [r["train"] for r in ranks]
    want = ref["train"]["losses"]
    if any(t["losses"] != tr[0]["losses"] for t in tr[1:]):
        fail(f"audio (c): the ranks' losses differ: {[t['losses'] for t in tr]}")
    loss_err = max(abs(a - b) for a, b in zip(tr[0]["losses"], want))
    if loss_err > AUDIO["loss_tol"]:
        fail(f"audio (c): losses {tr[0]['losses']} against train()'s {want} (tolerance "
             f"{AUDIO['loss_tol']})")
    enc = ranks[0]["serve"]["cross_shape"][2]
    closed = {"decode": [list(o) for o in audio_collectives(
                  cfg, tp_model.make_plan(cfg, mesh, "serve"), nb, 1, enc, "decode")],
              "step": [list(o) for o in audio_collectives(
                  cfg, tp_model.make_plan(cfg, mesh), nb, seq, enc, "train")]}
    for r in ranks:
        for k, got in (("decode", r["serve"]["decode_ops"]), ("step", r["train"]["ops"])):
            if got != closed[k]:
                fail(f"audio (c): rank {r['rank']}'s {k} collectives differ from the closed "
                     f"form: {len(got)} recorded, {len(closed[k])} expected")
    cross = [r["serve"]["cross_err"] for r in ranks]
    if max(cross) > AUDIO["cross_tol"] or any(
            r["serve"]["cross_shape"][3] != cfg.n_kv_heads // n for r in ranks):
        fail(f"audio (c): the ranks' cross caches {[r['serve']['cross_shape'] for r in ranks]} "
             f"lie {cross} from the one-process cache's heads (tolerance {AUDIO['cross_tol']})")
    serving = _cp_serve(ranks, ref["serve"], n, AUDIO["tol"], "audio (c)")
    walls = [w for t in tr for w in t["step_wall_ms"][1:]]
    out = {"layers": cfg.n_layers, "losses": tr[0]["losses"], "one_process": want,
           "loss_max_err": loss_err, "loss_tol": AUDIO["loss_tol"], "cross_err": max(cross),
           "cross_shape": ranks[0]["serve"]["cross_shape"],
           "step_wall_ms": [t["step_wall_ms"] for t in tr],
           "peak_bytes": [t["peak_bytes"] for t in tr], "local_params": tr[0]["local_params"],
           "params": tr[0]["params"], "serve": serving,
           "collectives": {k: {"count": len(v), "bytes": sum(o[1] for o in v)}
                           for k, v in closed.items()}}
    log(f"audio (c) {cfg.name} at {cfg.n_enc_layers} + {cfg.n_layers} layers, float32, a batch "
        f"of {nb}, split over 'model' by {n} gloo ranks: losses "
        + " ".join(f"{x:.6f}" for x in out["losses"]) + f" (train()'s within {loss_err:.3g}, "
        f"tolerance {AUDIO['loss_tol']}); the cross cache {out['cross_shape']} a rank within "
        f"{max(cross):.3g} of the one-process cache's heads; a rank holds "
        f"{out['local_params']} of {out['params']} params; step wall {_range(walls)} ms; peak "
        f"{_range(out['peak_bytes'], '{:.0f}')} bytes; collectives = the closed form: a train "
        f"step {out['collectives']['step']}, a decode step {out['collectives']['decode']}")
    return out


def _audio_dryrun() -> dict:
    """(e) The dry run of whisper-medium's three cells on 16 x 16; each
    cell's collectives (count and result bytes per kind) equal to the CPU's
    meta run (AUDIO["dryrun"])."""
    out = _dryrun_cells("audio (e)", AUDIO["modelled"], ())
    for arch, shape, _ in AUDIO["modelled"]:
        got = out[f"{arch}/{shape}/16x16"]["collectives"]
        want = AUDIO["dryrun"][shape]
        if {k: [v["count"], v["bytes"]] for k, v in got.items()} != want:
            fail(f"audio (e): {arch} x {shape} [16x16] records {got}, the CPU's meta run {want}")
    return out


# ------------------------------------------------------------------ phase 3n

# The vlm family over "model" (launch/tp_model.py's ``embed_inputs``: the
# dense family's splits behind precomputed patch embeddings).  internvl2-
# 26b (48 layers, d_model 6,144, 48 heads, 8 kv heads, d_ff 16,384, vocab
# 92,553, 19.86 B params) is served uncut on the (1, 1) mesh with its
# weights in bf16 (39.7 GB; 79.4 GB at float32 would not fit beside the
# draws), 1,024 stub patch embeddings a request in front of phase 3f's
# prompts.  The gloo pair runs it at full width and ``pair_layers`` of the
# 48 layers with float32 compute (17.0 GB of float32 weights one process,
# about half a rank) against a float32 one-process run: at m = 2 the cache
# splits on kv heads, 4 a rank.  ``tol`` and ``cross_tol`` are 3m's; the
# KV cache's gate is ``cross_tol``.  ``dryrun``: the CPU's meta run of the
# two serving cells on 16 x 16 (count, result bytes per kind); train_4k is
# FSDP-placed, which the placed step's dry run does not run.
VLM = {"arch": "internvl2-26b", "patches_seed": 13, "ranks": 2, "pair_layers": 8,
       "pair_batch": 2, "serve_param_dtype": "bfloat16", "compare_dtype": "float32",
       "tol": AUDIO["tol"], "kv_tol": AUDIO["cross_tol"],
       "modelled": tuple(("internvl2-26b", s, False) for s in ("prefill_32k", "decode_32k")),
       "unmodelled": (("internvl2-26b", "train_4k"),),
       "dryrun": {"prefill_32k": {"all-reduce": [97, 77_309_781_540],
                                  "all-gather": [1, 780_140_544]},
                  "decode_32k": {"all-reduce": [193, 20_502_672],
                                 "all-gather": [49, 4_816_896]}}}


def _vlm_cfg(full: bool, layers: int = 0, **over):
    """internvl2-26b (with ``layers`` layers, all for 0), or its smoke
    config in a rehearsal."""
    if not full:
        return smoke_config(VLM["arch"], **over)
    return get_config(VLM["arch"], **({"n_layers": layers} if layers else {}), **over)


def _vlm_pair_cfg(full: bool):
    """The config the gloo pair serves and its one-process run is held to."""
    return _vlm_cfg(full, VLM["pair_layers"], dtype=VLM["compare_dtype"])


def vlm_patches(cfg, rows: int, dev) -> torch.Tensor:
    """``rows`` requests' stub patch embeddings (rows, n_frontend_tokens,
    d_model), float32 unit normals drawn on ``dev`` from
    VLM["patches_seed"]."""
    gen = torch.Generator(device=dev).manual_seed(VLM["patches_seed"])
    return torch.randn((rows, cfg.n_frontend_tokens, cfg.d_model), generator=gen, device=dev)


def vlm_collectives(cfg, plan, rows: int, text: int, patches: int, kind: str = "train",
                    mode: str = "heads") -> list:
    """The "model"-axis collectives one rank issues running the vlm family
    split on heads (``launch/tp_model.py``) on a mesh with one data rank,
    as sorted (kind, bytes, group) rows: a placed train step or a prefill
    of ``rows`` requests of ``patches`` patch embeddings and ``text``
    tokens, or a decode step of ``rows`` requests with the KV cache placed
    by ``mode`` ("heads", "seq" or "whole").  Per layer, over every
    position: attention's and the MLP's output sums (in training also
    their inputs' gradient sums); under split-K the gather of the query
    heads and the merge's MAX and SUM.  Then :func:`lm_collectives`, its
    embedding of the text positions only (the patches bypass it), its loss
    over every position."""
    if plan.attn not in ("heads", "whole"):
        raise ValueError(f"{cfg.name}: the closed form covers attention split on its heads, "
                         f"not {plan.attn}")
    m = plan.model.size
    c = torch_dtype(cfg.dtype).itemsize
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    train = kind == "train"
    n = 2 if train else 1
    seq = patches + text
    t, tt = (rows, rows) if kind == "decode" else (rows * seq, rows * text)
    act = ("all-reduce", t * d * c, m)
    layer = [act] * (((plan.attn == "heads") + plan.mlp) * n)
    if kind == "decode" and mode == "seq":
        layer += [("all-gather", rows * h * hd * c, m), ("all-reduce", rows * h * 4, m),
                  ("all-reduce", rows * h * (hd + 1) * 4, m)]
    ops = layer * cfg.n_layers + lm_collectives(cfg, plan, rows, seq, tt, train)
    return sorted(o for o in ops if o[2] > 1)


def phase_vlm(dev: torch.device, full: bool = True, serve_path: dict | None = None,
              audio_path: dict | None = None) -> dict:
    """Phase 3n: (a) internvl2-26b's serve plans on 16 x 16, 2 x 16 x 16 and
    32 x 8; (b) internvl2-26b at full width and depth, bf16 weights, served
    on a one-rank NCCL group and a (1, 1) mesh: the placed greedy
    ``generate`` with 1,024 patch embeddings a request in front of phase
    3f's 4 x 256 prompts + 16 new tokens, tokens and log-probabilities
    equal to ``serve.generate``'s with the patches as ``inputs_embeds``;
    prefill and decode times, peak; (c) then split over "model" by two
    gloo ranks sharing the card on (1, 2), at VLM["pair_layers"] layers and
    float32 compute against a float32 one-process run: prefill logits and
    the one-process tokens' log-probabilities within VLM["tol"], greedy
    tokens equal up to near ties, each rank's KV cache within
    VLM["kv_tol"] of the one-process cache's kv heads, a prefill's and a
    decode step's collectives equal to :func:`vlm_collectives`; (d) (b)'s
    prefill KV cache over its filled positions as one link under 3f's four
    points (one ``bt_axes`` launch); (e) the dry run of internvl2-26b's two
    serving cells on 16 x 16, run while (c)'s ranks do, equal to the CPU's,
    and its train_4k's reason.  Returns rows and launches."""
    import torch.distributed as dist

    t_phase = time.perf_counter()
    lc = _PathLaunches()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rows: dict = {"vlm/plan": _vlm_plans()}

    def mark(what: str) -> None:
        log(f"vlm: {what} done at {time.perf_counter() - t_phase:.1f} s")

    (ROOT / "build").mkdir(exist_ok=True)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = launch.make_smoke_mesh(device=dev.type)
        cfg = _vlm_cfg(full, param_dtype=VLM["serve_param_dtype"])
        rows["vlm/generate"], kv = _vlm_generate(dev, lc, mesh, cfg, full)
        mark(f"{cfg.name} on (1, 1)")
    finally:
        dist.destroy_process_group()
    rows["vlm/kv_stream"] = _vlm_kv_stream(lc, kv, serve_path or {}, audio_path or {})
    del kv
    pcfg = _vlm_pair_cfg(full)
    ref = _vlm_pair_reference(dev, lc, pcfg, full)
    mark("the float32 one-process run")
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    def dry_run():
        rows["vlm/dryrun"] = _vlm_dryrun()

    pair, seconds = _spawn_ranks("vlm (c)", VLM["ranks"], "vlm_rank", [int(full), dev.type],
                                 dry_run)
    rows["vlm/pair_seconds"] = seconds
    mark("the pair of ranks")
    rows["vlm/two_ranks"] = _vlm_two_ranks(pair, ref, full, dev)
    seconds = time.perf_counter() - t_phase
    log(f"vlm-path launches: {lc.total}; phase 3n {seconds:.1f} s ({backend}, world 1; gloo, "
        f"world {VLM['ranks']})")
    return {"rows": rows, "launches": lc.total, "max_abs_err": 0, "seconds": seconds}


def _vlm_plans() -> dict:
    """(a) internvl2-26b's serve plans on 16 x 16, 2 x 16 x 16 and 32 x 8:
    attention split on heads (H / m a rank), ``wk`` / ``wv`` split on kv
    heads where m divides them, else replicated with the one kv head a
    rank's query heads read (``kv_index``, a partial leaf); the MLP on
    ``d_ff``; embed and head on "d" (the vocabulary is odd)."""
    from repro_torch.launch import tp_model
    from repro_torch.launch.mesh import AbstractMesh

    cfg = get_config(VLM["arch"])
    out = {}
    for shape in ((16, 16), (2, 16, 16), (32, 8)):
        m = shape[-1]
        names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
        pl = tp_model.make_plan(cfg, AbstractMesh(shape, names), "serve")
        kv = "heads" if cfg.n_kv_heads % m == 0 else "whole"
        hpl = cfg.n_heads // m
        # replicated kv: rank 0's query heads 0 .. hpl - 1 all read kv head 0
        want = ("heads", kv, None, cfg.n_kv_heads // m, set()) if kv == "heads" else (
            "heads", kv, (0,), 1, {"wk", "wv"})
        if ((pl.attn, pl.kv, pl.kv_index, pl.local.n_kv_heads,
             {p.rsplit("['", 1)[-1].rstrip("']") for p in pl.partial}) != want
                or (pl.mlp, pl.embed, pl.head, pl.local.n_heads) != (True, "d", "d", hpl)):
            fail(f"vlm (a): the serve plan of {cfg.name} on {shape} is {pl}")
        out["x".join(map(str, shape))] = {"heads": hpl, "kv": kv, "kv_heads": pl.local.n_kv_heads,
                                          "d_ff": cfg.d_ff // m, "embed": pl.embed,
                                          "head": pl.head, "partial": sorted(pl.partial)}
        log(f"vlm (a) {cfg.name} on {' x '.join(map(str, shape))}: {hpl} of {cfg.n_heads} heads "
            f"a rank, kv {kv} ({pl.local.n_kv_heads} of {cfg.n_kv_heads} a rank"
            + (f", replicated; rank 0 reads kv head {pl.kv_index})" if kv == "whole" else ")")
            + f", {cfg.d_ff // m} of d_ff {cfg.d_ff}, embed and head on d ({cfg.d_model // m} "
            f"of {cfg.d_model}; vocab {cfg.vocab})")
    return out


def _vlm_generate(dev, lc, mesh, cfg, full: bool) -> tuple[dict, torch.Tensor]:
    """(b): the placed greedy ``generate`` with patches on the (1, 1) mesh
    against ``serve.generate`` with the same patches as ``inputs_embeds``
    (phase 3f's requests, prompts and new tokens): tokens and
    log-probabilities equal; ``shard_params`` keeps the very weight
    tensors (no second copy); prefill and decode times and peaks.  Also
    returns the placed prefill's KV cache over its filled positions, flat
    (``k`` then ``v``), for (d)."""
    from repro_torch.launch import serve as placed
    from repro_torch.launch import tp_model

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    patches = vlm_patches(cfg, SERVE_FULL["requests"], dev)
    ref, params, _ = serve_reference(dev, lc, cfg, "vlm", full, timed=False, patches=patches)
    prompts, want = ref["prompts"].to(dev), ref["tokens"].to(dev)
    nreq, plen = prompts.shape
    new, npat = want.shape[1], patches.shape[1]
    max_len = npat + plen + new
    build_peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    local = placed.shard_params(cfg, mesh, params)
    if any(a is not b for a, b in zip(tree_leaves(local), tree_leaves(params))):
        fail(f"vlm (b): shard_params on (1, 1) copied {cfg.name}'s weights")
    weight_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    plan = tp_model.make_plan(cfg, mesh, "serve")
    mode = placed.kv_mode(cfg, mesh, nreq, max_len)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    res = lc.run("vlm placed generate",
                 lambda: placed.generate(local, cfg, mesh, prompts, new, patches=patches), {})
    serve_peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    if not torch.equal(res.tokens, want):
        fail(f"vlm (b): {cfg.name}'s placed generate's tokens differ from serve.generate's")
    if not torch.equal(res.logprobs.cpu(), ref["logprobs"]):
        fail(f"vlm (b): {cfg.name}'s placed log-probabilities differ from serve.generate's")
    tok = want[:, :1].to(torch.int32)
    with torch.no_grad():
        logits, cache = placed.prefill(local, plan, prompts, max_len, mode, patches=patches)
        pl = _serve_times(lambda: placed.prefill(local, plan, prompts, max_len, mode,
                                                 patches=patches),
                          lambda: placed.decode_step(local, plan, cache, tok, mode))
    filled = npat + plen
    if int(cache["pos"]) != filled or tuple(cache["k"].shape[:3]) != (cfg.n_layers, nreq, max_len):
        fail(f"vlm (b): the placed prefill's cache holds {tuple(cache['k'].shape)} at position "
             f"{int(cache['pos'])}, not {filled} of {max_len}")
    out = {"arch": cfg.name, "layers": cfg.n_layers, "params": cfg.param_count(),
           "weight_bytes": weight_bytes, "requests": nreq, "patches": npat, "prompt": plen,
           "new_tokens": new, "max_len": max_len, "cache": mode,
           "cache_shape": list(cache["k"].shape), "tokens_equal": True, "logprobs_equal": True,
           "weights_shared": True, "placed": pl, "build_peak_bytes": build_peak,
           "serve_peak_bytes": serve_peak,
           "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None}
    kv = torch.cat([cache["k"][:, :, :filled].reshape(-1), cache["v"][:, :, :filled].reshape(-1)])
    del params, local, logits, cache, res
    if cuda:
        torch.cuda.empty_cache()
    log(f"vlm (b) {cfg.name} at {cfg.n_layers} layers ({out['params']} params, {weight_bytes} "
        f"bytes of {cfg.param_dtype} weights, shared by the placed run), placed greedy generate "
        f"of {nreq} x ({npat} patches + {plen} prompt) + {new} tokens on (1, 1), cache {mode} "
        f"{out['cache_shape']}: tokens and log-probabilities equal to serve.generate's; prefill "
        f"{pl['prefill_ms']:.2f} ms ({pl['prefill_device_ms']} ms device), decode "
        f"{pl['decode_ms_per_token']:.3f} ms/token ({pl['decode_device_ms']} ms device); peak "
        f"{build_peak} bytes building the weights, {serve_peak} serving")
    log(f"vlm (b) device split: prefill {pl['prefill_device_split']}; decode "
        f"{pl['decode_device_split']}")
    return out, kv


def _vlm_kv_stream(lc, kv: torch.Tensor, serve_path: dict, audio_path: dict) -> dict:
    """(d) (b)'s prefill KV cache over its filled positions (every layer's
    keys, then values) as one link, its int8 view under 3f's four points
    (one ``bt_axes`` launch), equal to the plain version; its ACC / APP
    reductions beside 3f's weights' and 3m's cross cache's."""
    sess = obs.CaptureSession("vlm")
    st = sess.add("serve_prefill", "kv", kv)
    wl = sess.workload("serve_prefill", elems=SERVE["elems"], lanes=SERVE["lanes"])
    t1 = time.perf_counter()
    ev = lc.run("vlm kv grid", lambda: dse.evaluate_grid(SERVE_POINTS, wl),
                {"bt_axes": 1} if st.data.is_cuda else {})
    ms = (time.perf_counter() - t1) * 1e3
    plain = dse.evaluate_grid(SERVE_POINTS, wl, backend="torch", chunk_packets=1 << 20)
    if [dataclasses.asdict(e) for e in ev] != [dataclasses.asdict(e) for e in plain]:
        fail("vlm (d): the KV-cache grid differs from the plain version's")
    red = {e.label: 100 * e.bt_reduction for e in ev}
    out = {"bytes": st.num_bytes, "packets": wl.streams[0].shape[0], "measure_ms": ms,
           "bt": {e.label: [e.total_bt, e.aux_bt] for e in ev}, "red_pct": red}
    w = serve_path.get("rows", {}).get("serve/full", {}).get("measure", {}).get(
        "weights_split", {}).get("red_pct", {})
    cross = audio_path.get("rows", {}).get("audio/cross_stream", {}).get("red_pct", {})
    log(f"vlm (d) the KV cache ({st.num_bytes} int8 bytes, {out['packets']} packets of "
        f"{SERVE['elems']}) as one link, grid = plain, {ms:.1f} ms; reductions "
        + " ".join(f"{k}={v:.4f}%" for k, v in red.items())
        + "; beside 3f's weights " + " ".join(f"{k}={v:.4f}%" for k, v in w.items())
        + " and 3m's cross cache " + " ".join(f"{k}={v:.4f}%" for k, v in cross.items()))
    del sess, wl
    return out


@torch.no_grad()
def _vlm_pair_reference(dev, lc, cfg, full: bool) -> dict:
    """(c) The one-process serving the pair is held to (``serve_reference``
    of ``cfg`` with VLM["pair_batch"] requests' patches) and its prefill's
    KV cache at the first and the last layer, all saved to
    ``build/vlm_serve.npz``."""
    patches = vlm_patches(cfg, VLM["pair_batch"], dev)
    ref, params, _ = serve_reference(dev, lc, cfg, "vlm (c)", full, timed=False,
                                     patches=patches, requests=patches.shape[0])
    max_len = patches.shape[1] + ref["prompts"].shape[1] + ref["tokens"].shape[1]
    _, cache = serve.make_prefill_fn(cfg, max_len)(params, ref["prompts"].to(dev),
                                                   inputs_embeds=patches)
    keep = torch.tensor([0, cfg.n_layers - 1])
    saved = {k: v.numpy() for k, v in ref.items()}
    saved["kv_layers"] = keep.numpy()
    for key in ("k", "v"):
        saved[key] = cache[key][keep.to(dev)].to(torch.float32).cpu().numpy()
    np.savez(ROOT / "build" / "vlm_serve.npz", **saved)
    del params, cache, patches
    return ref


def vlm_rank(rank: int, world: int, port: int, out: str, full: str, device: str) -> None:
    """Phase 3n (c), one rank of a ``world``-rank gloo group on ``device``
    ("cuda": card 0; "cpu" for a rehearsal) and a (1, world) mesh: the
    pair's config served against the one-process run in
    ``build/vlm_serve.npz`` (its weights rebuilt from the same seed, the
    patches redrawn); writes the results to ``out``."""
    import torch.distributed as dist

    from repro_torch.launch import tp_model

    full = full == "1"
    dev = _rank_device(device, "vlm", rank)
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        mesh = launch.make_smoke_mesh(device=dev.type)
        cfg = _vlm_pair_cfg(full)
        plan = tp_model.make_plan(cfg, mesh, "serve")
        patches = vlm_patches(cfg, VLM["pair_batch"], dev)
        res = {"rank": rank, "device": str(dev),
               "plan": {"attn": plan.attn, "kv": plan.kv, "heads": plan.local.n_heads,
                        "kv_heads": plan.local.n_kv_heads, "embed": plan.embed,
                        "head": plan.head, "partial": sorted(plan.partial)},
               "serve": _cp_rank_serve(dev, mesh, cfg, plan, ROOT / "build" / "vlm_serve.npz",
                                       patches=patches)}
    finally:
        dist.destroy_process_group()
    Path(out).write_text(json.dumps(res))


def _vlm_two_ranks(ranks: list, ref: dict, full: bool, dev) -> dict:
    """(c), the gloo half: two ranks on (1, 2) against the float32
    one-process run: each rank on the card with its plan, the placed
    serving (as 3k's ``_cp_serve``), each rank's KV cache against the
    one-process cache's kv heads, and a prefill's and a decode step's
    collectives equal to the closed form."""
    from repro_torch.launch import tp_model
    from repro_torch.launch.mesh import AbstractMesh

    n = VLM["ranks"]
    cfg = _vlm_pair_cfg(full)
    plan = tp_model.make_plan(cfg, AbstractMesh((1, n), ("data", "model")), "serve")
    want_dev = "cuda:0" if dev.type == "cuda" else dev.type
    if any(r["device"] != want_dev for r in ranks) or (dev.type == "cuda" and any(
            not r["serve"]["peak_bytes"] for r in ranks)):
        fail(f"vlm (c): the ranks ran on {[r['device'] for r in ranks]}, not on {want_dev}")
    if any((r["plan"]["heads"], r["plan"]["kv_heads"], r["plan"]["kv"]) != (
            cfg.n_heads // n, cfg.n_kv_heads // n, "heads") or r["plan"]["partial"]
            for r in ranks):
        fail(f"vlm (c): the ranks' plans are {[r['plan'] for r in ranks]}")
    nb, plen = ref["prompts"].shape
    new = ref["tokens"].shape[1]
    mode = ranks[0]["serve"]["cache"]
    closed = {"prefill": [list(o) for o in vlm_collectives(
                  cfg, plan, nb, plen, cfg.n_frontend_tokens, "prefill")],
              "decode": [list(o) for o in vlm_collectives(cfg, plan, nb, 1, 0, "decode", mode)]}
    for r in ranks:
        for k in closed:
            got = r["serve"][f"{k}_ops"]
            if got != closed[k]:
                fail(f"vlm (c): rank {r['rank']}'s {k} collectives differ from the closed "
                     f"form: {len(got)} recorded, {len(closed[k])} expected")
    kv = [r["serve"]["kv_err"] for r in ranks]
    want_shape = [cfg.n_layers, nb, cfg.n_frontend_tokens + plen + new, cfg.n_kv_heads // n,
                  cfg.resolved_head_dim]
    if max(kv) > VLM["kv_tol"] or any(r["serve"]["kv_shape"] != want_shape for r in ranks):
        fail(f"vlm (c): the ranks' KV caches {[r['serve']['kv_shape'] for r in ranks]} lie {kv} "
             f"from the one-process cache's kv heads (tolerance {VLM['kv_tol']})")
    serving = _cp_serve(ranks, ref, n, VLM["tol"], "vlm (c)")
    out = {"layers": cfg.n_layers, "kv_err": max(kv), "kv_tol": VLM["kv_tol"],
           "kv_shape": ranks[0]["serve"]["kv_shape"], "serve": serving,
           "collectives": {k: {"count": len(v), "bytes": sum(o[1] for o in v)}
                           for k, v in closed.items()}}
    log(f"vlm (c) {cfg.name} at {cfg.n_layers} layers, float32, {nb} requests of "
        f"{cfg.n_frontend_tokens} patches + {plen} tokens, split over 'model' by {n} gloo "
        f"ranks: the KV cache {out['kv_shape']} a rank within {max(kv):.3g} of the one-process "
        f"cache's kv heads (tolerance {VLM['kv_tol']}); collectives = the closed form: a "
        f"prefill {out['collectives']['prefill']}, a decode step {out['collectives']['decode']}")
    return out


def _vlm_dryrun() -> dict:
    """(e) The dry run of internvl2-26b's two serving cells on 16 x 16, each
    cell's collectives (count and result bytes per kind) equal to the
    CPU's meta run (VLM["dryrun"]); its train_4k names FSDP."""
    out = _dryrun_cells("vlm (e)", VLM["modelled"], VLM["unmodelled"])
    for arch, shape, _ in VLM["modelled"]:
        got = out[f"{arch}/{shape}/16x16"]["collectives"]
        want = VLM["dryrun"][shape]
        if {k: [v["count"], v["bytes"]] for k, v in got.items()} != want:
            fail(f"vlm (e): {arch} x {shape} [16x16] records {got}, the CPU's meta run {want}")
    for arch, shape in VLM["unmodelled"]:
        if "FSDP" not in out[f"{arch}/{shape}/16x16"]["collectives_reason"]:
            fail(f"vlm (e): {arch} x {shape} [16x16] is not refused for FSDP: "
                 f"{out[f'{arch}/{shape}/16x16']['collectives_reason']}")
    return out


# ------------------------------------------------------------------ phase 4


def _bt_chunked_plain(s: torch.Tensor, rows: int = 1 << 24) -> int:
    """Plain bt_count over row chunks that overlap by one row, summed with
    the int32 wrap of the reference."""
    total = 0
    for r0 in range(0, s.shape[0] - 1, rows):
        total += int(bt_count(s[r0: r0 + rows + 1], backend="torch"))
    return (total + 2**31) % 2**32 - 2**31


def phase_scale(dev: torch.device, full_m: int | None = None) -> dict:
    """Scale checks, then the timing table of every kernel (the quantizer
    at the pinned 2**20 elements and at ``full_m``, by default the full
    width of EGRESS_ARCH's gradient)."""
    full_m = get_config(EGRESS_ARCH).param_count() if full_m is None else full_m
    gen = torch.Generator(device=dev).manual_seed(7)
    p, n = SCALE_PACKETS, 32
    x = torch.randint(0, 256, (p, n), generator=gen, device=dev, dtype=torch.uint8)
    w = torch.randint(0, 256, (p, n), generator=gen, device=dev, dtype=torch.uint8)
    big = torch.randint(0, 256, (SCALE_BT_ROWS, 8), generator=gen, device=dev, dtype=torch.uint8)

    res = psu_stream(x, w, k=4)
    err = 0
    chunk = 1 << 19
    for p0 in range(0, p, chunk):
        ref = psu_stream(x[p0: p0 + chunk], w[p0: p0 + chunk], k=4, backend="torch")
        err = max(err, max_err(res.order[p0: p0 + chunk], ref.order),
                  max_err(res.rank[p0: p0 + chunk], ref.rank),
                  max_err(res.stream[p0 * 4: (p0 + chunk) * 4], ref.stream))
    bt_in = _bt_chunked_plain(res.stream[:, :8])
    bt_wt = _bt_chunked_plain(res.stream[:, 8:])
    if err or (int(res.bt_input), int(res.bt_weight)) != (bt_in, bt_wt):
        fail(f"psu_stream at {p} packets: err {err}, BT {(int(res.bt_input), int(res.bt_weight))}"
             f" vs plain {(bt_in, bt_wt)}")
    log(f"scale psu_stream: {p} paired packets bit-exact, BT=({bt_in}, {bt_wt})")
    del res

    got = int(bt_count(big))
    ref = _bt_chunked_plain(big)
    if got != ref:
        fail(f"bt_count on the 1 GiB stream: {got} vs plain {ref}")
    log(f"scale bt_count: (2**27, 8) uint8 = 1 GiB, BT={got} (int32, wraps) matches plain")

    # the jagged multi-axis batch; its plain version runs 32 links at a time
    la, pa, na = SCALE_AXES
    xa = torch.randint(0, 256, (la, pa, na), generator=gen, device=dev, dtype=torch.uint8)
    va = torch.randint(0, pa + 1, (la,), generator=gen, device=dev)
    akw = dict(configs=SCALE_AXES_CONFIGS, input_lanes=16)

    def axes_plain():
        return torch.cat([bt_count_axes(xa[i: i + 32], None, va[i: i + 32], backend="torch", **akw)
                          for i in range(0, la, 32)])

    got = bt_count_axes(xa, None, va, **akw)
    ref = axes_plain()
    e = max_err(got, ref)
    if e:
        fail(f"bt_axes on the {SCALE_AXES} batch: err {e} vs plain")
    log(f"scale bt_axes: jagged {SCALE_AXES} uint8 ({xa.numel() >> 20} MiB, "
        f"{int(va.sum())} valid packets), "
        f"{len(SCALE_AXES_CONFIGS)} configs bit-exact, largest link total {int(got.max())}")

    # the same batch with per-wire activity windows; the plain version
    # 32 links at a time (each link is measured on its own)
    wkw = dict(akw, activity_windows=SCALE_WINDOW)

    def act_plain():
        parts = [bt_count_axes(xa[i: i + 32], None, va[i: i + 32], backend="torch", **wkw)
                 for i in range(0, la, 32)]
        return type(parts[0])(*(torch.cat(f) for f in zip(*parts)))

    act = bt_count_axes(xa, None, va, **wkw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = act_plain()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    e = max(max_err(a, b) for a, b in zip(act, ref))
    del ref
    chunked = bt_count_axes(xa, None, va, chunk_packets=4096, **wkw)
    e_chunk = max(max_err(a, b) for a, b in zip(act, chunked))
    del chunked
    if e or e_chunk or max_err(act.bt, got):
        fail(f"bt_axes_activity on the {SCALE_AXES} batch: err {e} vs plain, {e_chunk} vs "
             f"4096-packet chunks, or its BT differs from bt_axes")
    if max_err(act.toggles.sum(2).sum(-1), act.bt.sum(-1)):
        fail("bt_axes_activity at scale: per-wire toggles do not sum to the gross BT")
    log(f"scale bt_axes_activity: jagged {SCALE_AXES}, {len(SCALE_AXES_CONFIGS)} configs, "
        f"windows of {SCALE_WINDOW} rows -> toggles {tuple(act.toggles.shape)} int32 "
        f"({act.toggles.numel() * 4} bytes) bit-exact vs plain (all {la} links, "
        f"{plain_s:.1f} s) and vs 4096-packet chunks; per-wire sums = gross BT")
    del act

    # ---- timings: main path shapes, then scale shapes ----
    u = TABLE1_UNIFORM
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.integers(0, 256, (1, 16), dtype=np.uint8)).to(dev)
    ui, uw = (torch.from_numpy(a).to(dev) for a in uniform_pairs(u["packets"], u["elems"]))
    ustream = TxPipeline(LinkSpec(key="none")).transmit(ui, uw)
    uslice = ustream[:, :8]  # the staged path's input-half column slice

    def sort_case(pk, plain=None, plain_reps=10):
        pn = pk.numel()
        keys = bucket_map(popcount(pk, 8), 8, 4).to(torch.uint8)
        plain = plain or (lambda: psu_sort(pk, k=4, backend="torch"))
        return {
            "shape": list(pk.shape),
            "ms": time_ms(lambda: psu_sort(pk, k=4)),
            "plain_ms": time_ms(plain, reps=plain_reps, warmup=1),
            "library_ms": time_ms(lambda: torch.argsort(keys, dim=-1, stable=True)),
            "library": "torch.argsort(keys, dim=-1, stable=True) on precomputed APP keys "
                       "(the sort alone)",
            "bytes": pn * (1 + 8), "ops": pn * 4,
        }

    def bt_case(s):
        t, lanes = s.shape
        return {
            "shape": [t, lanes], "stride": list(s.stride()),
            "ms": time_ms(lambda: bt_count(s)),
            "plain_ms": time_ms(lambda: bt_count(s, backend="torch")),
            "library_ms": None, "library": "none (no single PyTorch call counts BT)",
            "bytes": t * lanes + 4, "ops": (t - 1) * lanes * 3,
        }

    def stream_case(a, b, **kw):
        """Each side's bytes read once, int32 order and rank and the uint8
        stream written once, the two BT totals; ~4 operations per element
        (key, rank, scatter) and ~3 per stream byte (XOR-popcount, add)."""
        pn = a.numel()
        sides = 2 if b is not None else 1
        return {
            "shape": list(a.shape) + (["paired"] if b is not None else
                                      [f"input-only {kw['input_lanes']} lanes"]),
            "ms": time_ms(lambda: psu_stream(a, b, k=4, **kw)),
            "plain_ms": time_ms(lambda: psu_stream(a, b, k=4, backend="torch", **kw)),
            "library_ms": None, "library": "none (no single PyTorch call sorts, packs and counts)",
            "bytes": pn * (sides + 8 + sides) + 8, "ops": pn * 4 + pn * sides * 3,
        }

    def axes_case(xb, vb, configs, plain):
        return {
            **axes_work(xb, vb, configs),
            "ms": time_ms(lambda: bt_count_axes(xb, None, vb, configs=configs, input_lanes=16)),
            "plain_ms": time_ms(plain, reps=3, warmup=1),
            "library_ms": None, "library": "none (no single PyTorch call sorts, codes and counts)",
        }

    def act_case(xb, vb, configs, window, plain, plain_reps=3):
        """axes_work plus per-wire activity: ~3 operations per valid row x
        wire x config (ballot, popcount, add), and the (L, C, NW, WIRES)
        toggles and (L, C, WIRES) ones written once."""
        work = axes_work(xb, vb, configs)
        nl, npk, nb = xb.shape
        lanes = 16
        nwires = lanes * 8 + max_partitions(configs, lanes)
        nw = -(-npk * (nb // lanes) // window)
        vrows = int(vb.clamp(0, npk).sum()) * (nb // lanes)
        return {
            "shape": work["shape"] + [f"windows of {window} rows"],
            "ms": time_ms(lambda: bt_count_axes(xb, None, vb, configs=configs, input_lanes=16,
                                                activity_windows=window)),
            "plain_ms": time_ms(plain, reps=plain_reps, warmup=min(plain_reps - 1, 1)),
            "library_ms": None,
            "library": "none (no single PyTorch call computes windowed per-wire toggles)",
            "bytes": work["bytes"] + nl * len(configs) * (nw + 1) * nwires * 4,
            "ops": work["ops"] + vrows * nwires * len(configs) * 3,
        }

    def quant_case(v, plain_reps=10):
        """Each float read once (4 bytes), each code written once (1 byte)
        and one float32 scale per block; ~8 float ops per element (abs,
        flush test, max, division, rint, two clamps, convert)."""
        n = v.shape[0]
        padded = n + (-n) % 256
        return {
            "shape": [n, "float32", "block 256"],
            "ms": time_ms(lambda: quantize_egress(v)),
            "plain_ms": time_ms(lambda: quantize_egress(v, backend="torch"), reps=plain_reps,
                                warmup=1),
            "library_ms": None,
            "library": "none (no single PyTorch call finds per-block scales and rounds to int8)",
            "bytes": 4 * n + padded + 4 * (padded // 256), "ops": 8 * n,
        }

    # the egress path's full-width shapes (phase 3d (ii)): psu_sort on the
    # weights' int8 view as (M / 64, 64) packets, its plain version in
    # 2**19-packet chunks as phase 3d checks it, and bt_count on one
    # 2**23-row chunk of the (M / 16, 16) wire
    w8e = int8_view(torch.randn(full_m, generator=gen, device=dev))
    pk_e = w8e[: full_m // 64 * 64].view(torch.uint8).view(-1, 64)

    def egress_sort_plain(step=1 << 19):
        for p0 in range(0, pk_e.shape[0], step):
            psu_sort(pk_e[p0: p0 + step], k=4, backend="torch")

    egress_sort = sort_case(pk_e, egress_sort_plain, plain_reps=3)
    egress_sort["shape"] += ["egress, plain in 2**19-packet chunks"]
    stream_e = tensor_flit_stream(w8e.view(torch.uint8))[: (1 << 23) + 1]
    egress_bt = bt_case(stream_e)
    egress_bt["shape"] += ["egress chunk"]

    gq = torch.from_numpy(egress_inputs()[0]).to(dev)
    gfull = torch.randn(full_m, generator=gen, device=dev)
    conv_in = torch.from_numpy(conv_streams(n_images=CODEC_COMPARE["conv_images"])[0]).to(dev)
    # the transmit path's conv input stream (Table I: 7,350 packets of 64)
    conv_tx = torch.from_numpy(conv_streams(n_images=TABLE1_CONV["images"])[0]).to(dev)
    got = psu_stream(conv_tx, None, k=4, input_lanes=16)
    ref = psu_stream(conv_tx, None, k=4, input_lanes=16, backend="torch")
    e = max(max_err(a, b) for a, b in zip(got, ref))
    if e:
        fail(f"psu_stream on the conv stream {tuple(conv_tx.shape)}: err {e} vs plain")
    log(f"conv psu_stream: {tuple(conv_tx.shape)} input-only, 16 lanes, APP k=4 bit-exact, "
        f"BT={int(got.bt_input)}")
    conv_valid = torch.tensor([conv_in.shape[0]], device=dev)
    grid = SCALE_AXES_CONFIGS[:12]  # the codec path's grid
    cases = {
        "psu_sort": (sort_case(q), sort_case(x), egress_sort),
        "bt_count": (bt_case(uslice), bt_case(big), egress_bt),
        "psu_stream": (stream_case(ui, uw), stream_case(x, w),
                       stream_case(conv_tx, None, input_lanes=16)),
        "bt_axes": (
            axes_case(conv_in[None], conv_valid, grid, lambda: bt_count_axes(
                conv_in[None], None, conv_valid, configs=grid, input_lanes=16,
                backend="torch")),
            axes_case(xa, va, SCALE_AXES_CONFIGS, axes_plain),
        ),
        "bt_axes_activity": (
            act_case(conv_in[None], conv_valid, grid, CODEC_ACTIVITY["window"], lambda: (
                bt_count_axes(conv_in[None], None, conv_valid, configs=grid, input_lanes=16,
                              backend="torch", activity_windows=CODEC_ACTIVITY["window"]))),
            act_case(xa, va, SCALE_AXES_CONFIGS, SCALE_WINDOW, act_plain, plain_reps=1),
        ),
        "quantize_egress": (quant_case(gq), quant_case(gfull, plain_reps=3)),
    }
    # the same calls split into device time (profiler) and host wall time
    kernel_names = {"psu_sort": ("psu_sort_kernel",),
                    "bt_count": ("bt_flat_kernel", "bt_rows_kernel"),
                    "psu_stream": ("psu_stream_kernel",), "bt_axes": ("bt_axes",),
                    # the activity entry's three kernels and its result's zero fill
                    "bt_axes_activity": ("bt_axes", "FillFunctor"),
                    "quantize_egress": ("quantize_egress_kernel",)}
    calls = {
        "psu_sort": (lambda: psu_sort(q, k=4), lambda: psu_sort(x, k=4),
                     lambda: psu_sort(pk_e, k=4)),
        "bt_count": (lambda: bt_count(uslice), lambda: bt_count(big),
                     lambda: bt_count(stream_e)),
        "psu_stream": (lambda: psu_stream(ui, uw, k=4), lambda: psu_stream(x, w, k=4),
                       lambda: psu_stream(conv_tx, None, k=4, input_lanes=16)),
        "bt_axes": (
            lambda: bt_count_axes(conv_in[None], None, conv_valid, configs=grid, input_lanes=16),
            lambda: bt_count_axes(xa, None, va, **akw),
        ),
        "bt_axes_activity": (
            lambda: bt_count_axes(conv_in[None], None, conv_valid, configs=grid, input_lanes=16,
                                  activity_windows=CODEC_ACTIVITY["window"]),
            lambda: bt_count_axes(xa, None, va, **wkw),
        ),
        "quantize_egress": (lambda: quantize_egress(gq), lambda: quantize_egress(gfull)),
    }
    for name, pair in cases.items():
        for case, fn in zip(pair, calls[name]):
            case["device_ms"], case["device_split"] = device_ms(fn, kernel_names[name])
            case["wall_ms"] = wall_ms(fn)
    # where bt_axes spends its time at scale: the same batch under subsets
    # of its configs (one ordering with one codec, then more), kernel and
    # fold device time each
    subsets = {
        "none/none": (CodecVariant("none", None, False, "none"),),
        "acc/none": (CodecVariant("acc", None, False, "none"),),
        "app4/none": (CodecVariant("app", 4, False, "none"),),
        "none/bus_invert": (CodecVariant("none", None, False, "bus_invert"),),
        "none/bus_invert4": (CodecVariant("none", None, False, "bus_invert", 4),),
        "codec none x 3 orderings": tuple(c for c in SCALE_AXES_CONFIGS if c.codec == "none"),
        "all but bus_invert": tuple(c for c in SCALE_AXES_CONFIGS if c.codec != "bus_invert"),
    }
    breakdown = {}
    for tag, cfgs in subsets.items():
        total, split = device_ms(lambda: bt_count_axes(xa, None, va, configs=cfgs, input_lanes=16),
                                 ("bt_axes",))
        breakdown[tag] = {"configs": len(cfgs), "device_ms": total, "device_split": split}
        log(f"time bt_axes scale subset {tag} ({len(cfgs)} configs): device_ms={total} "
            f"device_split={split}")
    cases["bt_axes"][1]["subsets"] = breakdown
    # the same for the activity entry (its fill, pair and own kernel)
    act_subsets = {tag: subsets[tag] for tag in ("none/none", "none/bus_invert",
                                                 "none/bus_invert4")}
    act_subsets["none/transition"] = (CodecVariant("none", None, False, "transition"),)
    act_subsets["all 14 configs"] = SCALE_AXES_CONFIGS
    breakdown = {}
    for tag, cfgs in act_subsets.items():
        total, split = device_ms(lambda: bt_count_axes(xa, None, va, configs=cfgs,
                                                       input_lanes=16,
                                                       activity_windows=SCALE_WINDOW),
                                 kernel_names["bt_axes_activity"])
        breakdown[tag] = {"configs": len(cfgs), "device_ms": total, "device_split": split}
        log(f"time bt_axes_activity scale subset {tag} ({len(cfgs)} configs): "
            f"device_ms={total} device_split={split}")
    cases["bt_axes_activity"][1]["subsets"] = breakdown
    for name, pair in cases.items():
        for tag, case, before in zip(("main", "scale", THIRD_CASE.get(name, "egress")), pair,
                                     BEFORE_DEVICE_MS[name]):
            case["bound_ms"], case["bound_by"] = bound(case["bytes"], case["ops"])
            head = f"time {name} {tag} {case['shape']}:"
            log(f"{head} kernel_ms={case['ms']}")
            log(f"{head} device_ms={case['device_ms']} (before: {before}) (profiler, kernels "
                f"only) wall_ms={case['wall_ms']} (host, per call)")
            log(f"{head} device_split={case['device_split']}")
            log(f"{head} bound_ms={case['bound_ms']} (by {case['bound_by']}: "
                f"{case['bytes']} bytes at 3.35 TB/s, {case['ops']} ops at 67 T/s)")
            log(f"{head} plain_ms={case['plain_ms']}")
            log(f"{head} library_ms={case['library_ms']} [{case['library']}]")
    return cases


# ------------------------------------------------------------------ main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    card = phase_card()
    errs = phase_kernels(dev)
    main_path = phase_main(dev)
    codec_path = phase_codec(dev)
    activity_path = phase_activity(dev)
    egress_path = phase_egress(dev)
    noc_path = phase_noc(dev)
    handoff: dict = {}
    serve_path = phase_serve(dev, handoff=handoff)
    train_path = phase_train(dev, handoff=handoff)
    _compare_reductions(serve_path, train_path)
    dist_path = phase_dist(dev, handoff=handoff)
    tp_path = phase_tp(dev, handoff=handoff, dist_path=dist_path)
    del handoff
    ep_path = phase_ep(dev, serve_path=serve_path, train_path=train_path)
    cp_path = phase_cp(dev)
    ssd_path = phase_ssd(dev, serve_path=serve_path, train_path=train_path)
    audio_path = phase_audio(dev, serve_path=serve_path, train_path=train_path)
    vlm_path = phase_vlm(dev, serve_path=serve_path, audio_path=audio_path)
    cases = phase_scale(dev)
    record = []
    for name, meta in KERNELS.items():
        m, s, *egress = cases[name]
        # each kernel's launches on the paths that carry it: the transmit
        # path (phase 3) and the egress path (3d) for psu_sort and
        # bt_count, the transmit path for psu_stream, the codec path for
        # bt_axes, the activity path for bt_axes_activity and the egress
        # path for quantize_egress; the NoC / DSE path (3e) for all but
        # psu_stream; the serving path (3f) for psu_sort, bt_count, bt_axes
        # and bt_axes_activity; the training path (3g) for all but
        # quantize_egress; the distribution path (3h) for psu_sort,
        # bt_count and bt_axes; the expert-parallel path (3j), the SSD
        # path (3l), the encoder-decoder path (3m) and the vlm path (3n)
        # for bt_axes
        paths = {"psu_sort": ("transmit", "egress", "noc", "serve", "train", "dist"),
                 "bt_count": ("transmit", "egress", "noc", "serve", "train", "dist"),
                 "psu_stream": ("transmit", "train"),
                 "bt_axes": ("codec", "noc", "serve", "train", "dist", "ep", "ssd", "audio",
                             "vlm"),
                 "bt_axes_activity": ("activity", "noc", "serve", "train"),
                 "quantize_egress": ("egress", "noc")}[name]
        runs = {"transmit": main_path, "codec": codec_path, "activity": activity_path,
                "egress": egress_path, "noc": noc_path, "serve": serve_path,
                "train": train_path, "dist": dist_path, "ep": ep_path, "ssd": ssd_path,
                "audio": audio_path, "vlm": vlm_path}
        by_path = {p: runs[p]["launches"][name] for p in paths}
        record.append({
            "name": name, "route": "cuda", **meta,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max([errs[name]] + [runs[p].get("max_abs_err", 0) for p in paths]),
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "shape": m["shape"], "scale_shape": s["shape"], "scale_ms": s["ms"],
            "scale_plain_ms": s["plain_ms"], "scale_bound_ms": s["bound_ms"],
            "scale_library_ms": s["library_ms"], "library": m["library"],
        })
        for e in egress:  # the egress path's full-width shape, psu_stream's conv stream
            tag = THIRD_CASE.get(name, "egress")
            record[-1].update({f"{tag}_shape": e["shape"], f"{tag}_ms": e["ms"],
                               f"{tag}_plain_ms": e["plain_ms"],
                               f"{tag}_bound_ms": e["bound_ms"],
                               f"{tag}_library_ms": e["library_ms"]})
        noc_time = noc_path["rows"]["noc/full_ring"]["times"].get(
            {"bt_axes": "bt_count_links", "psu_sort": "psu_sort"}.get(name, ""))
        if noc_time is not None:  # the full-width ring's shape (phase 3e (d))
            record[-1].update({f"noc_{k}": v for k, v in noc_time.items()})
        if name == "bt_axes":  # the served weight stream's shape (phase 3f (b))
            record[-1].update({f"serve_{k}": v for k, v in
                               serve_path["rows"]["serve/full"]["bt_axes"].items()})
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps({
        "card": card, "kernels": record, "main_path": main_path, "codec_path": codec_path,
        "activity_path": activity_path, "egress_path": egress_path, "noc_path": noc_path,
        "serve_path": serve_path, "train_path": train_path, "dist_path": dist_path,
        "tp_path": tp_path, "ep_path": ep_path, "cp_path": cp_path, "ssd_path": ssd_path,
        "audio_path": audio_path, "vlm_path": vlm_path, "scale_cases": cases,
        "seconds": time.perf_counter() - t0,
    }, indent=1, default=str))
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card["name"],
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
