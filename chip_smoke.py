#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's transmit, codec, activity, egress and NoC / DSE paths on one NVIDIA GPU.

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
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks.datagen import conv_streams, im2col, synth_images, uniform_pairs  # noqa: E402
from repro_torch import dse, kernels, noc, obs  # noqa: E402
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import quantize_egress  # noqa: E402
from repro_torch.kernels.axes import max_partitions  # noqa: E402
from repro_torch.noc.fabric import _queue_gather_table  # noqa: E402
from repro_torch.link import LinkPowerModel, LinkSpec, TxPipeline  # noqa: E402
from repro_torch.traffic import (  # noqa: E402
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

    def axes_work(xb, vb, configs):
        """Bytes: each valid packet byte read once, valid counts and totals.
        Operations: per valid byte ~4 per distinct sorted ordering (key,
        rank, scatter) and ~3 per config (code, XOR-popcount, add)."""
        nl, npk, nb = xb.shape
        vbytes = int(vb.clamp(0, npk).sum()) * nb
        sorted_orderings = {c.ordering for c in configs if c.key in ("acc", "app")}
        return {
            "shape": [nl, npk, nb, "input-only 16 lanes", f"{len(configs)} configs"],
            "bytes": vbytes + nl * 8 + nl * len(configs) * 12,
            "ops": vbytes * (4 * len(sorted_orderings) + 3 * len(configs)),
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
    cases = phase_scale(dev)
    record = []
    for name, meta in KERNELS.items():
        m, s, *egress = cases[name]
        # each kernel's launches on the paths that carry it: the transmit
        # path (phase 3) and the egress path (3d) for psu_sort and
        # bt_count, the transmit path for psu_stream, the codec path for
        # bt_axes, the activity path for bt_axes_activity and the egress
        # path for quantize_egress; the NoC / DSE path (3e) for all but
        # psu_stream
        paths = {"psu_sort": ("transmit", "egress", "noc"),
                 "bt_count": ("transmit", "egress", "noc"), "psu_stream": ("transmit",),
                 "bt_axes": ("codec", "noc"), "bt_axes_activity": ("activity", "noc"),
                 "quantize_egress": ("egress", "noc")}[name]
        runs = {"transmit": main_path, "codec": codec_path, "activity": activity_path,
                "egress": egress_path, "noc": noc_path}
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
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps({
        "card": card, "kernels": record, "main_path": main_path, "codec_path": codec_path,
        "activity_path": activity_path, "egress_path": egress_path, "noc_path": noc_path,
        "scale_cases": cases,
        "seconds": time.perf_counter() - t0,
    }, indent=1, default=str))
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card["name"],
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
