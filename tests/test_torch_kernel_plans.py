"""The CUDA kernels' host-side launch plans (``csrc/plan.h``), built with the
host C++ compiler and checked on the CPU: the contiguous ``bt_count`` plan
reads every compared element once and nothing past the stream, the strided
plan's vectors fit every row, the activity kernel's shared memory fits
a block at every blocking ``axes_blocking`` gives, and the ``psu_stream``
tile plan covers every packet once with aligned spans, fits a block and
spreads the transmit path's batches over every SM."""

import ctypes
import math
import shutil
import subprocess

import pytest

from repro_torch.kernels.axes import axes_blocking
from repro_torch.kernels.psu import MAX_N
from torch_groups import torch_threads  # noqa: F401

PLAN_H = "src/repro_torch/kernels/csrc"
SHIM = r"""
#include "plan.h"
extern "C" {
void flat(unsigned long long base, long long rows, long long lanes, long long isz, long long* o) {
  const repro::FlatPlan p = repro::flat_plan(base, rows, lanes, isz);
  o[0] = p.ncmp; o[1] = p.head; o[2] = p.nw; o[3] = p.tail; o[4] = p.pw; o[5] = p.r;
}
void rows(unsigned long long base, long long lanes, long long stride, long long isz,
          int threads, int* o) {
  const repro::RowsPlan p = repro::rows_plan(base, lanes, stride, isz, threads);
  o[0] = p.v; o[1] = p.nv; o[2] = p.gl;
}
void act(int bpk, int flits, int lanes, int n, int paired, int isz, int pmax, int min_cells,
         int cell_bytes, long long* o) {
  const repro::ActSmem a = repro::act_smem(bpk, flits, lanes, n, paired, isz, pmax, min_cells,
                                           cell_bytes);
  o[0] = (long long)a.bytes; o[1] = a.ncells;
  o[2] = (long long)repro::image_words_bytes(bpk, flits, lanes);
}
void stream(long long P, int n, int isz, int il, int wl, int warps, int sms, long long* o) {
  const repro::StreamPlan p = repro::stream_plan(P, n, isz, il, wl, warps, sms);
  o[0] = p.q; o[1] = p.tp; o[2] = p.tiles; o[3] = (long long)p.stage; o[4] = (long long)p.pad;
  o[5] = (long long)p.image; o[6] = (long long)p.wbuf; o[7] = (long long)p.smem;
  o[8] = (long long)p.head;
}
int tiles_per_sm() { return repro::STREAM_TILES_PER_SM; }
}
"""
THREADS = 256
ACT_CELLS, INV_CELL_BYTES = 512, 16  # csrc/axes.cu
SMEM_BLOCK = 232_448  # shared memory one block can have on the H100
ACT_STATIC = 5_120  # the activity kernel's static shared memory (ptxas)
WARPS = 8  # csrc/common.cuh
STREAM_STATIC = 5_200  # psu_stream_kernel's static shared memory (ptxas)
SMS = 132


@pytest.fixture(scope="module")
def plans(tmp_path_factory, request):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build csrc/plan.h")
    d = tmp_path_factory.mktemp("plans")
    (d / "shim.cpp").write_text(SHIM)
    root = request.config.rootpath
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(root / PLAN_H),
                    "-o", str(d / "libplans.so"), str(d / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "libplans.so"))
    ll, i = ctypes.c_longlong, ctypes.c_int
    lib.flat.argtypes = [ctypes.c_ulonglong, ll, ll, ll, ctypes.POINTER(ll)]
    lib.rows.argtypes = [ctypes.c_ulonglong, ll, ll, ll, i, ctypes.POINTER(i)]
    lib.act.argtypes = [i] * 9 + [ctypes.POINTER(ll)]
    lib.stream.argtypes = [ll, i, i, i, i, i, i, ctypes.POINTER(ll)]
    lib.tiles_per_sm.restype = i
    return lib


@pytest.mark.parametrize("isz", [1, 4])
def test_flat_plan_reads_each_element_once_inside_the_stream(plans, isz):
    out = (ctypes.c_longlong * 6)()
    for off in range(0, 16, isz):
        base = 4096 + off
        for lanes in (1, 2, 3, 4, 5, 7, 8, 12, 15, 16, 17, 24, 33, 100, 100_003):
            for rows in (2, 3, 5, 64):
                plans.flat(base, rows, lanes, isz, out)
                ncmp, head, nw, tail, pw, r = out
                what = (off, lanes, rows)
                assert ncmp == (rows - 1) * lanes
                # the element ranges [0, head), nw words, [tail, ncmp) tile [0, ncmp)
                assert 0 <= head <= ncmp and tail == head + nw * 16 // isz <= ncmp, what
                assert head * isz < 16 or head == ncmp, what
                assert pw * 16 + r == lanes * isz and 0 <= r < 16, what
                if nw:
                    assert (base + head * isz) % 16 == 0, what
                    # the last word's partner window ends inside the stream
                    last = base + head * isz + 16 * (nw - 1 + pw + (2 if r else 1))
                    assert last <= base + rows * lanes * isz, what
                # at most two words' worth of bytes are left to the element loop
                assert (ncmp - tail) * isz < 32, what


@pytest.mark.parametrize("isz", [1, 4])
def test_rows_plan_vectors_fit_every_row(plans, isz):
    out = (ctypes.c_int * 3)()
    for off in range(0, 16, isz):
        base = 4096 + off
        for lanes in (1, 2, 3, 4, 7, 8, 12, 16, 24, 100, 100_003):
            for stride in (lanes + 1, lanes + 3, 2 * lanes, 16 * (lanes // 16 + 1)):
                plans.rows(base, lanes, stride, isz, THREADS, out)
                v, nv, gl = out
                lb = lanes * isz
                fits = [c for c in (16, 8, 4)
                        if c <= lb and base % c == 0 and stride * isz % c == 0]
                assert v == (fits[0] if fits else 0), (off, lanes, stride)
                assert nv == (lb // v if v else 0)
                units = nv + (lb - nv * v) // isz  # loads per row pair
                assert (1 << gl) >= min(units, THREADS) and (gl == 0 or (1 << (gl - 1)) < units)


def test_activity_shared_memory_fits_a_block(plans):
    """Every packet size, lane split, pairing, element size and partition
    count the measurement takes, at the blocking the wrapper picks for a
    small and a large batch: image, staged packets and bus-invert cells fit
    one block, and one config's cells always fit a batch."""
    out = (ctypes.c_longlong * 3)()
    worst = 0
    for n in (1, 2, 8, 16, 24, 32, 64, 100, 256, 1000, MAX_N):
        for il in sorted({d for d in (1, 2, 4, 8, 16, 32, n) if n % d == 0}):
            for paired in (0, 1):
                lanes = il * (2 if paired else 1)
                flits = n // il
                for links, p in ((1, 7), (256, 16_384)):
                    bpk, _ = axes_blocking(links, p, flits, lanes, 5, 132)
                    steps = -(-bpk * flits // 32)
                    for isz in (1, 4):
                        for pmax in sorted({1, min(4, lanes), lanes}):
                            plans.act(bpk, flits, lanes, n, paired, isz, pmax, ACT_CELLS,
                                      INV_CELL_BYTES, out)
                            smem, ncells, image = out
                            staged = (-(-bpk * n // 16) * 16) * (2 if paired else 1)
                            assert ncells >= pmax * steps and ncells >= ACT_CELLS
                            assert smem >= image + ncells * INV_CELL_BYTES
                            assert smem >= image + (staged if isz == 1 else 0)
                            worst = max(worst, smem)
    assert worst + ACT_STATIC <= SMEM_BLOCK, worst


def _stream_plan(plans, p, n, isz, il, wl, sms):
    out = (ctypes.c_longlong * 9)()
    plans.stream(p, n, isz, il, wl, WARPS, sms, out)
    return dict(zip(("q", "tp", "tiles", "stage", "pad", "image", "wbuf", "smem", "head"), out))


@pytest.mark.parametrize("isz", [1, 4])
@pytest.mark.parametrize("paired", [0, 1])
def test_stream_plan_tiles_every_packet_once_aligned_and_fits_a_block(plans, isz, paired):
    """Every N from 1 to 1,024 (input lanes 1, a small divisor and N), small
    and large batches, with and without the cut to the SMs: the tiles
    cover [0, P) once, each tile's spans in x, w, order / rank and the
    stream start on 16-byte boundaries, the packet before a tile is staged
    from a 16-byte boundary inside x, and one block's shared memory (two
    stages of each side, the boundary row, the image, the order rows) fits
    the card's per-block limit."""
    worst = 0
    for n in range(1, 1025):
        for il in sorted({1, min(d for d in (2, 3, 4, 5, 8, n) if n % d == 0), n}):
            wl = il if paired else 0
            lanes = il + wl
            for p in (1, 7, 1_003, 4_194_304):
                for sms in (0, SMS, 8):
                    plan = _stream_plan(plans, p, n, isz, il, wl, sms)
                    what = (n, il, p, sms)
                    tp, tiles = plan["tp"], plan["tiles"]
                    assert tp >= 1 and tp % plan["q"] == 0, what
                    assert (tiles - 1) * tp < p <= tiles * tp, what
                    # tile t starts at packet t * tp: element t * tp * n
                    for b in (isz, 4, lanes // il):  # x and w, order and rank, stream
                        assert tp * n * b % 16 == 0, (what, b)
                    # a stage: the head (16-byte words ending with the packet
                    # before the tile, copied from x + tile start - head, which
                    # lies inside x for every tile after the first) and the tile
                    assert plan["head"] == -(-n * isz // 16) * 16 <= tp * n * isz, what
                    assert plan["stage"] >= plan["head"] + tp * n * isz
                    assert plan["stage"] % 16 == 0
                    assert plan["pad"] >= lanes and plan["pad"] % 16 == 0
                    assert plan["image"] >= tp * n * lanes // il and plan["image"] % 16 == 0
                    assert plan["wbuf"] == (WARPS * n * 4 if n > 32 else 0)
                    assert plan["smem"] == (2 * plan["stage"] * (2 if wl else 1) + plan["pad"]
                                            + plan["image"] + plan["wbuf"])
                    if sms == 0:  # the largest tile: at most 8 KB of x unless a quantum
                        assert tp * n * isz <= 8192 or tp == plan["q"], what
                    worst = max(worst, plan["smem"])
    assert worst + STREAM_STATIC <= SMEM_BLOCK, worst


@pytest.mark.parametrize("p,n,il,wl", [(100_000, 32, 8, 8), (7_350, 64, 16, 0),
                                       (4_194_304, 32, 8, 8), (1_003, 25, 5, 5)])
def test_stream_plan_spreads_the_transmit_batches_over_every_sm(plans, p, n, il, wl):
    """The transmit path's batches (Table I's 100,000 paired packets, the
    conv streams' 7,350 packets of 64 bytes) are cut, for an H100's 132 SMs
    and smaller cards, into tiles that leave no SM more than
    STREAM_TILES_PER_SM of them, the tile being the smallest aligned one
    that allows that — so no SM idles and none walks more tiles than the
    others; the scale batch keeps its 8 KB tiles, many an SM."""
    per_sm = plans.tiles_per_sm()
    assert per_sm >= 1
    full = _stream_plan(plans, p, n, 1, il, wl, 0)
    for sms in (SMS, 114, 78, 16):
        plan = _stream_plan(plans, p, n, 1, il, wl, sms)
        tp, q = plan["tp"], plan["q"]
        assert plan["tiles"] == math.ceil(p / tp)
        if tp == full["tp"]:  # the batch is large enough for full tiles
            assert plan["tiles"] >= per_sm * sms, (sms, plan)
            continue
        assert plan["tiles"] <= per_sm * sms, (sms, plan)
        assert tp == q or math.ceil(p / (tp - q)) > per_sm * sms, (sms, plan)
        if q == 1:  # the transmit path's packets: every SM gets its share
            assert plan["tiles"] > per_sm * sms * (tp - 1) / tp, (sms, plan)
