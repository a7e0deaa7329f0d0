"""The multi-axis BT core: plain PyTorch versions and the CUDA kernels'
wrappers.

Replaces ``repro/kernels/axes.py:bt_axes_pallas`` (body
``_bt_axes_kernel`` -> ``_axes_block``, bus-invert states
``_bus_invert_bits``) together with the inter-block fold
``repro/kernels/ops.py:_fold_axes``, in all of its modes:

* **the fused transmit stream** (``emit_stream``): one link, one uncoded
  'acc'/'app' config.  The CUDA kernel (``csrc/stream.cu``,
  ``psu_stream_kernel``) runs popcount -> bucket -> rank -> reorder ->
  flit-pack -> (input, weight) BT in one launch.  Persistent blocks walk
  tiles of whole packets (``csrc/plan.h`` ``stream_plan``: 16-byte aligned
  spans, at most 8 KB of inputs, small batches cut to spread over every
  SM); each tile's inputs and weights, with the packet before the
  tile, arrive by bulk asynchronous copy into a two-stage shared-memory
  ring one tile ahead.  The warps rank the tile's packets from the keys'
  bit-plane ballots (several packets a warp for N <= 32) and scatter each
  byte straight into its flit cell of a shared-memory image of the whole
  tile (integer addressing — no float permutation product, whose TF32
  form would round payloads above 2**11); the image goes out with 16-byte
  stores and its BT is counted in 32-bit words with per-word input/weight
  byte masks, the first row against the last flit of the packet before
  the tile, which one warp re-ranks.  Bound by bytes on the H100: each
  side's packets read once, int32 order and rank and the uint8 stream
  written once.
* **the jagged link x ordering x codec measurement** (``bt_axes``): an
  (L, P, N) batch with a real packet count per link, every (ordering,
  codec) config of a static tuple, bus-invert included, giving (L, C, 3)
  (input, weight, invert-line) BT totals and the carry that chunked
  streaming threads from one call to the next.  The CUDA kernels
  (``csrc/axes.cu``, ``bt_axes_kernel`` then ``bt_axes_fold_kernel``) are
  described there.
* **its per-wire activity windows** (``bt_axes_activity``): the same
  measurement that also adds every wire's toggles per window of flit rows
  and its rows at level 1 into (L, C, NW, WIRES) / (L, C, WIRES) sums
  (:class:`ActivityOut`).  The CUDA entry runs the two kernels above, the
  fold recording each block's entry state, then ``bt_axes_activity_kernel``
  reruns each block from that state (``csrc/axes.cu``); it has its own
  launch counter.

The plain version of the measurement, :func:`bt_axes_plain`, is written
independently of the kernel's block + fold split: per link it orders,
packs and codes the whole stream and counts every boundary below the
link's valid rows, with bus-invert's sequential decision in closed form
(:func:`bus_invert_lines`); its activity is the per-row wire bits of that
whole stream summed per window.  Every count is on the low 8 bits of each
lane, as in the reference: sort keys read ``width`` bits of the payload,
wires carry bytes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..core.bt import wrap_int32
from ..core.coding import (
    bus_invert_partitions,
    gray_encode_bytes,
    sign_magnitude_encode_bytes,
)
from ._build import DTYPE_CODES, check, library
from .btcount import bt_count_plain
from .psu import MAX_N, _popcount_bits, _rank_block, check_key

__all__ = [
    "Variant",
    "CodecVariant",
    "VARIANT_KEYS",
    "CODEC_SCHEMES",
    "validate_variants",
    "validate_codec_variants",
    "max_partitions",
    "validate_stream_call",
    "validate_axes_call",
    "bus_invert_lines",
    "psu_stream_plain",
    "psu_stream_cuda",
    "axes_carry",
    "axes_blocking",
    "ActivityOut",
    "bt_axes_plain",
    "bt_axes_cuda",
    "bt_axes_activity_cuda",
]

VARIANT_KEYS = ("none", "column_major", "acc", "app")

CODEC_SCHEMES = ("none", "gray", "sign_magnitude", "transition", "bus_invert")


class Variant(NamedTuple):
    """One ordering configuration: key ('none' | 'column_major' | 'acc' |
    'app'), the APP bucket count k (None otherwise) and the direction."""

    key: str = "acc"
    k: int | None = None
    descending: bool = False


class CodecVariant(NamedTuple):
    """One measured (ordering, codec) configuration: the ordering axes of
    :class:`Variant`, a scheme of ``CODEC_SCHEMES`` and, for 'bus_invert',
    the partition width in lanes (None = one invert line per flit)."""

    key: str = "acc"
    k: int | None = None
    descending: bool = False
    codec: str = "none"
    partition: int | None = None

    @property
    def ordering(self) -> Variant:
        return Variant(self.key, self.k, self.descending)


def validate_variants(variants: tuple[Variant, ...], width: int) -> tuple[Variant, ...]:
    """Check a variant tuple against the kernel's contract."""
    if not variants:
        raise ValueError("need at least one variant")
    out = []
    for v in variants:
        v = Variant(*v)
        if v.key not in VARIANT_KEYS:
            raise ValueError(f"unknown variant key {v.key!r}; choose from {VARIANT_KEYS}")
        if v.key == "app":
            if v.k is None or not 1 <= v.k <= width + 1:
                raise ValueError(f"variant {v}: 'app' needs k in [1, {width + 1}]")
        elif v.k is not None:
            raise ValueError(f"variant {v}: k is only meaningful for 'app'")
        if v.descending and v.key not in ("acc", "app"):
            raise ValueError(f"variant {v}: descending applies to sorted keys only")
        out.append(v)
    return tuple(out)


def validate_codec_variants(
    configs: tuple[CodecVariant, ...], width: int, lanes: int
) -> tuple[CodecVariant, ...]:
    """Check a config tuple against the measurement's contract."""
    if not configs:
        raise ValueError("need at least one codec config")
    out = []
    for cfg in configs:
        cfg = CodecVariant(*cfg)
        validate_variants((cfg.ordering,), width)
        if cfg.codec not in CODEC_SCHEMES:
            raise ValueError(
                f"config {cfg}: unknown codec scheme {cfg.codec!r}; choose from {CODEC_SCHEMES}"
            )
        if cfg.codec == "bus_invert":
            bus_invert_partitions(lanes, cfg.partition)
        elif cfg.partition is not None:
            raise ValueError(f"config {cfg}: partition is only meaningful for 'bus_invert'")
        out.append(cfg)
    return tuple(out)


def max_partitions(configs: tuple[CodecVariant, ...], lanes: int) -> int:
    """Invert-line slots the per-config outputs must provide (>= 1)."""
    return max(
        [1] + [bus_invert_partitions(lanes, c.partition)[0]
               for c in configs if c.codec == "bus_invert"]
    )


def validate_stream_call(
    n: int, *, config: CodecVariant, width: int, input_lanes: int,
    weight_lanes: int, pack: str,
) -> None:
    """The emit-stream contract: the measurement's (:func:`validate_axes_call`)
    with one uncoded 'acc'/'app' config."""
    (cfg,), _ = validate_axes_call(
        n, configs=(config,), width=width, input_lanes=input_lanes,
        weight_lanes=weight_lanes, split_lanes=None, pack=pack,
    )
    if cfg.codec != "none" or cfg.key not in ("acc", "app"):
        raise ValueError(f"the fused stream needs one uncoded 'acc'/'app' config, got {config}")


def _flit(values: torch.Tensor, lanes: int, pack: str) -> torch.Tensor:
    """(P, N) sorted payloads -> (P, F, lanes) flit halves."""
    p, n = values.shape
    if pack == "lane":
        return values.reshape(p, lanes, n // lanes).transpose(1, 2)
    return values.reshape(p, n // lanes, lanes)


def psu_stream_plain(
    x: torch.Tensor, w: torch.Tensor, *, width: int, k: int | None,
    descending: bool, input_lanes: int, weight_lanes: int, pack: str,
):
    """(order, rank, stream, bt_input, bt_weight) of (P, N) paired packets.

    ``weight_lanes == 0`` frames the inputs alone (``w`` is ignored).
    The stream is (P*F, lanes) uint8; BT is int32 over every flit boundary.
    """
    x = x.to(torch.int32)
    rank = _rank_block(x, width=width, k=k, descending=descending)
    order = torch.argsort(rank, dim=-1, stable=True)
    halves = [_flit(torch.gather(x, -1, order), input_lanes, pack)]
    if weight_lanes:
        ws = torch.gather(w.to(torch.int32), -1, order)
        halves.append(_flit(ws, weight_lanes, pack))
    p, n = x.shape
    lanes = input_lanes + weight_lanes
    stream = (torch.cat(halves, dim=-1).reshape(p * (n // input_lanes), lanes) & 0xFF)
    stream = stream.to(torch.uint8)
    bt_in = bt_count_plain(stream[:, :input_lanes], width=8)
    bt_w = bt_count_plain(stream[:, input_lanes:], width=8)
    return order.to(torch.int32), rank, stream, bt_in, bt_w


def psu_stream_cuda(
    x: torch.Tensor, w: torch.Tensor | None, *, width: int, k: int | None,
    descending: bool, input_lanes: int, weight_lanes: int, pack: str,
):
    """The same five outputs from the CUDA kernel, one launch.  ``x`` and
    ``w`` are contiguous uint8 or int32 (P, N) packets of one dtype on a
    CUDA device (``w`` may be None when ``weight_lanes == 0``)."""
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"psu_stream_cuda needs contiguous (P, N) packets, got {tuple(x.shape)}")
    if weight_lanes:
        if w is None or w.shape != x.shape or w.dtype != x.dtype:
            raise ValueError("psu_stream_cuda needs weights shaped and typed like the inputs")
        if w.device != x.device or not w.is_contiguous():
            raise ValueError("psu_stream_cuda needs contiguous weights on the inputs' device")
    p, n = x.shape
    if not 1 <= n <= MAX_N:
        raise ValueError(f"psu_stream_cuda takes 1 <= N <= {MAX_N}, got N={n}")
    config = CodecVariant("acc" if k is None else "app", k, descending)
    validate_stream_call(
        n, config=config, width=width, input_lanes=input_lanes,
        weight_lanes=weight_lanes, pack=pack,
    )
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"psu_stream_cuda takes uint8 or int32 packets, got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"psu_stream_cuda needs CUDA tensors, got {x.device}")
    flits, lanes = n // input_lanes, input_lanes + weight_lanes
    order = torch.empty((p, n), dtype=torch.int32, device=x.device)
    rank = torch.empty_like(order)
    stream = torch.empty((p * flits, lanes), dtype=torch.uint8, device=x.device)
    bt = torch.zeros(2, dtype=torch.int32, device=x.device)
    if p > 0:
        with torch.cuda.device(x.device):
            err = library().repro_psu_stream(
                x.data_ptr(), w.data_ptr() if weight_lanes else None,
                DTYPE_CODES[x.dtype], p, n, width, 0 if k is None else k,
                int(descending), input_lanes, weight_lanes, int(pack == "row"),
                order.data_ptr(), rank.data_ptr(), stream.data_ptr(),
                bt.data_ptr(), torch.cuda.current_stream().cuda_stream,
            )
        check(err, "repro_psu_stream")
        psu_stream_cuda.launches += 1
    return order, rank, stream, bt[0], bt[1]


psu_stream_cuda.launches = 0


# --------------------------------------------------------------------------
# the jagged link x ordering x codec measurement

_KEY_IDS = {name: i for i, name in enumerate(VARIANT_KEYS)}
_CODEC_IDS = {name: i for i, name in enumerate(CODEC_SCHEMES)}
# shared-memory flit image of one CUDA block: packets per block are cut to
# fit it (at most AXES_BLOCK_PACKETS)
AXES_IMAGE_BYTES = 16384
AXES_BLOCK_PACKETS = 128


def axes_blocking(links: int, p: int, flits: int, lanes: int, orderings: int,
                  sms: int) -> tuple[int, int]:
    """(packets per block, blocks per link) of the measurement kernels.

    A block's image holds its packets' ``flits`` rows of ``lanes`` bytes,
    each row padded to an odd number of 32-bit words, in
    ``AXES_IMAGE_BYTES``, and at most ``AXES_BLOCK_PACKETS`` packets; a
    small batch then halves the packets per block until its (links x
    blocks, orderings) grid gives the card's ``sms`` SMs at least two blocks
    each (or one packet per block).
    """
    row = 4 * (-(-lanes // 4) | 1)
    bpk = max(1, min(AXES_BLOCK_PACKETS, AXES_IMAGE_BYTES // (flits * row)))
    while bpk > 1 and links * -(-p // bpk) * orderings < 2 * sms:
        bpk = -(-bpk // 2)
    return bpk, -(-p // bpk)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=64)
def _config_table(configs, lanes: int, device: torch.device) -> tuple[torch.Tensor, int]:
    """The kernels' int32 table on ``device`` — each distinct ordering as
    (key, k, descending), then each config as (ordering index, codec,
    partitions, lanes per partition), then per ordering (stateless codec
    bits, offset and count of its stateless configs, offset and count of
    its bus-invert (config, partition) items) and those two lists — and the
    number of orderings.  Kept per (configs, lanes, device): a fresh copy
    from pageable host memory would wait for the stream on every call."""
    orderings: list[Variant] = []
    rows = []
    for cfg in configs:
        if cfg.ordering not in orderings:
            orderings.append(cfg.ordering)
        npart, pw = (
            bus_invert_partitions(lanes, cfg.partition) if cfg.codec == "bus_invert" else (1, lanes)
        )
        rows += [orderings.index(cfg.ordering), _CODEC_IDS[cfg.codec], npart, pw]
    head = [f for o in orderings for f in (_KEY_IDS[o.key], o.k or 0, int(o.descending))]
    stateless = [[c for c, cfg in enumerate(configs)
                  if cfg.ordering == o and cfg.codec != "bus_invert"] for o in orderings]
    items = [[(c, q) for c, cfg in enumerate(configs) if cfg.ordering == o
              and cfg.codec == "bus_invert" for q in range(rows[4 * c + 2])] for o in orderings]
    base = len(head) + len(rows) + 5 * len(orderings)
    recs, lists = [], []
    for sl, it in zip(stateless, items):
        need = sum({1 << _CODEC_IDS[configs[c].codec] for c in sl})
        recs += [need, base + len(lists), len(sl)]
        lists += sl
        recs += [base + len(lists), len(it)]
        lists += [v for pair in it for v in pair]
    table = head + rows + recs + lists
    return torch.tensor(table, dtype=torch.int32).to(device), len(orderings)


def validate_axes_call(
    n: int, *, configs, width: int, input_lanes: int, weight_lanes: int,
    split_lanes: int | None, pack: str,
) -> tuple[tuple[CodecVariant, ...], int]:
    """The measurement's contract for packets of ``n`` elements; returns
    the checked configs and the resolved ``split_lanes``."""
    if input_lanes < 1 or n % input_lanes != 0:
        raise ValueError(f"packet size {n} not divisible by input_lanes={input_lanes}")
    if weight_lanes not in (0, input_lanes):
        raise ValueError(
            "the multi-axis measurement needs a symmetric (or absent) weight side: "
            f"weight_lanes={weight_lanes} vs input_lanes={input_lanes}"
        )
    if pack not in ("lane", "row"):
        raise ValueError(f"the multi-axis measurement packs 'lane'|'row', got {pack!r}")
    lanes = input_lanes + weight_lanes
    configs = validate_codec_variants(tuple(configs), width, lanes)
    for cfg in configs:
        if cfg.key in ("acc", "app"):
            check_key(width, cfg.k)
    split_lanes = input_lanes if split_lanes is None else split_lanes
    if not 0 <= split_lanes <= lanes:
        raise ValueError(f"split_lanes={split_lanes} outside the {lanes}-lane flit")
    return configs, split_lanes


def bus_invert_lines(hd: torch.Tensor, lbits: int, entry: torch.Tensor) -> torch.Tensor:
    """Invert-line states of a bus-invert wire, (..., T, P) int32.

    ``hd`` (..., T-1, P) holds the data Hamming distances between
    consecutive flits of each of P partitions of ``lbits`` wires, ``entry``
    (..., P) the state of row 0.  The sequential rule — invert iff that
    lowers the distance to the previous *wire* flit, ties uninverted — is
    v_t = tie_t ? 0 : h_t ^ v_{t-1} with h_t = [2 HD_t > lbits] and tie_t =
    [2 HD_t == lbits]: a prefix-XOR that resets at ties, here one cumsum
    and one cummax (``repro/kernels/axes.py:_bus_invert_bits``).
    """
    h = (2 * hd > lbits).to(torch.int64)
    xpre = torch.cumsum(h, dim=-2) & 1  # h_1 ^ ... ^ h_t
    tpos = torch.arange(1, hd.shape[-2] + 1, device=hd.device).unsqueeze(-1)
    packed = torch.where(2 * hd == lbits, 2 * tpos + xpre, 0)  # (t, X_t) at ties
    cmax = torch.cummax(packed, dim=-2).values  # the most recent tie
    xr = torch.where(cmax > 0, cmax & 1, 0)
    entry = entry.to(torch.int64).unsqueeze(-2)
    # until the first tie the entry state still propagates
    rest = xpre ^ xr ^ (entry * (cmax == 0))
    return torch.cat([entry, rest], dim=-2).to(torch.int32)


def axes_carry(
    links: int, configs, lanes: int, device, activity: bool = False
) -> dict[str, torch.Tensor]:
    """The zero carry between calls: nothing transmitted yet on any link.

    ``started`` (L,) marks links that sent a flit, ``wire`` (C, L, lanes)
    holds each config's last wire flit (the last data flit for
    'transition') and ``inv`` (C, L, PMAX) its last invert-line states;
    with ``activity`` also ``parity`` (C, L, lanes*8), each wire's level
    under 'transition' signaling (the running parity of its data bit).
    All int32.
    """
    c, pmax = len(configs), max_partitions(configs, lanes)
    carry = {
        "started": torch.zeros(links, dtype=torch.int32, device=device),
        "wire": torch.zeros((c, links, lanes), dtype=torch.int32, device=device),
        "inv": torch.zeros((c, links, pmax), dtype=torch.int32, device=device),
    }
    if activity:
        carry["parity"] = torch.zeros((c, links, lanes * 8), dtype=torch.int32, device=device)
    return carry


class ActivityOut(NamedTuple):
    """Where one call of the measurement adds its per-wire activity.

    ``toggles`` (L, C, NW, WIRES) and ``ones`` (L, C, WIRES) are int32
    sums the call adds into in place; WIRES is lanes*8 data wires (wire =
    lane*8 + bit, LSB first) then PMAX invert lines.  The toggle at the
    boundary into global flit row r counts in window r // ``window_rows``;
    ``base_row`` is the global row of this call's first row (chunked calls
    land every toggle in the window of its global row).
    """

    toggles: torch.Tensor
    ones: torch.Tensor
    window_rows: int
    base_row: int = 0


def _bits8(b: torch.Tensor) -> torch.Tensor:
    """(..., K) bytes -> (..., K*8) 0/1 int32 wire bits, LSB first."""
    bits = (b.to(torch.int32).unsqueeze(-1) >> torch.arange(8, device=b.device)) & 1
    return bits.reshape(*b.shape[:-1], b.shape[-1] * 8)


def _add_windows(out: torch.Tensor, rows: torch.Tensor, base: int, w: int) -> None:
    """Add (L, T, K) per-row counts of global rows base .. base+T-1 into
    their windows of ``out`` (L, NW, K)."""
    links, t, k = rows.shape
    off = base % w
    nwin = -(-(off + t) // w)
    padded = torch.zeros((links, nwin * w, k), dtype=torch.int32, device=rows.device)
    padded[:, off: off + t] = rows
    out[:, base // w: base // w + nwin] += padded.reshape(links, nwin, w, k).sum(2, dtype=torch.int32)


def _ordered_stream(x, w, ordering: Variant, *, width, input_lanes, weight_lanes, pack):
    """(L, P*F, lanes) int32 low bytes of every link's packed stream."""
    links, p, n = x.shape
    flat = x.reshape(links * p, n)
    if ordering.key in ("acc", "app"):
        rank = _rank_block(flat, width=width, k=ordering.k, descending=ordering.descending)
        order = torch.argsort(rank, dim=-1, stable=True)
    elif ordering.key == "column_major":  # slot l*F + f carries element f*L + l
        i = torch.arange(n, device=x.device)
        order = ((i % (n // input_lanes)) * input_lanes + i // (n // input_lanes)).expand(
            links * p, n
        )
    else:
        order = None
    halves = []
    for side, lanes in ((x, input_lanes), (w, weight_lanes)):
        if lanes:
            v = side.reshape(links * p, n)
            halves.append(_flit(v if order is None else torch.gather(v, -1, order), lanes, pack))
    stream = torch.cat(halves, dim=-1) & 0xFF
    return stream.reshape(links, p * (n // input_lanes), input_lanes + weight_lanes)


def _sides(per_lane: torch.Tensor, split: int) -> torch.Tensor:
    """(L, lanes) counts -> (L, 2) input-side and weight-side sums."""
    return torch.stack([per_lane[:, :split].sum(-1), per_lane[:, split:].sum(-1)], dim=-1)


_BYTE_MAPS = {
    "none": lambda s: s,
    "gray": gray_encode_bytes,
    "sign_magnitude": sign_magnitude_encode_bytes,
}


def bt_axes_plain(
    x: torch.Tensor, w: torch.Tensor | None, valid: torch.Tensor, *, configs,
    width: int, input_lanes: int, weight_lanes: int, split_lanes: int | None, pack: str,
    carry: dict | None = None, activity: ActivityOut | None = None,
) -> tuple[torch.Tensor, dict]:
    """(totals, carry) of an (L, P, N) batch: int32 (L, C, 3) (input-side,
    weight-side, invert-line) BT per link and config.

    Each link sends its first ``valid[l]`` packets (clamped to [0, P]);
    rows past them count nothing.  ``carry`` (see :func:`axes_carry`;
    default: a cold start) is the state left by the previous call on the
    same links, and the returned carry continues from this one.  ``w`` is
    ignored when ``weight_lanes`` is 0.  With ``activity`` the call also
    adds every wire's toggles per window and its rows at level 1 into
    ``activity``'s tensors (the carry then needs ``parity``).
    """
    links, p, n = x.shape
    configs, split = validate_axes_call(
        n, configs=configs, width=width, input_lanes=input_lanes,
        weight_lanes=weight_lanes, split_lanes=split_lanes, pack=pack,
    )
    flits, lanes = n // input_lanes, input_lanes + weight_lanes
    pmax = max_partitions(configs, lanes)
    dev = x.device
    if carry is None:
        carry = axes_carry(links, configs, lanes, dev, activity=activity is not None)
    x = x.to(torch.int32)
    w = w.to(torch.int32) if weight_lanes else None
    vr = torch.as_tensor(valid, device=dev).to(torch.int64).clamp(0, p) * flits
    has = vr > 0
    was = carry["started"] != 0
    entered = (was & has).unsqueeze(-1)  # the boundary into row 0 counts
    bmask = torch.arange(1, p * flits, device=dev)[None, :] < vr[:, None]  # boundary into row r
    rmask = torch.arange(p * flits, device=dev)[None, :, None] < vr[:, None, None]  # row r
    last = (vr - 1).clamp(min=0)
    streams: dict[Variant, torch.Tensor] = {}
    totals, wires, invs, parities = [], [], [], []
    for ci, cfg in enumerate(configs):
        if cfg.ordering not in streams:
            streams[cfg.ordering] = _ordered_stream(
                x, w, cfg.ordering, width=width, input_lanes=input_lanes,
                weight_lanes=weight_lanes, pack=pack,
            )
        s = streams[cfg.ordering]
        cw, civ = carry["wire"][ci], carry["inv"][ci]
        aux_rows = None  # (L, T, npart) invert-line (toggles, levels) for activity
        if cfg.codec == "bus_invert":
            npart, pw = bus_invert_partitions(lanes, cfg.partition)
            d = s.reshape(links, -1, npart, pw)
            pc = _popcount_bits(d[:, 1:] ^ d[:, :-1], 8)  # (L, T-1, P, pw)
            cwp = cw.reshape(links, npart, pw)
            # row 0 against the carried wire flit; forced 0 on a cold start
            entry = (2 * _popcount_bits(d[:, 0] ^ cwp, 8).sum(-1) > 8 * pw) & was[:, None]
            v = bus_invert_lines(pc.sum(-1), 8 * pw, entry)  # (L, T, P)
            flip = (v[:, 1:] ^ v[:, :-1]).unsqueeze(-1)
            per_lane = (torch.where(flip == 1, 8 - pc, pc) * bmask[:, :, None, None]).sum(1)
            wire0 = d[:, 0] ^ (entry.to(torch.int32).unsqueeze(-1) * 0xFF)
            per_lane = per_lane.reshape(links, lanes) + (
                _popcount_bits(cwp ^ wire0, 8).reshape(links, lanes) * entered
            )
            aux = (flip[..., 0] * bmask[:, :, None]).sum((1, 2)) + (
                (civ[:, :npart] != entry).sum(-1) * entered[:, 0]
            )
            v_last = v[torch.arange(links, device=dev), last]  # (L, P)
            d_last = d[torch.arange(links, device=dev), last]
            w_last = ((d_last ^ (v_last.unsqueeze(-1) * 0xFF)) & 0xFF).reshape(links, lanes)
            inv_out = civ.clone()
            inv_out[:, :npart] = torch.where(has[:, None], v_last, civ[:, :npart])
            if activity is not None:
                wire = ((d ^ (v.unsqueeze(-1) * 0xFF)) & 0xFF).reshape(links, -1, lanes)
                aux_rows = (
                    torch.cat([(civ[:, None, :npart] != entry[:, None]) * entered[:, :, None],
                               flip[..., 0] * bmask[:, :, None]], dim=1),
                    v * rmask,
                )
        else:
            if cfg.codec == "transition":  # wire_t ^ wire_{t-1} = data_t
                wire = s
                flips = _popcount_bits(s[:, 1:], 8)
                first = _popcount_bits(s[:, 0], 8)
            else:
                wire = _BYTE_MAPS[cfg.codec](s)
                flips = _popcount_bits(wire[:, 1:] ^ wire[:, :-1], 8)
                first = _popcount_bits(wire[:, 0] ^ cw, 8)
            per_lane = (flips * bmask[:, :, None]).sum(1) + first * entered
            aux = torch.zeros(links, dtype=torch.int64, device=dev)
            w_last = wire[torch.arange(links, device=dev), last]
            inv_out = civ
        totals.append(torch.cat([_sides(per_lane, split), aux[:, None]], dim=-1))
        wires.append(torch.where(has[:, None], w_last, cw))
        invs.append(inv_out)
        if activity is None:
            continue
        par = carry["parity"][ci]
        if cfg.codec == "transition":
            # the wire toggles where its data bit is 1; its level is the
            # running parity of the data bit, entered at the carried parity
            tog = torch.cat([s[:, :1] * entered[:, :, None], s[:, 1:] * bmask[:, :, None]], dim=1)
            data = _bits8(s) * rmask
            lvl = ((par[:, None] + torch.cumsum(data, dim=1)) & 1) * rmask
            par = ((par + data.sum(1)) & 1).to(torch.int32)
        else:
            tog = torch.cat([(wire[:, :1] ^ cw[:, None]) * entered[:, :, None],
                             (wire[:, 1:] ^ wire[:, :-1]) * bmask[:, :, None]], dim=1)
            lvl = _bits8(wire) * rmask
        tog, ones = _bits8(tog), lvl.sum(1)
        pad = torch.zeros((links, tog.shape[1], pmax), dtype=torch.int32, device=dev)
        ones_aux = torch.zeros((links, pmax), dtype=torch.int64, device=dev)
        if aux_rows is not None:
            pad[..., : aux_rows[0].shape[-1]] = aux_rows[0]
            ones_aux[:, : aux_rows[1].shape[-1]] = aux_rows[1].sum(1)
        _add_windows(activity.toggles[:, ci], torch.cat([tog, pad], dim=-1),
                     activity.base_row, activity.window_rows)
        activity.ones[:, ci] += torch.cat([ones, ones_aux], dim=-1).to(torch.int32)
        parities.append(par)
    new_carry = {
        "started": (was | has).to(torch.int32),
        "wire": torch.stack(wires).to(torch.int32),
        "inv": torch.stack(invs).to(torch.int32),
    }
    if activity is not None:
        new_carry["parity"] = torch.stack(parities).to(torch.int32)
    return wrap_int32(torch.stack(totals, dim=1)), new_carry


def _axes_launch(x, w, valid, *, configs, width, input_lanes, weight_lanes, split_lanes,
                 pack, carry, activity):
    """Check the arguments, launch the measurement (with ``activity``,
    its activity mode) and return (totals, carry, launched)."""
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"bt_axes_cuda needs contiguous (L, P, N) packets, got {tuple(x.shape)}")
    if weight_lanes:
        if w is None or w.shape != x.shape or w.dtype != x.dtype:
            raise ValueError("bt_axes_cuda needs weights shaped and typed like the inputs")
        if w.device != x.device or not w.is_contiguous():
            raise ValueError("bt_axes_cuda needs contiguous weights on the inputs' device")
    links, p, n = x.shape
    if not 1 <= n <= MAX_N:
        raise ValueError(f"bt_axes_cuda takes 1 <= N <= {MAX_N}, got N={n}")
    configs, split = validate_axes_call(
        n, configs=configs, width=width, input_lanes=input_lanes,
        weight_lanes=weight_lanes, split_lanes=split_lanes, pack=pack,
    )
    lanes = input_lanes + weight_lanes
    nc, pmax = len(configs), max_partitions(configs, lanes)
    dev = x.device
    if activity is not None:
        nwires = lanes * 8 + pmax
        tog = activity.toggles
        if (tog.dtype != torch.int32 or tog.device != dev or tog.dim() != 4
                or tog.shape[:2] != (links, nc) or tog.shape[3] != nwires
                or not tog.is_contiguous()):
            raise ValueError(f"activity toggles must be contiguous int32 ({links}, {nc}, NW, "
                             f"{nwires}) on {dev}")
        if activity.window_rows < 1 or activity.base_row < 0 or (
                -(-(activity.base_row + p * (n // input_lanes)) // activity.window_rows)
                > tog.shape[2]):
            raise ValueError(f"{tog.shape[2]} windows of {activity.window_rows} rows do not "
                             f"hold rows {activity.base_row}..+{p * (n // input_lanes)}")
        if (activity.ones.dtype != torch.int32 or activity.ones.shape != (links, nc, nwires)
                or activity.ones.device != dev or not activity.ones.is_contiguous()):
            raise ValueError(f"activity ones must be contiguous int32 ({links}, {nc}, {nwires})")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"bt_axes_cuda takes uint8 or int32 packets, got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"bt_axes_cuda needs CUDA tensors, got {x.device}")
    if carry is None:  # fresh zeros, updated in place by the fold
        carry = axes_carry(links, configs, lanes, dev, activity=activity is not None)
        wire, inv_c = carry["wire"], carry["inv"]
        parity = carry.get("parity")
    else:
        wire = carry["wire"].to(device=dev, dtype=torch.int32).clone()
        inv_c = carry["inv"].to(device=dev, dtype=torch.int32).clone()
        parity = None if activity is None else (
            carry["parity"].to(device=dev, dtype=torch.int32).clone()
        )
    started = carry["started"].to(device=dev, dtype=torch.int32).contiguous()
    v = torch.as_tensor(valid, device=dev).to(torch.int32).clamp(0, p).contiguous()
    tab, n_orderings = _config_table(configs, lanes, dev)
    sms = _sm_count(torch.cuda.current_device() if dev.index is None else dev.index)
    bpk, g = axes_blocking(links, p, n // input_lanes, lanes, n_orderings, sms)
    cells = links * g * nc
    part = torch.empty(cells * 2 * pmax * 3, dtype=torch.int32, device=dev)
    edge = torch.empty(cells * 4 * lanes, dtype=torch.uint8, device=dev)
    inv = torch.empty(cells * 4 * pmax, dtype=torch.uint8, device=dev)
    started_out = torch.empty_like(started)
    totals = torch.zeros((links, nc, 3), dtype=torch.int32, device=dev)
    out_carry = {"started": started_out, "wire": wire, "inv": inv_c}
    if parity is not None:
        out_carry["parity"] = parity
    if not (links and p):
        started_out.copy_(started)
        return totals, out_carry, False
    args = (
        x.data_ptr(), w.data_ptr() if weight_lanes else None, DTYPE_CODES[x.dtype],
        links, p, n, v.data_ptr(), width, input_lanes, weight_lanes, split,
        int(pack == "row"), bpk, g, tab.data_ptr(), n_orderings, nc, pmax,
        part.data_ptr(), edge.data_ptr(), inv.data_ptr(), started.data_ptr(),
        started_out.data_ptr(), wire.data_ptr(), inv_c.data_ptr(), totals.data_ptr(),
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if activity is None:
            err = library().repro_bt_axes(*args, stream)
        else:
            es = lanes + 2 * pmax + 1  # entry state per (link, block, config)
            bpar = torch.empty(cells * lanes, dtype=torch.uint8, device=dev)
            ent = torch.empty(cells * es, dtype=torch.uint8, device=dev)
            err = library().repro_bt_axes_activity(
                *args, bpar.data_ptr(), ent.data_ptr(), es, parity.data_ptr(),
                activity.base_row, activity.window_rows, activity.toggles.shape[2],
                activity.toggles.data_ptr(), activity.ones.data_ptr(), stream,
            )
    check(err, "repro_bt_axes_activity" if activity is not None else "repro_bt_axes")
    return totals, out_carry, True


def bt_axes_cuda(
    x: torch.Tensor, w: torch.Tensor | None, valid: torch.Tensor, *, configs,
    width: int, input_lanes: int, weight_lanes: int, split_lanes: int | None, pack: str,
    carry: dict | None = None,
) -> tuple[torch.Tensor, dict]:
    """The same (totals, carry) as :func:`bt_axes_plain` from the CUDA
    kernels, one launch entry.

    ``x`` and ``w`` are contiguous uint8 or int32 (L, P, N) packets of one
    dtype on a CUDA device (``w`` may be None when ``weight_lanes`` is 0),
    1 <= N <= MAX_N; ``valid`` is (L,) on the same device.
    """
    totals, carry, launched = _axes_launch(
        x, w, valid, configs=configs, width=width, input_lanes=input_lanes,
        weight_lanes=weight_lanes, split_lanes=split_lanes, pack=pack, carry=carry,
        activity=None,
    )
    bt_axes_cuda.launches += launched
    return totals, carry


bt_axes_cuda.launches = 0


def bt_axes_activity_cuda(
    x: torch.Tensor, w: torch.Tensor | None, valid: torch.Tensor, *, configs,
    width: int, input_lanes: int, weight_lanes: int, split_lanes: int | None, pack: str,
    activity: ActivityOut, carry: dict | None = None,
) -> tuple[torch.Tensor, dict]:
    """:func:`bt_axes_cuda` in the activity mode, one launch entry: the
    same (totals, carry) — the carry with ``parity`` — and every wire's
    window toggles and level-1 rows added into ``activity``'s contiguous
    int32 tensors on the packets' device."""
    totals, carry, launched = _axes_launch(
        x, w, valid, configs=configs, width=width, input_lanes=input_lanes,
        weight_lanes=weight_lanes, split_lanes=split_lanes, pack=pack, carry=carry,
        activity=activity,
    )
    bt_axes_activity_cuda.launches += launched
    return totals, carry


bt_axes_activity_cuda.launches = 0
