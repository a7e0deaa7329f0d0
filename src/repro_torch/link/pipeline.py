"""`TxPipeline` — the transmit path, fused on its hot path.

Counterpart of ``repro.link.pipeline``.  One object owns the paper's
dataflow (popcount -> bucket -> counting sort -> reorder -> pack ->
measure), configured by a ``LinkSpec``, with the reference's two paths:

  * **fused**, for 'acc'/'app' keys with 'row'/'lane' packing and a
    symmetric (or absent) weight side: one ``psu_stream`` launch sorts,
    reorders, packs and counts BT (``kernels/axes.py``);
  * **staged**, for everything else ('none', 'column_major', 'col',
    asymmetric framings, row streams, and every spec with a wire codec):
    the registered stages, the wire codec on the assembled stream
    (``repro_torch.codec``), then one ``bt_count`` launch per lane half
    (``kernels/btcount.py``).  Coded specs also report their invert-line
    transitions and added wires, and the energy model charges both.

Tensors stay on the device they arrive on; numpy arrays are moved to the
pipeline's ``device`` (``cuda`` unless the caller names another).

Probes (``repro_torch.obs``, off by default): ``run`` is a ``link.tx``
span, each staged-path stage a ``link.stage`` span, and ``measure`` /
``measure_rows`` fire a ``link.report`` event with the report's totals,
the Python ints the report reads from the device anyway.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import _obs_hooks as _obs
from ..core.bt import BTReport
from ..kernels import bt_count, psu_stream
from ..kernels.backend import check_backend, resolve_device
from .framing import _validate_paired, assemble_stream
from .power import LinkPowerModel
from .spec import LinkSpec
from .stages import ENCODE_STAGES, PACK_STAGES, make_order, row_bucket_order

__all__ = ["TxPipeline", "TxResult", "LinkReport"]


@dataclasses.dataclass(frozen=True)
class TxResult:
    """What one transmit produces: the permutation, the wire image, the BT."""

    order: torch.Tensor  # (P, N) int32 (or (R,) for row streams)
    rank: Optional[torch.Tensor]  # (P, N) int32; None on the staged path
    stream: torch.Tensor  # (T, lanes) uint8 wire rows (codec-coded if any)
    bt_input: torch.Tensor  # int32: input-side bit transitions
    bt_weight: torch.Tensor  # int32: weight-side bit transitions
    fused: bool  # produced by the single-launch kernel?
    invert: Optional[torch.Tensor] = None  # (T, partitions) uint8 bus-invert lines
    bt_aux: torch.Tensor | int = 0  # int32: invert-line transitions


@dataclasses.dataclass(frozen=True)
class LinkReport:
    """BT / energy accounting of one measured stream (Table-I columns +
    the Fig. 6/7 energy model)."""

    name: str
    num_flits: int
    input_bt: int
    weight_bt: int
    fused: bool = False
    energy_pj: float = 0.0
    aux_bt: int = 0  # invert-line transitions (codec overhead)
    extra_wires: int = 0  # invert lines added beside the data lanes

    @property
    def total_bt(self) -> int:
        return self.input_bt + self.weight_bt

    @property
    def gross_bt(self) -> int:
        """Data BT plus the codec's own invert-line transitions."""
        return self.total_bt + self.aux_bt

    @property
    def input_bt_per_flit(self) -> float:
        return self.input_bt / max(self.num_flits, 1)

    @property
    def weight_bt_per_flit(self) -> float:
        return self.weight_bt / max(self.num_flits, 1)

    @property
    def overall_bt_per_flit(self) -> float:
        return self.total_bt / max(self.num_flits, 1)

    def reduction_vs(self, base: "LinkReport") -> float:
        """Overall BT reduction relative to a baseline report (fraction),
        scored on ``gross_bt``."""
        return 1.0 - self.gross_bt / max(base.gross_bt, 1e-9)

    def to_bt_report(self) -> BTReport:
        """The ``repro_torch.core.bt.BTReport`` view (Table-I columns)."""
        return BTReport(
            torch.tensor(self.input_bt_per_flit, dtype=torch.float32),
            torch.tensor(self.weight_bt_per_flit, dtype=torch.float32),
            torch.tensor(self.overall_bt_per_flit, dtype=torch.float32),
        )


class TxPipeline:
    """Transmit pipeline over one link, configured by a ``LinkSpec``.

    Args:
      spec: framing + stage selection.
      power: energy model for ``LinkReport.energy_pj`` (default paper model).
      fused: force (True) or forbid (False) the fused kernel; None = use it
        whenever the spec allows (never for a coded spec).
      backend: ``"torch"`` runs the plain versions on any device; None
        lets the tensor's device decide (``kernels/backend.py``).
      device: where numpy inputs are put (``cuda`` unless named).
    """

    def __init__(
        self,
        spec: LinkSpec = LinkSpec(),
        *,
        power: LinkPowerModel | None = None,
        fused: bool | None = None,
        backend: str | None = None,
        device: str | torch.device | None = None,
    ) -> None:
        self.spec = spec
        self.power = power if power is not None else LinkPowerModel()
        self._fused = fused
        self._backend = check_backend(backend)
        self.device = resolve_device(device)

    def _tensor(self, values) -> torch.Tensor:
        if isinstance(values, torch.Tensor):
            return values
        return torch.from_numpy(np.ascontiguousarray(values)).to(self.device)

    # ---------------------------------------------------------------- stages
    def encode(self, values: torch.Tensor) -> torch.Tensor:
        """The wire byte image of ``values`` under the encode stage."""
        return ENCODE_STAGES[self.spec.encode](values)

    def order(self, inputs: torch.Tensor) -> torch.Tensor:
        """Per-packet transmit permutation (derived from encoded inputs)."""
        s = self.spec
        return make_order(
            s.key, self.encode(self._tensor(inputs)), lanes=s.input_lanes,
            width=s.width, k=s.k, descending=s.descending,
        )

    def _fusable(self, weights: torch.Tensor | None) -> bool:
        s = self.spec
        # a wire codec recodes the assembled stream after packing, so its
        # BT cannot come out of the fused sort + pack + count kernel
        return (
            s.key in ("acc", "app")
            and s.pack in ("lane", "row")
            and s.codec == "none"
            and (weights is None or s.symmetric)
        )

    def _code_wire(self, stream: torch.Tensor):
        """Apply the spec's wire codec: (wire, invert lines, aux BT)."""
        from ..codec.schemes import codec_by_name, invert_line_transitions

        coded = codec_by_name(self.spec.codec).encode(stream)
        return coded.wire, coded.invert, invert_line_transitions(coded.invert)

    # ------------------------------------------------------------- packet TX
    def run(self, inputs, weights=None) -> TxResult:
        """Transmit P packets: returns permutation, wire stream and BT.

        ``inputs`` is (P, elems_per_packet); ``weights`` (optional) is
        (P, elems_per_packet) for the symmetric framing or
        (P, weight_elems_per_packet) for asymmetric links.
        """
        s = self.spec
        inputs = self._tensor(inputs)
        weights = None if weights is None else self._tensor(weights)
        if weights is not None:
            _validate_paired(inputs, weights, s)
        elif inputs.shape[-1] != s.elems_per_packet:
            raise ValueError(
                f"packet payload {inputs.shape[-1]} != "
                f"flits*input_lanes = {s.elems_per_packet}"
            )
        fused = self._fused if self._fused is not None else self._fusable(weights)
        if fused and not self._fusable(weights):
            raise ValueError(
                f"spec (key={s.key!r}, pack={s.pack!r}, codec={s.codec!r}, "
                f"symmetric={s.symmetric}) cannot run fused"
            )
        with _obs.span(
            "link.tx", path="fused" if fused else "staged", key=s.key, codec=s.codec,
            packets=int(inputs.shape[0]),
        ):
            xi = self.encode(inputs)
            wi = self.encode(weights) if weights is not None else None
            if fused:
                res = psu_stream(
                    xi, wi, width=s.width, k=None if s.key == "acc" else s.k,
                    descending=s.descending, input_lanes=s.input_lanes,
                    weight_lanes=s.weight_lanes if wi is not None else None,
                    pack=s.pack, backend=self._backend,
                )
                return TxResult(
                    res.order, res.rank, res.stream, res.bt_input, res.bt_weight, True
                )
            with _obs.span("link.stage", stage="order"):
                order = make_order(
                    s.key, xi, lanes=s.input_lanes, width=s.width, k=s.k,
                    descending=s.descending,
                )
            with _obs.span("link.stage", stage="assemble"):
                stream = assemble_stream(xi, wi, s, order, s.pack)
            invert = None
            bt_aux = torch.zeros((), dtype=torch.int32, device=stream.device)
            if s.codec != "none":
                with _obs.span("link.stage", stage="codec"):
                    stream, invert, bt_aux = self._code_wire(stream)
            with _obs.span("link.stage", stage="bt"):
                bt_i = bt_count(stream[:, : s.input_lanes], backend=self._backend)
                if wi is not None and s.weight_lanes:
                    bt_w = bt_count(stream[:, s.input_lanes :], backend=self._backend)
                else:
                    bt_w = torch.zeros((), dtype=torch.int32, device=stream.device)
            return TxResult(order, None, stream, bt_i, bt_w, False, invert, bt_aux)

    def transmit(self, inputs, weights=None) -> torch.Tensor:
        """The (T, lanes) uint8 wire image of the packets."""
        return self.run(inputs, weights).stream

    def _report(self, name, stream, bt_i, bt_w, aux, fused) -> LinkReport:
        """The report of one measured wire stream: coded specs charge the
        invert-line transitions and the added wires."""
        num_flits, lanes = (int(d) for d in stream.shape)
        wires = self._extra_wires(lanes)
        energy = self.power.coded_link_energy_pj(bt_i + bt_w, aux, num_flits, 8 * lanes, wires)
        _obs.event(
            "link.report", name=name, bt_input=bt_i, bt_weight=bt_w, aux_bt=aux,
            num_flits=num_flits, energy_pj=energy,
        )
        return LinkReport(
            name, num_flits, bt_i, bt_w, fused=fused, energy_pj=energy, aux_bt=aux,
            extra_wires=wires,
        )

    def measure(self, inputs, weights=None, name: str = "stream") -> LinkReport:
        """BT / energy report for transmitting the packets under this spec."""
        res = self.run(inputs, weights)
        return self._report(
            name, res.stream, int(res.bt_input), int(res.bt_weight), int(res.bt_aux), res.fused
        )

    def _extra_wires(self, lanes: int) -> int:
        """Invert lines the spec's codec adds beside ``lanes`` byte lanes:
        the actual width of the stream (an input-only run of a paired spec
        codes only the input half)."""
        if self.spec.codec == "none":
            return 0
        from ..codec.schemes import codec_by_name

        return codec_by_name(self.spec.codec).extra_wires(lanes)

    # --------------------------------------------------------------- row TX
    def row_order(self, rows: torch.Tensor) -> torch.Tensor:
        """Transmit order of whole rows of an (R, B) byte matrix ('none' or
        'row_bucket' key, DESIGN.md §3.3)."""
        s = self.spec
        rows = self._tensor(rows)
        if s.key == "none":
            return torch.arange(rows.shape[0], dtype=torch.int32, device=rows.device)
        if s.key != "row_bucket":
            raise ValueError(f"row streams use key 'none' or 'row_bucket', got {s.key!r}")
        return row_bucket_order(rows, s.k, width=s.width, descending=s.descending)

    def _row_wire(self, rows):
        """(wire stream, aux BT) of an (R, B) byte-row stream."""
        enc = self.encode(self._tensor(rows))
        ordered = enc.index_select(0, self.row_order(enc).to(torch.int64))
        stream = PACK_STAGES[self.spec.pack].stream(ordered, self.spec.bytes_per_flit)
        stream = stream.to(torch.uint8)
        if self.spec.codec == "none":
            return stream, 0
        wire, _, bt_aux = self._code_wire(stream)
        return wire, bt_aux

    def transmit_rows(self, rows) -> torch.Tensor:
        """Wire image of an (R, B) byte-row stream: encode, order whole rows
        by popcount bucket, lay out with the pack stage, then apply the
        wire codec (if any)."""
        return self._row_wire(rows)[0]

    def measure_rows(self, rows, name: str = "rows") -> LinkReport:
        """BT / energy report for streaming ``rows`` under this spec."""
        stream, bt_aux = self._row_wire(rows)
        bt = int(bt_count(stream, backend=self._backend))
        return self._report(name, stream, bt, 0, int(bt_aux), False)
