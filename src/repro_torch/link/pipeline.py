"""`TxPipeline` — the transmit path, fused on its hot path.

Counterpart of ``repro.link.pipeline``.  One object owns the paper's
dataflow (popcount -> bucket -> counting sort -> reorder -> pack ->
measure), configured by a ``LinkSpec``, with the reference's two paths:

  * **fused**, for 'acc'/'app' keys with 'row'/'lane' packing and a
    symmetric (or absent) weight side: one ``psu_stream`` launch sorts,
    reorders, packs and counts BT (``kernels/axes.py``);
  * **staged**, for everything else ('none', 'column_major', 'col',
    asymmetric framings, row streams): the registered stages, then one
    ``bt_count`` launch per lane half (``kernels/btcount.py``).

Tensors stay on the device they arrive on; numpy arrays are moved to the
pipeline's ``device`` (``cuda`` unless the caller names another).  Specs
with a wire codec raise ``NotImplementedError``: codecs are a later slice
of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

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
    stream: torch.Tensor  # (T, lanes) uint8 wire rows
    bt_input: torch.Tensor  # int32: input-side bit transitions
    bt_weight: torch.Tensor  # int32: weight-side bit transitions
    fused: bool  # produced by the single-launch kernel?


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
      spec: framing + stage selection (uncoded specs only in this port).
      power: energy model for ``LinkReport.energy_pj`` (default paper model).
      fused: force (True) or forbid (False) the fused kernel; None = use it
        whenever the spec allows.
      backend: kernel backend override (``"torch"`` runs the plain versions
        on any device, ``"cuda"`` insists on the kernels).
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
        if spec.codec != "none":
            raise NotImplementedError(
                f"wire codec {spec.codec!r}: coded specs are not ported yet "
                "(ROADMAP queue 1 item 5, repro.codec)"
            )
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
        return (
            s.key in ("acc", "app")
            and s.pack in ("lane", "row")
            and (weights is None or s.symmetric)
        )

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
                f"spec (key={s.key!r}, pack={s.pack!r}, "
                f"symmetric={s.symmetric}) cannot run fused"
            )
        xi = self.encode(inputs)
        wi = self.encode(weights) if weights is not None else None
        if fused:
            res = psu_stream(
                xi, wi, width=s.width, k=None if s.key == "acc" else s.k,
                descending=s.descending, input_lanes=s.input_lanes,
                weight_lanes=s.weight_lanes if wi is not None else None,
                pack=s.pack, backend=self._backend,
            )
            return TxResult(res.order, res.rank, res.stream, res.bt_input, res.bt_weight, True)
        order = make_order(
            s.key, xi, lanes=s.input_lanes, width=s.width, k=s.k,
            descending=s.descending,
        )
        stream = assemble_stream(xi, wi, s, order, s.pack)
        bt_i = bt_count(stream[:, : s.input_lanes], backend=self._backend)
        if wi is not None and s.weight_lanes:
            bt_w = bt_count(stream[:, s.input_lanes :], backend=self._backend)
        else:
            bt_w = torch.zeros((), dtype=torch.int32, device=stream.device)
        return TxResult(order, None, stream, bt_i, bt_w, False)

    def transmit(self, inputs, weights=None) -> torch.Tensor:
        """The (T, lanes) uint8 wire image of the packets."""
        return self.run(inputs, weights).stream

    def _report(self, name, num_flits, lanes, bt_i, bt_w, fused) -> LinkReport:
        energy = self.power.coded_link_energy_pj(bt_i + bt_w, 0, num_flits, 8 * lanes, 0)
        return LinkReport(name, num_flits, bt_i, bt_w, fused=fused, energy_pj=energy)

    def measure(self, inputs, weights=None, name: str = "stream") -> LinkReport:
        """BT / energy report for transmitting the packets under this spec."""
        res = self.run(inputs, weights)
        num_flits, lanes = (int(d) for d in res.stream.shape)
        return self._report(
            name, num_flits, lanes, int(res.bt_input), int(res.bt_weight), res.fused
        )

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

    def transmit_rows(self, rows) -> torch.Tensor:
        """Wire image of an (R, B) byte-row stream: encode, order whole rows
        by popcount bucket, lay out with the pack stage."""
        enc = self.encode(self._tensor(rows))
        ordered = enc.index_select(0, self.row_order(enc).to(torch.int64))
        stream = PACK_STAGES[self.spec.pack].stream(ordered, self.spec.bytes_per_flit)
        return stream.to(torch.uint8)

    def measure_rows(self, rows, name: str = "rows") -> LinkReport:
        """BT / energy report for streaming ``rows`` under this spec."""
        stream = self.transmit_rows(rows)
        bt = int(bt_count(stream, backend=self._backend))
        num_flits, lanes = (int(d) for d in stream.shape)
        return self._report(name, num_flits, lanes, bt, 0, False)
