"""Dynamic-power model for link-related power (paper Fig. 6/7; DESIGN.md §6).

A verbatim copy of ``repro.link.power`` (pure Python; the JAX package's
``__init__`` loads JAX).

    P_link ∝ alpha · C · V^2 · f,  alpha ∝ BT per flit

so *link-related power reduction = transfer_factor × BT reduction*, where the
transfer factor < 1 absorbs the non-data switching floor (clock, control) of
the transmission registers.  Calibrated from the paper: ACC 20.42 % BT ->
18.27 % power gives transfer_factor ≈ 0.895.
"""

from __future__ import annotations

import dataclasses

__all__ = ["LinkPowerModel"]


@dataclasses.dataclass(frozen=True)
class LinkPowerModel:
    """Maps measured BT to link-related energy/power (Fig. 6/7).

    ``transfer_factor`` maps BT reduction to link-related power reduction
    (non-data switching floor of the transmission registers); calibrated to
    the paper's ACC point (20.42 % BT -> 18.27 % power).
    ``energy_per_transition_pj`` sets the absolute scale (representative
    22 nm on-chip wire; absolute numbers are modeled, ratios are the claim).
    """

    transfer_factor: float = 18.27 / 20.42
    energy_per_transition_pj: float = 0.18
    static_flit_energy_pj: float = 2.0  # clock/control floor per flit

    def link_energy_pj(self, total_bt: float, num_flits: int) -> float:
        return (
            self.energy_per_transition_pj * float(total_bt)
            + self.static_flit_energy_pj * float(num_flits)
        )

    def coded_link_energy_pj(
        self,
        data_bt: float,
        aux_bt: float,
        num_flits: int,
        data_wires: int,
        extra_wires: int = 0,
    ) -> float:
        """Energy of a codec-coded stream, net of its added lines.

        Invert-line transitions (``aux_bt``) switch real wires, so they pay
        the same per-transition energy as data; the ``extra_wires`` invert
        lines also widen the clocked register bank, scaling the per-flit
        static floor by the wire-count ratio (DESIGN.md §11).  With
        ``aux_bt = extra_wires = 0`` this is exactly ``link_energy_pj`` —
        BT wins of any codec are reported *net* of this overhead.
        """
        if data_wires <= 0:
            raise ValueError(f"need data_wires >= 1, got {data_wires}")
        floor = 1.0 + extra_wires / float(data_wires)
        return (
            self.energy_per_transition_pj * float(data_bt + aux_bt)
            + self.static_flit_energy_pj * floor * float(num_flits)
        )

    def wire_energy_pj(
        self,
        per_wire_bt,
        num_flits: int,
        *,
        wire_caps=None,
        data_wires: int | None = None,
        extra_wires: int = 0,
    ) -> float:
        """Wire-resolved link energy from a per-wire BT vector (§15).

        ``per_wire_bt`` is the ``data_wires + extra_wires``-long toggle
        vector of one link (the ``ActivityProfile.per_wire`` view);
        ``wire_caps`` is an optional per-wire relative capacitance profile
        — ``energy_per_transition_pj`` is the per-transition cost of a
        cap-1.0 wire, so a 1.3 entry models a 30 % longer/loaded net.
        The static floor is the same widened-register term as
        ``coded_link_energy_pj``.  With uniform caps (the default) this
        reproduces ``link_energy_pj`` / ``coded_link_energy_pj`` EXACTLY
        (same float expression — pinned in tests), so the wire-resolved
        path is a refinement, never a second model.
        """
        bt = [float(b) for b in per_wire_bt]
        if data_wires is None:
            data_wires = len(bt) - extra_wires
        if data_wires <= 0:
            raise ValueError(f"need data_wires >= 1, got {data_wires}")
        if data_wires + extra_wires != len(bt):
            raise ValueError(
                f"{len(bt)} per-wire entries != {data_wires} data + "
                f"{extra_wires} extra wires"
            )
        if wire_caps is None:
            weighted = sum(bt)
        else:
            caps = [float(c) for c in wire_caps]
            if len(caps) != len(bt):
                raise ValueError(
                    f"{len(caps)} wire_caps != {len(bt)} wires"
                )
            weighted = sum(c * b for c, b in zip(caps, bt))
        floor = 1.0 + extra_wires / float(data_wires)
        return (
            self.energy_per_transition_pj * weighted
            + self.static_flit_energy_pj * floor * float(num_flits)
        )

    def power_reduction(self, bt_reduction: float) -> float:
        """Link-related power reduction predicted from a BT reduction."""
        return self.transfer_factor * bt_reduction
