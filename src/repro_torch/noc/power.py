"""NoC power roll-up: the Fig. 6/7 link model extended with per-hop cost.

Counterpart of ``repro.noc.power``, on the port's ``LinkPowerModel``.

Every hop of a multi-router path drives one link's wires (BT-proportional,
exactly the single-link ``repro_torch.link.LinkPowerModel``) *and* one router
traversal (buffer write/read, crossbar, arbitration — flit-proportional,
data-independent to first order).  Interconnect energy scaling with the
Hamming distance of consecutive transfers is the observation of Li et al.
(arXiv:2002.05293); the router constant is the standard NoC flit-energy
term.  Sorting therefore attacks the BT-proportional share only: the
router term is the NoC analogue of the single-link model's clock/control
floor, and it dilutes the fabric-level reduction the same way
``transfer_factor`` dilutes the link-level one.
"""

from __future__ import annotations

import dataclasses

from ..link.power import LinkPowerModel

__all__ = ["NocPowerModel"]


@dataclasses.dataclass(frozen=True)
class NocPowerModel(LinkPowerModel):
    """Per-hop energy: inherited per-link wire model + router flit energy.

    ``router_flit_energy_pj`` is a representative 22 nm 5-port
    wormhole-router traversal (buffering + crossbar + arbitration) per
    128-bit flit; like the base model's absolute constants, ratios are the
    claim, the absolute scale is modeled.
    """

    router_flit_energy_pj: float = 0.98

    def hop_energy_pj(self, total_bt: float, num_flits: int) -> float:
        """Energy of one link traversal: wire switching + router overhead.

        The fabric total is the sum of these over all links — the
        simulator stores one per ``LinkStats`` and ``NocReport.energy_pj``
        sums them, so the roll-up has a single code path.
        """
        return self.link_energy_pj(total_bt, num_flits) + (
            self.router_flit_energy_pj * float(num_flits)
        )

    def coded_hop_energy_pj(
        self,
        data_bt: float,
        aux_bt: float,
        num_flits: int,
        data_wires: int,
        extra_wires: int = 0,
    ) -> float:
        """Coded-link traversal: the widened-wire link model (identical to
        the point-to-point ``coded_link_energy_pj`` accounting, DESIGN.md
        §11) plus the router flit overhead.  Reduces to ``hop_energy_pj``
        when the link is uncoded."""
        return self.coded_link_energy_pj(
            data_bt, aux_bt, num_flits, data_wires, extra_wires
        ) + self.router_flit_energy_pj * float(num_flits)

    def wire_hop_energy_pj(
        self,
        per_wire_bt,
        num_flits: int,
        *,
        wire_caps=None,
        data_wires: int | None = None,
        extra_wires: int = 0,
    ) -> float:
        """Wire-resolved hop traversal: the per-wire link model (§15) plus
        the router flit overhead.  With uniform caps this equals
        ``coded_hop_energy_pj`` of the summed BT exactly — same refinement
        contract as the base model's ``wire_energy_pj``."""
        return self.wire_energy_pj(
            per_wire_bt, num_flits, wire_caps=wire_caps,
            data_wires=data_wires, extra_wires=extra_wires,
        ) + self.router_flit_energy_pj * float(num_flits)
