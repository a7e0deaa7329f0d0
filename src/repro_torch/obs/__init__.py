# repro_torch.obs — observability for the port (counterpart of repro.obs):
#   metrics.py  - counter/gauge/histogram registry + scoped collect()
#   trace.py    - span API emitting Chrome/Perfetto trace-event JSON
#   probes.py   - the sink behind repro_torch._obs_hooks: probe vocabulary,
#                 collect()/tracing()/profiled() activation (profiled() puts
#                 the probe spans in torch.profiler's trace)
#   report.py   - per-link BT tables, top-N hottest links, CSV/JSON dumps
#   activity.py - wire-level switching-activity profiles
#   saif.py     - SAIF / VCD export of measured activity for EDA flows
#   capture.py  - real-model traffic capture: taps on the model zoo record
#                 int8 wire streams (serving, a train step's gradients, MoE
#                 dispatch, the trained LeNet's conv kernels)
#
# Off and free by default: production modules import only
# repro_torch._obs_hooks (one None test per probe, no device sync), so an
# entry point's tensor work and outputs are the same whether this package
# is absent, imported or collecting (tests/test_torch_obs.py).
from .activity import (
    ActivityProfile,
    link_profiles,
    profile_from_arrays,
    profiles_from_noc,
    wire_name,
    wire_records,
    write_wires_csv,
)
from .capture import (
    TAP_SCENARIOS,
    CapturedStream,
    CaptureSession,
    capture,
    capture_lenet_conv,
    capture_moe_dispatch,
    capture_serve_decode,
    capture_train_step,
    load_session,
    save_session,
    train_batch,
)
from .metrics import Counter, Gauge, Histogram, Registry, registry_from_dict
from .probes import (
    PORT_PROBE_KINDS,
    PROBE_KINDS,
    active_registries,
    active_tracers,
    collect,
    profiled,
    tracing,
)
from .report import (
    activity_table,
    format_links,
    format_scenarios,
    link_table,
    metrics_dict,
    read_metrics_json,
    scenario_table,
    top_links,
    top_wires,
    write_activity_csv,
    write_links_csv,
    write_metrics_json,
    write_scenarios_csv,
    write_scenarios_json,
)
from .saif import parse_saif, write_saif, write_vcd
from .trace import Tracer, runtime_metadata

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "registry_from_dict",
    "Tracer",
    "runtime_metadata",
    "PROBE_KINDS",
    "PORT_PROBE_KINDS",
    "collect",
    "tracing",
    "profiled",
    "active_registries",
    "active_tracers",
    "link_table",
    "top_links",
    "format_links",
    "write_links_csv",
    "activity_table",
    "top_wires",
    "write_activity_csv",
    "scenario_table",
    "format_scenarios",
    "write_scenarios_csv",
    "write_scenarios_json",
    "metrics_dict",
    "write_metrics_json",
    "read_metrics_json",
    "ActivityProfile",
    "profile_from_arrays",
    "link_profiles",
    "profiles_from_noc",
    "wire_name",
    "wire_records",
    "write_wires_csv",
    "parse_saif",
    "write_saif",
    "write_vcd",
    "TAP_SCENARIOS",
    "CapturedStream",
    "CaptureSession",
    "capture",
    "capture_serve_decode",
    "capture_train_step",
    "capture_moe_dispatch",
    "capture_lenet_conv",
    "train_batch",
    "save_session",
    "load_session",
]
