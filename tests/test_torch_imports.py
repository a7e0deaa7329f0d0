"""The port stands alone: importing every repro_torch module and
chip_smoke.py loads neither JAX nor anything of the JAX package."""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import repro_torch

ROOT = Path(__file__).resolve().parents[1]


def _port_modules() -> list[str]:
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return sorted(names)


def test_every_port_module_is_listed():
    names = _port_modules()
    for expected in ("repro_torch.core.popcount", "repro_torch.kernels.psu",
                     "repro_torch.kernels.axes", "repro_torch.kernels._build",
                     "repro_torch.link.pipeline", "repro_torch.convert",
                     "repro_torch.codec.schemes", "repro_torch.codec.stage",
                     "repro_torch.codec.overhead", "repro_torch.codec.compare",
                     "repro_torch.traffic.ordering", "repro_torch._obs_hooks",
                     "repro_torch.obs", "repro_torch.obs.activity", "repro_torch.obs.metrics",
                     "repro_torch.obs.probes", "repro_torch.obs.report", "repro_torch.obs.saif",
                     "repro_torch.obs.trace", "repro_torch.kernels.quantize",
                     "repro_torch.models", "repro_torch.models.config", "repro_torch.configs",
                     "repro_torch.configs.shapes", "repro_torch.configs.internlm2_1_8b",
                     "repro_torch.traffic", "repro_torch.noc", "repro_torch.noc.topology",
                     "repro_torch.noc.routing", "repro_torch.noc.fabric",
                     "repro_torch.noc.simulate", "repro_torch.noc.latency",
                     "repro_torch.noc.power", "repro_torch.noc.adapters", "repro_torch.dse",
                     "repro_torch.dse.space", "repro_torch.dse.evaluate",
                     "repro_torch.dse.pareto", "repro_torch.dse.report"):
        assert expected in names


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    code = (
        "import importlib, json, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        f"for name in {_port_modules() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True,
        timeout=300, cwd=ROOT,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_noc_and_dse_export_the_reference_names():
    """``repro_torch.noc`` / ``repro_torch.dse`` carry the reference's
    ``__all__`` (read from its source: importing it would load JAX here)."""
    import ast

    import repro_torch.dse
    import repro_torch.noc

    for name, port in (("noc", repro_torch.noc), ("dse", repro_torch.dse)):
        tree = ast.parse((ROOT / "src" / "repro" / name / "__init__.py").read_text())
        ref = next(ast.literal_eval(n.value) for n in tree.body if isinstance(n, ast.Assign)
                   and any(getattr(t, "id", None) == "__all__" for t in n.targets))
        assert port.__all__ == ref
        assert all(hasattr(port, n) for n in ref)


def test_obs_and_its_hooks_import_without_jax():
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}]\n"
        "import repro_torch._obs_hooks as hooks\n"
        "assert hooks.SINK is None and not hooks.active()\n"
        "from repro_torch import obs\n"
        "with obs.collect() as reg:\n"
        "    hooks.event('codec.stream', workload='w', stream='w[0]', bt=3, packets=1)\n"
        "assert reg.value('codec.stream.bt', workload='w', stream='w[0]') == 3\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True,
        timeout=300, cwd=ROOT,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
