"""The port stands alone: importing every repro_torch module and
chip_smoke.py loads neither JAX nor anything of the JAX package."""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import repro_torch
from torch_groups import torch_threads  # noqa: F401

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
                     "repro_torch.dse.pareto", "repro_torch.dse.report",
                     "repro_torch.models.layers", "repro_torch.models.moe",
                     "repro_torch.models.ssd", "repro_torch.models.transformer",
                     "repro_torch.serve", "repro_torch.serve.kv_quant", "repro_torch.serve.loop",
                     "repro_torch.obs.capture", "repro_torch._tree", "repro_torch.checkpoint",
                     "repro_torch.checkpoint.manager", "repro_torch.data",
                     "repro_torch.data.pipeline", "repro_torch.optim", "repro_torch.optim.adamw",
                     "repro_torch.optim.compress", "repro_torch.train", "repro_torch.train.step",
                     "repro_torch.train.loop", "repro_torch.models.lenet",
                     "repro_torch.launch", "repro_torch.launch.mesh",
                     "repro_torch.launch.sharding", "repro_torch.launch.specs",
                     "repro_torch.launch.step", "repro_torch.launch.pipeline",
                     "repro_torch.launch.dryrun", "repro_torch.launch.tp",
                     "repro_torch.launch.tp_model", "repro_torch.launch.serve",
                     "repro_torch.roofline",
                     "repro_torch.roofline.analysis", "repro_torch.roofline.collect",
                     "repro_torch._collectives"):
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


def test_expert_parallel_path_imports_no_jax_and_no_reference():
    """The modules the expert-parallel slice changed, imported alone."""
    names = ["repro_torch.models.moe", "repro_torch.launch.tp", "repro_torch.launch.tp_model",
             "repro_torch.launch.step", "repro_torch.launch.serve", "repro_torch.launch.dryrun",
             "chip_smoke"]
    code = (
        "import importlib, json, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300, cwd=ROOT)
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


def _reference_all(path: str) -> list:
    """A reference package's ``__all__``, read from its source (importing
    it would load JAX here)."""
    import ast

    tree = ast.parse((ROOT / "src" / "repro" / path / "__init__.py").read_text())
    return next(ast.literal_eval(n.value) for n in tree.body if isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) == "__all__" for t in n.targets))


def test_models_and_serve_export_the_reference_names():
    import repro_torch.models
    import repro_torch.serve

    for name, port in (("models", repro_torch.models), ("serve", repro_torch.serve)):
        assert port.__all__ == _reference_all(name)
        assert all(hasattr(port, n) for n in port.__all__)


def test_training_path_exports_the_reference_names():
    import repro_torch.checkpoint
    import repro_torch.data
    import repro_torch.optim
    import repro_torch.train

    for name, port in (("checkpoint", repro_torch.checkpoint), ("data", repro_torch.data),
                       ("optim", repro_torch.optim), ("train", repro_torch.train)):
        assert port.__all__ == _reference_all(name)
        assert all(hasattr(port, n) for n in port.__all__)


def test_training_path_imports_without_jax():
    """The training loop with checkpoints, the optimizers, the LeNet and the
    training capture drivers run end to end with neither JAX nor the
    reference loaded."""
    code = (
        "import json, sys, tempfile\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}]\n"
        "import torch\n"
        "from repro_torch import obs, optim\n"
        "from repro_torch.configs import smoke_config\n"
        "from repro_torch.data import DataConfig\n"
        "from repro_torch.models import lenet\n"
        "from repro_torch.train import TrainLoopConfig, train\n"
        "cfg = smoke_config('internlm2-1.8b')\n"
        "d = tempfile.mkdtemp()\n"
        "r = train(cfg, DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2),\n"
        "          optim.AdamWConfig(), TrainLoopConfig(steps=2, checkpoint_every=1,\n"
        "          checkpoint_dir=d), device='cpu')\n"
        "assert len(r['log']) == 2\n"
        "sess = obs.capture_train_step(cfg, batch=1, seq=8, device='cpu')\n"
        "assert [s.name for s in sess.streams] == ['grads']\n"
        "p, info = lenet.train_lenet(steps=2, batch=4, ckpt_dir=d + '/lenet', device='cpu')\n"
        "sess = obs.capture_lenet_conv(params=p, device='cpu')\n"
        "assert [s.name for s in sess.streams] == ['conv1', 'conv2', 'inputs']\n"
        "out, err = optim.compressed_psum(torch.ones(512), torch.zeros(512),\n"
        "                                 optim.CompressionConfig(mode='int8_ef'))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True,
        timeout=300, cwd=ROOT,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_serving_path_imports_without_jax():
    """The model zoo, the serving loop and the capture drivers run a small
    model end to end with neither JAX nor the reference loaded."""
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}]\n"
        "import torch\n"
        "from repro_torch import obs\n"
        "from repro_torch.configs import smoke_config\n"
        "sess = obs.capture_serve_decode(smoke_config('internlm2-1.8b'), batch=1, prompt=4,\n"
        "                                new_tokens=2, device='cpu')\n"
        "assert [s.name for s in sess.streams] == ['weights', 'kv', 'kv']\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True,
        timeout=300, cwd=ROOT,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


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


def test_distribution_layer_exports_the_reference_names():
    """``launch`` carries the reference's ``__all__``; ``roofline`` all of
    its names but the two that read XLA executables; ``kernels`` the
    sharded link axis."""
    import repro_torch.kernels
    import repro_torch.launch
    import repro_torch.roofline

    assert repro_torch.launch.__all__ == _reference_all("launch")
    not_ported = {"collect_from_compiled", "parse_collectives"}
    assert set(_reference_all("roofline")) - set(repro_torch.roofline.__all__) == not_ported
    assert not any(hasattr(repro_torch.roofline, n) for n in not_ported)
    # the Pallas backend switches have no meaning in the port (dispatch by device)
    assert set(_reference_all("kernels")) - set(repro_torch.kernels.__all__) == {
        "BACKEND_ENV_VAR", "default_backend", "default_interpret", "force_default_backend",
        "pallas_launch_count", "resolve_backend"}
    for mod in (repro_torch.launch, repro_torch.roofline, repro_torch.kernels):
        assert all(hasattr(mod, n) for n in mod.__all__)


def test_distribution_layer_imports_without_jax(tmp_path):
    """A one-rank gloo group runs the rule-placed (tensor-parallel) step,
    the sharded link axis, a one-stage pipeline, a roofline record, placed
    greedy generation and meta dry-run cells (one with its collective term)
    with neither JAX nor the reference loaded."""
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}]\n"
        "import torch, torch.distributed as dist\n"
        f"dist.init_process_group('gloo', init_method='file://{tmp_path}/store', rank=0,\n"
        "                        world_size=1)\n"
        "from repro_torch import kernels, optim, roofline\n"
        "from repro_torch.configs import smoke_config\n"
        "from repro_torch.launch import dryrun, make_smoke_mesh\n"
        "from repro_torch.launch.pipeline import make_pipe_mesh, pipeline_apply\n"
        "from repro_torch.launch.step import make_placed_train_step, place_state\n"
        "from repro_torch.models import init_params\n"
        "cfg = smoke_config('internlm2-1.8b')\n"
        "mesh = make_smoke_mesh(device='cpu')\n"
        "p = init_params(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
        "p, o = place_state(cfg, mesh, p)\n"
        "step = make_placed_train_step(cfg, optim.AdamWConfig(), mesh)\n"
        "b = {k: torch.zeros((2, 8), dtype=torch.int32) for k in ('tokens', 'labels')}\n"
        "rec = roofline.collect_from_step(step, p, o, b, arch=cfg.name, shape='s', kind='train',\n"
        "                                 mesh_desc='1x1', num_devices=1, cfg=cfg)\n"
        "assert rec['hlo_flops_per_device'] > 0\n"
        "x = torch.randint(0, 256, (3, 5, 8), dtype=torch.int32)\n"
        "assert torch.equal(kernels.bt_count_axes_sharded(x, group=dist.group.WORLD),\n"
        "                   kernels.bt_count_axes(x))\n"
        "y = pipeline_apply(lambda sp, h: h * sp['w'][0], {'w': torch.full((1, 1), 2.)},\n"
        "                   torch.ones(3, 2), make_pipe_mesh(1, 'cpu'))\n"
        "assert torch.equal(y, torch.full((3, 2), 2.))\n"
        "assert dryrun.run_cell('mamba2-370m', 'decode_32k', False, verbose=False)['status'] == 'ok'\n"
        "from repro_torch.launch import serve\n"
        "g = serve.generate(serve.shard_params(cfg, mesh, init_params(cfg, None, 'meta')), cfg,\n"
        "                   mesh, torch.zeros((2, 4), dtype=torch.int32, device='meta'), 2)\n"
        "assert g.tokens.shape == (2, 2)\n"
        "rec = dryrun.run_cell('internlm2-1.8b', 'decode_32k', False, verbose=False)\n"
        "assert rec['collectives_modelled'] and rec['collective_ops']\n"
        "dist.destroy_process_group()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


# what a gloo rank of the port's multi-process tests imports: the helper
# module and the test module that started it (for its inputs and run_rank)
GLOO_WORKERS = ["torch_groups", "test_torch_distributed", "test_torch_tp", "test_torch_ep",
                "test_torch_cp", "test_torch_ssd_tp", "test_torch_encdec_tp",
                "test_torch_vlm_tp", "test_torch_fsdp", "test_torch_pipeline"]


def test_gloo_ranks_import_no_jax_and_no_reference():
    """Each gloo rank's imports, in a fresh process and in turn: neither JAX
    nor the JAX package loaded after any of them (``torch_groups.join`` and
    ``leave`` assert it on every rank as well)."""
    code = (
        "import importlib, json, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}, {str(ROOT / 'tests')!r}]\n"
        "for name in %r:\n"
        "    importlib.import_module(name)\n"
        "    bad = sorted(m for m in sys.modules\n"
        "                 if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "    if bad:\n"
        "        break\n"
        "print(json.dumps([name, bad]))\n" % GLOO_WORKERS
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [GLOO_WORKERS[-1], []]
