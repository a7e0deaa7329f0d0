"""Each cell's step against its plain reference at a small size on the CPU
(the port's plain versions), the control and the planted faults that the
comparison must catch, and the work counts the roofline shares rest on."""

import json
import math
import time
from pathlib import Path

import pytest
import torch

from portbench import faults, generate, harness
from portbench.paths import egress, ring_allreduce

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
# a gradient of 3,271 elements over leaves of each kind the configs hold:
# not a multiple of the quantizer block, the packet or the flit
SMALL = {
    "leaves": {"embed": [37, 40], "layers.mlp.up": [2, 40, 19], "final_norm": [91]},
    "assumed": {"weight_init": {"embed": {"mean": 0.0, "std": 0.02},
                                "layers.mlp.up": {"mean": 0.0, "std": 0.16},
                                "final_norm": {"mean": 1.0, "std": 0.0}}},
}


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def small_cell(name: str) -> harness.Cell:
    cell = harness.load_cell(BENCH, name, config=SMALL)
    if "bt_chunk_rows" in cell.mix:
        cell.mix["bt_chunk_rows"] = 17  # several chunks, as at full width
    return cell


def run(cell, traced=False, seed=2**31 + 11):
    return harness.run_cell(cell, seed, 0.05, traced, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_cell_matches_its_reference(name, traced):
    cell = small_cell(name)
    result, window = run(cell, traced)
    assert result["correct"], result["checks"]
    assert result["attempted"] == window["steps"] >= 2 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert all(c == {"value": 0, "limit": 0} for c in result["checks"].values())
    want = cell.per_layer if traced else cell.end_to_end
    assert set(result["metrics"]) <= set(want)
    if not traced:
        assert set(result["metrics"]) == set(want)
        m = generate.gradient_elements(SMALL)
        got = result["metrics"]["wire_GBps"]["value"]
        assert got == pytest.approx(window["steps"] * m / window["seconds"] / 1e9)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("mode", sorted(faults.BROKEN))
def test_control_and_faults_are_not_correct(name, mode):
    cell = small_cell(name)
    with faults.BROKEN[mode]():
        result, _ = run(cell)
    assert not result["correct"], (mode, result["checks"])
    assert run(cell)[0]["correct"]  # the program's own entries are back


def test_same_seed_same_inputs():
    mix = small_cell(CELLS[0]).mix
    a, b, c = (generate.snapshots(SMALL, mix, s, torch.device("cpu")) for s in (5, 5, 6))
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert not torch.equal(a[0]["grad"], c[0]["grad"])
    assert not torch.equal(a[0]["grad"], a[1]["grad"])


def test_work_counts():
    m = 1_889_110_016  # internlm2-1.8b's whole gradient
    mix = small_cell("internlm2-1.8b.grad_egress").mix
    w = egress.work(m, mix)
    assert w["quantize"][0] == 4 * m + m + 4 * m // 256
    assert w["egress_permutation"][0] == 4 * m + 8 * m
    assert w["bt_count"][0] == 2 * m
    r = ring_allreduce.work(m, small_cell("internlm2-1.8b.ring_allreduce").mix)
    assert r["noc_fabric"][0] == 3 * m and r["quantize"] == w["quantize"]
    # every layer's least time is bound by HBM at these counts
    assert all(b / 3.35e12 >= o / 67e12 for b, o in (*w.values(), *r.values()))


def test_config_files_hold_their_gradient():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        m = sum(math.prod(s) for s in cfg["leaves"].values())
        assert m == cfg["gradient_elements"] == generate.gradient_elements(cfg)
        assert set(cfg["assumed"]["weight_init"]) == set(cfg["leaves"])
        assert cfg["reduced"] == c["reduced"] == []
