"""repro_torch.kernels against repro.kernels on the CPU.

On CPU tensors every wrapper runs its kernel's plain PyTorch version; the
same numpy packets go through the reference's compiled backend, and for
each kernel one small case also through ``backend="interpret"`` (the
Pallas kernel body itself).  Every integer output is compared bit-exact.
The CUDA kernels themselves run only on a GPU: they are held against
these plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as rk
import repro_torch.kernels as tk
from repro_torch.kernels import _build
from repro_torch.kernels.axes import psu_stream_cuda
from repro_torch.kernels.btcount import bt_count_cuda
from repro_torch.kernels.psu import MAX_N, psu_sort_cuda
from torch_groups import torch_threads  # noqa: F401


def _pair(shape, seed, dtype=np.uint8, hi=256):
    a = np.random.default_rng(seed).integers(0, hi, shape).astype(dtype)
    return jnp.asarray(a), torch.from_numpy(a)


def _same(jx, tx):
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
    assert str(tx.dtype).split(".")[-1] == str(np.asarray(jx).dtype)


# ------------------------------------------------------------------ psu_sort


# (width, k, descending): ACC and APP k in {2, 4, 8}, widths 4 and 8, both
# directions, each crossed with every packet width N
KEY_CASES = [
    (8, None, False), (8, 4, True), (4, 2, False), (4, None, True), (8, 8, False), (8, 2, True),
]


@pytest.mark.parametrize("n", [8, 25, 49, 64])
@pytest.mark.parametrize("width,k,desc", KEY_CASES)
def test_psu_sort_matches_reference(n, width, k, desc):
    jx, tx = _pair((65, n), n * 100 + width * 10 + (k or 0))
    jo, jr = rk.psu_sort(jx, width=width, k=k, descending=desc)
    to, tr = tk.psu_sort(tx, width=width, k=k, descending=desc)
    _same(jo, to)
    _same(jr, tr)


@pytest.mark.parametrize("dtype,hi", [(np.int32, 1 << 16), (np.int8, 128), (np.uint8, 256)])
def test_psu_sort_and_reorder_dtypes(dtype, hi):
    jx, tx = _pair((130, 32), 11, dtype, hi)
    jo, jr = rk.psu_sort(jx, k=4)
    to, tr = tk.psu_sort(tx, k=4)
    _same(jo, to)
    _same(jr, tr)
    _same(rk.psu_reorder(jx, k=4, descending=True), tk.psu_reorder(tx, k=4, descending=True))


def test_psu_sort_interpret_case():
    jx, tx = _pair((9, 25), 5)
    jo, jr = rk.psu_sort(jx, width=8, k=4, backend="interpret", block_packets=8)
    to, tr = tk.psu_sort(tx, width=8, k=4)
    _same(jo, to)
    _same(jr, tr)


# ------------------------------------------------------------------ bt_count


@pytest.mark.parametrize(
    "shape,width", [((1, 8), 8), ((2, 16), 4), ((513, 16), 8), ((4096, 8), 16), ((300, 5), 4)]
)
def test_bt_count_matches_reference(shape, width):
    jx, tx = _pair(shape, shape[0] + width)
    got = tk.bt_count(tx, width=width)
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == int(rk.bt_count(jx, width=width))
    half = shape[1] // 2  # the staged TX path's non-contiguous column slices
    for js, ts in ((jx[:, :half], tx[:, :half]), (jx[:, half:], tx[:, half:])):
        assert int(tk.bt_count(ts, width=width)) == int(rk.bt_count(js, width=width))


def test_bt_count_int32_streams():
    jx, tx = _pair((700, 16), 3, np.int32, 1 << 20)
    for width in (4, 12, 16):
        assert int(tk.bt_count(tx, width=width)) == int(rk.bt_count(jx, width=width))


def test_bt_count_interpret_case():
    jx, tx = _pair((600, 16), 4)
    assert int(tk.bt_count(tx)) == int(rk.bt_count(jx, backend="interpret"))


# ---------------------------------------------------------------- psu_stream


def _stream_same(jres, tres):
    for a, b in zip(jres, tres):
        _same(a, b)


@pytest.mark.parametrize(
    "p,width,k,desc,pack",
    [
        (130, 8, None, False, "lane"),
        (130, 8, 4, True, "lane"),
        (65, 4, 2, False, "row"),
        (7, 4, None, True, "row"),
        (130, 8, 8, False, "row"),
        (64, 8, 2, True, "lane"),
        (65, 4, 4, False, "lane"),
        (130, 8, 4, False, "row"),
    ],
)
def test_psu_stream_paired_matches_reference(p, width, k, desc, pack):
    jx, tx = _pair((p, 32), p + width)
    jw, tw = _pair((p, 32), p + width + 1)
    kw = dict(width=width, k=k, descending=desc, pack=pack)
    _stream_same(rk.psu_stream(jx, jw, **kw), tk.psu_stream(tx, tw, **kw))


@pytest.mark.parametrize(
    "n,lanes,pack",
    [(48, 16, "lane"), (64, 16, "row"), (25, 5, "lane"), (49, 7, "row"), (8, 8, "lane")],
)
def test_psu_stream_input_only_matches_reference(n, lanes, pack):
    jx, tx = _pair((33, n), n)
    kw = dict(k=4, input_lanes=lanes, pack=pack)
    _stream_same(rk.psu_stream(jx, None, **kw), tk.psu_stream(tx, None, **kw))


def test_psu_stream_zero_weights_when_only_lanes_given():
    jx, tx = _pair((20, 64), 2)
    kw = dict(input_lanes=16, weight_lanes=16)
    _stream_same(rk.psu_stream(jx, None, **kw), tk.psu_stream(tx, None, **kw))


def test_psu_stream_int32_packets():
    jx, tx = _pair((70, 32), 8, np.int32, 1 << 12)
    jw, tw = _pair((70, 32), 9, np.int32, 1 << 12)
    for width in (8, 12):
        _stream_same(rk.psu_stream(jx, jw, width=width), tk.psu_stream(tx, tw, width=width))


def test_psu_stream_interpret_case():
    jx, tx = _pair((11, 32), 12)
    jw, tw = _pair((11, 32), 13)
    jres = rk.psu_stream(jx, jw, k=4, backend="interpret", block_packets=8)
    _stream_same(jres, tk.psu_stream(tx, tw, k=4))


def test_psu_stream_validation():
    x = torch.zeros((4, 32), dtype=torch.uint8)
    with pytest.raises(ValueError, match="divisible"):
        tk.psu_stream(x, input_lanes=5)
    with pytest.raises(ValueError, match="symmetric"):
        tk.psu_stream(x, x, weight_lanes=4)
    with pytest.raises(ValueError, match="'lane'\\|'row'"):
        tk.psu_stream(x, x, pack="col")
    with pytest.raises(ValueError, match="k in \\[1, 5\\]"):
        tk.psu_stream(x, x, width=4, k=8)
    with pytest.raises(ValueError, match="paired shapes"):
        tk.psu_stream(x, x[:, :16])


# ------------------------------------------------------------ dispatch / build


def test_device_decides_dispatch():
    x = torch.zeros((3, 16), dtype=torch.uint8)
    tk.reset_launch_counts()
    o, _ = tk.psu_sort(x)  # CPU tensor -> plain version, no launch
    assert o.device.type == "cpu"
    o2, _ = tk.psu_sort(x, backend="torch")
    assert torch.equal(o, o2)
    assert tk.launch_counts() == {"psu_sort": 0, "bt_count": 0, "psu_stream": 0, "bt_axes": 0,
                                  "bt_axes_activity": 0, "quantize_egress": 0}
    for bad in ("pallas", "cuda"):
        with pytest.raises(ValueError, match="unknown kernel backend"):
            tk.psu_sort(x, backend=bad)


def test_cuda_wrappers_check_before_launch():
    x = torch.zeros((3, 32), dtype=torch.uint8)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        psu_sort_cuda(x)
    with pytest.raises(ValueError, match=f"N <= {MAX_N}"):
        psu_sort_cuda(torch.zeros((2, MAX_N + 1), dtype=torch.uint8))
    with pytest.raises(TypeError, match="uint8 or int32"):
        psu_sort_cuda(x.to(torch.int64))
    with pytest.raises(ValueError, match="width"):
        bt_count_cuda(x, width=17)
    with pytest.raises(ValueError, match="contiguous lanes"):
        bt_count_cuda(x.t())
    with pytest.raises(ValueError, match=f"N <= {MAX_N}"):
        psu_stream_cuda(
            torch.zeros((2, 2048), dtype=torch.uint8), None, width=8, k=None,
            descending=False, input_lanes=8, weight_lanes=0, pack="lane",
        )


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
    assert sorted(p.name for p in _build.CSRC.glob("*.cu")) == [
        "axes.cu", "btcount.cu", "psu.cu", "quantize.cu", "stream.cu",
    ]
