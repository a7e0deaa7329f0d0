"""The hand-written CUDA kernels against their plain PyTorch versions on
the card.  Needs a CUDA device and ``nvcc``; without a device every test
here skips.  On the GPU machine, which has no JAX, this file runs alone:

    python -m pytest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import repro_torch.kernels as tk
from repro_torch.kernels.psu import MAX_N, psu_sort_cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels run only there)")
    return torch.device("cuda")


def _packets(dev, shape, seed, dtype=np.uint8, hi=256):
    a = np.random.default_rng(seed).integers(0, hi, shape).astype(dtype)
    return torch.from_numpy(a).to(dev)


@pytest.mark.parametrize("n", [1, 8, 25, 49, 64, 1024])
def test_psu_sort_kernel_matches_plain(dev, n):
    x = _packets(dev, (1003, n), n)
    x32 = _packets(dev, (1003, n), n + 1, np.int32, 1 << 16)
    tk.reset_launch_counts()
    for width, k, desc in ((8, None, False), (8, 4, True), (4, 2, False), (16, 17, True)):
        for v in (x, x32):
            got = tk.psu_sort(v, width=width, k=k, descending=desc)
            ref = tk.psu_sort(v, width=width, k=k, descending=desc, backend="torch")
            assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert tk.launch_counts()["psu_sort"] == 8
    with pytest.raises(ValueError, match=f"N <= {MAX_N}"):
        psu_sort_cuda(_packets(dev, (2, MAX_N + 1), 0))


@pytest.mark.parametrize("n,lanes,paired", [(32, 8, True), (64, 16, False), (25, 5, True)])
@pytest.mark.parametrize("pack", ["lane", "row"])
def test_psu_stream_kernel_matches_plain(dev, n, lanes, paired, pack):
    x = _packets(dev, (1003, n), n)
    w = _packets(dev, (1003, n), n + 1) if paired else None
    for k, desc in ((None, False), (4, True), (8, False)):
        kw = dict(k=k, descending=desc, input_lanes=lanes, pack=pack)
        got, ref = tk.psu_stream(x, w, **kw), tk.psu_stream(x, w, backend="torch", **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        # the stream's BT is what bt_count measures on each side of it
        assert torch.equal(got.bt_input, tk.bt_count(got.stream[:, :lanes]))


@pytest.mark.parametrize("shape", [(2, 8), (4099, 16), (1000, 5), (777, 24)])
def test_bt_count_kernel_matches_plain(dev, shape):
    s8 = _packets(dev, shape, shape[0])
    s32 = _packets(dev, shape, shape[0] + 1, np.int32, 1 << 20)
    half = shape[1] // 2
    for width in (4, 8, 16):
        for v in (s8, s8[:, :half], s8[:, half:], s32, s32[:, half:]):
            ref = tk.bt_count(v, width=width, backend="torch")
            assert torch.equal(tk.bt_count(v, width=width), ref)
