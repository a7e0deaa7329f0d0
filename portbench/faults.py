"""The control and the planted faults that ``correct`` has to catch.

Each is a context manager that replaces entries of the port while a run
lasts, so the run's timed path is broken underneath the harness:

* ``control``: the plain reference in the program's place, its floating-
  point steps (the quantizer and the weights' int8 view) in bfloat16, the
  precision below the float32 the configurations state;
* ``stale``: the quantizer hands every step the first step's output, a
  step that leaves its state unchanged;
* ``half``: every BT count measures half of its stream and doubles it,
  half of the batch left out and the rest taken for it;
* ``altered``: one int8 code altered where the quantizer produces it.

One chip runs each cell, so no fault leaves out an exchange between chips.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch import kernels, traffic
from repro_torch.noc import simulate

from .reference import wire


@contextlib.contextmanager
def _replaced(module, name: str, fn):
    saved = getattr(module, name)
    setattr(module, name, fn(saved))
    try:
        yield
    finally:
        setattr(module, name, saved)


def _bf16_quantize(_orig):
    def quantize_egress(x, block=256, backend=None):
        codes, scales = wire.quantize(x, block, torch.bfloat16)
        return codes, scales, codes.shape[0]
    return quantize_egress


def _bf16_int8_view(_orig):
    return lambda w: wire.int8_view(w, torch.bfloat16)


def _stale(orig):
    first = []

    def quantize_egress(x, block=256, backend=None):
        if not first:
            first.append(orig(x, block=block, backend=backend))
        codes, scales, mp = first[0]
        return codes.clone(), scales.clone(), mp
    return quantize_egress


def _half_bt(orig):
    def bt_count(stream, width=8, backend=None):
        return orig(stream[: max(stream.shape[0] // 2, 1)], width=width, backend=backend) * 2
    return bt_count


def _half_links(orig):
    def bt_count_links(streams, input_lanes=None, lengths=None, **kw):
        half = None if lengths is None else [max(int(n) // 2, 1) for n in lengths]
        return orig(streams, input_lanes=input_lanes, lengths=half, **kw) * 2
    return bt_count_links


def _altered(orig):
    def quantize_egress(x, block=256, backend=None):
        codes, scales, mp = orig(x, block=block, backend=backend)
        codes[codes.shape[0] // 3] ^= 1
        return codes, scales, mp
    return quantize_egress


@contextlib.contextmanager
def control():
    with _replaced(kernels, "quantize_egress", _bf16_quantize), \
            _replaced(traffic, "int8_view", _bf16_int8_view):
        yield


@contextlib.contextmanager
def stale():
    with _replaced(kernels, "quantize_egress", _stale):
        yield


@contextlib.contextmanager
def half():
    with _replaced(kernels, "bt_count", _half_bt), \
            _replaced(simulate, "bt_count_links", _half_links):
        yield


@contextlib.contextmanager
def altered():
    with _replaced(kernels, "quantize_egress", _altered):
        yield


BROKEN = {"control": control, "stale": stale, "half": half, "altered": altered}
