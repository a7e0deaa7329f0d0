"""Real-model traffic capture: tap the model zoo, record int8 wire streams.

Counterpart of ``repro.obs.capture``.  It records the model zoo's actual
traffic — the decode weight and KV streams of ``repro_torch.serve``, a
train step's gradient all-reduce payload (``repro_torch.train``), the MoE
dispatch buffers of ``repro_torch.models.moe`` and the trained LeNet's conv
kernels (``repro_torch.models.lenet``) — as int8 wire images
(``repro_torch.traffic.int8_view``), ready for the measurement stack:
``TxPipeline`` / ``dse.evaluate_grid`` / ``noc.simulate_noc`` / the
activity windows.

The hook contract is ``repro_torch._obs_hooks``'s (zero cost when
uninstalled): production modules call ``_obs_hooks.tap(kind, **payload)``
at fixed tap sites — one ``None`` test while no capture is active; a
:func:`capture` context installs this module's ``_Tap`` into
``_obs_hooks.TAP`` and every firing fans out to all active
:class:`CaptureSession`\\ s.  The reference's tap drops payloads that are
jax tracers (tap sites inside jitted functions or under ``jax.grad``); the
port has no tracers, so ``repro_torch.serve`` runs the model, and
``repro_torch.train`` the loss and its backward, inside
``_obs_hooks.muted()`` instead, and a capture records exactly the
reference's streams.

The scenario drivers take their inputs from a seed, drawn with numpy
(model weights from a seeded ``torch.Generator``), or explicitly
(``params=``, ``inputs=``, ``images=``), so the tests can feed both
packages the same bytes.

A stream's bytes stay on the device of the tensor it was taken from (a
1-D uint8 tensor): a full-width weight stream is measured where it was
captured, without a round trip through the host.  ``save_session`` /
``load_session`` write and read the reference's ``.npz`` format (one uint8
array per stream plus a JSON manifest), so each package reads the
other's files.

The tap vocabulary (kind -> scenario):

  =================  ===============  =====================================
  kind               scenario         fired by
  =================  ===============  =====================================
  serve.weights      serve_decode     ``serve.generate`` once before the
                                      decode loop (the multicast weight
                                      stream)
  serve.kv           serve_decode     ``serve.generate`` after each decode
                                      step (the new KV / SSM-state bytes)
  train.grads        train_allreduce  ``train.make_train_step`` after the
                                      gradients are computed
  moe.dispatch       moe_dispatch     ``models.moe.moe_block`` after the
                                      expert input buffers are gathered
  lenet.conv         lenet_conv       ``models.lenet.lenet_forward``
                                      (trained conv kernels + input batch)
  =================  ===============  =====================================

Each recorded stream fires a ``capture.stream`` probe event (bytes per
scenario/stream), so captures show in ``obs.collect`` registries.
"""

from __future__ import annotations

import dataclasses
import json
from contextlib import contextmanager
from typing import Sequence

import numpy as np
import torch

from .. import _obs_hooks
from .._tree import leaves
from ..kernels.backend import resolve_device
from ..traffic.ordering import int8_view

__all__ = [
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

# the canonical tap vocabulary: tap kind -> report scenario.  Unknown kinds
# capture under their own name.
TAP_SCENARIOS: dict[str, str] = {
    "serve.weights": "serve_decode",
    "serve.kv": "serve_decode",
    "train.grads": "train_allreduce",
    "moe.dispatch": "moe_dispatch",
    "lenet.conv": "lenet_conv",
}


# --------------------------------------------------------------------------
# captured streams and sessions
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CapturedStream:
    """One recorded int8 wire stream.

    ``data`` is the 1-D uint8 tensor of the tensor's symmetric int8 wire
    image (``repro_torch.traffic.int8_view``), on the device it was
    captured from — exactly the bytes the link / NoC / DSE stack measures.
    """

    scenario: str
    name: str
    kind: str
    data: torch.Tensor
    source_shape: tuple[int, ...]
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def num_bytes(self) -> int:
        return int(self.data.numel())


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _int8_bytes(x) -> torch.Tensor:
    """A tensor's int8 wire image as 1-D uint8 (int8 / uint8 data passes
    through unquantized — it IS its own wire image)."""
    t = _as_tensor(x)
    if t.dtype == torch.uint8:
        return t.reshape(-1)
    if t.dtype == torch.int8:
        return t.reshape(-1).view(torch.uint8)
    return int8_view(t).reshape(-1).view(torch.uint8)


def _tree_bytes(tree, min_ndim: int) -> tuple[torch.Tensor, int]:
    """Concatenated int8 wire bytes of a tree's float leaves (one amax per
    leaf, stacked layers included), in sorted-key order."""
    sel = [
        x for x in leaves(tree)
        if isinstance(x, torch.Tensor) and x.dim() >= min_ndim and x.numel()
        and x.is_floating_point()
    ]
    if not sel:
        return torch.zeros(0, dtype=torch.uint8), 0
    out = torch.empty(sum(x.numel() for x in sel), dtype=torch.uint8, device=sel[0].device)
    at = 0
    for x in sel:
        out[at: at + x.numel()] = _int8_bytes(x)
        at += x.numel()
    return out, len(sel)


class CaptureSession:
    """An ordered collection of captured streams, grouped by scenario.

    Sessions are what the :func:`capture` context yields; they convert to
    the measurement stack's shapes via :meth:`packets` (one packet matrix)
    and :meth:`workload` (one ``repro_torch.dse.Workload`` with each
    captured stream measured independently — no seam transitions between
    streams, so per-stream BT sums exactly to the scenario total).
    """

    def __init__(self, name: str = "capture") -> None:
        self.name = name
        self.streams: list[CapturedStream] = []

    # ---------------- recording ----------------

    def add(self, scenario: str, name: str, tensor, *, kind: str = "manual",
            **meta) -> CapturedStream:
        """Quantize ``tensor`` to its int8 wire image and record it."""
        data = _int8_bytes(tensor)
        shape = tuple(int(d) for d in getattr(tensor, "shape", (data.numel(),)))
        s = self._add_bytes(scenario, name, data, shape, kind, meta)
        _obs_hooks.event("capture.stream", tap=kind, scenario=scenario, stream=name,
                         bytes=s.num_bytes)
        return s

    def _add_bytes(self, scenario: str, name: str, data: torch.Tensor,
                   source_shape: tuple[int, ...], kind: str, meta: dict) -> CapturedStream:
        s = CapturedStream(
            scenario=scenario,
            name=name,
            kind=kind,
            data=_as_tensor(data).to(torch.uint8).reshape(-1),
            source_shape=tuple(int(d) for d in source_shape),
            meta=dict(meta),
        )
        self.streams.append(s)
        return s

    # ---------------- inspection ----------------

    def scenarios(self) -> tuple[str, ...]:
        return tuple(dict.fromkeys(s.scenario for s in self.streams))

    def get(self, scenario: str, name: str | None = None) -> list[CapturedStream]:
        return [s for s in self.streams
                if s.scenario == scenario and (name is None or s.name == name)]

    def _select(self, scenario: str, names: Sequence[str] | None) -> list[CapturedStream]:
        return [s for s in self.get(scenario) if names is None or s.name in names]

    def scenario_bytes(self, scenario: str, names: Sequence[str] | None = None) -> torch.Tensor:
        sel = self._select(scenario, names)
        if not sel:
            return torch.zeros(0, dtype=torch.uint8)
        return sel[0].data if len(sel) == 1 else torch.cat([s.data for s in sel])

    # ---------------- conversion to the measurement stack ----------------

    def packets(self, scenario: str, elems: int = 64, *, names: Sequence[str] | None = None,
                owner: str | None = None, strict: bool = False) -> torch.Tensor:
        """The scenario's captured bytes as one (P, elems) packet matrix.

        ``strict=True`` raises a clear :class:`ValueError` naming ``owner``
        when the byte count is not flit-divisible (otherwise the tail is
        trimmed to whole packets, the NoC-flow convention)."""
        data = self.scenario_bytes(scenario, names)
        return _bytes_to_packets(data, elems, owner=owner or scenario, strict=strict)

    def workload(self, scenario: str, *, elems: int = 64, lanes: int = 16,
                 names: Sequence[str] | None = None, owner: str | None = None,
                 strict: bool = False):
        """The scenario as a ``repro_torch.dse.Workload``: every captured
        stream becomes its own (P, elems) measurement stream (independent
        links, Table-I style — stream BT adds with no seam transitions)."""
        from ..dse.evaluate import Workload  # deferred: dse loads the kernels

        label = owner or scenario
        sel = self._select(scenario, names)
        if not sel:
            raise ValueError(
                f"{label}: no captured streams for scenario {scenario!r} "
                f"(captured: {list(self.scenarios()) or 'nothing'})"
            )
        pkts = tuple(_bytes_to_packets(s.data, elems, owner=f"{label}/{s.name}", strict=strict)
                     for s in sel)
        return Workload(name=label, streams=pkts, lanes=lanes)


def _bytes_to_packets(data: torch.Tensor, elems: int, *, owner: str,
                      strict: bool) -> torch.Tensor:
    n = int(data.numel())
    if strict and n % elems:
        raise ValueError(
            f"{owner}: captured stream carries {n} bytes, which is not "
            f"divisible into {elems}-byte packets ({n % elems} bytes left "
            f"over) — the config's dims are not flit-divisible; pad the "
            f"model dims or pick a LinkSpec whose packet size divides {n}"
        )
    p = n // elems
    if p == 0:
        raise ValueError(
            f"{owner}: captured only {n} bytes — smaller than one "
            f"{elems}-byte packet; capture more traffic or shrink the "
            f"packet size"
        )
    return data[: p * elems].reshape(p, elems)


# --------------------------------------------------------------------------
# the tap installed into repro_torch._obs_hooks.TAP
# --------------------------------------------------------------------------


def _extract(kind: str, payload: dict) -> list[tuple]:
    """(name, bytes, source_shape, meta) streams of one tap firing."""
    if kind == "serve.weights":
        data, n = _tree_bytes(payload["params"], 2)
        return [("weights", data, (int(data.numel()),), {"leaves": n})]
    if kind == "serve.kv":
        cache = payload["cache"]
        step = int(payload.get("step", 0))
        parts = []
        if "k" in cache:
            # decode_step already advanced pos: the new KV row is pos-1
            pos = max(int(cache["pos"]) - 1, 0)
            for key in ("k", "v"):
                parts.append(_int8_bytes(cache[key][:, :, pos]))
        for key in ("ssm", "ssm_trailing"):
            if key in cache:
                parts.append(_tree_bytes(cache[key], 2)[0])
        data = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.uint8)
        return [("kv", data, (int(data.numel()),), {"step": step})]
    if kind == "train.grads":
        data, n = _tree_bytes(payload["grads"], 1)
        return [("grads", data, (int(data.numel()),), {"leaves": n})]
    if kind == "moe.dispatch":
        ei = payload["expert_in"]
        shape = tuple(int(d) for d in ei.shape)  # (G, E, C, D)
        return [("expert_in", _int8_bytes(ei), shape,
                 {"experts": shape[1], "capacity": shape[2]})]
    # generic: every tensor-valued payload entry becomes one stream
    return [(name, _int8_bytes(t), tuple(int(d) for d in t.shape), {})
            for name, t in payload.items()
            if getattr(t, "ndim", None) is not None and t.numel()]


class _Tap:
    """The multiplexer installed into ``repro_torch._obs_hooks.TAP``."""

    def __init__(self) -> None:
        self.sessions: list[CaptureSession] = []

    def tap(self, kind: str, payload: dict) -> None:
        scenario = TAP_SCENARIOS.get(kind, kind)
        for name, data, shape, meta in _extract(kind, payload):
            for sess in self.sessions:
                sess._add_bytes(scenario, name, data, shape, kind, meta)
            _obs_hooks.event("capture.stream", tap=kind, scenario=scenario, stream=name,
                             bytes=int(data.numel()))


_TAP = _Tap()


def _refresh() -> None:
    _obs_hooks.TAP = _TAP if _TAP.sessions else None


@contextmanager
def capture(session: CaptureSession | None = None):
    """Activate traffic capture for the with-body; yields the session.

    Nested ``capture()`` scopes all record every tap firing (each scope
    keeps its own streams).  Entering the first scope installs the tap —
    before that, tap sites are a ``None`` test and nothing else.
    """
    sess = CaptureSession() if session is None else session
    _TAP.sessions.append(sess)
    _refresh()
    try:
        yield sess
    finally:
        _TAP.sessions.remove(sess)
        _refresh()


# --------------------------------------------------------------------------
# scenario drivers
# --------------------------------------------------------------------------


def train_batch(cfg, batch: int = 2, seq: int = 16, seed: int = 0,
                device: str | torch.device | None = None) -> dict:
    """A family-aware random batch for ``make_train_step`` on ``device``
    (``cuda`` unless named), drawn with numpy from ``seed``: int32 tokens
    and labels, float32 stub frames (encoder-decoder) or patch embeddings
    (VLM, whose labels are padded with -100 over the patches)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
    out = {"tokens": tok, "labels": lab}
    if cfg.family in ("encdec", "audio"):
        out["frames"] = rng.standard_normal((batch, 8, cfg.d_model), dtype=np.float32)
    elif cfg.family == "vlm":
        out["patches"] = rng.standard_normal((batch, cfg.n_frontend_tokens, cfg.d_model),
                                             dtype=np.float32)
        out["labels"] = np.pad(lab, ((0, 0), (cfg.n_frontend_tokens, 0)), constant_values=-100)
    return {k: torch.from_numpy(v).to(dev) for k, v in out.items()}


def capture_serve_decode(
    cfg,
    *,
    batch: int = 2,
    prompt: int = 8,
    new_tokens: int = 4,
    seed: int = 0,
    session: CaptureSession | None = None,
    device: str | torch.device | None = None,
) -> CaptureSession:
    """Run ``serve.generate`` under capture on ``device`` (``cuda`` unless
    named): records the multicast weight stream once plus one KV/state
    stream per decoded token.  Weights and prompts come from a generator
    seeded with ``seed`` (not the reference's JAX RNG)."""
    from ..models import init_params
    from ..models.layers import torch_dtype
    from ..serve.loop import generate

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(cfg, gen, dev)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen, device=dev)
    kw = {}
    if cfg.family in ("encdec", "audio"):
        kw["frames"] = torch.randn((batch, 8, cfg.d_model), generator=gen, device=dev)
    elif cfg.family == "vlm":
        kw["inputs_embeds"] = torch.randn((batch, cfg.n_frontend_tokens, cfg.d_model),
                                          generator=gen, device=dev).to(torch_dtype(cfg.dtype))
    with capture(session) as sess:
        generate(params, cfg, prompts, new_tokens, **kw)
    return sess


def capture_train_step(
    cfg,
    *,
    batch: int = 2,
    seq: int = 16,
    seed: int = 0,
    session: CaptureSession | None = None,
    device: str | torch.device | None = None,
    params=None,
    inputs: dict | None = None,
) -> CaptureSession:
    """Run one train step under capture on ``device`` (``cuda`` unless
    named): the ``train.grads`` tap records the gradient all-reduce
    payload.  Weights come from a generator seeded with ``seed`` (updated
    in place by the step) unless ``params`` is given (left as it was), the
    batch from :func:`train_batch` unless ``inputs`` is given."""
    from ..models import init_params
    from ..optim import AdamWConfig
    from ..optim import init as opt_init
    from ..train import make_train_step

    dev = resolve_device(device)
    own = params is None
    if own:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    opt = opt_init(params)
    step = make_train_step(cfg, AdamWConfig(warmup_steps=1, total_steps=10), donate=own)
    data = train_batch(cfg, batch, seq, seed, dev) if inputs is None else inputs
    with capture(session) as sess:
        step(params, opt, data)
    return sess


def capture_moe_dispatch(
    cfg,
    *,
    batch: int = 2,
    seq: int = 16,
    seed: int = 0,
    session: CaptureSession | None = None,
    device: str | torch.device | None = None,
) -> CaptureSession:
    """Run one MoE block under capture on ``device`` (``cuda`` unless
    named): records the dispatched expert input buffers (the dispatch
    traffic)."""
    if cfg.moe is None:
        raise ValueError(
            f"config family {cfg.family!r} has no MoE block; "
            "capture_moe_dispatch needs a MoE config"
        )
    from ..models.layers import torch_dtype
    from ..models.moe import init_moe, moe_block

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_moe(gen, cfg, (), dev)
    x = torch.randn((batch, seq, cfg.d_model), generator=gen, device=dev).to(
        torch_dtype(cfg.dtype))
    with capture(session) as sess, torch.no_grad():
        moe_block(params, x, cfg)
    return sess


def _lenet_images(n: int = 8, seed: int = 0,
                 device: str | torch.device | None = None) -> torch.Tensor:
    """``n`` (n, 32, 32, 1) LeNet task images on ``device`` (``cuda``
    unless named), drawn with numpy from ``seed``: class templates plus
    0.3 x normal noise, ``models.lenet.synth_batch``'s recipe."""
    from ..models.lenet import NUM_CLASSES, _templates

    rng = np.random.default_rng(seed)
    labels = rng.integers(0, NUM_CLASSES, n)
    imgs = _templates(seed)[labels] + np.float32(0.3) * rng.standard_normal(
        (n, 32, 32), dtype=np.float32)
    return torch.from_numpy(imgs[..., None]).to(resolve_device(device))


def capture_lenet_conv(
    params=None,
    *,
    steps: int = 300,
    batch: int = 64,
    seed: int = 0,
    ckpt_dir: str | None = None,
    session: CaptureSession | None = None,
    device: str | torch.device | None = None,
    images: torch.Tensor | None = None,
) -> CaptureSession:
    """Run a trained LeNet forward under capture on ``device`` (``cuda``
    unless named): records the trained (zero-clustered) conv kernels plus
    the input batch.  With ``params=None`` the model is trained in-repo
    first (restored from ``ckpt_dir`` when a checkpoint exists); the 8
    images are numpy draws from ``seed`` unless ``images`` is given."""
    from ..models import lenet

    dev = resolve_device(device)
    if params is None:
        params, _ = lenet.train_lenet(steps=steps, batch=batch, seed=seed, ckpt_dir=ckpt_dir,
                                      device=dev)
    if images is None:
        images = _lenet_images(8, seed, dev)
    with capture(session) as sess, torch.no_grad():
        lenet.lenet_forward(params, images)
    return sess


# --------------------------------------------------------------------------
# capture -> replay (artifact round-trip)
# --------------------------------------------------------------------------


def save_session(path: str, session: CaptureSession) -> None:
    """Persist a session's streams as one .npz (bytes + JSON manifest), in
    the reference's format."""
    manifest = [
        {
            "scenario": s.scenario,
            "name": s.name,
            "kind": s.kind,
            "source_shape": list(s.source_shape),
            "meta": s.meta,
        }
        for s in session.streams
    ]
    arrays = {f"s{i}": s.data.cpu().numpy() for i, s in enumerate(session.streams)}
    arrays["manifest"] = np.frombuffer(
        json.dumps({"name": session.name, "streams": manifest}).encode(), dtype=np.uint8
    )
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_session(path: str, device: str | torch.device | None = None) -> CaptureSession:
    """Rebuild a session from a :func:`save_session` artifact (either
    package's), its streams on ``device`` (``cuda`` unless named)."""
    dev = resolve_device(device)
    data = np.load(path)
    doc = json.loads(bytes(data["manifest"]).decode())
    sess = CaptureSession(doc.get("name", "capture"))
    for i, entry in enumerate(doc["streams"]):
        sess._add_bytes(
            entry["scenario"],
            entry["name"],
            torch.from_numpy(np.asarray(data[f"s{i}"], dtype=np.uint8).copy()).to(dev),
            tuple(entry["source_shape"]),
            entry["kind"],
            entry.get("meta", {}),
        )
    return sess
