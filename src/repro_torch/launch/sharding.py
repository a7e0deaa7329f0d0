"""Sharding rules: DP / TP / EP / SP assignment per parameter and input.

Counterpart of ``repro.launch.sharding``, with the same rules (DESIGN.md
§5):
  * batch           -> ("pod","data")  [DP; falls back to sequence (SP) when
                       the batch doesn't divide, e.g. long_500k's batch=1]
  * attention heads -> "model" (TP); GQA archs whose kv-head count doesn't
                       divide the axis shard the contraction (d_model) side
  * d_ff            -> "model" (Megatron column->row pair: one all-reduce)
  * experts         -> "model" (EP; granite pads 40 -> 48 experts)
  * vocab           -> "model" when divisible, else embedding d-axis
  * SSD blocks      -> contraction sharding on in/out projections; SSM head
                       axis of activations/caches on "model"

Every rule guards divisibility and falls back to replication.  A spec is a
:class:`PartitionSpec`, a tuple with one entry per leading tensor dim:
``None``, an axis name, or a tuple of axis names (a one-name tuple reads as
the name, as jax's does), padded exactly as the reference pads it.  A
sharding is a :class:`NamedSharding` (mesh, spec); :func:`to_placements`
turns a spec into the DTensor placements of a ``DeviceMesh``.  Leaf paths
are ``repro_torch._tree``'s ``keystr`` paths, which equal
``jax.tree_util.keystr``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from .._tree import tree_map_with_path
from ..models.config import ModelConfig
from .mesh import dp_axes, mesh_axes

__all__ = ["PartitionSpec", "P", "NamedSharding", "param_spec", "params_shardings",
           "opt_shardings", "batch_shardings", "cache_shardings", "replicated",
           "to_placements", "spec_axes"]


class PartitionSpec(tuple):
    """An immutable per-dim spec: ``PartitionSpec(None, "model")``."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return e[0] if len(e) == 1 else e
            return e

        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return "PartitionSpec" + (super().__repr__() if len(self) != 1
                                  else f"({self[0]!r})")


P = PartitionSpec


def spec_axes(spec: PartitionSpec) -> list[str]:
    """The mesh axis names a spec uses, in dim order."""
    out: list[str] = []
    for e in spec:
        if e is None:
            continue
        out.extend(e if isinstance(e, tuple) else (e,))
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``DeviceMesh`` or abstract)."""

    mesh: Any
    spec: PartitionSpec

    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


def to_placements(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim ``Shard(d)``
    for the tensor dim d its axis splits, else ``Replicate()``.  A tensor
    dim split over several axes (the ("pod", "data") batch) must name them
    in mesh order, the order DTensor splits in."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    dim_of: dict[str, int] = {}
    for d, e in enumerate(spec):
        group = () if e is None else (e if isinstance(e, tuple) else (e,))
        if [names.index(a) for a in group if a in names] != sorted(
                names.index(a) for a in group if a in names):
            raise ValueError(f"{spec}: axes {group} of dim {d} are not in mesh order {names}")
        for a in group:
            if a not in names:
                raise ValueError(f"{spec}: no mesh axis {a!r} in {names}")
            if a in dim_of:
                raise ValueError(f"{spec}: axis {a!r} splits two dims")
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate() for a in names)


def _div(n: int, m: int) -> bool:
    return m > 0 and n % m == 0


def _pad_rank(spec: tuple, rank: int) -> PartitionSpec:
    """Left-pad a trailing-dims spec with None up to the leaf rank (covers
    the layer-stack leading axis)."""
    pad = rank - len(spec)
    return P(*((None,) * pad + spec))


def _norm_path(path: str) -> str:
    """Normalize keystr paths: "['layers']['attn']['wq']" -> ".layers.attn.wq"."""
    return path.replace("['", ".").replace("']", "").replace("[", ".").replace("]", "")


def param_spec(
    path: str, shape: tuple[int, ...], cfg: ModelConfig, mesh, mode: str = "train"
) -> PartitionSpec:
    m = mesh_axes(mesh)["model"]
    path = _norm_path(path)
    name = path.rsplit(".", 1)[-1]
    rank = len(shape)
    if cfg.pure_dp:
        return P()  # replicate everything; batch shards over all axes
    if cfg.fsdp and mode == "train":
        return _fsdp_spec(path, name, shape, cfg, mesh)

    if name == "embed":
        v, d = shape
        if _div(v, m):
            return P("model", None)
        if _div(d, m):
            return P(None, "model")
        return P()
    if name == "head":
        d, v = shape
        if _div(v, m):
            return P(None, "model")
        if _div(d, m):
            return P("model", None)
        return P()

    if ".attn" in path or ".cross_attn" in path:
        if name == "wq":
            d, h, hd = shape[-3:]
            if _div(h, m):
                return _pad_rank((None, "model", None), rank)
            if _div(d, m):
                return _pad_rank(("model", None, None), rank)
            return P()
        if name in ("wk", "wv"):
            d, hkv, hd = shape[-3:]
            if _div(hkv, m):
                return _pad_rank((None, "model", None), rank)
            # GQA with kv-heads < TP degree: replicate the (small) kv
            # projections (the reference's measured choice)
            return P()
        if name == "wo":
            h, hd, d = shape[-3:]
            if _div(h, m):
                return _pad_rank(("model", None, None), rank)
            if _div(d, m):
                return _pad_rank((None, None, "model"), rank)
            return P()
        return P()  # q_norm / k_norm / biases

    if ".moe" in path:
        if name == "router":
            d, e = shape[-2:]
            return _pad_rank((None, "model"), rank) if _div(e, m) else P()
        if name in ("gate", "up", "down"):
            e = shape[-3]
            if _div(e, m):
                return _pad_rank(("model", None, None), rank)
            ff_axis = -1 if name in ("gate", "up") else -2
            if _div(shape[ff_axis], m):
                spec = [None, None, None]
                spec[ff_axis] = "model"
                return _pad_rank(tuple(spec), rank)
            return P()
        if name.startswith("shared_"):
            ff_axis = -1 if name in ("shared_gate", "shared_up") else -2
            spec = [None, None]
            if _div(shape[ff_axis], m):
                spec[ff_axis] = "model"
            return _pad_rank(tuple(spec), rank)
        return P()

    if ".mlp" in path:
        if name in ("gate", "up"):
            d, ff = shape[-2:]
            return _pad_rank((None, "model"), rank) if _div(ff, m) else P()
        if name == "down":
            ff, d = shape[-2:]
            return _pad_rank(("model", None), rank) if _div(ff, m) else P()
        return P()

    if ".ssd" in path:
        if name == "in_proj":  # contraction (d_model) sharding
            d = shape[-2]
            return _pad_rank(("model", None), rank) if _div(d, m) else P()
        if name == "out_proj":  # contraction (d_inner) sharding
            di = shape[-2]
            return _pad_rank(("model", None), rank) if _div(di, m) else P()
        return P()  # conv / dt / a_log / norms: small, replicated

    return P()  # norms and anything unmatched: replicated


def _fsdp_spec(path: str, name: str, shape: tuple[int, ...], cfg, mesh) -> PartitionSpec:
    """ZeRO-3-style 2D sharding: "model" on the TP axis as usual, plus the
    largest remaining axis sharded over "data"."""
    axes = mesh_axes(mesh)
    m, d = axes["model"], axes["data"]
    rank = len(shape)

    def pick(tp_axis: int | None) -> PartitionSpec:
        spec: list = [None] * rank
        if tp_axis is not None:
            spec[tp_axis] = "model"
        # largest un-taken axis divisible by the data-axis size
        best, best_size = None, 0
        for i, s in enumerate(shape):
            if i == tp_axis:
                continue
            if _div(s, d) and s > best_size:
                best, best_size = i, s
        if best is not None:
            spec[best] = "data"
        return P(*spec)

    if name == "embed":
        return pick(0 if _div(shape[0], m) else (1 if _div(shape[1], m) else None))
    if name == "head":
        return pick(1 if _div(shape[1], m) else None)
    if name in ("wq",):
        h = shape[-2]
        return pick(rank - 2 if _div(h, m) else None)
    if name in ("wk", "wv"):
        hkv = shape[-2]
        return pick(rank - 2 if _div(hkv, m) else None)
    if name == "wo":
        h = shape[-3]
        return pick(rank - 3 if _div(h, m) else None)
    if name in ("gate", "up", "down") and ".moe" in path:
        e = shape[-3]
        return pick(rank - 3 if _div(e, m) else None)
    if name == "router":
        return pick(rank - 1 if _div(shape[-1], m) else None)
    if name in ("gate", "up") and ".mlp" in path:
        return pick(rank - 1 if _div(shape[-1], m) else None)
    if name == "down" and ".mlp" in path:
        return pick(rank - 2 if _div(shape[-2], m) else None)
    if name in ("in_proj", "out_proj"):
        return pick(rank - 2 if _div(shape[-2], m) else None)
    # small leaves (norms, biases): replicate
    return P()


def params_shardings(cfg: ModelConfig, mesh, params_shapes: Any, mode: str = "train") -> Any:
    """The tree of :class:`NamedSharding` of a params tree (tensors, meta
    tensors or anything with ``.shape`` at the leaves)."""
    return tree_map_with_path(
        lambda path, x: NamedSharding(mesh, param_spec(path, tuple(x.shape), cfg, mesh, mode)),
        params_shapes)


def opt_shardings(cfg: ModelConfig, mesh, opt_shapes: Any, params_shapes: Any) -> Any:
    """Optimizer m/v mirror the parameter shardings; step is replicated.

    With ``cfg.zero1`` the m/v leaves are additionally sharded over the
    "data" axis (first free divisible dim): ZeRO-1.  A leaf whose param
    spec already holds "data" (an ``fsdp`` config) would name the axis
    twice; the reference builds that spec and jax refuses it
    (``DuplicateSpecError``), so this raises ``ValueError``.
    """
    p_sh = params_shardings(cfg, mesh, params_shapes)
    if not cfg.zero1:
        return type(opt_shapes)(step=NamedSharding(mesh, P()), m=p_sh,
                                v=tree_map_with_path(lambda _, s: s, p_sh))
    d = mesh_axes(mesh)["data"]

    def add_data_axis(path: str, sh: NamedSharding, shape_leaf) -> NamedSharding:
        shape = tuple(shape_leaf.shape)
        spec = list(sh.spec) + [None] * (len(shape) - len(sh.spec))
        for i, s in enumerate(shape):
            if spec[i] is None and _div(s, d):
                if "data" in spec_axes(sh.spec):
                    raise ValueError(
                        f"zero1 on {path}: its spec {sh.spec} already holds 'data' "
                        f"(cfg.fsdp={cfg.fsdp}); the reference's presets turn fsdp off "
                        f"with zero1")
                spec[i] = "data"
                break
        return NamedSharding(mesh, P(*spec))

    mv_sh = tree_map_with_path(add_data_axis, p_sh, params_shapes)
    return type(opt_shapes)(step=NamedSharding(mesh, P()), m=mv_sh,
                            v=tree_map_with_path(lambda _, s: s, mv_sh))


# --------------------------------------------------------------------------
# input / cache shardings
# --------------------------------------------------------------------------


def _dp_size(mesh, dp: tuple[str, ...]) -> int:
    axes = mesh_axes(mesh)
    out = 1
    for a in dp:
        out *= axes[a]
    return out


def batch_shardings(cfg: ModelConfig, mesh, batch_shapes: dict) -> dict:
    dp = dp_axes(mesh)
    if cfg.pure_dp:
        dp = tuple(mesh_axes(mesh))  # batch over every axis incl. "model"
    dpn = _dp_size(mesh, dp)

    def leaf(x):
        shape = tuple(x.shape)
        spec = [None] * len(shape)
        if _div(shape[0], dpn):
            spec[0] = dp
        elif len(shape) > 1 and _div(shape[1], dpn):
            spec[1] = dp  # SP fallback: shard sequence
        return NamedSharding(mesh, P(*spec))

    return {k: leaf(v) for k, v in batch_shapes.items()}


def cache_shardings(cfg: ModelConfig, mesh, cache_shapes: dict) -> dict:
    """KV/SSM cache shardings for decode cells.

    k/v: (L, B, S, Hkv, hd)  -> B over DP (or S when B=1: SP), Hkv over model
    ssm state: (L, B, H, N, P) -> B over DP, H over model
    conv: (L, B, K, C) -> B over DP, C over model
    """
    dp = dp_axes(mesh)
    if cfg.pure_dp:
        dp = tuple(mesh_axes(mesh))
    dpn = _dp_size(mesh, dp)
    m = mesh_axes(mesh)["model"]

    model_free = not cfg.pure_dp  # pure_dp spends "model" on the batch axis

    def kv(x):
        l, b, s, hkv, hd = x.shape
        spec: list = [None] * 5
        if _div(b, dpn):
            spec[1] = dp
        elif _div(s, dpn):
            spec[2] = dp
        if model_free and _div(hkv, m):
            spec[3] = "model"
        elif model_free and spec[2] is None and _div(s, m):
            # GQA archs with kv-heads < model axis: shard the KV sequence
            # instead (flash-decoding-style split-K)
            spec[2] = "model"
        return NamedSharding(mesh, P(*spec))

    def ssm_state(x):
        l, b, h, n, p = x.shape
        spec: list = [None] * 5
        if _div(b, dpn):
            spec[1] = dp
        if model_free and _div(h, m):
            spec[2] = "model"
        return NamedSharding(mesh, P(*spec))

    def conv(x):
        l, b, k, c = x.shape
        spec: list = [None] * 4
        if _div(b, dpn):
            spec[1] = dp
        if model_free and _div(c, m):
            spec[3] = "model"
        return NamedSharding(mesh, P(*spec))

    out: dict = {}
    for key, val in cache_shapes.items():
        if key == "pos":
            out[key] = NamedSharding(mesh, P())
        elif key in ("k", "v", "cross_k", "cross_v"):
            out[key] = kv(val)
        elif key in ("ssm", "ssm_trailing"):
            out[key] = {"state": ssm_state(val["state"]), "conv": conv(val["conv"])}
        else:
            out[key] = NamedSharding(mesh, P())
    return out


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
