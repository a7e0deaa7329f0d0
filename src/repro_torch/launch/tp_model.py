"""The dense, vlm, MoE, ssm, hybrid and encoder-decoder families' forward
and loss on one rank's shards of "model".

The reference's GSPMD splits the transformer over the mesh's "model" axis
by the rules of ``launch.sharding``.  Here one rank runs its part with
the operators of ``launch/tp.py``, and each split is read from the port's
own ``param_spec`` (:func:`make_plan`), never decided again:

  * ``wq`` / ``wo`` split on heads (:attr:`Plan.attn` "heads"): a column /
    row pair.  Attention runs ``models.layers.attention`` on the rank's
    heads with a local config (``n_heads / m``); its input enters through
    ``copy_to_model`` and its output leaves through ``reduce_from_model``.
  * ``wk`` / ``wv`` split on kv-heads when ``hkv % m == 0``; otherwise they
    are replicated (the reference's GQA rule) and each rank takes the kv
    heads its query heads read.
  * ``wq`` split on its input ``d`` and ``wo`` on its output ``d``, where
    "model" divides ``d_model`` but not the heads (attention's
    **contraction** split, "contraction"; ``wk`` / ``wv`` replicated).
    Each rank forms the partial queries of its ``d / m`` columns of ``x``
    and ``reduce_from_model`` sums them; every rank then holds the whole
    ``q`` and runs the whole attention core (qk-norm, rope, every head) on
    it with the whole ``k`` / ``v``; its ``wo`` block gives the output's
    ``d / m`` columns, which ``gather_from_model`` makes whole.  The
    partial queries are formed and summed in float32 and cast to the
    compute dtype once, so ``q`` rounds once, as the one-process product
    does (the reference's CPU compile reduces bf16 in float32 too).
  * MLP: ``gate`` / ``up`` column-split, ``down`` row-split, the same pair.
  * ``embed`` split on the vocabulary: a masked lookup summed over the
    group; split on ``d`` (a vocabulary the axis does not divide): the
    lookup's columns gathered.
  * ``head`` split on the vocabulary: a vocab-parallel cross-entropy (a MAX
    and a SUM all-reduce of per-token floats; the label's logit from the
    rank that owns it), so the logits are never gathered.  Split on ``d``:
    the partial logits summed over the group, then the plain loss.  With
    tied embeddings the head is ``embed``'s shard transposed.
  * ``q_norm`` / ``k_norm`` (per head, shared by the heads) and every norm
    stay replicated.
  * Encoder-decoder (the encdec and audio families, whisper): the
    encoder's self-attention (bidirectional), the decoder's self-attention
    and its cross-attention all split on heads by the one attention rule,
    and each MLP on ``d_ff``.  :func:`encode` runs ``_encode``'s order on
    the rank's blocks; :func:`cross_kv` projects the encoder output with
    the rank's ``wk`` / ``wv`` heads (``encode_kv``), and
    :func:`cross_block` runs ``cross_attention`` on the rank's ``wq`` /
    ``wo`` heads, entered through ``copy_to_model`` and left through
    ``reduce_from_model`` as self-attention is.  Attention's contraction
    split is refused here: the encoder-decoder runs attention split on
    heads only.
  * MoE (expert parallelism): ``gate`` / ``up`` / ``down`` split on the
    expert axis, so a rank holds the experts ``[index E/m, (index+1) E/m)``
    of the E (padded) experts (:attr:`Plan.experts`); the ``router`` split
    on its expert columns.  Each rank gathers the router's columns (d x E/m
    a layer) and computes the one-process routing on the replicated tokens,
    so its expert choices and capacity slots are bitwise those of
    ``models.moe``; gathered logits could round otherwise than a column
    block's product and flip a near tie.  It then dispatches the tokens
    to its own experts only, runs them, and the partial combines are
    summed over "model": no all-to-all, as in the reference's schedule
    (the tokens are replicated over "model").  A padded expert gets no
    token, so a rank holding only padded experts adds zero.

  * The vlm family (internvl2): the dense family's layers behind
    precomputed patch embeddings.  :func:`forward` puts the patches in
    front of the text's embedding, as ``models.forward`` does with
    ``inputs_embeds``: the patches are cast to the compute dtype and not
    scaled by ``sqrt(d_model)`` (only :func:`embed`'s text is), and the
    positions run over patches and text.  The patches are data, replicated
    over "model" and split over the data-parallel axes by their rows, as
    the tokens are; they need no collective of their own.

  * SSD (the ssm and hybrid families; :attr:`Plan.ssd`): ``in_proj`` split
    on its ``d_model`` rows and ``out_proj`` on its ``d_inner`` rows (the
    rules' contraction split; the small leaves replicated).  Each rank
    forms the partial projection of its ``d / m`` columns of ``x`` in
    float32, and ``reduce_from_model`` sums it, cast once, so every rank
    holds the whole projection.  Under "heads" ("model" divides the SSM
    heads) a rank then takes its heads' ``z``, ``x`` and ``dt`` columns and
    the whole ``B`` and ``C`` (every head of a group reads them), runs the
    conv on those channels and the chunk scan on its heads (the scan is
    per head), sums the gated norm's squares over "model", and its
    ``out_proj`` rows (its heads' ``d_inner`` block) give a partial output
    that ``reduce_from_model`` sums, in float32 and cast once too.  Under "whole" (heads the axis does
    not divide) the core runs whole on every rank between the two split
    contractions; with neither projection split, it is
    ``models.ssd.ssd_block``.  zamba2's shared attention and MLP block runs
    through :func:`layer`, once a group of SSM layers, on the same leaves.

The gradient of a split leaf is this rank's block.  A replicated leaf has
one of two kinds of gradient (:attr:`Plan.partial`):

  * **partial**, when its use is split across the group: each rank's
    gradient covers its own heads only and must be summed over "model".
    These are ``wk`` / ``wv`` when replicated, ``q_norm`` / ``k_norm``
    under a head split (self- and cross-attention's alike), and under the SSD head split ``conv_w``,
    ``conv_b``, ``a_log``, ``dt_bias``, ``d_skip`` and ``norm_w``: a rank
    uses its heads' entries only, and the ``B`` / ``C`` conv channels that
    every rank uses carry only its own heads' share.
  * **whole**, when it is used whole before a split region: a norm whose
    output enters the split products through ``copy_to_model``, whose
    backward already sums the input's gradient.  Summing it again would
    multiply it by m.  Under attention's contraction split ``wk``, ``wv``,
    ``q_norm`` and ``k_norm`` are whole too: every rank runs the whole
    core on the whole ``q``, so their gradients are whole on every rank.

The gradient kinds of the contraction split's tensors: the core's ``dq``,
``dk`` and ``dv`` are whole on every rank.  ``do``, the gradient of the
core's output, is partial (each rank's ``wo`` block sees its own output
columns only), so ``o`` enters ``wo`` through ``copy_to_model``, whose
backward sums it; without it ``dq`` / ``dk`` / ``dv`` would be 1/m-ish
shares and the step silently wrong.  ``dx`` of the query columns is
partial (this rank's columns only) and is summed by the backward of the
``copy_to_model`` that ``x`` enters before its columns are taken; ``x``
reaches ``wk`` / ``wv`` directly, since their use is whole.

The SSD head split has three more such places.  The summed projection is
replicated, but each rank's use of it covers its own heads' columns and
its heads' share of ``B`` / ``C``: it enters the split region through
``copy_to_model``, or ``in_proj``'s gradient misses the other ranks'
share.  The gated norm's sum of squares is summed over "model" forward,
and its gradient is summed backward as well (each rank's gradient of the
whole sum covers its own columns), so it passes ``reduce_from_model`` and
then ``copy_to_model``.  Under "whole" the core runs whole on the summed
projection, so its gradient is whole and needs no sum; the core's output
enters ``out_proj``'s rows through ``copy_to_model``, as attention's
output does under its contraction split.

The encoder-decoder has one such place.  The encoder's output ``enc`` is
replicated over "model", but each rank uses it only through its own
``wk`` / ``wv`` heads, in every decoder layer's cross K/V, so a rank's
gradient of ``enc`` is a partial sum.  :func:`encode` passes ``enc``
through ``copy_to_model`` once, after ``enc_norm`` and before the decoder
loop, whose backward sums that gradient over "model": one all-reduce of
``dEnc`` a step instead of one a decoder layer, the same sum in another
order.  Without it every encoder parameter's gradient misses the other
ranks' share and the step is silently wrong.  ``enc_norm`` and
``cross_norm`` are whole leaves: their outputs enter the split products
through ``copy_to_model``, so their gradients are not summed again.

The MoE routing is such a replicated region: its outputs ``xg`` (the
tokens, into the rank's expert buffers) and ``top_p`` (into the rank's
slice of the combine) enter the split region, so each rank's gradient of
them covers its own experts only.  Both enter through ``copy_to_model``;
only then is the gradient of the logits, and so of the gathered router,
whole on every rank, and ``gather_from_model``'s backward (the rank's
columns) right.  Without it the router's gradient is silently wrong by the
other ranks' share.  The load-balance loss is computed from the replicated
probabilities on every rank: its gradient is whole and is not summed
again.  No MoE leaf is partial: the router and the experts are split
leaves, ``mlp_norm`` is whole.

The load-balance loss is a product of two means over the batch's groups.
The reference's step routes the global batch in one program, so in
training its means are taken over the data-parallel ranks
(:func:`tp.batch_mean`, one all-reduce a layer of the stacked pair); each
rank's own means would give another loss.

On a one-rank group every operator is the identity and each function
below runs the one-process op sequence of ``models.transformer`` (the SSD
block is ``models.ssd.ssd_block`` itself).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from .._tree import leaves_with_path
from ..models import lm_loss as _lm_loss
from ..models import moe as _moe
from ..models import ssd as _ssd
from ..models import param_shapes
from ..models.config import ModelConfig
from ..models.layers import (attend, attention, cross_attention, encode_kv, mlp, norm_rope,
                             project_kv, rms_norm, torch_dtype)
from ..models.transformer import (_ce, _layer, _n_layers, _positions, embed_tokens,
                                 init_cache, ssm_schedule)
from .mesh import dp_axes, mesh_axes
from .sharding import cache_shardings, params_shardings
from .tp import (AxisGroup, all_reduce, axis_group, batch_mean, copy_to_model,
                 gather_from_model, reduce_from_model)

__all__ = ["Plan", "make_plan", "unsupported", "embed", "embed_inputs", "layer",
           "attention_block", "contracted_qkv", "contracted_out", "encode", "cross_kv",
           "cross_block", "dec_layer", "mlp_block", "moe_route", "moe_dispatch", "moe_block",
           "ssd_project", "ssd_block", "ssd_decode", "forward", "logits", "loss",
           "make_loss_fn", "take_heads"]


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one rank runs the model, read from the specs.

    ``attn``: attention split on its "heads", on its "contraction"
    (``wq``'s input and ``wo``'s output ``d``) or "whole"; ``kv``: "heads"
    (``wk`` / ``wv`` split) or "whole" (replicated); ``kv_index``: with a
    head split and whole kv, the kv heads this rank's query heads read;
    ``mlp``: the MLP split on ``d_ff``; ``embed`` / ``head``: "vocab", "d"
    or "whole"; ``local``: the config attention sees on this rank (every
    head under the contraction split); ``split``: the leaf
    paths "model" splits; ``partial``: the replicated leaf paths whose
    gradient is a partial sum over "model" (the self- and cross-attention's
    ``q_norm`` / ``k_norm`` under a head split: whisper has neither, so its
    ``partial`` is empty); ``experts``: a MoE rank's
    range [lo, hi) of the padded experts; ``data``: in training, the
    data-parallel group over which the load-balance loss's means are taken
    (one rank when serving); ``ssd``: the SSD core split on "heads" or run
    "whole" (None without SSD layers); ``ssd_heads``: under "heads", this
    rank's range [h0, h1) of the SSM heads; ``conv``: whether a decode
    cache's conv tail is split over "model" on its channels (a contiguous
    ``d_xbc / m`` block a rank, by ``cache_shardings``)."""

    cfg: ModelConfig
    local: ModelConfig
    model: AxisGroup
    attn: str
    kv: str
    kv_index: Optional[tuple[int, ...]]
    mlp: bool
    embed: str
    head: str
    split: frozenset
    partial: frozenset
    experts: Optional[tuple[int, int]] = None
    data: AxisGroup = AxisGroup(1)
    ssd: Optional[str] = None
    ssd_heads: Optional[tuple[int, int]] = None
    conv: bool = False

    @property
    def ssd_split(self) -> bool:
        """Whether the SSD projections are split on their contraction."""
        return any(p.endswith("['ssd']['in_proj']") for p in self.split)


def _model_dim(spec, rank: int) -> Optional[int]:
    """The dim, counted from the end, that "model" splits in ``spec``."""
    for d, e in enumerate(spec):
        if e is not None and "model" in (e if isinstance(e, tuple) else (e,)):
            return d - rank
    return None


def _name(path: str) -> str:
    return path.rsplit("['", 1)[-1].rstrip("']")


def _model_dims(cfg: ModelConfig, mesh, mode: str) -> dict[str, Optional[int]]:
    """Leaf path -> the dim "model" splits (from the end), from the rules."""
    shapes = param_shapes(cfg)
    return {path: _model_dim(sh.spec, t.dim()) for (path, t), (_, sh) in zip(
        leaves_with_path(shapes), leaves_with_path(params_shardings(cfg, mesh, shapes, mode)))}


# (wq, wo)'s "model" dims, from the end -> the attention mode
_ATTN = {(None, None): "whole", (-2, -3): "heads", (-3, -1): "contraction"}
# the SSD leaves the rules keep replicated, used in parts under "heads"
_SSD_SMALL = ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip", "norm_w")
_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec", "audio")
_ENCDEC = ("encdec", "audio")


def _leaf_dims(dims: dict, block: str) -> dict[str, set]:
    """name -> the "model" dims of every leaf of ``block`` (``['attn']``,
    ``['mlp']``, ``['moe']``, ``['ssd']``), whichever subtree holds it."""
    out: dict[str, set] = {}
    for p, d in dims.items():
        if f"['{block}']" in p:
            out.setdefault(_name(p), set()).add(d)
    return out


def _one(dims: dict, block: str) -> dict:
    return {k: next(iter(v)) for k, v in _leaf_dims(dims, block).items()}


def _why_not(cfg: ModelConfig, dims: dict, m: int) -> Optional[str]:
    attn, mlps = _one(dims, "attn"), _one(dims, "mlp")
    if attn and (attn["wq"], attn["wo"]) not in _ATTN:
        return (f"{cfg.name}: the rules split attention as (wq, wo: {attn['wq']}, "
                f"{attn['wo']}) on a {m}-rank 'model' axis, neither on heads nor on d")
    if cfg.family in _ENCDEC:
        if _ATTN[attn["wq"], attn["wo"]] == "contraction":
            return (f"{cfg.name}: the rules split attention on its contraction on a {m}-rank "
                    f"'model' axis; the encoder-decoder runs attention split on heads only")
        cross = _one(dims, "cross_attn")
        if cross != attn:  # on heads or whole, as self-attention
            return (f"{cfg.name}: the rules split cross-attention as {cross} on a {m}-rank "
                    f"'model' axis, self-attention as {attn}")
    if set(mlps.values()) - {None} and mlps != {k: (-2 if k == "down" else -1) for k in mlps}:
        return f"{cfg.name}: the rules split the MLP as {mlps}, not on d_ff"
    moe = _one(dims, "moe")
    if moe and (moe["gate"], moe["up"], moe["down"], moe["router"]) != (-3, -3, -3, -1):
        how = "split the experts' d_ff" if moe["up"] is not None else "keep the experts whole"
        return (f"{cfg.name}: the rules {how} (gate, up, down, router: {moe['gate']}, "
                f"{moe['up']}, {moe['down']}, {moe['router']}) on a {m}-rank 'model' axis "
                f"({cfg.moe.padded_experts} experts), not the expert axis")
    if moe and cfg.moe.num_shared_experts:
        return f"{cfg.name}: the expert-parallel block does not run shared experts"
    ssd = _leaf_dims(dims, "ssd")
    if ssd:
        inout = (ssd["in_proj"], ssd["out_proj"])
        if inout not in (({None}, {None}), ({-2}, {-2})) or any(
                ssd[k] != {None} for k in _SSD_SMALL):
            return (f"{cfg.name}: the rules split the SSD block as {ssd} on a {m}-rank "
                    f"'model' axis, not in_proj and out_proj both on their contraction")
    return None


def unsupported(cfg: ModelConfig, mesh, mode: str = "train") -> Optional[str]:
    """Why the rules' splits of ``cfg`` on ``mesh`` are not ones this forward
    runs, or None: it takes the dense, vlm, MoE (with no shared experts),
    ssm, hybrid and encoder-decoder families, attention split on heads or
    on its contraction (or whole; the encoder-decoder on heads or whole),
    the MLP on ``d_ff`` (or whole), the experts and the router on their
    expert axis, and the SSD projections on their contraction (or
    whole)."""
    if cfg.family not in _FAMILIES:
        return (f"{cfg.name}: the tensor-parallel forward covers the dense, vlm, MoE, ssm, "
                f"hybrid and encoder-decoder families, not {cfg.family!r}")
    return _why_not(cfg, _model_dims(cfg, mesh, mode), mesh_axes(mesh)["model"])


def _conv_split(cfg: ModelConfig, mesh) -> bool:
    """Whether ``cache_shardings`` splits a decode cache's conv tail over
    "model" (on its channels)."""
    if cfg.family not in ("ssm", "hybrid"):
        return False
    spec = cache_shardings(cfg, mesh, init_cache(cfg, 1, 1, device="meta"))["ssm"]["conv"].spec
    return len(spec) > 3 and spec[3] == "model"


def make_plan(cfg: ModelConfig, mesh, mode: str = "train") -> Plan:
    """The rank's plan on ``mesh`` (a ``DeviceMesh``, or an ``AbstractMesh``
    for a stand-in group) from ``param_spec`` of every leaf."""
    if cfg.family not in _FAMILIES:
        raise ValueError(unsupported(cfg, mesh, mode))
    model = axis_group(mesh, "model")
    dims = _model_dims(cfg, mesh, mode)
    reason = _why_not(cfg, dims, model.size)
    if reason:
        raise ValueError(reason)
    attn_dims = _one(dims, "attn")
    attn = _ATTN[attn_dims.get("wq"), attn_dims.get("wo")]
    kv = "heads" if attn_dims.get("wk") is not None else "whole"
    embed_mode = {-2: "vocab", -1: "d", None: "whole"}[dims["['embed']"]]
    head_mode = embed_mode if cfg.tie_embeddings else {-1: "vocab", -2: "d", None: "whole"}[
        dims["['head']"]]
    local, kv_index, partial = cfg, None, frozenset()
    if attn == "heads" and model.size > 1:
        hpl, rep = cfg.n_heads // model.size, cfg.q_rep
        if kv == "heads":
            kvl = cfg.n_kv_heads // model.size
        else:
            first = model.index * hpl
            kv_index = ((first // rep,) if rep % hpl == 0
                        else tuple((first + j) // rep for j in range(hpl)))
            kvl = len(kv_index)
        local = dataclasses.replace(cfg, n_heads=hpl, n_kv_heads=kvl,
                                    head_dim=cfg.resolved_head_dim)
        # replicated leaves whose use is split over the heads; under the
        # contraction split none: wk, wv, q_norm, k_norm are used whole
        partial = frozenset(p for p in dims if ("['attn']" in p or "['cross_attn']" in p) and (
            _name(p) in ("q_norm", "k_norm") or (kv == "whole" and _name(p) in ("wk", "wv"))))
    ssd, ssd_heads = None, None
    if cfg.family in ("ssm", "hybrid"):
        n_heads = _ssd.ssm_dims(cfg)[1]
        split_in = _one(dims, "ssd")["in_proj"] is not None
        ssd = "heads" if split_in and n_heads % model.size == 0 else "whole"
        if ssd == "heads" and model.size > 1:
            n = n_heads // model.size
            ssd_heads = (model.index * n, (model.index + 1) * n)
            # the small SSD leaves, used in parts (the B / C conv channels by
            # every rank, each for its own heads): partial gradients
            partial |= frozenset(p for p in dims if "['ssd']" in p and _name(p) in _SSD_SMALL)
    split = frozenset(p for p, d in dims.items() if d is not None and model.size > 1)
    experts, data = None, AxisGroup(1)
    if cfg.family == "moe":
        n = cfg.moe.padded_experts // model.size
        experts = (model.index * n, (model.index + 1) * n)
        if mode == "train":  # the batch's rows, as batch_shardings splits them
            data = axis_group(mesh, dp_axes(mesh))
    return Plan(cfg, local, model, attn, kv, kv_index,
                _one(dims, "mlp").get("up") is not None, embed_mode, head_mode, split,
                partial, experts, data, ssd, ssd_heads,
                model.size > 1 and _conv_split(cfg, mesh))


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


def take_heads(t: torch.Tensor, index: tuple[int, ...], dim: int) -> torch.Tensor:
    """The heads ``index`` of ``t`` along ``dim`` (a view for one head)."""
    if len(index) == 1:
        return t.narrow(dim, index[0], 1)
    return t.index_select(dim, torch.tensor(index, device=t.device))


def _kv_view(lp: dict, plan: Plan) -> dict:
    """A layer's attention params with whole ``wk`` / ``wv`` cut to the kv
    heads this rank's query heads read."""
    if plan.kv_index is None:
        return lp
    return {**lp, "wk": take_heads(lp["wk"], plan.kv_index, -2),
            "wv": take_heads(lp["wv"], plan.kv_index, -2)}


def contracted_qkv(lp: dict, x: torch.Tensor, plan: Plan, positions) -> tuple:
    """Under the contraction split, the whole roped ``q``, ``k`` and ``v``
    of the normed, replicated ``x``: the partial queries of this rank's
    ``d / m`` columns summed over "model" in float32, then cast; the keys
    and values from the whole ``wk`` / ``wv``."""
    g, dt = plan.model, x.dtype
    xq = _d_slice(copy_to_model(x, g), plan, lp["wq"]).to(torch.float32)
    q = torch.einsum("bsd,dhk->bshk", xq, lp["wq"].to(dt).to(torch.float32))
    q = reduce_from_model(q, g).to(dt)
    k, v = project_kv(lp, x)
    q, k = norm_rope(lp, q, k, plan.cfg, positions)
    return q, k, v


def contracted_out(lp: dict, o: torch.Tensor, plan: Plan) -> torch.Tensor:
    """Under the contraction split, the whole output of the core's heads
    ``o`` (B, S, H, D): this rank's ``d / m`` output columns, gathered."""
    g = plan.model
    y = torch.einsum("bshk,hkd->bsd", copy_to_model(o, g), lp["wo"].to(o.dtype))
    return gather_from_model(y, g, -1)


def attention_block(lp: dict, x: torch.Tensor, plan: Plan, positions,
                    causal: bool = True) -> torch.Tensor:
    """Attention of the normed, replicated ``x`` (bidirectional with
    ``causal`` False, the encoder's); the result replicated."""
    if plan.attn == "whole":
        return attention(lp, x, plan.cfg, positions, causal)
    g = plan.model
    if plan.attn == "heads":
        y = attention(_kv_view(lp, plan), copy_to_model(x, g), plan.local, positions, causal)
        return reduce_from_model(y, g)
    return contracted_out(lp, attend(*contracted_qkv(lp, x, plan, positions), plan.cfg, causal),
                          plan)


def mlp_block(lp: dict, x: torch.Tensor, plan: Plan) -> torch.Tensor:
    if not plan.mlp:
        return mlp(lp, x, plan.cfg)
    g = plan.model
    return reduce_from_model(mlp(lp, copy_to_model(x, g), plan.cfg), g)


def layer(lp: dict, h: torch.Tensor, plan: Plan, positions, causal: bool = True) -> tuple:
    """One layer, dense or MoE (``models.transformer._attn_layer``'s or
    ``_moe_layer``'s op order; an encoder's with ``causal`` False): (h, the
    load-balance loss or None)."""
    eps = plan.cfg.rms_eps
    h = h + attention_block(lp["attn"], rms_norm(h, lp["attn_norm"], eps), plan, positions,
                            causal)
    x = rms_norm(h, lp["mlp_norm"], eps)
    if "moe" in lp:
        y, aux = moe_block(lp["moe"], x, plan)
        return h + y, aux
    return h + mlp_block(lp["mlp"], x, plan), None


def encode(params: dict, plan: Plan, frames: torch.Tensor) -> torch.Tensor:
    """The encoder's output of the stub ``frames`` (B, S_enc, d), replicated
    over "model" (``models.transformer._encode``'s order: the frames cast
    to the compute dtype, each encoder layer bidirectional, ``enc_norm``),
    passed through ``copy_to_model`` for the decoder's cross K/V under a
    head split: each rank's gradient of it covers its own ``wk`` / ``wv``
    heads only, so its backward sums it over "model" (the module
    docstring's gradient trap).  Under "whole" every rank's gradient of it
    is whole, and is not summed."""
    cfg = plan.cfg
    enc = frames.to(torch_dtype(cfg.dtype))
    positions = _positions(enc.shape[1], enc.device)
    for i in range(_n_layers(params["enc_layers"])):
        enc, _ = layer(_layer(params["enc_layers"], i), enc, plan, positions, causal=False)
    enc = rms_norm(enc, params["enc_norm"], cfg.rms_eps)
    return copy_to_model(enc, plan.model) if plan.attn == "heads" else enc


def cross_kv(lp: dict, enc: torch.Tensor, plan: Plan) -> tuple:
    """This rank's kv heads of the cross-attention keys and values of the
    encoder output ``enc`` (from :func:`encode`): ``models.layers.encode_kv``
    on the rank's ``wk`` / ``wv`` heads."""
    return encode_kv(_kv_view(lp, plan), enc, plan.local)


def cross_block(lp: dict, x: torch.Tensor, ek: torch.Tensor, ev: torch.Tensor,
                plan: Plan) -> torch.Tensor:
    """Cross-attention of the normed, replicated ``x`` against this rank's
    cross keys and values ``ek`` / ``ev`` on the rank's ``wq`` / ``wo``
    heads (``models.layers.cross_attention``); the result replicated."""
    if plan.attn == "whole":
        return cross_attention(lp, x, ek, ev, plan.cfg)
    g = plan.model
    return reduce_from_model(cross_attention(lp, copy_to_model(x, g), ek, ev, plan.local), g)


def dec_layer(lp: dict, h: torch.Tensor, ek: torch.Tensor, ev: torch.Tensor, plan: Plan,
              positions) -> torch.Tensor:
    """One decoder layer (``models.transformer._dec_layer``'s order):
    causal self-attention, cross-attention against this rank's ``ek`` /
    ``ev``, then the MLP."""
    eps = plan.cfg.rms_eps
    h = h + attention_block(lp["attn"], rms_norm(h, lp["attn_norm"], eps), plan, positions)
    h = h + cross_block(lp["cross_attn"], rms_norm(h, lp["cross_norm"], eps), ek, ev, plan)
    return h + mlp_block(lp["mlp"], rms_norm(h, lp["mlp_norm"], eps), plan)


def moe_route(lp: dict, x: torch.Tensor, plan: Plan, dropless: bool = False) -> _moe.Routing:
    """The one-process routing of the normed, replicated ``x``, bitwise, on
    every rank: the router's columns gathered, then ``models.moe.route``."""
    router = gather_from_model(lp["router"].to(x.dtype), plan.model, -1)
    return _moe.route(router, x, plan.cfg, dropless)


def moe_dispatch(lp: dict, x: torch.Tensor, plan: Plan, dropless: bool = False) -> tuple:
    """This rank's dispatch: (the routing; the combine one-hot of its
    experts (G, gs, E/m, C); their buffers ``expert_in`` (G, E/m, C, d))."""
    g = plan.model
    r = moe_route(lp, x, plan, dropless)
    # the gradient trap (module docstring): each rank's use of xg and top_p
    # below covers its own experts only, so their gradients are summed
    r = dataclasses.replace(r, xg=copy_to_model(r.xg, g), top_p=copy_to_model(r.top_p, g))
    dispatch, combine = _moe.dispatch_combine(r, *plan.experts, x.dtype)
    return r, combine, torch.einsum("gsec,gsd->gecd", dispatch, r.xg)


def moe_block(lp: dict, x: torch.Tensor, plan: Plan,
              dropless: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel MoE block of the normed, replicated ``x``:
    (y replicated, the load-balance loss).  It fires no ``moe.dispatch``
    tap: the reference's jitted step records nothing there."""
    r, combine, expert_in = moe_dispatch(lp, x, plan, dropless)
    y = torch.einsum("gsec,gecd->gsd", combine, _moe.expert_ffn(lp, expert_in))
    aux = _moe.load_balance(r, plan.cfg, lambda t: batch_mean(t, plan.data))
    return reduce_from_model(y, plan.model).reshape(x.shape), aux


def ssd_project(p: dict, x: torch.Tensor, plan: Plan) -> torch.Tensor:
    """The whole input projection of the normed, replicated ``x`` on every
    rank: the partial products of this rank's ``d / m`` columns summed over
    "model" in float32, then cast (one rounding, as the one-process
    product).  Under "heads" it then enters the split region through
    ``copy_to_model``: each rank's use covers its own heads only."""
    g, dt = plan.model, x.dtype
    xq = _d_slice(copy_to_model(x, g), plan, p["in_proj"]).to(torch.float32)
    proj = reduce_from_model(xq @ p["in_proj"].to(dt).to(torch.float32), g).to(dt)
    return copy_to_model(proj, g) if plan.ssd == "heads" else proj


def _ssd_norm(p: dict, y: torch.Tensor, z: torch.Tensor, plan: Plan) -> torch.Tensor:
    """The gated norm of this rank's heads' ``y`` / ``z`` (whole under
    "whole"): under "heads" the squares of the rank's ``d_inner`` columns
    are summed over "model" forward and backward."""
    cfg, g, heads = plan.cfg, plan.model, plan.ssd_heads
    if heads is None:
        return _ssd.gated_norm(y, z, p["norm_w"], cfg.rms_eps)
    d_inner, _, hd, _, _ = _ssd.ssm_dims(cfg)
    w = p["norm_w"][..., heads[0] * hd: heads[1] * hd]
    return _ssd.gated_norm(y, z, w, cfg.rms_eps,
                           lambda ss: copy_to_model(reduce_from_model(ss, g), g) / d_inner)


def _ssd_out(p: dict, y: torch.Tensor, plan: Plan) -> torch.Tensor:
    """The output of the core's ``y`` through this rank's ``out_proj`` rows,
    summed over "model" in float32 and cast once, as the projection's
    partial products: under "heads" ``y`` is already the rank's ``d_inner``
    block; under "whole" the block is cut from the whole ``y``, which
    enters through ``copy_to_model``."""
    g, dt = plan.model, y.dtype
    if plan.ssd == "whole":
        n = p["out_proj"].shape[-2]
        y = copy_to_model(y, g)[..., g.index * n: (g.index + 1) * n]
    out = y.to(torch.float32) @ p["out_proj"].to(dt).to(torch.float32)
    return reduce_from_model(out, g).to(dt)


def _conv_block(plan: Plan, c: int) -> tuple[int, int]:
    """This rank's channels [c0, c1) of a conv tail split over "model"."""
    n = c // plan.model.size
    return plan.model.index * n, (plan.model.index + 1) * n


def ssd_block(p: dict, x: torch.Tensor, plan: Plan, return_cache: bool = False):
    """The SSD block of the normed, replicated ``x``; the result replicated.
    With ``return_cache``, also this rank's decode cache: the final state of
    its heads (all under "whole") and the last ``d_conv - 1`` raw rows of
    its conv channel block (all when the cache's tail is whole)."""
    cfg, heads = plan.cfg, plan.ssd_heads
    if not plan.ssd_split:
        return _ssd.ssd_block(p, x, cfg, return_cache)
    dt_ = x.dtype
    proj = ssd_project(p, x, plan)
    z, xbc_raw, dt_raw = _ssd.split_proj(proj, cfg, heads)
    xs, bmat, cmat = _ssd._split_xbc(_ssd.conv(xbc_raw, p, cfg, heads), cfg, heads)
    y, hlast = _ssd.scan(p, xs, bmat, cmat, dt_raw, cfg, heads)
    out = _ssd_out(p, _ssd_norm(p, y, z, plan), plan)
    if not return_cache:
        return out
    d_inner, n_heads, _, _, _ = _ssd.ssm_dims(cfg)
    tail = proj[:, -(cfg.ssm.d_conv - 1):, d_inner:-n_heads]
    if plan.conv:
        tail = tail[..., slice(*_conv_block(plan, tail.shape[-1]))]
    return out, {"state": hlast, "conv": tail.to(dt_)}


def ssd_decode(p: dict, x: torch.Tensor, cache: dict, plan: Plan) -> tuple:
    """One token of the SSD block of the normed, replicated ``x`` (B, 1, d)
    with this rank's cache blocks: (output, replicated; new cache blocks).
    A conv tail split on its channels convolves the new row's channels of
    its own block (the conv is depthwise), and the activated row is
    all-gathered over "model"; the recurrence runs on the rank's heads."""
    cfg, g, heads = plan.cfg, plan.model, plan.ssd_heads
    if not (plan.ssd_split or plan.conv):
        return _ssd.ssd_decode(p, x, cache, cfg)
    dt_ = x.dtype
    d_inner, n_heads, _, _, _ = _ssd.ssm_dims(cfg)
    proj = ssd_project(p, x, plan) if plan.ssd_split else _ssd.project(p, x)
    z, _, dt_raw = _ssd.split_proj(proj, cfg, heads)
    row = proj[..., d_inner:-n_heads]  # the new raw row, every channel
    w, b = p["conv_w"].to(dt_), p["conv_b"].to(dt_)
    if plan.conv:
        c = slice(*_conv_block(plan, row.shape[-1]))
        act, tail = _ssd.conv_step(cache["conv"], row[..., c], w[:, c], b[c])
        act = gather_from_model(act, g, -1)
    else:
        act, tail = _ssd.conv_step(cache["conv"], row, w, b)
    xs, bmat, cmat = _ssd._split_xbc(_ssd.xbc_part(act, cfg, heads), cfg, heads)
    y, state = _ssd.state_step(p, xs, bmat, cmat, dt_raw, cache["state"], heads)
    y = _ssd_norm(p, y, z, plan)
    out = _ssd_out(p, y, plan) if plan.ssd_split else y @ p["out_proj"].to(dt_)
    return out, {"state": state, "conv": tail}


def ssd_layer(lp: dict, h: torch.Tensor, plan: Plan) -> torch.Tensor:
    """One SSM layer (``models.transformer._ssm_layer``'s op order)."""
    return h + ssd_block(lp["ssd"], rms_norm(h, lp["norm"], plan.cfg.rms_eps), plan)


def embed(params: dict, plan: Plan, tokens: torch.Tensor) -> torch.Tensor:
    """The replicated embedding of ``tokens`` from this rank's shard."""
    cfg, g = plan.cfg, plan.model
    if g.size == 1 or plan.embed == "whole":
        return embed_tokens(params, cfg, tokens)
    w = params["embed"]
    if plan.embed == "vocab":
        ids = tokens.long() - g.index * w.shape[0]
        own = ((ids >= 0) & (ids < w.shape[0]))[..., None]
        e = torch.where(own, F.embedding(torch.where(own[..., 0], ids, 0), w), 0.0)
        e = reduce_from_model(e, g)
    else:
        e = gather_from_model(F.embedding(tokens.long(), w), g, -1)
    return e.to(torch_dtype(cfg.dtype)) * math.sqrt(cfg.d_model)


def embed_inputs(params: dict, plan: Plan, tokens: torch.Tensor,
                 patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The replicated input sequence: the embedding of ``tokens``, behind
    the vlm family's ``patches`` (B, P, d) when given, cast to the compute
    dtype and unscaled (``models.forward``'s ``inputs_embeds``)."""
    text = embed(params, plan, tokens)
    return text if patches is None else torch.cat([patches.to(text.dtype), text], dim=1)


def forward(params: dict, plan: Plan, tokens: torch.Tensor,
            frames: Optional[torch.Tensor] = None,
            patches: Optional[torch.Tensor] = None) -> tuple:
    """(the final-normed hidden state (B, S, d), replicated over "model";
    the summed load-balance loss), as ``models.forward``'s (the vlm
    family's with ``patches`` as its ``inputs_embeds``: S counts them), or
    for the encoder-decoder families ``models.encdec_forward``'s of
    ``frames`` and the decoder's ``tokens``."""
    cfg = plan.cfg
    if cfg.family in _ENCDEC:
        if frames is None:
            raise ValueError(f"{cfg.name}: the encoder-decoder forward needs frames")
        enc = encode(params, plan, frames)
        h = embed(params, plan, tokens)
        positions = _positions(h.shape[1], h.device)
        layers = params["layers"]
        for i in range(_n_layers(layers)):
            lp = _layer(layers, i)
            h = dec_layer(lp, h, *cross_kv(lp["cross_attn"], enc, plan), plan, positions)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return rms_norm(h, params["final_norm"], cfg.rms_eps), aux
    h = embed_inputs(params, plan, tokens, patches)
    positions = _positions(h.shape[1], h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    layers = params["layers"]
    if cfg.family in ("ssm", "hybrid"):
        for tree, i in ssm_schedule(cfg):
            if tree == "shared":
                h, _ = layer(params["shared"], h, plan, positions)  # the shared leaves
            else:
                h = ssd_layer(_layer(params[tree], i), h, plan)
    else:
        auxs = []
        for i in range(_n_layers(layers)):
            h, a = layer(_layer(layers, i), h, plan, positions)
            auxs.append(a)
        if cfg.family == "moe":
            aux = aux + torch.stack(auxs).sum()
    return rms_norm(h, params["final_norm"], cfg.rms_eps), aux


# --------------------------------------------------------------------------
# logits / loss
# --------------------------------------------------------------------------


def _head(params: dict, plan: Plan) -> torch.Tensor:
    return params["embed"].T if plan.cfg.tie_embeddings else params["head"]


def _d_slice(h: torch.Tensor, plan: Plan, w: torch.Tensor) -> torch.Tensor:
    """This rank's columns of ``h`` under a split of ``w``'s first dim, its
    ``d`` (the head's (d/m, V), ``wq``'s (d/m, H, D))."""
    n = w.shape[0]
    return h[..., plan.model.index * n: (plan.model.index + 1) * n]


def logits(params: dict, plan: Plan, h: torch.Tensor) -> torch.Tensor:
    """Logits of the replicated ``h``: this rank's vocabulary block under a
    vocab split (the rank's columns, ``index * V/m`` on), else whole."""
    w, g = _head(params, plan), plan.model
    if plan.head == "d" and g.size > 1:
        x = _d_slice(copy_to_model(h, g), plan, w)
        return reduce_from_model(x @ w.to(h.dtype), g)
    x = copy_to_model(h, g) if plan.head == "vocab" else h
    return x @ w.to(h.dtype)


def _ce_vocab(lg: torch.Tensor, labels: torch.Tensor, g: AxisGroup):
    """(sum, count) of the cross-entropy over valid labels from this rank's
    vocabulary block ``lg``: one MAX and one SUM all-reduce of per-token
    floats."""
    lf = lg.to(torch.float32)
    mx = all_reduce(torch.amax(lf.detach(), dim=-1), g, "max")
    se = torch.sum(torch.exp(lf - mx[..., None]), dim=-1)
    lab = labels.long() - g.index * lf.shape[-1]
    own = (lab >= 0) & (lab < lf.shape[-1])
    gold = torch.take_along_dim(lf, torch.where(own, lab, 0)[..., None], dim=-1)[..., 0]
    both = reduce_from_model(torch.stack([se, torch.where(own, gold, 0.0)], dim=-1), g)
    lse = torch.log(both[..., 0]) + mx
    valid = labels >= 0
    ce = torch.where(valid, lse - both[..., 1], 0.0)
    return ce.sum(), valid.sum()


def loss(params: dict, plan: Plan, h: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over valid labels (``models.lm_loss``'s chunking)
    from this rank's head shard."""
    cfg, g = plan.cfg, plan.model
    if g.size == 1 or plan.head == "whole":
        return _lm_loss(params, cfg, h, labels)

    def ce(hc, lc):
        lg = logits(params, plan, hc)
        return _ce_vocab(lg, lc, g) if plan.head == "vocab" else _ce(lg, lc)

    chunk, s = cfg.logits_chunk, h.shape[1]
    if chunk and s % chunk == 0 and s > chunk:
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        cnt = torch.zeros((), dtype=torch.int64, device=h.device)
        for c0 in range(0, s, chunk):
            cs, cn = ce(h[:, c0: c0 + chunk], labels[:, c0: c0 + chunk])
            tot, cnt = tot + cs, cnt + cn
        return tot / torch.clamp_min(cnt, 1)
    tot, cnt = ce(h, labels)
    return tot / torch.clamp_min(cnt, 1)


def make_loss_fn(plan: Plan) -> Callable[[Any, dict], torch.Tensor]:
    """``(local params, local batch) -> loss``, as ``train.make_loss_fn``'s:
    the cross-entropy plus the load-balance loss (the encoder-decoder's
    forward reads the batch's ``frames``, the vlm family's its ``patches``,
    whose labels are -100)."""

    def loss_fn(params, batch):
        h, aux = forward(params, plan, batch["tokens"], batch.get("frames"),
                         batch.get("patches"))
        return loss(params, plan, h, batch["labels"]) + aux

    return loss_fn
