"""Multi-device inference on a device mesh, and the training step.

Counterpart of ``vit_with_opencl_tpu/parallel/spmd.py``. The mesh
(``parallel/mesh.py``) is a grid of devices with ("data", "model") axes
that one process drives, as JAX's ``Mesh`` + ``shard_map`` is one program
driving every device: each SPMD body is ported line by line as a loop over
the shards of a data row, and JAX's collectives are the functions of
``parallel/collectives.py`` on the shard lists. The inference paths:

  * ``dp_forward_fn`` — data parallelism: the batch split over every
    device of the mesh, the params replicated, no communication;
  * ``tp_forward`` — tensor parallelism (Megatron): the weights in the
    head-major TP layout (``to_tp_layout``) sharded over "model" by
    ``shard_params_tp``; column-parallel QKV/fc1, head-parallel attention,
    row-parallel out-proj/fc2 with a ``psum`` after each; int8, W8A8 and
    calibrated outlier W8A8 weights through ``_dot_q``;
  * ``sp_forward`` — sequence parallelism: tokens sharded over "model",
    params replicated, K/V all-gathered (``kv="gather"``) or rotated around
    the ring (``kv="ring"``, ``ops/ring_attention``: the carried blockwise
    kernel at shards of >= 128 tokens);
  * ``sp_tp_forward`` — both: token-sharded activations, model-sharded
    weights, all-gather → column → row → ``psum_scatter`` per block.

Every path runs on the mesh's devices; a mesh of CPU devices runs the plain
versions (the CPU tests use ``make_mesh(..., devices=["cpu"] * 8)``, as the
JAX tests use 8 virtual CPU devices).

The training step: the single-device part of ``make_train_step``. Its
routes are the JAX package's:

  * ``xla``   — the per-op forward in plain PyTorch ops, autograd backward;
  * ``flash`` — the same, with the attention core through
    ``ops/attention.packed_fused_attention_trainable`` (the packed kernel
    forward and ``packed_attention_bwd`` backward; past padded T = 1024 the
    blockwise forward with its log-sum-exp and ``blockwise_attention_bwd``);
  * ``fused`` — ``flash``, and every encoder layer through
    ``ops/fused_block.fused_encoder_layer_trainable`` (the forward chain and
    the three-stage fused backward, its MLP stage split in the H-chunked
    pair at ViT-L/H widths) where ``fused_block.supports_trainable`` holds
    for the compute dtype (ViT-B, ViT-L/16@384 and ViT-H/14 do).

fp32 master weights stay fp32: the per-op route multiplies bf16 activations
by them in fp32, and the fused chain casts its four matmul weights to the
activation dtype, with gradients accumulated in fp32 back to the masters,
as in JAX.

Not ported here: training on a mesh (``make_train_step(mesh)``,
``shard_params_gspmd``, ``gspmd_param_specs``: a ``mesh`` raises
``NotImplementedError``) and the autotune ``tuning`` knobs.
``scan_unroll`` is accepted and has no effect: the port's encoder is a
Python loop over the layers, with nothing to unroll.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import optim
from ..config import ViTConfig
from ..engine import resolve_device
from ..models import quant, vit
from ..ops import attention as attention_ops
from . import collectives
from .mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh", "Replicas", "replicate_params",
           "dp_forward_fn", "to_tp_layout", "tp_pspecs",
           "shard_params_tp", "tp_forward", "sp_forward", "sp_tp_forward",
           "make_train_step", "train_kernels"]

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Shards of a data row: batch split, replicated params
# ---------------------------------------------------------------------------


def _split_batch(images: torch.Tensor, n: int) -> list:
    """The batch in ``n`` equal slices (a ``P("data")`` input)."""
    b = images.shape[0]
    if b % n:
        raise ValueError(f"batch {b} not divisible by {n} shards")
    return list(images.chunk(n))


class Replicas(dict):
    """A param tree on each distinct device of a mesh, keyed by device:
    ``replicate_params``'s result, the counterpart of ``jax.device_put``
    with a replicated sharding. Passed to ``sp_forward`` or to a
    ``dp_forward_fn`` forward, the weights cross to the devices once, not on
    every call."""


def replicate_params(params: Params, mesh: Mesh) -> Replicas:
    """``params`` on each distinct device of ``mesh`` (no copy where they
    already lie)."""
    return _replicas(params, mesh.devices.ravel())


def _replicas(params, devices) -> Replicas:
    """``params`` as given when it is a ``Replicas`` that covers
    ``devices``; a tree is copied to each distinct device now."""
    devices = list(dict.fromkeys(devices))
    if not isinstance(params, Replicas):
        return Replicas((dev, vit.params_to(params, dev)) for dev in devices)
    missing = [dev for dev in devices if dev not in params]
    if missing:
        raise ValueError(f"the replicated params hold no copy on {missing}")
    return params


def _gather_rows(outs: list, device: torch.device) -> torch.Tensor:
    """The data rows' results, assembled on ``device`` (a ``P("data")``
    output)."""
    return torch.cat([o.to(device) for o in outs])


def _head(x: torch.Tensor, p: Params, config: ViTConfig, compute_dtype,
          return_logits: bool) -> torch.Tensor:
    """Final-LN'd [B, T, D] tokens → logits, or probabilities."""
    logits = vit.classifier_logits(x.float(), p, config, compute_dtype)
    return logits if return_logits else torch.softmax(logits, dim=-1)


# ---------------------------------------------------------------------------
# Tensor-parallel parameter layout
# ---------------------------------------------------------------------------
#
# The single-device stacked layout packs QKV as [L, D, 3D] with the 3D axis
# ordered (q|k|v). For clean head-sharding the TP layout reorders it
# head-major: [L, D, nh, 3, hd] flattened to [L, D, nh*3*hd], so a shard of
# the last axis is a whole group of heads. out_proj is [L, nh*hd, D]
# (already head-major on its input dim). A leaf's spec is a tuple with one
# entry per axis: "model" on the axis that shards, None elsewhere; () for a
# replicated leaf (JAX's PartitionSpec).


def to_tp_layout(params: Params, config: ViTConfig) -> Params:
    """Stacked params → the TP layout (head-major QKV), int8 and outlier
    dicts included."""
    nh, hd, L, d = config.num_heads, config.head_dim, config.depth, config.embed_dim

    def reorder_out_axis(x, rows):
        # [..., rows, 3D] with (q|k|v)-major out axis → head-major nh*3*hd.
        x = x.reshape(L, rows, 3, nh, hd).permute(0, 1, 3, 2, 4)
        return x.reshape(L, rows, nh * 3 * hd)

    lp = dict(params["layers"])
    qkv_w = lp["qkv_w"]
    if quant.is_quantized(qkv_w):
        # int8 dicts: the per-output-channel scale lives on q's out axis, so
        # the two reorder together; an outlier dict's bf16 "hi" block too
        # (its rows, the outlier input channels, are the same on every shard).
        new = {
            "q": reorder_out_axis(qkv_w["q"], qkv_w["q"].shape[1]),
            "scale": reorder_out_axis(qkv_w["scale"], 1),
        }
        if "hi" in qkv_w:
            new["hi"] = reorder_out_axis(qkv_w["hi"], qkv_w["hi"].shape[1])
        lp["qkv_w"] = new
    else:
        lp["qkv_w"] = reorder_out_axis(qkv_w, d)
    qkv_b = lp["qkv_b"].reshape(L, 3, nh, hd).permute(0, 2, 1, 3)
    lp["qkv_b"] = qkv_b.reshape(L, nh * 3 * hd)
    out = dict(params)
    out["layers"] = lp
    return out


def _fc2_outlier_to_masked(w: Dict[str, Any], n_model: int) -> Dict[str, Any]:
    """fc2 outlier dict, split form ({q: [L, H-k, D], hi: [L, k, D]}) →
    masked-trailing form ({q: [L, H, D] with the last k rows zero, hi
    unchanged}) so the q rows shard evenly over "model" in line with the
    column-parallel fc1 output slices. Exact: the appended rows are zero,
    and the per-output-channel scale does not depend on the row count.

    The calibrated plan puts every fc2 outlier channel in the global
    trailing group, which lands in the last model shard's hidden slice, so
    k must fit one shard's slice (k <= H/n_model)."""
    q = w["q"]
    k = w["hi"].shape[1]
    h_total = q.shape[1] + k
    if h_total % n_model:
        raise ValueError(
            f"hidden_dim {h_total} not divisible by model axis {n_model}")
    if k > h_total // n_model:
        raise ValueError(
            f"fc2 outlier group ({k} channels) exceeds one model shard's "
            f"hidden slice ({h_total // n_model}); re-plan with "
            f"k_h <= hidden_dim / n_model for TP serving")
    zeros = torch.zeros((q.shape[0], k, q.shape[2]), dtype=q.dtype, device=q.device)
    return {"q": torch.cat([q, zeros], dim=1), "scale": w["scale"], "hi": w["hi"]}


def _weight_spec(leaf: Any, spec: tuple, hi_spec: Optional[tuple] = None) -> Any:
    """Spec of a (possibly int8-quantized) matmul weight leaf.

    Column-parallel weights shard their out axis, and the per-output-channel
    scale shards with it. Row-parallel weights shard the in axis; the scale
    (out-channel-indexed, and commuting with the psum) stays replicated. An
    outlier dict's "hi" block shards as ``hi_spec`` (default: as q)."""
    if not quant.is_quantized(leaf):
        return spec
    out_axis_sharded = len(spec) >= 3 and spec[2] is not None
    d = {"q": spec, "scale": (None, None, "model") if out_axis_sharded else ()}
    if "hi" in leaf:
        d["hi"] = hi_spec if hi_spec is not None else spec
    return d


def tp_pspecs(params: Params, config: ViTConfig) -> Params:
    """Spec tree matching the TP layout: column-parallel QKV/fc1,
    row-parallel out/fc2, everything else replicated.

    Outlier hi groups: qkv/fc1 shard hi's out axis with q's; out-proj shards
    hi's per-head-tail rows with its head-group row shards; fc2 (the
    masked-trailing form of ``_fc2_outlier_to_masked``) replicates hi — it
    is small (k_h x D bf16) and only the last shard's partial uses it."""
    specs = optim.tree_map(lambda _: (), params)
    lp = params["layers"]
    sl = specs["layers"]
    sl["qkv_w"] = _weight_spec(lp["qkv_w"], (None, None, "model"))
    sl["qkv_b"] = (None, "model")
    sl["out_w"] = _weight_spec(lp["out_w"], (None, "model", None),
                               hi_spec=(None, "model", None))
    sl["fc1_w"] = _weight_spec(lp["fc1_w"], (None, None, "model"))
    sl["fc1_b"] = (None, "model")
    sl["fc2_w"] = _weight_spec(lp["fc2_w"], (None, "model", None), hi_spec=())
    return specs


def _shard_leaf(x: torch.Tensor, spec: tuple, n_model: int, j: int) -> torch.Tensor:
    """Model shard j of a leaf: its slice on the spec's "model" axis."""
    if "model" not in spec:
        return x
    axis = spec.index("model")
    size = x.shape[axis] // n_model
    return x.narrow(axis, j * size, size)


def shard_params_tp(params: Params, mesh: Mesh, config: ViTConfig) -> list:
    """Re-layout and place params for tensor parallelism: ``out[i][j]`` is
    model shard j's param tree on ``mesh.devices[i, j]`` (replicated leaves
    whole, sharded leaves their slice), for each data row i."""
    n_model = mesh.shape["model"]
    if config.num_heads % n_model:
        raise ValueError(
            f"num_heads {config.num_heads} not divisible by model axis {n_model}")
    if config.hidden_dim % n_model:
        raise ValueError(
            f"hidden_dim {config.hidden_dim} not divisible by model axis {n_model}")
    tp = to_tp_layout(params, config)
    fc2 = tp["layers"]["fc2_w"]
    if quant.is_quantized(fc2) and "hi" in fc2:
        lp = dict(tp["layers"])
        lp["fc2_w"] = _fc2_outlier_to_masked(fc2, n_model)
        tp = dict(tp)
        tp["layers"] = lp
    specs = tp_pspecs(tp, config)
    # W8A8 params stored K-major (quant.w8a8_layout) keep that layout in
    # each shard, as a compact copy of the shard's K or N slice.
    qkv = params["layers"]["qkv_w"]
    k_major = quant.is_quantized(qkv) and quant.is_k_major(qkv["q"])

    def shard(j, dev):
        tree = optim.tree_map(
            lambda x, spec: _shard_leaf(x, spec, n_model, j).to(dev).contiguous(),
            tp, specs)
        return quant.w8a8_layout(tree) if k_major else tree

    return [[shard(j, dev) for j, dev in enumerate(row)] for row in mesh.devices]


# ---------------------------------------------------------------------------
# Tensor-parallel forward (explicit collectives)
# ---------------------------------------------------------------------------


def _dot_q(x: torch.Tensor, w: Any, w8a8: bool = False, *,
           heads: Optional[tuple] = None, tail_shards: Optional[int] = None,
           shard: Optional[int] = None) -> torch.Tensor:
    """x @ w in fp32, for fp and int8 {q, scale} weights.

    Unlike ``quant.matmul_q`` this keeps the fp32 accumulator (no downcast,
    no bias) so row-parallel callers sum at full precision; the scale is per
    output channel and commutes with the psum. ``w8a8`` also quantizes the
    activation per token (``quant.quantize_act``) and multiplies int8 by
    int8; both scales are local to the shard.

    Outlier-aware dicts (bf16 "hi" groups) compose per shard: the split
    form (qkv/fc1: q rows fewer than x's channels), the masked per-head
    form (``heads=(nh_loc, hd)``, out-proj) and the masked trailing form
    (``tail_shards=n_model``, fc2 after ``_fc2_outlier_to_masked``), where
    every outlier channel lies in the last shard's slice: that shard
    (``shard``) leaves its tail out of the absmax and adds the hi product,
    the others quantize plainly."""
    if quant.is_quantized(w):
        if "hi" in w:
            if not w8a8:
                raise ValueError(
                    "outlier-aware quantized params (bf16 'hi' groups) "
                    "require w8a8=True — weight-only int8 has no hi path")
            return _dot_q_outlier(x, w, heads=heads, tail_shards=tail_shards,
                                  shard=shard)
        if w8a8:
            xq, sx = quant.quantize_act(x)
            return quant.int8_product(xq, w["q"]) * sx * w["scale"][..., 0, :]
        out = x.float() @ w["q"].to(x.dtype).float()
        return out * w["scale"][..., 0, :]
    return x.float() @ w.float()


def _dot_q_outlier(x: torch.Tensor, w: Dict[str, torch.Tensor], *,
                   heads: Optional[tuple], tail_shards: Optional[int],
                   shard: Optional[int]) -> torch.Tensor:
    """Shard-local outlier-aware W8A8 dot (fp32 accumulator, no bias)."""
    f32 = torch.float32
    din = x.shape[-1]
    m = w["q"].shape[0]
    scale = w["scale"][..., 0, :]
    if m < din:
        # split form: the trailing outlier input rows run bf16 (qkv/fc1).
        xq, sx = quant.quantize_act(x[..., :m])
        hi = x[..., m:].float() @ w["hi"].to(x.dtype).float()
        return quant.int8_product(xq, w["q"]) * sx * scale + hi
    if heads is not None:
        # masked per-head form (out-proj): the local heads' tails are zero
        # rows in q and left out of the absmax; the tails run bf16.
        nh_loc, hd = heads
        kh = w["hi"].shape[0] // nh_loc
        xq, sx, x_hi = quant.quantize_act_masked(x, nh_loc, hd, kh)
        hi = x_hi.float() @ w["hi"].to(x.dtype).float()
        return quant.int8_product(xq, w["q"]) * sx * scale + hi
    if tail_shards is None or shard is None:
        raise ValueError(
            "masked outlier weight needs heads= (out-proj) or tail_shards= "
            "and shard= (fc2) to locate its outlier channels on this shard")
    # masked trailing form (fc2): the global outlier tail lies in the last
    # shard's slice.
    k = w["hi"].shape[0]
    is_last = shard == tail_shards - 1
    xf = x.float()
    keep = torch.ones(din, dtype=f32, device=x.device)
    if is_last:
        keep[din - k:] = 0.0
    absmax = torch.clamp_min((xf.abs() * keep).amax(dim=-1, keepdim=True),
                             quant.ACT_ABSMAX_FLOOR)
    r = torch.full_like(absmax, 127.0) / absmax
    xq = torch.clamp(torch.round(xf * r), -127, 127).to(torch.int8)
    out = quant.int8_product(xq, w["q"]) * (absmax * quant._INV_127) * scale
    if is_last:
        out = out + x[..., din - k:].float() @ w["hi"].to(x.dtype).float()
    return out


def _tp_block(hs: list, lps: list, config: ViTConfig, n_model: int, kernels,
              devices, w8a8: bool = False) -> list:
    """One encoder layer over a data row's model shards: local heads and a
    local hidden slice each, two psums (after out-proj and after fc2)."""
    nh_loc = config.num_heads // n_model
    hd = config.head_dim
    # Attention: column-parallel QKV (local heads), head-parallel core,
    # row-parallel out-proj + psum.
    partials = []
    for h, lp in zip(hs, lps):
        b, t, _ = h.shape
        x = kernels["layer_norm"](h, lp["ln1_w"], lp["ln1_b"], config.eps)
        qkv = _dot_q(x, lp["qkv_w"], w8a8)
        qkv = (qkv + lp["qkv_b"]).to(h.dtype)  # [B, T, nh_loc*3*hd] head-major
        if "attention_packed" in kernels:
            ctx = attention_ops.packed_fused_attention(
                qkv, num_heads=nh_loc, head_dim=hd, packing="per_head")
        else:
            q, k, v = qkv.reshape(b, t, nh_loc, 3, hd).permute(3, 0, 2, 1, 4)
            ctx = kernels["attention"](q, k, v, config)
            ctx = ctx.permute(0, 2, 1, 3).reshape(b, t, nh_loc * hd)
        partials.append(_dot_q(ctx, lp["out_w"], w8a8, heads=(nh_loc, hd)))
    attn = collectives.psum(partials, devices)
    hs = [h + (a + lp["out_b"]).to(h.dtype) for h, a, lp in zip(hs, attn, lps)]
    # MLP: column-parallel fc1 (local hidden slice), row-parallel fc2 + psum.
    partials = []
    for j, (h, lp) in enumerate(zip(hs, lps)):
        x = kernels["layer_norm"](h, lp["ln2_w"], lp["ln2_b"], config.eps)
        hid = _dot_q(x, lp["fc1_w"], w8a8)
        hid = vit.gelu_erf((hid + lp["fc1_b"]).to(h.dtype))
        partials.append(_dot_q(hid, lp["fc2_w"], w8a8, tail_shards=n_model,
                               shard=j))
    mlp = collectives.psum(partials, devices)
    return [h + (m + lp["fc2_b"]).to(h.dtype) for h, m, lp in zip(hs, mlp, lps)]


def tp_forward(images: torch.Tensor, params: list, config: ViTConfig,
               mesh: Mesh, *, compute_dtype: torch.dtype = torch.bfloat16,
               attention_impl: str = "xla", return_logits: bool = False,
               w8a8: bool = False) -> torch.Tensor:
    """DPxTP forward over a ("data", "model") mesh.

    The batch is split over "data"; within each data row the layer weights
    are sharded over "model" as ``shard_params_tp`` lays them out
    (``params``, its result). Returns the probabilities [B, num_classes]
    (logits with ``return_logits``) on the mesh's first device. ``w8a8``
    runs the four block GEMMs int8 x int8 (int8 param dicts required).
    ``attention_impl="flash"`` runs the attention core as
    ``packed_fused_attention(packing="per_head")``."""
    n_model = mesh.shape["model"]
    kernels = vit.resolve_kernels(attention_impl)
    outs = []
    for imgs, devices, shards in zip(_split_batch(images, mesh.shape["data"]),
                                     mesh.devices, params):
        hs = []
        for dev, p in zip(devices, shards):
            x = vit.embed(imgs.to(dev), p, config, compute_dtype)
            if config.pre_norm:
                x = kernels["layer_norm"](x, p["pre_ln_w"], p["pre_ln_b"],
                                          config.eps)
            hs.append(x)
        layers = [vit._layer_list(p) for p in shards]
        for i in range(config.depth):
            hs = _tp_block(hs, [ls[i] for ls in layers], config, n_model,
                           kernels, devices, w8a8)
        # Every shard holds the same tokens now: the output reads shard 0's.
        p = shards[0]
        x = vit.layer_norm(hs[0], p["final_ln_w"], p["final_ln_b"], config.eps)
        outs.append(_head(x, p, config, compute_dtype, return_logits))
    return _gather_rows(outs, mesh.devices[0, 0])


# ---------------------------------------------------------------------------
# Sequence-parallel forward (tokens sharded over "model")
# ---------------------------------------------------------------------------
#
# Every ViT op except the attention core is per-token independent, so the
# token axis shards cleanly: LN, the matmuls and the residuals run on local
# token slices. Attention needs every K/V position: each shard all-gathers
# K/V, or K/V rotate around the ring (ops/ring_attention).


def _token_shards(xs: list, t: int, n_model: int) -> list:
    """Each shard's slice of the tokens, padded to divide the shards."""
    t_pad = -(-t // n_model) * n_model
    t_loc = t_pad // n_model
    out = []
    for j, x in enumerate(xs):
        if t_pad != t:
            x = F.pad(x, (0, 0, 0, t_pad - t))
        out.append(x[:, j * t_loc:(j + 1) * t_loc])
    return out


def _sp_attention(q: list, k_loc: list, v_loc: list, devices,
                  config: ViTConfig, seq_len: int) -> list:
    """q: each shard's local [B, H, T_loc, hd]; K/V local shards → gathered
    full-T, padded tokens masked."""
    k = collectives.all_gather(k_loc, devices, dim=2)
    v = collectives.all_gather(v_loc, devices, dim=2)
    scale = float(np.float32(1.0 / np.sqrt(config.head_dim)))
    out = []
    for qj, kj, vj in zip(q, k, v):
        s = (qj.float() @ kj.float().transpose(-1, -2)) * scale
        kv_pos = torch.arange(s.shape[-1], device=s.device)
        s = torch.where(kv_pos < seq_len, s, attention_ops.MASK_VALUE)
        p = torch.softmax(s, dim=-1)
        out.append((p.to(vj.dtype).float() @ vj.float()).to(vj.dtype))
    return out


def sp_forward(images: torch.Tensor, params: Params, config: ViTConfig,
               mesh: Mesh, *, compute_dtype: torch.dtype = torch.float32,
               return_logits: bool = False, kv: str = "gather") -> torch.Tensor:
    """Sequence-parallel forward: tokens sharded over "model", the batch
    over "data", params replicated: ``replicate_params``'s result, or a tree
    that is copied to each device on this call (no copy where it lies).

    ``kv`` selects how each token shard sees the whole K/V sequence:
    "gather" (all-gather K/V, then local whole-row attention) or "ring"
    (K/V stay sharded and rotate around the ring, ``ops/ring_attention``;
    the carried blockwise kernel at shards of >= 128 tokens)."""
    from ..ops.ring_attention import ring_attention_shard

    if kv not in ("gather", "ring"):
        raise ValueError(f"unknown kv strategy {kv!r}")
    n_model = mesh.shape["model"]
    t = config.num_tokens
    t_loc = -(-t // n_model)
    nh, hd = config.num_heads, config.head_dim
    outs = []
    for imgs, devices in zip(_split_batch(images, mesh.shape["data"]),
                             mesh.devices):
        reps = _replicas(params, devices)
        xs = []
        for dev in devices:
            p = reps[dev]
            x = vit.embed(imgs.to(dev), p, config, compute_dtype)  # [B, T, D]
            if config.pre_norm:
                x = vit.layer_norm(x, p["pre_ln_w"], p["pre_ln_b"], config.eps)
            xs.append(x)
        xs = _token_shards(xs, t, n_model)
        b = xs[0].shape[0]
        layers = {dev: vit._layer_list(p) for dev, p in reps.items()}
        for i in range(config.depth):
            lps = [layers[dev][i] for dev in devices]
            qkvs = []
            for h, lp in zip(xs, lps):
                hh = vit.layer_norm(h, lp["ln1_w"], lp["ln1_b"], config.eps)
                qkv = hh.float() @ lp["qkv_w"].float()
                qkv = (qkv + lp["qkv_b"]).to(h.dtype)
                qkvs.append(qkv.reshape(b, t_loc, 3, nh, hd).permute(2, 0, 3, 1, 4))
            q, k, v = ([z[c] for z in qkvs] for c in range(3))
            if kv == "ring":
                ctx = ring_attention_shard(
                    q, k, v, devices=devices, scale=float(1.0 / np.sqrt(hd)),
                    seq_len=t, shard_tokens=t_loc)
            else:
                ctx = _sp_attention(q, k, v, devices, config, t)
            new = []
            for h, c, lp in zip(xs, ctx, lps):
                c = c.permute(0, 2, 1, 3).reshape(b, t_loc, nh * hd)
                attn = c.float() @ lp["out_w"].float()
                h = h + (attn + lp["out_b"]).to(h.dtype)
                hh = vit.layer_norm(h, lp["ln2_w"], lp["ln2_b"], config.eps)
                hid = hh.float() @ lp["fc1_w"].float()
                hid = vit.gelu_erf((hid + lp["fc1_b"]).to(h.dtype))
                mlp = hid.float() @ lp["fc2_w"].float()
                new.append(h + (mlp + lp["fc2_b"]).to(h.dtype))
            xs = new
        xs = [vit.layer_norm(x, reps[dev]["final_ln_w"], reps[dev]["final_ln_b"],
                             config.eps) for x, dev in zip(xs, devices)]
        # Gather the token shards; slice off the padding.
        full = collectives.all_gather(xs, devices, dim=1)[0][:, :t]
        outs.append(_head(full, reps[devices[0]], config, compute_dtype,
                          return_logits))
    return _gather_rows(outs, mesh.devices[0, 0])


# ---------------------------------------------------------------------------
# Composed sequence x tensor parallelism (Megatron-style SP)
# ---------------------------------------------------------------------------
#
# Activations live token-sharded in the per-token regions (LN, residuals)
# while the matmul weights stay model-sharded as in ``tp_forward``. Each
# block does all_gather(tokens) → column-parallel matmul → row-parallel
# matmul → psum_scatter(tokens). Attention runs on the gathered sequence
# with the padded keys masked (``true_seq_len``).


def _masked_xla_attention(qkv: torch.Tensor, b: int, t_pad: int, nh_loc: int,
                          hd: int, seq_len: int) -> torch.Tensor:
    """Per-head-packed qkv [B, T_pad, nh*3*hd] → ctx, padded keys masked."""
    q, k, v = qkv.reshape(b, t_pad, nh_loc, 3, hd).permute(3, 0, 2, 1, 4)
    s = q.float() @ k.float().transpose(-1, -2)
    s = s * float(np.float32(1.0 / np.sqrt(hd)))
    kv_pos = torch.arange(s.shape[-1], device=s.device)
    s = torch.where(kv_pos < seq_len, s, attention_ops.MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    ctx = (p.to(v.dtype).float() @ v.float()).to(v.dtype)
    return ctx.permute(0, 2, 1, 3).reshape(b, t_pad, nh_loc * hd)


def sp_tp_forward(images: torch.Tensor, params: list, config: ViTConfig,
                  mesh: Mesh, *, compute_dtype: torch.dtype = torch.bfloat16,
                  attention_impl: str = "flash", return_logits: bool = False,
                  w8a8: bool = False) -> torch.Tensor:
    """Sequence-parallel x tensor-parallel forward over ("data", "model").

    ``params`` is ``shard_params_tp``'s result: the weights model-sharded;
    between blocks the activations are token-sharded. ``attention_impl``:
    "flash" (``packed_fused_attention`` with per-head packing and the padded
    keys masked by ``true_seq_len``) or "xla". Returns probabilities [B,
    num_classes] on the mesh's first device. ``w8a8`` runs the four block
    GEMMs int8 x int8 (int8 param dicts required)."""
    if attention_impl not in ("flash", "xla"):
        raise ValueError(f"unknown attention_impl {attention_impl!r}")
    n_model = mesh.shape["model"]
    t = config.num_tokens
    t_pad = -(-t // n_model) * n_model
    nh_loc, hd = config.num_heads // n_model, config.head_dim
    outs = []
    for imgs, devices, shards in zip(_split_batch(images, mesh.shape["data"]),
                                     mesh.devices, params):
        xs = []
        for dev, p in zip(devices, shards):
            x = vit.embed(imgs.to(dev), p, config, compute_dtype)  # [B, T, D]
            if config.pre_norm:
                x = vit.layer_norm(x, p["pre_ln_w"], p["pre_ln_b"], config.eps)
            xs.append(x)
        xs = _token_shards(xs, t, n_model)
        b = xs[0].shape[0]
        layers = [vit._layer_list(p) for p in shards]
        for i in range(config.depth):
            lps = [ls[i] for ls in layers]
            # Attention: LN → AG(tokens) → column-parallel QKV → head-parallel
            # core → row-parallel out → RS(tokens).
            hh = [vit.layer_norm(h, lp["ln1_w"], lp["ln1_b"], config.eps)
                  for h, lp in zip(xs, lps)]
            hg = collectives.all_gather(hh, devices, dim=1)
            partials = []
            for h, g, lp in zip(xs, hg, lps):
                qkv = (_dot_q(g, lp["qkv_w"], w8a8) + lp["qkv_b"]).to(h.dtype)
                if attention_impl == "flash":
                    ctx = attention_ops.packed_fused_attention(
                        qkv, num_heads=nh_loc, head_dim=hd, packing="per_head",
                        true_seq_len=t if t_pad != t else None)
                else:
                    ctx = _masked_xla_attention(qkv, b, t_pad, nh_loc, hd, t)
                partials.append(_dot_q(ctx, lp["out_w"], w8a8, heads=(nh_loc, hd)))
            attn = collectives.psum_scatter(partials, devices, dim=1)
            xs = [h + (a + lp["out_b"]).to(h.dtype) for h, a, lp in zip(xs, attn, lps)]
            # MLP: LN → AG → column-parallel fc1 + GELU → row-parallel fc2 → RS.
            hh = [vit.layer_norm(h, lp["ln2_w"], lp["ln2_b"], config.eps)
                  for h, lp in zip(xs, lps)]
            hg = collectives.all_gather(hh, devices, dim=1)
            partials = []
            for j, (h, g, lp) in enumerate(zip(xs, hg, lps)):
                hid = _dot_q(g, lp["fc1_w"], w8a8)
                hid = vit.gelu_erf((hid + lp["fc1_b"]).to(h.dtype))
                partials.append(_dot_q(hid, lp["fc2_w"], w8a8,
                                       tail_shards=n_model, shard=j))
            mlp = collectives.psum_scatter(partials, devices, dim=1)
            xs = [h + (m + lp["fc2_b"]).to(h.dtype) for h, m, lp in zip(xs, mlp, lps)]
        xs = [vit.layer_norm(x, p["final_ln_w"], p["final_ln_b"], config.eps)
              for x, p in zip(xs, shards)]
        full = collectives.all_gather(xs, devices, dim=1)[0][:, :t]
        outs.append(_head(full, shards[0], config, compute_dtype, return_logits))
    return _gather_rows(outs, mesh.devices[0, 0])


# ---------------------------------------------------------------------------
# Data-parallel inference (params replicated)
# ---------------------------------------------------------------------------


def dp_forward_fn(config: ViTConfig, mesh: Mesh, *,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  attention_impl: str = "xla", kernels=None, preprocess=None):
    """Data-parallel forward: the batch split over every device of the mesh
    (data-major, ``P(("data", "model"))``), the params replicated. Returns
    ``fwd(images, params) -> probabilities`` on the mesh's first device;
    each shard runs ``vit.forward`` on its own device with ``kernels``
    (default ``resolve_kernels(attention_impl)``), after ``preprocess``
    where one is given (``DataParallelEngine``'s uint8 normalisation).
    ``params`` is ``replicate_params``'s result, or a tree that is copied
    to each device on every call (no copy where it lies)."""
    kernels = kernels if kernels is not None else vit.resolve_kernels(attention_impl)
    devices = list(mesh.devices.ravel())

    def fwd(images: torch.Tensor, params) -> torch.Tensor:
        reps = _replicas(params, devices)
        outs = []
        for x, dev in zip(_split_batch(images, len(devices)), devices):
            x = x.to(dev)
            if preprocess is not None:
                x = preprocess(x)
            outs.append(vit.forward(x, reps[dev], config,
                                    compute_dtype=compute_dtype, kernels=kernels))
        return _gather_rows(outs, devices[0])

    return fwd


# ---------------------------------------------------------------------------
# Training step (one device)
# ---------------------------------------------------------------------------


def train_kernels(config: ViTConfig, attention_impl: str,
                  compute_dtype: torch.dtype) -> dict:
    """The forward's kernel table for a training route (see the module's
    docstring)."""
    if attention_impl not in ("xla", "flash", "fused"):
        raise ValueError(f"unknown attention_impl {attention_impl!r}")
    kernels = vit.resolve_kernels("xla")
    if attention_impl == "xla":
        return kernels
    from ..ops import attention, fused_block

    kernels["attention_packed"] = (
        lambda qkv, cfg: attention.packed_fused_attention_trainable(
            qkv, cfg.num_heads, cfg.head_dim))
    itemsize = torch.empty((), dtype=compute_dtype).element_size()
    if attention_impl == "fused" and fused_block.supports_trainable(
            config, dtype_bytes=itemsize):
        kernels["encoder_block"] = fused_block.fused_encoder_layer_trainable
    return kernels


def make_train_step(config: ViTConfig, mesh=None, *, device=None,
                    lr=1e-3, compute_dtype: torch.dtype = torch.float32,
                    optimizer: str = "sgd", weight_decay: float = 0.05,
                    attention_impl: str = "xla", grad_accum: int = 1,
                    scan_unroll: int = 1,
                    grad_clip_norm: Optional[float] = None,
                    label_smoothing: float = 0.0,
                    tuning: Optional[dict] = None):
    """Cross-entropy training step on ``device`` (default the card, which
    must be there; ``device="cpu"`` runs the plain versions).

    ``optimizer="sgd"`` returns ``step(params, images, labels) -> (params,
    loss)``; ``"adamw"`` returns ``(init_fn, step)`` with ``step(params,
    opt_state, images, labels) -> (params, opt_state, loss)``. ``lr`` may be
    a schedule of the step count for AdamW. The step updates ``params`` and
    the optimizer state in place (one copy of the weights and moments, not
    two) and returns them. Labels are int [B] or soft [B, C] (CE against
    the given distribution); ``label_smoothing`` blends in the uniform CE;
    ``grad_accum=A`` splits the batch into A microbatches whose fp32
    gradients are averaged (the full-batch gradient); ``grad_clip_norm``
    clips by global L2 norm before the update, on both optimizers."""
    if mesh is not None:
        raise NotImplementedError(
            "a mesh (data, tensor or sequence parallelism over several cards) "
            "is not ported yet; the port trains on one device")
    if tuning:
        raise NotImplementedError("the autotune knobs are not ported yet")
    del scan_unroll  # the encoder is a Python loop: nothing to unroll
    resolve_device(device)
    kernels = train_kernels(config, attention_impl, compute_dtype)
    if not 0.0 <= label_smoothing < 1.0:
        raise ValueError(f"label_smoothing must be in [0, 1), got "
                         f"{label_smoothing}")
    clip = None
    if grad_clip_norm is not None:
        if not grad_clip_norm > 0.0:
            # 0 silently freezes training; negative flips gradient signs.
            raise ValueError(f"grad_clip_norm must be > 0, got "
                             f"{grad_clip_norm}")
        clip = optim.clip_by_global_norm(grad_clip_norm)
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def loss_fn(params, images, labels):
        logits = vit.forward(images, params, config,
                             compute_dtype=compute_dtype, return_logits=True,
                             kernels=kernels)
        logp = torch.log_softmax(logits, dim=-1)
        if labels.dim() == 2:
            nll = -torch.mean(torch.sum(labels.to(logp.dtype) * logp, -1))
        else:
            nll = -torch.mean(torch.gather(logp, 1, labels.long()[:, None]))
        if label_smoothing:
            uniform = -torch.mean(logp)
            nll = (1.0 - label_smoothing) * nll + label_smoothing * uniform
        return nll

    def value_and_grads(params, images, labels):
        leaves = optim.tree_leaves(params)
        train = [p.detach().requires_grad_(optim._is_float(p)) for p in leaves]
        live = _rebuild(params, iter(train))
        wanted = [t for t in train if t.requires_grad]

        def one(imgs, labs):
            loss = loss_fn(live, imgs, labs)
            grads = torch.autograd.grad(loss, wanted, allow_unused=True)
            # A leaf the loss does not reach gets zeros, as under jax.grad.
            grads = [torch.zeros_like(t) if g is None else g
                     for t, g in zip(wanted, grads)]
            return loss.detach(), grads

        if grad_accum == 1:
            loss, grads = one(images, labels)
        else:
            b = images.shape[0]
            if b % grad_accum:
                raise ValueError(f"batch {b} not divisible by "
                                 f"grad_accum={grad_accum}")
            mb = b // grad_accum
            loss, grads = None, None
            for i in range(grad_accum):
                sl = slice(i * mb, (i + 1) * mb)
                l_i, g_i = one(images[sl], labels[sl])
                g_i = [g.to(torch.float32, copy=True) for g in g_i]
                if grads is None:
                    loss, grads = l_i, g_i
                else:
                    loss = loss + l_i
                    for acc, g in zip(grads, g_i):
                        acc.add_(g)
            inv = 1.0 / grad_accum
            loss = loss * inv
            grads = [g * inv for g in grads]
        it = iter(grads)
        return loss, _rebuild(params, (next(it) if optim._is_float(p) else None
                                       for p in leaves))

    def sgd_update(params, grads):
        def one(p, g):  # (p - lr·g) in fp32, cast back to p's dtype
            if g is None:
                return p
            step = lr * g.float()
            if p.dtype == torch.float32:
                p.sub_(step)
            else:
                p.copy_((p.float() - step).to(p.dtype))
            return p

        optim.tree_map(one, params, grads)
        return params

    if optimizer == "sgd":
        def step(params, images, labels):
            loss, grads = value_and_grads(params, images, labels)
            if clip is not None:
                grads, _ = clip.update(grads, {})
            return sgd_update(params, grads), loss

        return step

    if optimizer != "adamw":
        raise ValueError(f"unknown optimizer {optimizer!r}")
    tx = optim.adamw(lr, weight_decay=weight_decay)
    if clip is not None:
        tx = optim.chain(clip, tx)

    def adam_step(params, opt_state, images, labels):
        loss, grads = value_and_grads(params, images, labels)
        updates, opt_state = tx.update(grads, opt_state, params)
        optim.apply_updates(params, updates)
        return params, opt_state, loss

    return tx.init, adam_step


def _rebuild(tree, leaves):
    """``tree``'s nested dicts with the leaves taken in JAX's order."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)
