"""The ViT forward pass on PyTorch, with a kernel table like the JAX package's.

Counterpart of ``vit_with_opencl_tpu/models/vit.py``, function for function:
the patch-embedding conv as patchify + one GEMM, the encoder as a loop over
stacked per-layer weights, the fused [D, 3D] QKV projection, and the
classifier head on the CLS row (DeiT averages the CLS and distillation
heads). Two routes, chosen by ``resolve_kernels``:

  * ``xla``   — plain PyTorch ops throughout (the JAX package leaves this
    route to XLA, outside any Pallas kernel);
  * ``flash`` — the encoder of a config that ``fused_block.supports`` goes
    to chains of CUDA kernels (``ops/fused_block``): the small configs whose
    whole weight stack fits the JAX package's on-chip budget (ViT-Ti, ViT-S)
    to the stack, with its fp32 residual stream across every layer, the
    others to the per-layer chain, as ``encoder`` says; other configs
    (tanh-GELU) send only the attention core to the packed-attention kernel.

Numerics: bf16 storage and matmul inputs with fp32 accumulation, fp32 LN
statistics and softmax, as the JAX package. Every GEMM outside the kernels
is an fp32-output product of the upcast operands, because a bf16-output
matmul would round where the reference does not. ``param_dtype`` and
``compute_dtype`` of ``torch.float32`` give the tight-parity mode.

int8 weights (``models/quant``: {"q": int8, "scale": fp32} leaves) run
everywhere a weight does: the chain takes them as weight-only int8, or as
W8A8 when ``resolve_kernels(..., w8a8=True)``; the patch embedding and the
head multiply their fp32 products by the scale, as the JAX package does.
The calibrated outlier-aware weights (a bf16 "hi" group beside the encoder's
int8 leaves) need ``w8a8``: the chain's outlier form, or ``matmul_w8a8``'s
trailing and masked forms on the per-op route.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ViTConfig
from ..ops import attention as attention_ops
from ..ops import fused_block
from ..ops import layernorm as layernorm_ops
from . import quant

Params = Dict[str, Any]

_LAYER_KEYS = {  # stacked key -> (reference name suffix, transposed)
    "ln1_w": ("ln_1_weight", False),
    "ln1_b": ("ln_1_bias", False),
    "qkv_w": ("self_attention_in_proj_weight", True),
    "qkv_b": ("self_attention_in_proj_bias", False),
    "out_w": ("self_attention_out_proj_weight", True),
    "out_b": ("self_attention_out_proj_bias", False),
    "ln2_w": ("ln_2_weight", False),
    "ln2_b": ("ln_2_bias", False),
    "fc1_w": ("mlp_0_weight", True),
    "fc1_b": ("mlp_0_bias", False),
    "fc2_w": ("mlp_3_weight", True),
    "fc2_b": ("mlp_3_bias", False),
}
_MATMUL_KEYS = ("patch_w", "head_w", "head_dist_w", "qkv_w", "out_w",
                "fc1_w", "fc2_w")


# ---------------------------------------------------------------------------
# Parameters: named numpy dict (io layer) ↔ stacked dict of tensors
# ---------------------------------------------------------------------------


def stack_params(named: Dict[str, np.ndarray], config: ViTConfig, *,
                 param_dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cuda") -> Params:
    """{torchvision-style name: array} → stacked params on ``device``.

    Matmul weights are transposed to the right-multiply layout ``[in, out]``
    and stored in ``param_dtype``; LN parameters, biases, tokens and the
    positional embedding stay fp32. The same layout as the JAX package's
    ``stack_params``; the dict is built on the host and copied once."""
    f32 = np.float32
    d = config.embed_dim

    def a(name):
        return np.asarray(named[name], f32)

    prefix = [a("class_token").reshape(1, d)]
    if config.num_prefix_tokens > 1:
        prefix.append(a("dist_token").reshape(1, d))
    host: Params = {
        "prefix_tokens": np.concatenate(prefix, 0),
        # conv [D, C, P, P] → [C*P*P, D] so the patchify output right-multiplies.
        "patch_w": a("conv_proj_weight").reshape(d, -1).T,
        "patch_b": a("conv_proj_bias"),
        "pos_emb": a("encoder_pos_embedding"),
        "final_ln_w": a("encoder_ln_weight"),
        "final_ln_b": a("encoder_ln_bias"),
    }
    if config.pre_norm:
        host["pre_ln_w"] = a("encoder_pre_ln_weight")
        host["pre_ln_b"] = a("encoder_pre_ln_bias")
    if config.head_type != "none":
        host["head_w"] = a("heads_head_weight").T
        host["head_b"] = a("heads_head_bias")
    if config.head_type == "cls+dist":
        host["head_dist_w"] = a("heads_head_dist_weight").T
        host["head_dist_b"] = a("heads_head_dist_bias")
    host["layers"] = {}
    for key, (ref, transpose) in _LAYER_KEYS.items():
        arrs = [a(f"encoder_layers_encoder_layer_{layer}_{ref}")
                for layer in range(config.depth)]
        host["layers"][key] = np.stack([x.T for x in arrs] if transpose else arrs)
    return _to_torch(host, param_dtype, device)


def _to_torch(host: Params, param_dtype: torch.dtype, device) -> Params:
    def conv(key, arr):
        # A copy: training updates params in place, which must not write
        # through to the caller's arrays.
        t = torch.from_numpy(np.array(arr, np.float32))
        dtype = param_dtype if key in _MATMUL_KEYS else torch.float32
        return t.to(device=device, dtype=dtype).contiguous()

    out = {k: conv(k, v) for k, v in host.items() if k != "layers"}
    out["layers"] = {k: conv(k, v) for k, v in host["layers"].items()}
    return out


def params_from_jax(stacked: Params, *,
                    device: torch.device | str = "cuda", opt_state=None):
    """The JAX package's stacked params (leaves as numpy arrays; bf16 leaves
    as ``ml_dtypes.bfloat16``) → the port's params, value for value.

    Both packages then compute on identical weights. bf16 leaves go through
    float32, which is exact, and come back to bf16 unchanged. Quantized
    weights ({"q": int8, "scale": fp32} dicts of ``quantize_stacked_params``,
    with the bf16 "hi" group of ``quantize_stacked_params_outlier``) keep
    their layout: int8 as ``torch.int8``, scales as fp32, "hi" as bf16.

    With ``opt_state`` (an optax AdamW state: any pytree of tuples holding
    one ``ScaleByAdamState``, as ``optax.adamw`` or a chain with
    ``clip_by_global_norm`` makes), returns ``(params, state)``, the state
    in ``optim.adamw``'s form: its ``count``, ``mu`` and ``nu`` carried
    across value for value, so both packages can go on from one
    mid-training state."""

    def conv(a):
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        # A copy: a JAX array's host view is read-only to JAX, and training
        # updates params in place.
        return torch.from_numpy(np.array(a)).to(device)

    out = {k: conv(v) for k, v in stacked.items() if k != "layers"}
    out["layers"] = {k: conv(v) for k, v in stacked["layers"].items()}
    if opt_state is None:
        return out
    return out, _adam_state_from_jax(opt_state, conv)


def _adam_state_from_jax(state, conv) -> dict:
    """The one (count, mu, nu) record inside an optax state pytree."""
    found = []

    def walk(node):
        if all(hasattr(node, f) for f in ("count", "mu", "nu")):
            found.append(node)
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)

    walk(state)
    if len(found) != 1:
        raise ValueError(f"expected one Adam state (count, mu, nu) in the "
                         f"optax state, found {len(found)}")
    adam = found[0]

    def tree(t):
        return {k: tree(v) if isinstance(v, dict) else conv(v)
                for k, v in t.items()}

    return {"count": conv(np.asarray(adam.count)).to(torch.int32),
            "mu": tree(adam.mu), "nu": tree(adam.nu)}


def params_to(params: Params, device: torch.device | str) -> Params:
    """Every tensor of a (nested) param dict on ``device``: a host pytree
    (``quant.calibrate_w8a8``) onto the card."""
    return {k: params_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in params.items()}


def unstack_params(params: Params, config: ViTConfig) -> Dict[str, np.ndarray]:
    """Stacked params → {reference tensor name: fp32 numpy array}, the
    inverse of :func:`stack_params` (PyTorch ``[out, in]`` layout again)."""
    d = config.embed_dim

    def h(t):
        return t.detach().float().cpu().numpy()

    prefix = h(params["prefix_tokens"]).reshape(config.num_prefix_tokens, d)
    named: Dict[str, np.ndarray] = {
        "class_token": prefix[0],
        "conv_proj_weight": np.ascontiguousarray(h(params["patch_w"]).T).reshape(
            d, config.in_chans, config.patch_size, config.patch_size),
        "conv_proj_bias": h(params["patch_b"]),
        "encoder_pos_embedding": h(params["pos_emb"]),
        "encoder_ln_weight": h(params["final_ln_w"]),
        "encoder_ln_bias": h(params["final_ln_b"]),
    }
    if config.num_prefix_tokens > 1:
        named["dist_token"] = prefix[1]
    if config.pre_norm:
        named["encoder_pre_ln_weight"] = h(params["pre_ln_w"])
        named["encoder_pre_ln_bias"] = h(params["pre_ln_b"])
    if config.head_type != "none":
        named["heads_head_weight"] = np.ascontiguousarray(h(params["head_w"]).T)
        named["heads_head_bias"] = h(params["head_b"])
    if config.head_type == "cls+dist":
        named["heads_head_dist_weight"] = np.ascontiguousarray(
            h(params["head_dist_w"]).T)
        named["heads_head_dist_bias"] = h(params["head_dist_b"])
    for key, (ref, transpose) in _LAYER_KEYS.items():
        stacked = h(params["layers"][key])
        for layer in range(config.depth):
            a = stacked[layer]
            named[f"encoder_layers_encoder_layer_{layer}_{ref}"] = (
                np.ascontiguousarray(a.T) if transpose else a)
    return named


def init_params(config: ViTConfig, seed: int = 0,
                param_dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cuda") -> Params:
    """Trainable from-scratch initialisation (stacked layout), the JAX
    package's ``init_params`` value for value: NumPy's generator from
    ``seed`` draws truncated-normal(0.02) matmul weights (clipped at 2
    sigma) and positional embeddings in the same order, with zero biases and
    prefix tokens, unit LNs and a zero-initialised classifier head. fp32 by
    default (training keeps fp32 masters and casts per step); a bf16
    ``param_dtype`` rounds the matmul weights with torch (to nearest even,
    as ``ml_dtypes`` does)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    d, h, L = config.embed_dim, config.hidden_dim, config.depth

    def tnorm(shape, std=0.02):
        a = rng.standard_normal(shape, f32)
        np.clip(a, -2.0, 2.0, out=a)  # truncation at 2 sigma
        return a * std

    host: Params = {
        "prefix_tokens": np.zeros((config.num_prefix_tokens, d), f32),
        "patch_w": tnorm((config.in_chans * config.patch_size**2, d)),
        "patch_b": np.zeros((d,), f32),
        "pos_emb": tnorm((config.num_tokens, d)),
        "final_ln_w": np.ones((d,), f32),
        "final_ln_b": np.zeros((d,), f32),
    }
    if config.pre_norm:
        host["pre_ln_w"] = np.ones((d,), f32)
        host["pre_ln_b"] = np.zeros((d,), f32)
    if config.head_type != "none":
        host["head_w"] = np.zeros((d, config.num_classes), f32)
        host["head_b"] = np.zeros((config.num_classes,), f32)
    if config.head_type == "cls+dist":
        host["head_dist_w"] = np.zeros((d, config.num_classes), f32)
        host["head_dist_b"] = np.zeros((config.num_classes,), f32)
    host["layers"] = {
        "ln1_w": np.ones((L, d), f32),
        "ln1_b": np.zeros((L, d), f32),
        "qkv_w": tnorm((L, d, 3 * d)),
        "qkv_b": np.zeros((L, 3 * d), f32),
        "out_w": tnorm((L, d, d)),
        "out_b": np.zeros((L, d), f32),
        "ln2_w": np.ones((L, d), f32),
        "ln2_b": np.zeros((L, d), f32),
        "fc1_w": tnorm((L, d, h)),
        "fc1_b": np.zeros((L, h), f32),
        "fc2_w": tnorm((L, h, d)),
        "fc2_b": np.zeros((L, d), f32),
    }
    return _to_torch(host, param_dtype, device)


def cheap_stacked_params(config: ViTConfig, *,
                         param_dtype: torch.dtype = torch.bfloat16,
                         scale: float = 0.02,
                         device: torch.device | str = "cuda") -> Params:
    """Deterministic non-random stacked params, made on ``device``.

    For benchmarks: varied, well-scaled values from an integer hash, with no
    host arrays to copy. The same hash and order as the JAX package's
    ``cheap_stacked_params`` (int32 arithmetic that wraps, and a
    non-negative remainder), so both give the same values."""
    f32 = torch.float32
    d, h, L = config.embed_dim, config.hidden_dim, config.depth
    salt = [0]

    def fill(shape, dtype=param_dtype):
        salt[0] += 1
        n = int(np.prod(shape))
        i = torch.arange(n, dtype=torch.int32, device=device)
        v = torch.remainder(i * 1103515245 + salt[0] * 12345, 2039).to(f32)
        v = (v / 2039.0 - 0.5) * (2.0 * scale)
        return v.reshape(shape).to(dtype)

    def const(shape, value):
        return torch.full(shape, value, dtype=f32, device=device)

    params: Params = {
        "prefix_tokens": fill((config.num_prefix_tokens, d), f32),
        "patch_w": fill((config.in_chans * config.patch_size**2, d)),
        "patch_b": fill((d,), f32),
        "pos_emb": fill((config.num_tokens, d), f32),
        "final_ln_w": const((d,), 1.0),
        "final_ln_b": const((d,), 0.0),
    }
    if config.pre_norm:
        params["pre_ln_w"] = const((d,), 1.0)
        params["pre_ln_b"] = const((d,), 0.0)
    if config.head_type != "none":
        params["head_w"] = fill((d, config.num_classes))
        params["head_b"] = fill((config.num_classes,), f32)
    if config.head_type == "cls+dist":
        params["head_dist_w"] = fill((d, config.num_classes))
        params["head_dist_b"] = fill((config.num_classes,), f32)
    params["layers"] = {
        "ln1_w": const((L, d), 1.0),
        "ln1_b": const((L, d), 0.0),
        "qkv_w": fill((L, d, 3 * d)),
        "qkv_b": fill((L, 3 * d), f32),
        "out_w": fill((L, d, d)),
        "out_b": fill((L, d), f32),
        "ln2_w": const((L, d), 1.0),
        "ln2_b": const((L, d), 0.0),
        "fc1_w": fill((L, d, h)),
        "fc1_b": fill((L, h), f32),
        "fc2_w": fill((L, h, d)),
        "fc2_b": fill((L, d), f32),
    }
    return params


# ---------------------------------------------------------------------------
# Plain ops (the xla route; the kernels plug in through the table)
# ---------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LN with fp32 statistics, var = E[x²]−E[x]²; returns x's dtype."""
    return layernorm_ops.layer_norm_reference(x, w, b, eps)


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact erf-GELU in fp32, returned in x's dtype."""
    xf = x.float()
    return (0.5 * xf * (1.0 + torch.erf(xf * float(np.float32(1 / np.sqrt(2.0)))))
            ).to(x.dtype)


def _gelu(x: torch.Tensor, config: ViTConfig) -> torch.Tensor:
    if config.gelu_approx == "tanh":
        return F.gelu(x, approximate="tanh")
    return gelu_erf(x)


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  config: ViTConfig) -> torch.Tensor:
    """Reference attention math on [B, H, T, hd] inputs: fp32 scores, the
    scale applied to the scores, fp32 softmax, probabilities cast to v's
    dtype for the PV product."""
    scale = float(np.float32(1.0 / np.sqrt(config.head_dim)))
    scores = q.float() @ k.float().transpose(-1, -2)
    probs = torch.softmax(scores * scale, dim=-1)
    return (probs.to(v.dtype).float() @ v.float()).to(v.dtype)


def _attention_block(x: torch.Tensor, lp: Params, config: ViTConfig,
                     kernels: Dict[str, Any]) -> torch.Tensor:
    """LN1 → fused QKV matmul → attention core → out-proj, on [B, T, D]."""
    b, t, d = x.shape
    nh, hd = config.num_heads, config.head_dim
    h = kernels["layer_norm"](x, lp["ln1_w"], lp["ln1_b"], config.eps)
    qkv = kernels["matmul"](h, lp["qkv_w"], lp["qkv_b"])  # [B, T, 3D]
    if "attention_packed" in kernels:
        ctx = kernels["attention_packed"](qkv, config)  # [B, T, D]
    else:
        q, k, v = qkv.reshape(b, t, 3, nh, hd).permute(2, 0, 3, 1, 4)
        ctx = kernels["attention"](q, k, v, config)
        ctx = ctx.permute(0, 2, 1, 3).reshape(b, t, d)
    return kernels["matmul"](ctx, lp["out_w"], lp["out_b"])


def _mlp_block(x: torch.Tensor, lp: Params, config: ViTConfig,
               kernels: Dict[str, Any]) -> torch.Tensor:
    h = kernels["layer_norm"](x, lp["ln2_w"], lp["ln2_b"], config.eps)
    h = kernels["matmul_gelu"](h, lp["fc1_w"], lp["fc1_b"], config)
    return kernels["matmul"](h, lp["fc2_w"], lp["fc2_b"])


def _default_kernels() -> Dict[str, Any]:
    return {
        "layer_norm": layer_norm,
        # x @ w (+ b), fp32 accumulation, x's dtype; int8 weight dicts too.
        "matmul": quant.matmul_q,
        "matmul_gelu": lambda x, w, b, cfg: _gelu(quant.matmul_q(x, w, b), cfg),
        "attention": xla_attention,
    }


def resolve_kernels(attention_impl: str = "xla", w8a8: bool = False,
                    heads: Optional[tuple] = None) -> Dict[str, Any]:
    """Kernel table for the forward pass.

    ``attention_impl``:
      * 'xla'   — plain PyTorch ops;
      * 'flash' (or its synonym 'fused_block', as in the JAX package) — the
        packed-attention kernel for the per-op path, and the chains of
        ``ops/fused_block`` (whole stack, layer groups or per layer, as
        ``encoder`` routes) for every config ``fused_block.supports``.

    ``w8a8``: per-token dynamic int8 activations into the encoder's four
    GEMMs (``quant.matmul_w8a8`` on the per-op path, the W8A8 chain on the
    fused one). It needs int8 weight dicts; fp weights run as before. The
    embedding, head and attention core stay in the activation dtype.
    ``heads`` is passed on to ``matmul_w8a8``.
    """
    kernels = _default_kernels()
    if attention_impl in ("flash", "fused_block"):
        kernels["attention_packed"] = attention_ops.packed_fused_attention
        kernels["_fused_block_if_supported"] = True
    elif attention_impl != "xla":
        raise ValueError(f"unknown attention_impl {attention_impl!r}")
    if w8a8:
        mm = functools.partial(quant.matmul_w8a8, heads=heads)
        kernels["matmul"] = mm
        kernels["matmul_gelu"] = lambda x, w, b, cfg: _gelu(mm(x, w, b), cfg)
        kernels["w8a8"] = True
    return kernels


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------


def patchify(images: torch.Tensor, config: ViTConfig) -> torch.Tensor:
    """[B, C, H, W] → [B, num_patches, C*P*P] with (ic, kh, kw) patch layout
    (the conv kernel's flattening, reference: ViT_seq.c:46)."""
    b, c, _, _ = images.shape
    p, g = config.patch_size, config.grid_size
    x = images.reshape(b, c, g, p, g, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, g * g, c * p * p)


def _weight_product(x: torch.Tensor, w: Any,
                  compute_dtype: torch.dtype) -> torch.Tensor:
    """x @ w with fp32 output, the weight in ``compute_dtype``; an int8
    weight's per-channel scale multiplies the product."""
    if quant.is_quantized(w):
        out = x.float() @ w["q"].to(compute_dtype).float()
        return out * w["scale"][0]
    return x.float() @ w.to(compute_dtype).float()


def embed(images: torch.Tensor, params: Params, config: ViTConfig,
          compute_dtype: torch.dtype) -> torch.Tensor:
    """Patch-embed + prefix tokens + positional embedding → [B, T, D]:
    one GEMM (fp32 output) and an fp32 epilogue."""
    b = images.shape[0]
    patches = patchify(images, config).to(compute_dtype)
    tok = _weight_product(patches, params["patch_w"], compute_dtype)
    tok = tok + params["patch_b"]
    prefix = params["prefix_tokens"][None].expand(
        (b,) + tuple(params["prefix_tokens"].shape))
    x = torch.cat([prefix, tok], dim=1) + params["pos_emb"]
    return x.to(compute_dtype)


def _layer(params: Params, layer: int) -> Params:
    def take(v):
        return {k: t[layer] for k, t in v.items()} if isinstance(v, dict) else v[layer]

    return {k: take(v) for k, v in params["layers"].items()}


def _layer_list(params: Params) -> list:
    """Every layer's slice of the stacked weights, one dict each, as views.
    Unbinding once (not indexing per layer) keeps the backward to one
    gradient per stacked leaf: autograd stacks the layers' gradients instead
    of adding a full-size zero-padded one per layer."""
    per_key = {}
    for k, v in params["layers"].items():
        per_key[k] = ([dict(zip(v, vals)) for vals in zip(*(t.unbind(0) for t in v.values()))]
                      if isinstance(v, dict) else v.unbind(0))
    depth = len(next(iter(per_key.values())))
    return [{k: per_key[k][i] for k in per_key} for i in range(depth)]


def encoder(x: torch.Tensor, params: Params, config: ViTConfig,
            kernels: Dict[str, Any]) -> torch.Tensor:
    """The layers in order over the stacked weights, routed as the JAX
    package routes them.

    A forced ``encoder_block`` runs every layer (ignored for quantized
    params), under autograd too: training's ``fused`` route puts
    ``fused_block.fused_encoder_layer_trainable`` there. Otherwise the ``flash`` route takes, in this order: layer
    groups of ``kernels["fused_group_size"]`` when it divides the depth and
    ``fused_block.supports`` the config; the whole stack when not W8A8 and
    ``fused_block.supports_stack`` (small configs: ViT-Ti and ViT-S, in
    bf16 or int8 weights); the per-layer chain when ``supports``; else the
    per-op path."""
    qkv_w = params["layers"]["qkv_w"]
    quantized = quant.is_quantized(qkv_w)
    block: Optional[Callable] = None if quantized else kernels.get("encoder_block")
    if block is None and kernels.get("_fused_block_if_supported"):
        wbytes = 1 if quantized else qkv_w.element_size()
        w8a8 = bool(kernels.get("w8a8")) and quantized
        gs = kernels.get("fused_group_size")
        if (gs and gs > 1 and config.depth % gs == 0
                and fused_block.supports(config, dtype_bytes=wbytes)):
            return fused_block.fused_encoder_group(
                x, params["layers"], config, group_size=gs, w8a8=w8a8)
        if not w8a8 and fused_block.supports_stack(config, dtype_bytes=wbytes):
            return fused_block.fused_encoder_stack(x, params["layers"], config)
        if fused_block.supports(config, dtype_bytes=wbytes):
            block = functools.partial(fused_block.fused_encoder_layer, w8a8=w8a8)
    for lp in _layer_list(params)[:config.depth]:
        if block is not None:
            x = block(x, lp, config)
        else:
            x = x + _attention_block(x, lp, config, kernels)
            x = x + _mlp_block(x, lp, config, kernels)
    return x


def forward_features(images: torch.Tensor, params: Params, config: ViTConfig,
                     *, compute_dtype: torch.dtype = torch.bfloat16,
                     kernels: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Tower forward → final-LN token features [B, T, D] (fp32)."""
    kernels = kernels or _default_kernels()
    x = embed(images, params, config, compute_dtype)
    if config.pre_norm:
        x = kernels["layer_norm"](x, params["pre_ln_w"], params["pre_ln_b"],
                                  config.eps)
    x = encoder(x, params, config, kernels)
    x = layer_norm(x, params["final_ln_w"], params["final_ln_b"], config.eps)
    return x.float()


def forward(images: torch.Tensor, params: Params, config: ViTConfig, *,
            compute_dtype: torch.dtype = torch.bfloat16,
            kernels: Optional[Dict[str, Any]] = None,
            return_logits: bool = False) -> torch.Tensor:
    """Full classifier forward → probabilities [B, num_classes] (fp32)."""
    feats = forward_features(images, params, config,
                             compute_dtype=compute_dtype, kernels=kernels)
    if config.head_type == "none":
        raise ValueError("head_type='none': use forward_features")
    logits = classifier_logits(feats, params, config, compute_dtype)
    if return_logits:
        return logits
    return torch.softmax(logits, dim=-1)


def classifier_logits(feats: torch.Tensor, params: Params, config: ViTConfig,
                      compute_dtype: torch.dtype) -> torch.Tensor:
    """CLS-row classifier head (reference: ViT_seq.c:509-513); the DeiT
    dual head averages the CLS and distillation heads."""

    def head(feat, w, bias):
        return _weight_product(feat.to(compute_dtype), w, compute_dtype) + bias

    logits = head(feats[:, 0], params["head_w"], params["head_b"])
    if config.head_type == "cls+dist":
        logits = 0.5 * (logits + head(feats[:, 1], params["head_dist_w"],
                                      params["head_dist_b"]))
    return logits
