"""Pure-NumPy fp32 golden model — the semantic oracle.

Mirrors the reference's sequential CPU backend op-for-op
(reference: ViT_seq.c:402-518 ``ViT_seq``): fp32 throughout, exact-erf GELU
(ViT_seq.c:283-285), LayerNorm via E[x²]−E[x]² with eps=1e-6
(ViT_seq.c:126-141), pre-LN encoder blocks (ViT_seq.c:330-370), CLS-row-only
classifier head (ViT_seq.c:509-513), numerically-stable softmax
(ViT_seq.c:372-397). Everything else in the port — the plain PyTorch
forward and the CUDA kernels — is validated against this module. A copy of the
JAX package's ``models/golden``.

The golden files shipped with the reference (``Data/answer_result*.txt``) were
produced by the C path this mirrors.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

try:  # scipy is optional: fall back to vectorized math.erf without it
    from scipy.special import erf as _erf_impl
except ImportError:  # pragma: no cover - exercised only without scipy
    import math

    _erf_impl = np.vectorize(math.erf, otypes=[np.float32])

from ..config import ViTConfig

__all__ = [
    "golden_forward",
    "patch_embed",
    "layer_norm",
    "multihead_attention",
    "linear",
    "gelu",
    "mlp_block",
    "encoder_block",
    "softmax",
]

f32 = np.float32


def _erf(x: np.ndarray) -> np.ndarray:
    return _erf_impl(x)


def gelu(x: np.ndarray) -> np.ndarray:
    """Exact erf-GELU (reference: ViT_seq.c:283-285)."""
    x = x.astype(f32)
    return (f32(0.5) * x * (f32(1.0) + _erf(x / np.sqrt(f32(2.0))).astype(f32))).astype(f32)


def patch_embed(image: np.ndarray, conv_w: np.ndarray, conv_b: np.ndarray,
                config: ViTConfig) -> np.ndarray:
    """Patch-embedding conv + flatten/transpose → [num_patches, embed_dim].

    The reference does a direct strided conv producing [embed_dim, g, g]
    (ViT_seq.c:25-57) then a flatten+transpose to [g*g, embed_dim]
    (ViT_seq.c:59-81). Mathematically that is patchify + matmul, which is how
    it's computed here.
    """
    c, H, W = image.shape
    p, g = config.patch_size, config.grid_size
    # (c, g, p, g, p) -> (g, g, c, p, p): patch vectors in (ic, kh, kw) order,
    # matching the conv kernel layout ((oc*C+ic)*P+kh)*P+kw (ViT_seq.c:46).
    patches = (
        image.reshape(c, g, p, g, p)
        .transpose(1, 3, 0, 2, 4)
        .reshape(g * g, c * p * p)
        .astype(f32)
    )
    w = conv_w.reshape(config.embed_dim, c * p * p).astype(f32)
    return patches @ w.T + conv_b.astype(f32)


def layer_norm(x: np.ndarray, weight: np.ndarray, bias: np.ndarray,
               eps: float) -> np.ndarray:
    """Per-token LN with var = E[x²]−E[x]² (reference: ViT_seq.c:120-142)."""
    x = x.astype(f32)
    mean = np.mean(x, axis=-1, keepdims=True, dtype=f32)
    mean_sq = np.mean(x * x, axis=-1, keepdims=True, dtype=f32)
    var = mean_sq - mean * mean
    inv_std = f32(1.0) / np.sqrt(var + f32(eps))
    return ((x - mean) * inv_std * weight.astype(f32) + bias.astype(f32)).astype(f32)


def linear(x: np.ndarray, weight: np.ndarray, bias: np.ndarray) -> np.ndarray:
    """x @ W.T + b with PyTorch-layout [out, in] weight
    (reference: ViT_seq.c:295-309)."""
    return (x.astype(f32) @ weight.astype(f32).T + bias.astype(f32)).astype(f32)


def softmax(x: np.ndarray) -> np.ndarray:
    """Numerically-stable softmax over the last axis
    (reference: ViT_seq.c:372-397)."""
    x = x.astype(f32)
    e = np.exp(x - np.max(x, axis=-1, keepdims=True))
    return (e / np.sum(e, axis=-1, keepdims=True, dtype=f32)).astype(f32)


def multihead_attention(
    x: np.ndarray,
    in_w: np.ndarray,
    in_b: np.ndarray,
    out_w: np.ndarray,
    out_b: np.ndarray,
    config: ViTConfig,
) -> np.ndarray:
    """Per-head scaled-dot attention (reference: ViT_seq.c:144-281).

    The in-proj weight is packed [3*D, D] with Q/K/V slabs at offsets
    0, D, 2D (ViT_seq.c:150).
    """
    d, nh, hd = config.embed_dim, config.num_heads, config.head_dim
    tokens = x.shape[0]
    qkv = linear(x, in_w, in_b)  # [T, 3D]
    q, k, v = qkv[:, :d], qkv[:, d : 2 * d], qkv[:, 2 * d :]

    # [T, D] -> [nh, T, hd]
    def split(t):
        return t.reshape(tokens, nh, hd).transpose(1, 0, 2)

    q, k, v = split(q), split(k), split(v)
    scores = (q @ k.transpose(0, 2, 1)).astype(f32) / np.sqrt(f32(hd))
    probs = softmax(scores)
    ctx = (probs @ v).astype(f32)  # [nh, T, hd]
    ctx = ctx.transpose(1, 0, 2).reshape(tokens, d)
    return linear(ctx, out_w, out_b)


def mlp_block(x, fc1_w, fc1_b, fc2_w, fc2_b):
    """fc1 → erf-GELU → fc2 (reference: ViT_seq.c:310-327)."""
    return linear(gelu(linear(x, fc1_w, fc1_b)), fc2_w, fc2_b)


def encoder_block(x: np.ndarray, p: Dict[str, np.ndarray], config: ViTConfig,
                  prefix: str) -> np.ndarray:
    """Pre-LN transformer block (reference: ViT_seq.c:330-370)."""
    g = lambda k: p[prefix + k]
    ln1 = layer_norm(x, g("ln_1_weight"), g("ln_1_bias"), config.eps)
    attn = multihead_attention(
        ln1,
        g("self_attention_in_proj_weight"),
        g("self_attention_in_proj_bias"),
        g("self_attention_out_proj_weight"),
        g("self_attention_out_proj_bias"),
        config,
    )
    res = (x + attn).astype(f32)
    ln2 = layer_norm(res, g("ln_2_weight"), g("ln_2_bias"), config.eps)
    mlp = mlp_block(ln2, g("mlp_0_weight"), g("mlp_0_bias"),
                    g("mlp_3_weight"), g("mlp_3_bias"))
    return (res + mlp).astype(f32)


def golden_forward(
    images: np.ndarray, params: Dict[str, np.ndarray], config: ViTConfig
) -> np.ndarray:
    """Full forward pass → class probabilities [n, num_classes].

    ``images`` is [n, c, h, w] float32 (the packed-binary layout);
    ``params`` is the {name: shaped array} dict from
    ``io.binfmt.weights_to_dict``. Mirrors ``ViT_seq`` (ViT_seq.c:402-518),
    extended for the preset variants (extra prefix tokens, pre-norm, dual
    head) which the reference does not have.
    """
    if images.ndim == 3:
        images = images[None]
    n = images.shape[0]
    probs = np.zeros((n, config.num_classes), dtype=f32)
    d = config.embed_dim

    for i in range(n):
        tok = patch_embed(images[i], params["conv_proj_weight"],
                          params["conv_proj_bias"], config)
        prefix_rows = [params["class_token"].reshape(1, d).astype(f32)]
        if config.num_prefix_tokens > 1:
            prefix_rows.append(params["dist_token"].reshape(1, d).astype(f32))
        x = np.concatenate(prefix_rows + [tok], axis=0)  # [T, D]
        x = (x + params["encoder_pos_embedding"].astype(f32)).astype(f32)
        if config.pre_norm:
            x = layer_norm(x, params["encoder_pre_ln_weight"],
                           params["encoder_pre_ln_bias"], config.eps)
        for layer in range(config.depth):
            x = encoder_block(
                x, params, config, f"encoder_layers_encoder_layer_{layer}_"
            )
        x = layer_norm(x, params["encoder_ln_weight"], params["encoder_ln_bias"],
                       config.eps)
        if config.head_type == "none":
            raise ValueError("head_type='none' towers produce features, not probs; "
                             "use golden_features()")
        logits = linear(x[0:1], params["heads_head_weight"],
                        params["heads_head_bias"])[0]
        if config.head_type == "cls+dist":
            dist_logits = linear(x[1:2], params["heads_head_dist_weight"],
                                 params["heads_head_dist_bias"])[0]
            logits = ((logits + dist_logits) * f32(0.5)).astype(f32)
        probs[i] = softmax(logits)
    return probs


def golden_features(
    images: np.ndarray, params: Dict[str, np.ndarray], config: ViTConfig
) -> np.ndarray:
    """Bare-tower forward → final-LN CLS features [n, embed_dim]
    (for head_type='none' towers like the CLIP vision trunk)."""
    if images.ndim == 3:
        images = images[None]
    n = images.shape[0]
    feats = np.zeros((n, config.embed_dim), dtype=f32)
    d = config.embed_dim
    for i in range(n):
        tok = patch_embed(images[i], params["conv_proj_weight"],
                          params["conv_proj_bias"], config)
        prefix_rows = [params["class_token"].reshape(1, d).astype(f32)]
        if config.num_prefix_tokens > 1:
            prefix_rows.append(params["dist_token"].reshape(1, d).astype(f32))
        x = np.concatenate(prefix_rows + [tok], axis=0)
        x = (x + params["encoder_pos_embedding"].astype(f32)).astype(f32)
        if config.pre_norm:
            x = layer_norm(x, params["encoder_pre_ln_weight"],
                           params["encoder_pre_ln_bias"], config.eps)
        for layer in range(config.depth):
            x = encoder_block(
                x, params, config, f"encoder_layers_encoder_layer_{layer}_"
            )
        x = layer_norm(x, params["encoder_ln_weight"], params["encoder_ln_bias"],
                       config.eps)
        feats[i] = x[0]
    return feats
