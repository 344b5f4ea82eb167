"""Checkpoint exporters: torchvision / HuggingFace state dicts → Weight_*.bin.

Counterpart of ``vit_with_opencl_tpu/io/export.py``. The reference consumes
per-tensor raw-fp32 files whose names are torchvision ``vit_b_16``
state-dict keys (e.g. ``Weight_77_encoder_layers_encoder_layer_6_ln_1_bias.bin``);
its authors ran the torchvision→bin export offline and never shipped the
script. This module is that tool:

  * ``from_torchvision_state_dict``: torchvision ``VisionTransformer`` keys
    (``class_token``, ``conv_proj.*``, ``encoder.layers.encoder_layer_N.*``,
    packed ``self_attention.in_proj_*``, ``mlp.0/.3``, ``heads.head``);
  * ``from_hf_state_dict``: HuggingFace ``ViTForImageClassification`` keys
    (separate q/k/v projections — packed here into the reference's
    ``in_proj`` layout, q|k|v along the out dim);
  * ``to_torchvision_state_dict``: the inverse of the first;
  * ``export_weights``: dict → ``Weight_<idx>_<name>.bin`` directory, which
    the port's CLI and engine load;
  * ``main``: ``python -m vit_with_opencl_tpu_torch.io.export --out DIR
    (--from-pth CKPT.pth | --from-pretrained HF_ID)``.

Network access is never required: both converters take an in-memory state
dict (torch tensors of any float dtype, numpy arrays, or anything
``np.asarray`` accepts), and ``export_from_pretrained`` reads only a local
HuggingFace cache.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from ..config import ViTConfig
from . import binfmt


def _np(x: Any) -> np.ndarray:
    """torch.Tensor (any float dtype, any device) | np.ndarray | array-like
    → float32 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


def from_torchvision_state_dict(
    state: Mapping[str, Any], config: ViTConfig
) -> Dict[str, np.ndarray]:
    """torchvision VisionTransformer state dict → {reference name: array}.

    Key map (torchvision → reference file-name token):
      class_token [1,1,D] → class_token [D]
      conv_proj.weight/bias → conv_proj_weight/bias
      encoder.pos_embedding [1,T,D] → encoder_pos_embedding [T,D]
      encoder.layers.encoder_layer_N.{ln_1,ln_2}.{weight,bias}
      ...self_attention.{in_proj_weight,in_proj_bias,out_proj.weight,out_proj.bias}
      ...mlp.{0,3}.{weight,bias}
      encoder.ln.{weight,bias} → encoder_ln_*
      heads.head.{weight,bias} → heads_head_*
    """
    d = config.embed_dim
    out: Dict[str, np.ndarray] = {
        "class_token": _np(state["class_token"]).reshape(d),
        "conv_proj_weight": _np(state["conv_proj.weight"]),
        "conv_proj_bias": _np(state["conv_proj.bias"]),
        "encoder_pos_embedding": _np(state["encoder.pos_embedding"]).reshape(
            config.num_tokens, d
        ),
        "encoder_ln_weight": _np(state["encoder.ln.weight"]),
        "encoder_ln_bias": _np(state["encoder.ln.bias"]),
    }
    if config.head_type != "none":
        out["heads_head_weight"] = _np(state["heads.head.weight"])
        out["heads_head_bias"] = _np(state["heads.head.bias"])
    for i in range(config.depth):
        src = f"encoder.layers.encoder_layer_{i}."
        dst = f"encoder_layers_encoder_layer_{i}_"
        out[dst + "ln_1_weight"] = _np(state[src + "ln_1.weight"])
        out[dst + "ln_1_bias"] = _np(state[src + "ln_1.bias"])
        out[dst + "self_attention_in_proj_weight"] = _np(
            state[src + "self_attention.in_proj_weight"]
        )
        out[dst + "self_attention_in_proj_bias"] = _np(
            state[src + "self_attention.in_proj_bias"]
        )
        out[dst + "self_attention_out_proj_weight"] = _np(
            state[src + "self_attention.out_proj.weight"]
        )
        out[dst + "self_attention_out_proj_bias"] = _np(
            state[src + "self_attention.out_proj.bias"]
        )
        out[dst + "ln_2_weight"] = _np(state[src + "ln_2.weight"])
        out[dst + "ln_2_bias"] = _np(state[src + "ln_2.bias"])
        out[dst + "mlp_0_weight"] = _np(state[src + "mlp.0.weight"])
        out[dst + "mlp_0_bias"] = _np(state[src + "mlp.0.bias"])
        out[dst + "mlp_3_weight"] = _np(state[src + "mlp.3.weight"])
        out[dst + "mlp_3_bias"] = _np(state[src + "mlp.3.bias"])
    _validate(out, config)
    return out


def from_hf_state_dict(
    state: Mapping[str, Any], config: ViTConfig
) -> Dict[str, np.ndarray]:
    """HuggingFace ViT(ForImageClassification) state dict → reference names.

    HF stores q/k/v as separate Linear layers; the reference (and torchvision)
    pack them as ``in_proj`` [3D, D] with q|k|v stacked along the out dim
    (reference slices at offsets 0, D, 2D — ViT_seq.c:150).
    """
    d = config.embed_dim

    def g(key):
        # classifier-bearing checkpoints prefix the tower with "vit."
        return _np(state[key] if key in state else state["vit." + key])

    out: Dict[str, np.ndarray] = {
        "class_token": g("embeddings.cls_token").reshape(d),
        "conv_proj_weight": g("embeddings.patch_embeddings.projection.weight"),
        "conv_proj_bias": g("embeddings.patch_embeddings.projection.bias"),
        "encoder_pos_embedding": g("embeddings.position_embeddings").reshape(
            config.num_tokens, d
        ),
        "encoder_ln_weight": g("layernorm.weight"),
        "encoder_ln_bias": g("layernorm.bias"),
    }
    if config.head_type != "none":
        out["heads_head_weight"] = _np(state["classifier.weight"])
        out["heads_head_bias"] = _np(state["classifier.bias"])
    for i in range(config.depth):
        src = f"encoder.layer.{i}."
        dst = f"encoder_layers_encoder_layer_{i}_"
        q_w = g(src + "attention.attention.query.weight")
        k_w = g(src + "attention.attention.key.weight")
        v_w = g(src + "attention.attention.value.weight")
        q_b = g(src + "attention.attention.query.bias")
        k_b = g(src + "attention.attention.key.bias")
        v_b = g(src + "attention.attention.value.bias")
        out[dst + "self_attention_in_proj_weight"] = np.concatenate(
            [q_w, k_w, v_w], axis=0
        )
        out[dst + "self_attention_in_proj_bias"] = np.concatenate([q_b, k_b, v_b])
        out[dst + "self_attention_out_proj_weight"] = g(
            src + "attention.output.dense.weight"
        )
        out[dst + "self_attention_out_proj_bias"] = g(
            src + "attention.output.dense.bias"
        )
        # HF: layernorm_before ↔ ln_1 (attention), layernorm_after ↔ ln_2 (MLP).
        out[dst + "ln_1_weight"] = g(src + "layernorm_before.weight")
        out[dst + "ln_1_bias"] = g(src + "layernorm_before.bias")
        out[dst + "ln_2_weight"] = g(src + "layernorm_after.weight")
        out[dst + "ln_2_bias"] = g(src + "layernorm_after.bias")
        out[dst + "mlp_0_weight"] = g(src + "intermediate.dense.weight")
        out[dst + "mlp_0_bias"] = g(src + "intermediate.dense.bias")
        out[dst + "mlp_3_weight"] = g(src + "output.dense.weight")
        out[dst + "mlp_3_bias"] = g(src + "output.dense.bias")
    _validate(out, config)
    return out


def to_torchvision_state_dict(
    params: Mapping[str, np.ndarray], config: ViTConfig
) -> Dict[str, np.ndarray]:
    """{reference name: array} → torchvision VisionTransformer state-dict
    naming (the inverse of :func:`from_torchvision_state_dict`).

    Used to round-trip trained/exported weights back into the torch
    ecosystem, and to build a synthetic ``.pth`` stand-in for a real
    checkpoint (``torch.save`` of its values as tensors)."""
    d = config.embed_dim
    out: Dict[str, np.ndarray] = {
        "class_token": np.asarray(params["class_token"]).reshape(1, 1, d),
        "conv_proj.weight": np.asarray(params["conv_proj_weight"]),
        "conv_proj.bias": np.asarray(params["conv_proj_bias"]),
        "encoder.pos_embedding": np.asarray(
            params["encoder_pos_embedding"]
        ).reshape(1, config.num_tokens, d),
        "encoder.ln.weight": np.asarray(params["encoder_ln_weight"]),
        "encoder.ln.bias": np.asarray(params["encoder_ln_bias"]),
    }
    if config.head_type != "none":
        out["heads.head.weight"] = np.asarray(params["heads_head_weight"])
        out["heads.head.bias"] = np.asarray(params["heads_head_bias"])
    pairs = (
        ("ln_1_weight", "ln_1.weight"), ("ln_1_bias", "ln_1.bias"),
        ("self_attention_in_proj_weight", "self_attention.in_proj_weight"),
        ("self_attention_in_proj_bias", "self_attention.in_proj_bias"),
        ("self_attention_out_proj_weight",
         "self_attention.out_proj.weight"),
        ("self_attention_out_proj_bias", "self_attention.out_proj.bias"),
        ("ln_2_weight", "ln_2.weight"), ("ln_2_bias", "ln_2.bias"),
        ("mlp_0_weight", "mlp.0.weight"), ("mlp_0_bias", "mlp.0.bias"),
        ("mlp_3_weight", "mlp.3.weight"), ("mlp_3_bias", "mlp.3.bias"),
    )
    for i in range(config.depth):
        src = f"encoder_layers_encoder_layer_{i}_"
        dst = f"encoder.layers.encoder_layer_{i}."
        for ref_sfx, tv_sfx in pairs:
            out[dst + tv_sfx] = np.asarray(params[src + ref_sfx])
    return out


def _validate(params: Dict[str, np.ndarray], config: ViTConfig) -> None:
    shapes = binfmt.weight_shapes(config)
    for name, expected in shapes.items():
        if name not in params:
            raise KeyError(f"exporter produced no tensor for {name!r}")
        got = params[name].shape
        if tuple(got) != tuple(expected):
            raise ValueError(f"{name}: shape {got} != expected {expected}")


def export_weights(
    params: Dict[str, np.ndarray],
    directory: str | os.PathLike,
    config: ViTConfig,
) -> List[str]:
    """Write {name: array} to ``Weight_<idx>_<name>.bin`` files; returns the
    file names written (the reference's on-disk checkpoint format)."""
    names = binfmt.weight_names(config)
    binfmt.save_weights(directory, [params[n] for n in names], config)
    return [f"Weight_{i}_{n}.bin" for i, n in enumerate(names)]


def export_from_pretrained(
    model_name: str,
    directory: str | os.PathLike,
    config: ViTConfig,
) -> List[str]:
    """Convenience: HF ``from_pretrained`` → export. Reads only the local
    HuggingFace cache (``local_files_only=True``: nothing is downloaded);
    raises ``RuntimeError`` when ``transformers`` or the checkpoint is
    absent."""
    try:
        from transformers import AutoModelForImageClassification
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("transformers not available") from e
    try:
        model = AutoModelForImageClassification.from_pretrained(
            model_name, local_files_only=True
        )
    except OSError as e:
        raise RuntimeError(
            f"checkpoint {model_name!r} not in the local HF cache, and this "
            "exporter reads no network: download it elsewhere and point "
            "HF_HOME at the cache"
        ) from e
    params = from_hf_state_dict(model.state_dict(), config)
    return export_weights(params, directory, config)


def main(argv=None) -> int:
    """CLI: convert a checkpoint to the reference Weight_*.bin directory.

    Sources: --from-pth (a torch.save'd state dict, torchvision or HF
    naming — auto-detected) or --from-pretrained (HF hub id, local cache
    only).
    """
    import argparse

    from ..config import PRESETS, get_config

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--config", default="vit_b_16_224",
                        choices=sorted(PRESETS))
    parser.add_argument("--out", required=True, help="output weight directory")
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--from-pth", help="path to a torch-saved state dict")
    src.add_argument("--from-pretrained", help="HF model id (local cache only)")
    args = parser.parse_args(argv)
    config = get_config(args.config)

    if args.from_pretrained:
        files = export_from_pretrained(args.from_pretrained, args.out, config)
    else:
        state = torch.load(args.from_pth, map_location="cpu",
                           weights_only=True)
        if isinstance(state, dict) and "state_dict" in state:
            state = state["state_dict"]
        keys = set(state)
        if any(k.startswith(("vit.", "embeddings.")) or "layernorm_before" in k
               for k in keys):
            params = from_hf_state_dict(state, config)
        else:
            params = from_torchvision_state_dict(state, config)
        files = export_weights(params, args.out, config)
    print(f"wrote {len(files)} weight files to {args.out}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
