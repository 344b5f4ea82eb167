"""Model configuration: ``ViTConfig`` and the named presets.

A copy of the JAX package's ``config`` module, so that the port imports
nothing of that package. The reference hard-codes every hyperparameter as
duplicated ``#define``s in both backends (reference: ViT_seq.c:10-21,
ViT_opencl.c:13-24) and selects fixtures and backends by comment toggles
(Main.c:20-21,53-54). Here those become a real, validated config object plus
named presets for the BASELINE.json config matrix.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Architecture hyperparameters for a ViT classifier tower.

    Defaults are exactly the reference model: torchvision ``vit_b_16``
    (reference: ViT_seq.c:10-21).
    """

    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    num_classes: int = 1000
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    eps: float = 1e-6
    # Number of learned tokens prepended to the patch tokens. 1 = CLS only
    # (the reference); 2 = CLS + distillation token (DeiT).
    num_prefix_tokens: int = 1
    # Classifier head input: "cls" (reference: CLS row only, ViT_seq.c:509-513),
    # "cls+dist" (DeiT dual head, averaged at inference), or "none" (bare tower,
    # e.g. the CLIP vision trunk before projection).
    head_type: str = "cls"
    # CLIP-style variants apply a LayerNorm *before* the encoder stack.
    pre_norm: bool = False
    # GELU flavor: "erf" is the reference's exact-erf GELU (ViT_seq.c:283-285);
    # "tanh" is the cheaper approximation (not used by any reference path).
    gelu_approx: str = "erf"
    name: str = "vit"

    def __post_init__(self):
        if self.img_size % self.patch_size != 0:
            raise ValueError(
                f"img_size {self.img_size} not divisible by patch_size {self.patch_size}"
            )
        if self.embed_dim % self.num_heads != 0:
            raise ValueError(
                f"embed_dim {self.embed_dim} not divisible by num_heads {self.num_heads}"
            )
        if self.head_type not in ("cls", "cls+dist", "none"):
            raise ValueError(f"unknown head_type {self.head_type!r}")
        if self.gelu_approx not in ("erf", "tanh"):
            raise ValueError(f"unknown gelu_approx {self.gelu_approx!r}")
        if self.head_type == "cls+dist" and self.num_prefix_tokens < 2:
            raise ValueError("cls+dist head needs num_prefix_tokens >= 2")

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def num_tokens(self) -> int:
        """Sequence length: prefix tokens + patch tokens (197 for the reference)."""
        return self.num_patches + self.num_prefix_tokens

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def hidden_dim(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)

    @property
    def flops_per_image(self) -> int:
        """Forward-pass MAC*2 count (for roofline accounting).

        Convention: counts every matmul's MACs*2 — patch embed, QKV,
        attention scores AND probs@V (the 2*t*t*d term), out-proj, MLP,
        head — and excludes non-matmul work (LN, softmax, GELU, residuals).
        This is the standard MFU numerator; quoting roofline img/s from it
        therefore *includes* attention FLOPs in the denominator (a few %
        at 197 tokens)."""
        t, d, h = self.num_tokens, self.embed_dim, self.hidden_dim
        patch = self.num_patches * d * (self.in_chans * self.patch_size**2)
        per_layer = (
            t * d * 3 * d  # qkv
            + 2 * t * t * d  # scores + scores@v (all heads combined)
            + t * d * d  # out proj
            + 2 * t * d * h  # mlp
        )
        head = 0
        if self.head_type != "none":
            head = d * self.num_classes
        return 2 * (patch + per_layer * self.depth + head)


# ---------------------------------------------------------------------------
# Presets — the BASELINE.json config matrix.
# ---------------------------------------------------------------------------

VIT_B_16_224 = ViTConfig(name="vit_b_16_224")

VIT_TINY_16_224 = ViTConfig(
    name="vit_tiny_16_224", embed_dim=192, depth=12, num_heads=3
)

# ViT-Small (timm vit_small_patch16_224 geometry).
VIT_S_16_224 = ViTConfig(
    name="vit_s_16_224", embed_dim=384, depth=12, num_heads=6
)

VIT_L_16_384 = ViTConfig(
    name="vit_l_16_384",
    img_size=384,
    embed_dim=1024,
    depth=24,
    num_heads=16,
)

# ViT-H/14 (timm vit_huge_patch14_224 geometry): 632M params, 257 tokens.
VIT_H_14_224 = ViTConfig(
    name="vit_h_14_224",
    patch_size=14,
    embed_dim=1280,
    depth=32,
    num_heads=16,
)

# ViT-G/14 (Zhai et al. 2022, "Scaling Vision Transformers" — giant class):
# 1.84B params: 76.7 MB of bf16 weights per layer.
VIT_G_14_224 = ViTConfig(
    name="vit_g_14_224",
    patch_size=14,
    embed_dim=1664,
    depth=48,
    num_heads=16,
    mlp_ratio=8192 / 1664,  # the paper's MLP width is 8192, not 4*D
)

# CLIP ViT-B/16 vision tower: pre-LN before the stack, no classifier head
# (the projection to the joint embedding space is applied outside the tower).
CLIP_VIT_B_16 = ViTConfig(
    name="clip_vit_b_16",
    head_type="none",
    pre_norm=True,
)

# DeiT-B/16 with distillation token: dual-head (CLS head + distill head),
# averaged at inference time.
DEIT_B_16_224 = ViTConfig(
    name="deit_b_16_224",
    num_prefix_tokens=2,
    head_type="cls+dist",
)

PRESETS = {
    c.name: c
    for c in (VIT_B_16_224, VIT_TINY_16_224, VIT_S_16_224, VIT_L_16_384,
              VIT_H_14_224, VIT_G_14_224, CLIP_VIT_B_16, DEIT_B_16_224)
}


def get_config(name: str) -> ViTConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}") from None
