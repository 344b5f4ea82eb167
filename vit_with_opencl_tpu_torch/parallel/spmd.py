"""The training step: cross-entropy, gradients and the update, on one device.

Counterpart of the single-device part of
``vit_with_opencl_tpu/parallel/spmd.make_train_step``. The routes are the
JAX package's:

  * ``xla``   — the per-op forward in plain PyTorch ops, autograd backward;
  * ``flash`` — the same, with the attention core through
    ``ops/attention.packed_fused_attention_trainable`` (the packed kernel
    forward, ``packed_attention_bwd`` backward);
  * ``fused`` — ``flash``, and every encoder layer through
    ``ops/fused_block.fused_encoder_layer_trainable`` (the forward chain and
    the three-stage fused backward, its MLP stage split in the H-chunked
    pair at ViT-L/H widths) where ``fused_block.supports_trainable`` holds
    for the compute dtype (ViT-B, ViT-L/16@384 and ViT-H/14 do).

fp32 master weights stay fp32: the per-op route multiplies bf16 activations
by them in fp32, and the fused chain casts its four matmul weights to the
activation dtype, with gradients accumulated in fp32 back to the masters,
as in JAX.

Not ported here: the mesh (data, tensor and sequence parallelism; a
``mesh`` raises ``NotImplementedError``) and the autotune ``tuning``
knobs. ``scan_unroll`` is accepted and has no effect: the port's encoder is
a Python loop over the layers, with nothing to unroll.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import optim
from ..config import ViTConfig
from ..engine import resolve_device
from ..models import vit

__all__ = ["make_train_step", "train_kernels"]


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
