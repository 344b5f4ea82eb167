#!/usr/bin/env python3
"""How close chip_smoke.py's phase-5c step check sits to its noise floor.

    python3 step_noise.py

Run from the repository root on a machine with a card. Phase 5c holds one
AdamW step of ViT-L/16@512 (``Trainer``, bf16, B = 4, phase 3e's random
params) on the kernels to the same step on the plain links: the losses
within STEP_LOSS_REL of each other. This script prints that difference for
the ``flash`` and ``fused`` routes beside the difference that an
exact-equivalent change to the plain links alone gives: the plain blockwise
attention with each key tile's sums (Σp and bf16(p)·V) taken in reverse
order. It then holds the blockwise forward and its plain version to an fp64
softmax at T = 1025, B = 4 (16 heads of 64): mean abs error, mean error
along the sign of the exact value (a negative mean leans toward zero), and
the log-sum-exp's mean signed error. The last line is one JSON object with
every figure.
"""

from __future__ import annotations

import json
import sys

import torch

import chip_smoke as cs
from vit_with_opencl_tpu_torch import optim
from vit_with_opencl_tpu_torch.harness import fixtures
from vit_with_opencl_tpu_torch.models import vit
from vit_with_opencl_tpu_torch.ops import attention
from vit_with_opencl_tpu_torch.train import Trainer

ATTENTION_LINKS = ("packed_fused_attention", "packed_attention_bwd",
                   "blockwise_attention_fwd", "blockwise_attention_bwd")
CHAIN_LINKS = ("fused_encoder_layer", "fused_encoder_layer_bwd")


def reversed_sums_reference(q, k, v, scale, block_k, return_lse=False, kv_len=None):
    """``attention._blockwise_heads_reference`` with each key tile's Σp and
    bf16(p)·V summed over the keys in reverse order: the same function."""
    b, nh, t, hd = q.shape
    kv_len = t if kv_len is None else kv_len
    t_pad = -(-t // block_k) * block_k
    pad = (0, 0, 0, t_pad - t)
    k = torch.nn.functional.pad(k, pad)
    v = torch.nn.functional.pad(v, pad)
    qf = q.float()
    m = torch.full((b, nh, t, 1), -float("inf"), device=q.device)
    l = torch.zeros((b, nh, t, 1), device=q.device)
    acc = torch.zeros((b, nh, t, hd), device=q.device)
    for k0 in range(0, t_pad, block_k):
        kt = k[..., k0:k0 + block_k, :].float()
        s = (qf @ kt.transpose(-1, -2)) * scale
        col = torch.arange(k0, k0 + block_k, device=q.device)
        s = torch.where(col < kv_len, s, attention.MASK_VALUE)
        m_next = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next)
        l = alpha * l + p.flip(-1).sum(-1, keepdim=True)
        vt = v[..., k0:k0 + block_k, :]
        pv = p.to(vt.dtype).float().flip(-1) @ vt.float().flip(-2)
        acc = acc * alpha + pv
        m = m_next
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = acc * torch.where(l == 0.0, 1.0, 1.0 / l)
    lse = (m + torch.log(l_safe))[..., 0] if return_lse else None
    return out, lse


def step_losses(dev) -> dict:
    """Phase 5c's step loss per route: kernels, plain links, and plain links
    with the reversed sums; relative differences to the plain links."""
    cfg = cs.LONG_CFG
    start = vit.stack_params(fixtures.random_params(cfg, seed=0), cfg,
                             param_dtype=torch.float32, device=dev)
    images, labels = cs.train_batch(cs.LONG_TRAIN_BATCH, seed=3, cfg=cfg)
    images, labels = images[:cs.LONG_STEP_BATCH], labels[:cs.LONG_STEP_BATCH]
    plain_fn = attention._blockwise_heads_reference
    out = {}
    for route in ("flash", "fused"):
        tr = Trainer(cfg, device=dev, lr=cs.TRAIN_LR, optimizer="adamw",
                     compute_dtype=torch.bfloat16, attention_impl=route, seed=0)

        def step():
            tr.params = optim.tree_map(torch.clone, start)
            tr.opt_state = tr._init_opt(tr.params)
            tr.step_idx = 0
            tr.fit(iter([(images, labels)]), steps=1)
            torch.cuda.synchronize()
            return tr.last_loss

        losses = {"kernels": step()}
        for name, fn in (("plain", plain_fn), ("plain, sums reversed", reversed_sums_reference)):
            attention._blockwise_heads_reference = fn
            try:
                with cs.plain_chain(*ATTENTION_LINKS, module=attention), \
                        cs.plain_chain(*CHAIN_LINKS):
                    losses[name] = step()
            finally:
                attention._blockwise_heads_reference = plain_fn
        rel = {name: abs(v - losses["plain"]) / abs(losses["plain"])
               for name, v in losses.items() if name != "plain"}
        print(f"{cfg.name} {route} step loss: " + ", ".join(
            f"{name} {v:.6f}" for name, v in losses.items()) + "; from the plain links: "
            + ", ".join(f"{name} {v:.2e}" for name, v in rel.items())
            + f" (chip_smoke's bound {cs.STEP_LOSS_REL})", flush=True)
        out[route] = {"loss": losses, "rel": rel}
        del tr
        torch.cuda.empty_cache()
    return out


def errors_against_fp64(dev) -> dict:
    """The blockwise forward and its plain version against an fp64 softmax."""
    b, t, nh, hd = 4, 1025, 16, 64
    gen = torch.Generator(device=dev).manual_seed(t + b)
    qkv = torch.randn((b, t, 3 * nh * hd), generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = qkv.double().reshape(b, t, 3, nh, hd).permute(2, 0, 3, 1, 4)
    s = (q @ k.transpose(-1, -2)) / hd ** 0.5
    exact = (torch.softmax(s, -1) @ v).permute(0, 2, 1, 3).reshape(b, t, nh * hd)
    exact_lse = torch.logsumexp(s, -1)
    out = {}
    for name, fn in (("kernel", attention.blockwise_attention_fwd),
                     ("plain", attention.blockwise_attention_fwd_reference)):
        o, lse = fn(qkv, nh, hd, return_lse=True)
        err = o.double() - exact
        out[name] = {"mean_abs_err": float(err.abs().mean()),
                     "mean_signed_err": float((err * exact.sign()).mean()),
                     "lse_mean_signed_err": float((lse.double() - exact_lse).mean()),
                     "lse_mean_abs_err": float((lse.double() - exact_lse).abs().mean())}
        print(f"blockwise forward B={b} T={t} hd={hd}, {name} against fp64: "
              + ", ".join(f"{key} {val:.3e}" for key, val in out[name].items()), flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: step_noise needs a card")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    record = {"steps": step_losses(dev)}
    with torch.inference_mode():
        record["fp64"] = errors_against_fp64(dev)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
