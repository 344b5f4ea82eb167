"""Training loop: input pipeline, training step, checkpoints and resume.

Counterpart of ``vit_with_opencl_tpu/train.py`` (``Trainer``) on one
device: :class:`data.DevicePrefetcher` feeds
:func:`parallel.spmd.make_train_step` (routes ``xla``, ``flash`` and
``fused``; SGD or AdamW, gradient accumulation, clipping, label smoothing),
with an fp32 EMA shadow, periodic checkpoints (:mod:`io.checkpoint`) with
resume, throughput and loss logging that reads the loss from the card only
at log points, and export to the reference weight format.

Not ported yet, and refused with ``NotImplementedError``: a ``mesh``
(multi-card training), ``mixup`` and ``device_augment`` (the on-card
augment pipeline), the program-split ``attention_impl="split:..."`` route,
and the autotune cache (``tuning``, ``tuning_path`` and the ``batch_size``
lookup). ``scan_unroll`` is accepted and has no effect (see
``parallel/spmd``).
"""

from __future__ import annotations

import os
import re
import time
from typing import Iterable, Optional

import numpy as np
import torch

from . import optim
from .config import ViTConfig
from .data import DevicePrefetcher
from .engine import resolve_device
from .io import checkpoint as ckpt_io
from .models import vit
from .parallel import spmd

__all__ = ["Trainer"]

_STEP_RE = re.compile(r"^step_(\d{8})$")


def _f32_shadow(params):
    """fp32 copy of every floating leaf (an EMA shadow in bf16 with decay
    near 1 has per-step increments below a bf16 ulp and freezes)."""
    return optim.tree_map(
        lambda p: p.detach().float().clone() if torch.is_floating_point(p)
        else p.clone(), params)


class Trainer:
    """Owns the params and optimizer state and runs the step loop on one
    device (default the card, which must be there; ``device="cpu"`` runs
    the plain versions of every kernel).

    >>> tr = Trainer(cfg, lr=1e-3, optimizer="adamw", attention_impl="fused")
    >>> params = tr.fit(batches, steps=1000)

    ``batches`` is any iterable of host ``(images, labels)`` pairs (see
    :func:`data.memory_dataset`).
    """

    def __init__(
        self,
        config: ViTConfig,
        *,
        device=None,
        mesh=None,
        lr: float = 1e-3,
        schedule: Optional[str] = None,
        warmup_steps: int = 0,
        total_steps: Optional[int] = None,
        optimizer: str = "sgd",
        weight_decay: float = 0.05,
        compute_dtype: torch.dtype = torch.bfloat16,
        attention_impl: str = "xla",
        grad_accum: int = 1,
        scan_unroll: int = 1,
        tuning: Optional[dict] = None,
        batch_size: Optional[int] = None,
        tuning_path: Optional[str] = None,
        grad_clip_norm: Optional[float] = None,
        label_smoothing: float = 0.0,
        mixup: Optional[dict] = None,
        device_augment: Optional[dict] = None,
        ema_decay: Optional[float] = None,
        seed: int = 0,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
        log_every: int = 50,
        log_fn=print,
    ):
        refused = {"mesh (multi-card training)": mesh is not None,
                   "mixup (on-card Mixup/CutMix)": mixup is not None,
                   "device_augment (the on-card augment pipeline)":
                       device_augment is not None,
                   "attention_impl='split:...' (program-split steps)":
                       attention_impl.startswith("split:"),
                   "tuning, tuning_path and batch_size (the autotune cache)":
                       bool(tuning) or tuning_path is not None
                       or batch_size is not None}
        for what, given in refused.items():
            if given:
                raise NotImplementedError(f"{what} is not ported yet")
        self.config = config
        self.device = resolve_device(device)
        self.optimizer = optimizer
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.log_every = log_every
        self.log_fn = log_fn
        self.step_idx = 0
        # The most recent step's loss; None until a step has run.
        self.last_loss: Optional[float] = None

        if schedule is not None:
            if optimizer != "adamw":
                raise ValueError(
                    "lr schedules ride the optimizer's step count; use "
                    "optimizer='adamw' (sgd here is the stateless step)")
            if schedule == "cosine":
                if not total_steps:
                    raise ValueError("schedule='cosine' needs total_steps")
                lr = optim.warmup_cosine_decay_schedule(0.0, lr, warmup_steps,
                                                        total_steps)
            elif schedule == "constant":
                lr = (optim.linear_schedule(0.0, lr, warmup_steps)
                      if warmup_steps else lr)
            else:
                raise ValueError(f"unknown schedule {schedule!r}")

        made = spmd.make_train_step(
            config, device=self.device, lr=lr, compute_dtype=compute_dtype,
            optimizer=optimizer, weight_decay=weight_decay,
            attention_impl=attention_impl, grad_accum=grad_accum,
            scan_unroll=scan_unroll, grad_clip_norm=grad_clip_norm,
            label_smoothing=label_smoothing)
        if optimizer == "sgd":
            self._init_opt, self._step = None, made
        else:
            self._init_opt, self._step = made

        self.params = vit.init_params(config, seed=seed, device=self.device)
        self.opt_state = self._init_opt(self.params) if self._init_opt else None

        # EMA shadow weights (the eval and export weights of the usual ViT
        # recipe); None unless ema_decay is set.
        self.ema_decay = ema_decay
        self.ema_params = None
        if ema_decay is not None:
            if not 0.0 < ema_decay < 1.0:
                raise ValueError(f"ema_decay must be in (0, 1), got "
                                 f"{ema_decay}")
            self.ema_params = _f32_shadow(self.params)

    def _ema_update(self) -> None:
        """ema = d·ema + (1 − d)·p in fp32, in place (d and 1 − d rounded
        as the JAX package's float32 arithmetic rounds them)."""
        d = float(np.float32(self.ema_decay))
        keep = float(np.float32(1.0) - np.float32(self.ema_decay))

        def one(e, p):
            if torch.is_floating_point(e):
                e.copy_(d * e + keep * p.float())
            return e

        optim.tree_map(one, self.ema_params, self.params)

    # -- checkpointing ----------------------------------------------------

    def _ckpt_path(self, step: int) -> str:
        return os.path.join(self.checkpoint_dir, f"step_{step:08d}")

    def save(self) -> str:
        """Write params (+ optimizer state, + EMA) under
        ``checkpoint_dir/step_NNNNNNNN``."""
        if not self.checkpoint_dir:
            raise ValueError("Trainer built without checkpoint_dir")
        tree = {"params": self.params, "step": np.int64(self.step_idx)}
        if self.opt_state is not None:
            tree["opt_state"] = self.opt_state
        if self.ema_params is not None:
            tree["ema_params"] = self.ema_params
        path = self._ckpt_path(self.step_idx)
        ckpt_io.save_checkpoint(path, tree)
        return path

    def latest_checkpoint(self) -> Optional[str]:
        if not self.checkpoint_dir or not os.path.isdir(self.checkpoint_dir):
            return None
        steps = [int(m.group(1)) for e in os.listdir(self.checkpoint_dir)
                 if (m := _STEP_RE.match(e))]
        return self._ckpt_path(max(steps)) if steps else None

    def resume(self) -> bool:
        """Load the newest checkpoint if there is one; True if so.

        As the JAX package's: the checkpoint's own structure decides what
        is restored, so a run survives setting changes across restarts. EMA
        on with a checkpoint that has none seeds the shadow from the
        restored params; EMA off ignores a stored shadow. An optimizer
        state that does not fit this Trainer's (another optimizer, or
        ``grad_clip_norm`` toggled, which wraps AdamW in a chain) restarts
        from scratch with a logged warning; an SGD Trainer ignores a stored
        optimizer state."""
        path = self.latest_checkpoint()
        if path is None:
            return False
        saved = ckpt_io.load_checkpoint(path)  # its own structure decides
        self.params = ckpt_io.restore_like(saved["params"], self.params)
        if self.opt_state is not None:
            restored = None
            if "opt_state" in saved:
                try:
                    restored = ckpt_io.restore_like(saved["opt_state"],
                                                    self.opt_state)
                except ValueError:
                    self.log_fn(
                        f"resume: opt_state in {path} does not match this "
                        "Trainer's optimizer settings (e.g. grad_clip_norm "
                        "changed); restarting optimizer state from scratch")
            self.opt_state = (restored if restored is not None
                              else self._init_opt(self.params))
        if self.ema_params is not None:
            # Seed from the checkpoint's shadow if it has one, else restart
            # the average from the restored params.
            self.ema_params = _f32_shadow(
                ckpt_io.restore_like(saved["ema_params"], self.ema_params)
                if "ema_params" in saved else self.params)
        self.step_idx = int(saved["step"])
        return True

    def export_reference(self, directory: str, *, use_ema: bool = False):
        """Write the trained weights as a reference-format directory
        (``Weight_<idx>_<name>.bin``) that the port's CLI and engine load;
        ``use_ema`` exports the EMA shadow instead."""
        from .io.export import export_weights

        src = self.ema_params if use_ema else self.params
        if use_ema and src is None:
            raise ValueError("use_ema=True but Trainer has no ema_decay")
        return export_weights(vit.unstack_params(src, self.config), directory,
                              self.config)

    # -- the loop ---------------------------------------------------------

    def fit(self, batches: Iterable, *, steps: Optional[int] = None,
            prefetch: int = 2):
        """Run updates until ``step_idx`` reaches ``steps`` (or ``batches``
        runs out). Returns the params."""
        loader = DevicePrefetcher(batches, buffer_size=prefetch,
                                  device=self.device)
        loss = None
        imgs_done = 0
        t0 = time.perf_counter()
        try:
            for images, labels in loader:
                if steps is not None and self.step_idx >= steps:
                    break
                if self.opt_state is None:
                    self.params, loss = self._step(self.params, images, labels)
                else:
                    self.params, self.opt_state, loss = self._step(
                        self.params, self.opt_state, images, labels)
                self.step_idx += 1
                if self.ema_params is not None:
                    self._ema_update()
                imgs_done += images.shape[0]
                if self.log_every and self.step_idx % self.log_every == 0:
                    value = float(loss)  # reads the card: a sync point
                    dt = time.perf_counter() - t0
                    self.log_fn(f"step {self.step_idx}: loss {value:.4f}, "
                                f"{imgs_done / dt:.0f} img/s")
                    imgs_done, t0 = 0, time.perf_counter()
                if (self.checkpoint_every and self.checkpoint_dir
                        and self.step_idx % self.checkpoint_every == 0):
                    self.save()
        finally:
            loader.close()
        if loss is not None:
            self.last_loss = float(loss)
        return self.params
