"""Optimizers, clipping and schedules with optax's numerics, in torch.

The JAX package trains through ``optax.adamw``, ``optax.clip_by_global_norm``
and optax's schedules (``parallel/spmd.make_train_step``, ``train.Trainer``).
The port imports no optax, so this module is its own copy of those, in
optax's form: a transform is an ``(init, update)`` pair, ``update(grads,
state, params) -> (updates, state)``, ``chain`` composes them and
``apply_updates`` adds the updates to the parameters. Parameter trees are
the port's nested dicts of tensors; like JAX, every tree walk visits dict
keys in sorted order (the order of the global norm's sum).

The numerics follow optax step for step:

  * ``adamw``: ``mu = (1 - b1)·g + b1·mu``, ``nu = (1 - b2)·g² + b2·nu``,
    ``count += 1``, ``m̂ = mu / (1 - b1^count)``, ``v̂ = nu / (1 -
    b2^count)``, ``u = m̂ / (√v̂ + eps)``, then the decay ``u + wd·p`` on
    every leaf (biases and LN parameters included, as ``optax.adamw``
    without a mask), then ``u · (−lr)``. ``torch.optim.AdamW`` scales p
    before the step instead, which rounds differently. The bias-correction
    powers are taken in float64 and rounded once, which is what XLA's
    compiled integer power gives; an ulp there matters, since 1 − b2^t is
    small early on.
  * ``clip_by_global_norm``: ``where(‖g‖ < max, g, g / ‖g‖ · max)``.
  * ``linear_schedule`` and ``warmup_cosine_decay_schedule`` in float32 from
    the step count, as optax's ``polynomial_schedule`` (power 1),
    ``cosine_decay_schedule`` and ``join_schedules``.

Memory: ``adamw``'s update changes ``mu`` and ``nu`` in place (the state it
is given is the state it returns), and ``apply_updates`` adds to the
parameters in place; a caller that keeps an old state or old parameters
clones them first. Counts and learning rates stay on the parameters' device,
so a step never waits for the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch

Tree = dict
Schedule = Callable[[torch.Tensor], torch.Tensor]


class Transform(NamedTuple):
    """optax's ``GradientTransformation``: ``init(params) -> state`` and
    ``update(grads, state, params) -> (updates, state)``."""
    init: Callable
    update: Callable


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, keys in sorted order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts in JAX's order (keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _is_float(t: torch.Tensor) -> bool:
    return torch.is_floating_point(t)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int,
                    transition_begin: int = 0) -> Union[Schedule, float]:
    """optax's ``linear_schedule``: from ``init_value`` to ``end_value``
    over ``transition_steps`` steps, then constant. A non-positive
    ``transition_steps`` gives the constant ``init_value``."""
    if transition_steps <= 0:
        return lambda count: torch.full((), init_value, dtype=torch.float32,
                                        device=count.device)
    transition_begin = max(transition_begin, 0)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = torch.clamp(count - transition_begin, 0, transition_steps)
        frac = 1 - c.to(torch.float32) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """optax's ``cosine_decay_schedule`` (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, "
                         f"got {decay_steps}")

    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = torch.minimum(count.to(torch.float32),
                          torch.tensor(float(decay_steps), device=count.device))
        cosine = 0.5 * (1 + torch.cos(torch.pi * c / float(decay_steps)))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """optax's ``warmup_cosine_decay_schedule``: linear warm-up to
    ``peak_value`` over ``warmup_steps``, then cosine decay to
    ``end_value`` at ``decay_steps`` (which counts the warm-up)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        return torch.where(count < warmup_steps, warm(count),
                           decay(count - warmup_steps))

    return schedule


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------


def global_norm(tree) -> torch.Tensor:
    """√(Σ over leaves of Σ g²), the leaves in JAX's order."""
    total = None
    for g in tree_leaves(tree):
        s = torch.sum(g * g)
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(max_norm: float) -> Transform:
    """Scale every leaf by ``max_norm / ‖g‖`` when the global norm reaches
    ``max_norm``: ``where(‖g‖ < max, g, g / ‖g‖ · max)``. Stateless."""

    def update(grads, state, params=None):
        norm = global_norm(grads)
        keep = norm < max_norm
        return tree_map(
            lambda g: torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm),
            grads), state

    return Transform(lambda params: {}, update)


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """1 − decay^count in float32, the power of float32(decay) taken in
    float64 and rounded once (as XLA's compiled integer power gives it)."""
    base = torch.tensor(decay, dtype=torch.float32, device=count.device)
    return 1 - torch.pow(base.double(), count.double()).to(torch.float32)


def adamw(learning_rate: Union[float, Schedule], b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> Transform:
    """optax's ``adamw`` (no mask: every leaf decays). ``learning_rate`` is
    a float or a schedule of the step count. The state is ``{"count": int32
    scalar, "mu": tree, "nu": tree}``; ``update`` changes mu and nu in place.
    """

    def init(params):
        dev = tree_leaves(params)[0].device
        return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params):
        if params is None:
            raise ValueError("adamw needs the params for its weight decay")
        count = state["count"]
        count_inc = count + 1
        bc1 = _bias_correction(b1, count_inc)
        bc2 = _bias_correction(b2, count_inc)
        if callable(learning_rate):
            step = -1 * learning_rate(count)
        else:
            step = -learning_rate

        def one(g, mu, nu, p):
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * (g * g))
            u = (mu / bc1.to(mu.dtype)) / (torch.sqrt(nu / bc2.to(nu.dtype)) + eps)
            u = u + weight_decay * p
            if isinstance(step, torch.Tensor):
                return step.to(u.dtype) * u
            return step * u

        updates = tree_map(one, grads, state["mu"], state["nu"], params)
        return updates, {"count": count_inc, "mu": state["mu"],
                         "nu": state["nu"]}

    return Transform(init, update)


def chain(*transforms: Transform) -> Transform:
    """optax's ``chain``: the transforms in order; the state is a tuple of
    theirs."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return Transform(init, update)


def apply_updates(params, updates):
    """``p + u`` cast to p's dtype, in place; non-float leaves untouched.
    Returns ``params``."""

    def one(p, u):
        if not _is_float(p):
            return p
        if p.dtype == u.dtype:
            p.add_(u)
        else:
            p.copy_((p + u).to(p.dtype))
        return p

    tree_map(one, params, updates)
    return params
