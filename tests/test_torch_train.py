"""The port's training path against the JAX package on the CPU: init, the
data pipeline, the optimizers and schedules against optax, one
``make_train_step`` step per route and optimizer against JAX's
``spmd.make_train_step`` on a one-device mesh, and the ``Trainer``
behaviours of ``tests/test_train.py`` (descent, checkpoints, resume across
setting changes, EMA, label smoothing, clipping, export).

Inputs and weights are made with numpy from seeds and given to both sides.
Config: D = 64, 4 heads, H = 256, depth 2, 32-pixel images at patch 8
(T = 17), 17 classes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    # The xdist workers share the host's cores: one torch thread each.
    torch.set_num_threads(1)

from vit_with_opencl_tpu import config as jconfig
from vit_with_opencl_tpu import data as jdata
from vit_with_opencl_tpu.harness import fixtures as jfixtures
from vit_with_opencl_tpu.models import vit as jvit
from vit_with_opencl_tpu.parallel import spmd as jspmd
from vit_with_opencl_tpu_torch import ViTConfig, data, optim
from vit_with_opencl_tpu_torch.harness import fixtures
from vit_with_opencl_tpu_torch.io import binfmt
from vit_with_opencl_tpu_torch.models import golden, vit
from vit_with_opencl_tpu_torch.parallel import spmd
from vit_with_opencl_tpu_torch.train import Trainer

CFG = ViTConfig(name="train_small", img_size=32, patch_size=8, embed_dim=64,
                depth=2, num_heads=4, num_classes=17)
JCFG = jconfig.ViTConfig(name="train_small", img_size=32, patch_size=8,
                         embed_dim=64, depth=2, num_heads=4, num_classes=17)
CPU = "cpu"


def _dataset(n=16, seed=5):
    images = fixtures.random_images(CFG, n=n, seed=seed)
    labels = (np.arange(n) * 7) % CFG.num_classes
    return images, labels


def _leaves(tree):
    return [np.asarray(a, np.float32) if not isinstance(a, torch.Tensor)
            else a.detach().float().numpy() for a in optim.tree_leaves(
                {k: (dict(v) if isinstance(v, dict) else v) for k, v in tree.items()})]


def _jleaves(tree):
    return [np.asarray(jnp.asarray(a, jnp.float32)) for a in jax.tree.leaves(tree)]


def _random_params(seed=0):
    """Random (not zero-headed) fp32 params for both sides."""
    jp = jvit.random_stacked_params(JCFG, jax.random.key(seed), jnp.float32)
    host = jax.tree.map(np.asarray, jp)
    return host, vit.params_from_jax(host, device=CPU)


# -- init and data ----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_init_params_bit_identical_to_jax(dtype):
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    want = jvit.init_params(JCFG, seed=3, param_dtype=jdt)
    got = vit.init_params(CFG, seed=3, param_dtype=tdt, device=CPU)
    assert jax.tree.structure(want) == jax.tree.structure(
        jax.tree.map(lambda t: 0, got))
    for a, b in zip(_leaves(got), _jleaves(want)):
        np.testing.assert_array_equal(a, b)
    assert got["layers"]["qkv_w"].dtype == tdt
    assert got["pos_emb"].dtype == torch.float32


def test_memory_dataset_order_matches_jax():
    images, labels = _dataset(16)
    ours = data.memory_dataset(images, labels, 5, epochs=3, seed=4,
                               drop_last=False)
    theirs = jdata.memory_dataset(images, labels, 5, epochs=3, seed=4,
                                  drop_last=False)
    pairs = list(zip(ours, theirs))
    assert len(pairs) == 12
    for (a, la), (b, lb) in pairs:
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    with pytest.raises(ValueError, match="batch_size"):
        next(data.memory_dataset(images, labels, 17))


def test_prefetcher_yields_tensors_and_propagates_errors():
    images, labels = _dataset(8)
    batches = list(data.DevicePrefetcher(
        data.memory_dataset(images, labels, 4, shuffle=False), device=CPU))
    assert len(batches) == 2 and batches[0][0].shape == (4, 3, 32, 32)
    np.testing.assert_array_equal(batches[1][1].numpy(), labels[4:])

    def bad():
        yield images[:2], labels[:2]
        raise RuntimeError("source broke")

    it = data.DevicePrefetcher(bad(), device=CPU)
    next(it)
    with pytest.raises(RuntimeError, match="source broke"):
        next(it)


def test_device_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spmd.make_train_step(CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data.DevicePrefetcher(iter([]))


@pytest.mark.parametrize("kw", [dict(mesh=object()), dict(mixup={}),
                                dict(device_augment={}),
                                dict(attention_impl="split:fused"),
                                dict(tuning={"attention_ipc": 2}),
                                dict(batch_size=64)])
def test_trainer_refuses_what_is_not_ported(kw):
    with pytest.raises(NotImplementedError, match="not ported"):
        Trainer(CFG, device=CPU, **kw)


# -- optimizers and schedules against optax ---------------------------------


def _grad_trees(params, steps, seed=0):
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda p: rng.normal(0, 1, np.shape(p)).astype(np.float32)
                         * rng.choice([1e-3, 1.0, 30.0]), params)
            for _ in range(steps)]


@pytest.mark.parametrize("clip", [None, 0.5])
@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_matches_optax(clip, schedule):
    host, ours = _random_params(1)
    lr = (optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 6) if schedule
          else 1e-2)
    our_lr = (optim.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 6) if schedule
              else 1e-2)
    tx = optax.adamw(lr, weight_decay=0.05)
    ttx = optim.adamw(our_lr, weight_decay=0.05)
    if clip:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
        ttx = optim.chain(optim.clip_by_global_norm(clip), ttx)
    jp, js = host, tx.init(host)
    ts = ttx.init(ours)
    update = jax.jit(tx.update)
    for g in _grad_trees(host, 6):
        upd, js = update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        tg = vit.params_from_jax(g, device=CPU)
        tupd, ts = ttx.update(tg, ts, ours)
        optim.apply_updates(ours, tupd)
    # Six steps through the moments: each step agrees to a few fp32 ulps
    # (the bias-correction power in float64 against XLA's integer pow).
    for a, b in zip(_leaves(ours), _jleaves(jp)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    _, tstate = vit.params_from_jax(host, device=CPU, opt_state=js)
    adam = ts[-1] if clip else ts
    assert int(adam["count"]) == int(tstate["count"]) == 6
    for a, b in zip(_leaves(adam["nu"]), _leaves(tstate["nu"])):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12)


def test_clip_by_global_norm_matches_optax():
    host, _ = _random_params(2)
    for g in _grad_trees(host, 3, seed=4):
        for max_norm in (1e-3, 1e9):
            want, _ = optax.clip_by_global_norm(max_norm).update(g, ())
            got, _ = optim.clip_by_global_norm(max_norm).update(
                vit.params_from_jax(g, device=CPU), {})
            for a, b in zip(_leaves(got), _jleaves(want)):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


def test_schedules_match_optax():
    counts = jnp.arange(0, 40, dtype=jnp.int32)
    tc = torch.arange(0, 40, dtype=torch.int32)
    pairs = [(optax.warmup_cosine_decay_schedule(0.0, 3e-3, 5, 30),
              optim.warmup_cosine_decay_schedule(0.0, 3e-3, 5, 30)),
             (optax.warmup_cosine_decay_schedule(0.0, 1.0, 0, 10, 0.1),
              optim.warmup_cosine_decay_schedule(0.0, 1.0, 0, 10, 0.1)),
             (optax.linear_schedule(0.0, 3e-3, 7), optim.linear_schedule(0.0, 3e-3, 7))]
    for want, got in pairs:
        np.testing.assert_allclose(np.array([float(got(c)) for c in tc]),
                                   np.array([float(want(c)) for c in counts]),
                                   rtol=1e-6, atol=1e-12)


def test_adam_state_carries_across_from_jax():
    """A mid-training optax state carried into the port: one more step of
    both agrees as the steps of ``test_adamw_matches_optax`` do."""
    host, _ = _random_params(3)
    tx = optax.adamw(1e-2, weight_decay=0.05)
    jp, js = host, tx.init(host)
    grads = _grad_trees(host, 4, seed=7)
    for g in grads[:3]:
        upd, js = tx.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
    ours, ts = vit.params_from_jax(jax.tree.map(np.asarray, jp), device=CPU,
                                   opt_state=js)
    upd, js = tx.update(grads[3], js, jp)
    jp = optax.apply_updates(jp, upd)
    ttx = optim.adamw(1e-2, weight_decay=0.05)
    tupd, ts = ttx.update(vit.params_from_jax(grads[3], device=CPU), ts, ours)
    optim.apply_updates(ours, tupd)
    for a, b in zip(_leaves(ours), _jleaves(jp)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    assert int(ts["count"]) == 4


# -- one step of make_train_step against JAX's -----------------------------

# Each leaf's update (new − old) against JAX's, held within a share of its
# largest magnitude. fp32: the same function summed in another order; the
# loss to 1e-5, SGD updates measured within 3.1e-5. bf16 compute with fp32
# masters: the frameworks' autodiff rounds some cotangents to bf16 at other
# points and bf16 flips travel through the attention; the loss measured
# within 1.1e-5, SGD updates within 1.3e-2.
STEP_TOL = {"f32": dict(loss=1e-5, update=1e-3),
            "bf16": dict(loss=1e-4, update=5e-2)}
# AdamW's first step is g / (|g| + eps): ±lr wherever |g| is well above
# eps, so a gradient whose sign is noise turns into a ±lr difference. Its
# first moment, (1 − b1)·g, is held like the SGD update, and its parameter
# updates by their mean difference: measured 6.1e-4·lr (fp32) and 0.28·lr
# (bf16, where sign noise is common).
ADAM_MEAN = {"f32": 5e-3, "bf16": 0.5}


def _one_step(route, opt, dtype, grad_accum=1):
    tdt, jdt = {"f32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    host, ours = _random_params(5)
    images, labels = _dataset(8, seed=6)
    lr = 0.1 if opt == "sgd" else 1e-3
    mesh = jspmd.make_mesh(data=1, model=1)
    jmade = jspmd.make_train_step(JCFG, mesh, lr=lr, compute_dtype=jdt,
                                  optimizer=opt, attention_impl=route,
                                  grad_accum=grad_accum)
    tmade = spmd.make_train_step(CFG, device=CPU, lr=lr, compute_dtype=tdt,
                                 optimizer=opt, attention_impl=route,
                                 grad_accum=grad_accum)
    old = _jleaves(host)
    ji, jl = jnp.asarray(images), jnp.asarray(labels)
    ti, tl = torch.from_numpy(images), torch.from_numpy(labels)
    mu = None
    if opt == "sgd":
        jp, jloss = jmade(host, ji, jl)
        tp, tloss = tmade(ours, ti, tl)
    else:
        jp, js, jloss = jmade[1](host, jmade[0](host), ji, jl)
        tp, ts, tloss = tmade[1](ours, tmade[0](ours), ti, tl)
        mu = (_leaves(ts["mu"]), _jleaves(js[0].mu))
    return (float(tloss), float(jloss),
            [a - o for a, o in zip(_leaves(tp), old)],
            [b - o for b, o in zip(_jleaves(jp), old)], lr, mu)


def _held(got, want, share):
    for a, b in zip(got, want):
        assert float(np.abs(a - b).max()) <= share * float(np.abs(b).max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("opt", ["sgd", "adamw"])
@pytest.mark.parametrize("route", ["xla", "flash", "fused"])
def test_train_step_matches_jax(route, opt, dtype):
    tloss, jloss, tupd, jupd, lr, mu = _one_step(route, opt, dtype)
    tol = STEP_TOL[dtype]
    np.testing.assert_allclose(tloss, jloss, rtol=tol["loss"])
    if opt == "sgd":
        _held(tupd, jupd, tol["update"])
        return
    _held(*mu, tol["update"])
    for a, b in zip(tupd, jupd):
        assert float(np.abs(a - b).mean()) <= ADAM_MEAN[dtype] * lr


def test_grad_accum_equals_full_batch():
    host, _ = _random_params(6)
    images, labels = _dataset(8, seed=6)
    outs = []
    for accum in (1, 2):
        params = vit.params_from_jax(host, device=CPU)
        step = spmd.make_train_step(CFG, device=CPU, lr=0.1,
                                    attention_impl="fused", grad_accum=accum)
        p, loss = step(params, torch.from_numpy(images), torch.from_numpy(labels))
        outs.append((float(loss), _leaves(p)))
    # The mean of two half-batch means is the full-batch mean, summed in
    # another order.
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-6)
    for a, b in zip(outs[0][1], outs[1][1]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="grad_accum"):
        spmd.make_train_step(CFG, device=CPU, grad_accum=3)(
            params, torch.from_numpy(images), torch.from_numpy(labels))


def test_train_step_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="mesh"):
        spmd.make_train_step(CFG, object(), device=CPU)


def test_label_smoothing_loss_semantics():
    """Smoothed loss = (1 − eps)·CE + eps·uniform CE, as JAX's."""
    host, _ = _random_params(1)
    images, labels = _dataset(8)
    mesh = jspmd.make_mesh(data=1, model=1)

    def loss_of(**kw):
        step = spmd.make_train_step(CFG, device=CPU, lr=0.0, **kw)
        _, loss = step(vit.params_from_jax(host, device=CPU),
                       torch.from_numpy(images), torch.from_numpy(labels))
        jstep = jspmd.make_train_step(JCFG, mesh, lr=0.0, **kw)
        _, jloss = jstep(host, jnp.asarray(images), jnp.asarray(labels))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        return float(loss)

    plain = loss_of()
    assert plain == loss_of(label_smoothing=0.0)
    smooth = loss_of(label_smoothing=0.1)
    assert np.isfinite(smooth) and abs(smooth - plain) > 1e-6
    soft = np.eye(CFG.num_classes, dtype=np.float32)[labels]
    step = spmd.make_train_step(CFG, device=CPU, lr=0.0)
    _, soft_loss = step(vit.params_from_jax(host, device=CPU),
                        torch.from_numpy(images), torch.from_numpy(soft))
    np.testing.assert_allclose(float(soft_loss), plain, rtol=1e-6)
    with pytest.raises(ValueError, match="label_smoothing"):
        spmd.make_train_step(CFG, device=CPU, label_smoothing=1.0)


def test_grad_clip_norm_bounds_update():
    host, _ = _random_params(0)
    images, labels = (torch.from_numpy(a) for a in _dataset(8))
    step = spmd.make_train_step(CFG, device=CPU, lr=1.0, grad_clip_norm=1e-3)
    p1, _ = step(vit.params_from_jax(host, device=CPU), images, labels)
    delta = np.sqrt(sum(float(np.sum((a - b) ** 2))
                        for a, b in zip(_leaves(p1), _jleaves(host))))
    assert delta <= 1e-3 + 1e-6
    loose = spmd.make_train_step(CFG, device=CPU, lr=1e-2, grad_clip_norm=1e9)
    plain = spmd.make_train_step(CFG, device=CPU, lr=1e-2)
    pa, _ = loose(vit.params_from_jax(host, device=CPU), images, labels)
    pb, _ = plain(vit.params_from_jax(host, device=CPU), images, labels)
    for a, b in zip(_leaves(pa), _leaves(pb)):
        np.testing.assert_array_equal(a, b)
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError, match="grad_clip_norm"):
            spmd.make_train_step(CFG, device=CPU, grad_clip_norm=bad)


# -- Trainer ---------------------------------------------------------------


def _loss_at(log):
    return float(log.split("loss ")[1].split(",")[0])


@pytest.mark.parametrize("route", ["xla", "fused"])
def test_trainer_descends_and_checkpoints(tmp_path, route):
    images, labels = _dataset(16)
    logs = []
    tr = Trainer(CFG, device=CPU, lr=1e-2, optimizer="adamw",
                 compute_dtype=torch.float32, attention_impl=route,
                 checkpoint_dir=str(tmp_path), checkpoint_every=4,
                 log_every=2, log_fn=logs.append, seed=7)
    tr.fit(data.memory_dataset(images, labels, 8, epochs=None, seed=2), steps=8)
    assert tr.step_idx == 8 and "loss" in logs[0]
    first = _loss_at(logs[0])
    assert _loss_at(logs[-1]) < first  # memorising 16 images
    assert tr.latest_checkpoint().endswith("step_00000008")

    tr2 = Trainer(CFG, device=CPU, lr=1e-2, optimizer="adamw",
                  compute_dtype=torch.float32, attention_impl=route,
                  checkpoint_dir=str(tmp_path), log_every=0, seed=0)
    assert tr2.resume() and tr2.step_idx == 8
    for a, b in zip(_leaves(tr2.params), _leaves(tr.params)):
        np.testing.assert_array_equal(a, b)
    assert int(tr2.opt_state["count"]) == 8
    for a, b in zip(_leaves(tr2.opt_state["mu"]), _leaves(tr.opt_state["mu"])):
        np.testing.assert_array_equal(a, b)
    tr2.fit(data.memory_dataset(images, labels, 8, epochs=None, seed=9),
            steps=10)
    assert tr2.step_idx == 10 and tr2.last_loss < first


def test_trained_model_exports_to_reference_format(tmp_path):
    """Train (cosine schedule), export, reload through the reference loader:
    the golden model reproduces the trained model's outputs."""
    images, labels = _dataset(8)
    tr = Trainer(CFG, device=CPU, lr=1e-2, optimizer="adamw", schedule="cosine",
                 warmup_steps=2, total_steps=6, compute_dtype=torch.float32,
                 log_every=0)
    tr.fit(data.memory_dataset(images, labels, 8, epochs=None, seed=1), steps=6)
    files = tr.export_reference(str(tmp_path / "Network"))
    assert len(files) == len(binfmt.weight_names(CFG))
    loaded = binfmt.load_weights(tmp_path / "Network", CFG, round_to_6dp=False,
                                 strict=True)
    ref = golden.golden_forward(images[:4], binfmt.weights_to_dict(loaded, CFG),
                                CFG)
    with torch.no_grad():
        probs = vit.forward(torch.from_numpy(images[:4]), tr.params, CFG,
                            compute_dtype=torch.float32)
    np.testing.assert_allclose(ref, probs.numpy(), atol=2e-5)


def test_checkpoint_structure_and_strict_restore(tmp_path):
    from vit_with_opencl_tpu_torch.io import checkpoint

    tree = {"params": {"w": torch.ones(2, 3)}, "step": np.int64(4),
            "opt_state": ({}, {"count": torch.tensor(4, dtype=torch.int32)})}
    checkpoint.save_checkpoint(tmp_path / "ck", tree)
    structure = checkpoint.checkpoint_structure(tmp_path / "ck")
    assert structure["params"]["w"] == ((2, 3), torch.float32)
    assert set(structure) == {"params", "step", "opt_state"}
    assert checkpoint.checkpoint_structure(tmp_path / "missing") is None
    back = checkpoint.load_checkpoint(tmp_path / "ck", tree)
    assert torch.equal(back["params"]["w"], tree["params"]["w"])
    with pytest.raises(ValueError, match="params"):
        checkpoint.load_checkpoint(tmp_path / "ck",
                                   dict(tree, params={"w": torch.ones(3, 2)}))
    with pytest.raises(ValueError, match="opt_state"):
        checkpoint.load_checkpoint(tmp_path / "ck",
                                   dict(tree, opt_state=tree["opt_state"][1]))


def test_trainer_sgd_grad_accum():
    images, labels = _dataset(16)
    tr = Trainer(CFG, device=CPU, lr=1e-2, optimizer="sgd",
                 compute_dtype=torch.float32, grad_accum=2, log_every=0)
    tr.fit(data.memory_dataset(images, labels, 16, epochs=4, seed=2))
    assert tr.step_idx == 4 and np.isfinite(tr.last_loss)
    with pytest.raises(ValueError, match="without checkpoint_dir"):
        tr.save()


def test_trainer_ema_tracks_params(tmp_path):
    images, labels = _dataset(16)
    tr = Trainer(CFG, device=CPU, lr=5e-2, optimizer="sgd",
                 compute_dtype=torch.float32, ema_decay=0.5, log_every=0,
                 checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    init = tr.ema_params["layers"]["qkv_w"].clone()
    tr.fit(data.memory_dataset(images, labels, 16, epochs=4, seed=3))
    ema, live = tr.ema_params["layers"]["qkv_w"], tr.params["layers"]["qkv_w"]
    assert (ema - init).abs().max() > 0 and (ema - live).abs().max() > 0
    assert (ema - init).abs().mean() < (live - init).abs().mean()
    tr2 = Trainer(CFG, device=CPU, lr=5e-2, optimizer="sgd",
                  compute_dtype=torch.float32, ema_decay=0.5, log_every=0,
                  checkpoint_dir=str(tmp_path / "ck"))
    assert tr2.resume()
    assert torch.equal(tr2.ema_params["layers"]["qkv_w"], ema)
    assert tr.export_reference(str(tmp_path / "W"), use_ema=True)
    with pytest.raises(ValueError, match="ema_decay"):
        Trainer(CFG, device=CPU, optimizer="sgd", log_every=0).export_reference(
            str(tmp_path / "W2"), use_ema=True)


def test_ema_update_matches_jax_arithmetic():
    """d·e + (1 − d)·p with d and 1 − d rounded as float32 arithmetic does
    (the JAX Trainer's jnp.float32(decay))."""
    tr = Trainer(CFG, device=CPU, optimizer="sgd", ema_decay=0.9999,
                 log_every=0)
    e = tr.ema_params["layers"]["fc1_w"].clone()
    p = tr.params["layers"]["fc1_w"]
    p.add_(0.25)
    tr._ema_update()
    d = jnp.float32(0.9999)
    want = d * jnp.asarray(e.numpy()) + (1.0 - d) * jnp.asarray(p.numpy())
    np.testing.assert_array_equal(tr.ema_params["layers"]["fc1_w"].numpy(),
                                  np.asarray(want))


def test_resume_across_ema_setting_change(tmp_path):
    images, labels = _dataset(16)
    ck = str(tmp_path / "ck")
    tr = Trainer(CFG, device=CPU, lr=1e-2, optimizer="sgd",
                 compute_dtype=torch.float32, log_every=0, checkpoint_dir=ck,
                 checkpoint_every=2)
    tr.fit(data.memory_dataset(images, labels, 16, epochs=2, seed=4))
    tr_ema = Trainer(CFG, device=CPU, lr=1e-2, optimizer="sgd",
                     compute_dtype=torch.float32, ema_decay=0.9, log_every=0,
                     checkpoint_dir=ck, checkpoint_every=2)
    assert tr_ema.resume()
    assert torch.equal(tr_ema.ema_params["layers"]["qkv_w"],
                       tr_ema.params["layers"]["qkv_w"])
    tr_ema.fit(data.memory_dataset(images, labels, 16, epochs=2, seed=5))
    tr_plain = Trainer(CFG, device=CPU, lr=1e-2, optimizer="sgd",
                       compute_dtype=torch.float32, log_every=0,
                       checkpoint_dir=ck)
    assert tr_plain.resume()
    assert tr_plain.ema_params is None and tr_plain.step_idx == tr_ema.step_idx


def test_resume_across_grad_clip_setting_change(tmp_path):
    """Toggling grad_clip_norm chains AdamW with the clip, which changes the
    optimizer state's structure: resume warns and restarts the optimizer
    state, and still restores params and step."""
    images, labels = _dataset(16)
    ck = str(tmp_path / "ck")
    tr = Trainer(CFG, device=CPU, lr=1e-2, optimizer="adamw",
                 compute_dtype=torch.float32, log_every=0, checkpoint_dir=ck,
                 checkpoint_every=2)
    tr.fit(data.memory_dataset(images, labels, 16, epochs=2, seed=4))
    logs = []
    tr_clip = Trainer(CFG, device=CPU, lr=1e-2, optimizer="adamw",
                      compute_dtype=torch.float32, grad_clip_norm=1.0,
                      log_every=0, log_fn=logs.append, checkpoint_dir=ck)
    assert tr_clip.resume() and tr_clip.step_idx == 2
    assert any("opt_state" in m for m in logs)
    for a, b in zip(_leaves(tr_clip.params), _leaves(tr.params)):
        np.testing.assert_array_equal(a, b)
    assert int(tr_clip.opt_state[1]["count"]) == 0  # fresh and usable
    tr_clip.fit(data.memory_dataset(images, labels, 16, epochs=2, seed=5))
    assert tr_clip.step_idx == 4 and np.isfinite(tr_clip.last_loss)
    tr_clip.save()
    tr_back = Trainer(CFG, device=CPU, lr=1e-2, optimizer="adamw",
                      compute_dtype=torch.float32, log_every=0, checkpoint_dir=ck)
    assert tr_back.resume() and tr_back.step_idx == 4
    tr_sgd = Trainer(CFG, device=CPU, lr=1e-2, optimizer="sgd",
                     compute_dtype=torch.float32, log_every=0, checkpoint_dir=ck)
    assert tr_sgd.resume()
    assert tr_sgd.step_idx == 4 and tr_sgd.opt_state is None


def test_ema_shadow_stays_fp32():
    images, labels = _dataset(16)
    tr = Trainer(CFG, device=CPU, lr=5e-2, optimizer="sgd",
                 compute_dtype=torch.bfloat16, ema_decay=0.9999, log_every=0)
    assert all(t.dtype == torch.float32 for t in optim.tree_leaves(tr.ema_params))
    before = tr.ema_params["head_w"].clone()
    tr.fit(data.memory_dataset(images, labels, 16, epochs=2, seed=6))
    assert tr.ema_params["head_w"].dtype == torch.float32
    assert (tr.ema_params["head_w"] - before).abs().max() > 0
