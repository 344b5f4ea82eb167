"""The port's engine and CLI on the CPU: the flow of tests/test_e2e.py
(fixtures on disk → CLI → comparator green), batch padding and uint8 input."""

import os

import numpy as np
import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    # The xdist workers share the host's cores: one torch thread each.
    torch.set_num_threads(1)

from vit_with_opencl_tpu_torch import ViTConfig, cli
from vit_with_opencl_tpu_torch import config as config_lib
from vit_with_opencl_tpu_torch.engine import InferenceEngine
from vit_with_opencl_tpu_torch.io.preprocess import IMAGENET_MEAN, IMAGENET_STD
from vit_with_opencl_tpu_torch.harness import fixtures, results
from vit_with_opencl_tpu_torch.io import binfmt
from vit_with_opencl_tpu_torch.models import golden

CFG = ViTConfig(name="e2e_small_torch", img_size=32, patch_size=8,
                embed_dim=48, depth=2, num_heads=4, num_classes=1000)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A fake reference workspace: input binary + weight dir + answer file."""
    root = tmp_path_factory.mktemp("ws_torch")
    params = fixtures.random_params(CFG, seed=11, scale=0.05)
    images = fixtures.random_images(CFG, n=5, seed=5)
    binfmt.save_image_data(root / "input.bin", images)
    binfmt.save_weights(root / "Network", fixtures.params_to_positional(params, CFG), CFG)
    rounded = {k: binfmt.round_6dp(v) for k, v in params.items()}
    results.write_results(root / "answer.txt", golden.golden_forward(images, rounded, CFG))
    return root


def _argv(ws, output, *extra):
    return ["--input", str(ws / "input.bin"), "--weights", str(ws / "Network"),
            "--output", str(ws / output), "--answer", str(ws / "answer.txt"),
            "--config", CFG.name, *extra]


@pytest.mark.parametrize("backend_args", [
    ("--backend", "golden"),
    ("--backend", "gpu", "--attention", "xla", "--device", "cpu"),
    ("--backend", "gpu", "--attention", "flash", "--device", "cpu",
     "--batch-size", "2"),
    ("--backend", "gpu", "--attention", "fused_block", "--device", "cpu",
     "--batch-size", "2"),
], ids=["golden", "gpu_xla_cpu", "gpu_flash_cpu", "gpu_fused_block_cpu"])
def test_cli_matches_answer(workspace, monkeypatch, capsys, backend_args):
    monkeypatch.setitem(config_lib.PRESETS, CFG.name, CFG)
    rc = cli.main(_argv(workspace, f"result_{'_'.join(backend_args[1::2])}.txt",
                        *backend_args))
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Comparator: files match." in out


def test_cli_reports_mismatch(workspace, monkeypatch, capsys):
    monkeypatch.setitem(config_lib.PRESETS, CFG.name, CFG)
    lines = (workspace / "answer.txt").read_text().splitlines()
    label = int(lines[0].split("label: ")[1].split(" /")[0])
    lines[0] = lines[0].replace(f"label: {label} ", f"label: {(label + 1) % 1000} ")
    (workspace / "bad_answer.txt").write_text("\n".join(lines) + "\n")
    argv = _argv(workspace, "result_bad.txt", "--backend", "gpu", "--device", "cpu")
    argv[argv.index(str(workspace / "answer.txt"))] = str(workspace / "bad_answer.txt")
    assert cli.main(argv) == 1
    assert "Comparator: 1 mismatches." in capsys.readouterr().out


@pytest.fixture(scope="module")
def small():
    params = fixtures.random_params(CFG, seed=3, scale=0.05)
    images = fixtures.random_images(CFG, n=3, seed=4)
    return params, images, golden.golden_forward(images, params, CFG)


@pytest.mark.parametrize("route", ["xla", "flash"])
def test_engine_pads_the_last_batch(small, route):
    params, images, ref = small
    engine = InferenceEngine(CFG, params, batch_size=2, param_dtype=torch.float32,
                             compute_dtype=torch.float32, attention_impl=route,
                             device="cpu")
    assert engine.warmup() > 0
    probs = engine.run(images)  # 3 images: one full batch, one padded
    assert probs.shape == ref.shape
    np.testing.assert_allclose(probs, ref, atol=1e-5)
    # The padded rows change nothing: one image alone gives the same row.
    np.testing.assert_allclose(engine.run(images[2]), probs[2:], atol=1e-6)
    assert engine.run(images[:0]).shape == (0, CFG.num_classes)


def test_fp32_flash_engine_matches_jax_engine(small):
    """The engine's fp32 mode (``param_dtype`` and ``compute_dtype`` fp32,
    ``attention_impl="flash"``: on the card the fp32 GEMM and the fp32
    packed attention in the encoder's chain) on the CPU, against the JAX
    engine in the same mode (its Pallas kernels in interpret mode), on a
    2-layer config. Tolerance: fp32 summation order, 1e-6 on probabilities
    over 1000 classes (measured about 1e-8)."""
    import dataclasses

    import jax.numpy as jnp

    from vit_with_opencl_tpu import ViTConfig as JViTConfig
    from vit_with_opencl_tpu.engine import InferenceEngine as JInferenceEngine

    params, images, ref = small
    jcfg = JViTConfig(**dataclasses.asdict(CFG))
    want = JInferenceEngine(jcfg, params, batch_size=2, param_dtype=jnp.float32,
                            compute_dtype=jnp.float32,
                            attention_impl="flash").run(images)
    engine = InferenceEngine(CFG, params, batch_size=2, param_dtype=torch.float32,
                             compute_dtype=torch.float32, attention_impl="flash",
                             device="cpu")
    got = engine.run(images)
    assert got.shape == want.shape == ref.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_engine_normalize_uint8(small):
    params, _, _ = small
    raw = np.random.default_rng(9).integers(0, 256, (3, 3, 32, 32), dtype=np.uint8)
    normalized = ((raw.astype(np.float32) - IMAGENET_MEAN.reshape(1, 3, 1, 1) * 255.0)
                  / (IMAGENET_STD.reshape(1, 3, 1, 1) * 255.0))
    kw = dict(batch_size=4, param_dtype=torch.float32,
              compute_dtype=torch.float32, attention_impl="flash", device="cpu")
    raw_engine = InferenceEngine(CFG, params, normalize_uint8=True, **kw)
    probs = raw_engine.run(raw)
    ref = golden.golden_forward(normalized, params, CFG)
    np.testing.assert_allclose(probs, ref, atol=1e-5)
    with pytest.raises(ValueError, match="uint8"):
        raw_engine.run(normalized)
    with pytest.raises(ValueError, match="uint8"):
        InferenceEngine(CFG, params, **kw).run(raw)


def test_engine_quantize_not_ported(small):
    """int8 and W8A8 run (tests/test_torch_quant.py); the calibrated
    outlier-aware W8A8 mode, once not ported, now runs, and never quietly as
    plain W8A8: its encoder weights carry the bf16 outlier groups."""
    params, images, ref = small
    engine = InferenceEngine(CFG, params, quantize="int8-w8a8", calibrate=images,
                             device="cpu", attention_impl="flash", batch_size=2,
                             param_dtype=torch.float32, compute_dtype=torch.float32)
    for key in ("qkv_w", "out_w", "fc1_w", "fc2_w"):
        assert engine.params["layers"][key]["hi"].dtype == torch.bfloat16
    probs = engine.run(images)
    np.testing.assert_allclose(probs, ref, atol=1e-2)
    assert (probs.argmax(-1) == ref.argmax(-1)).all()
