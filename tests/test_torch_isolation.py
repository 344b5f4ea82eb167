"""The port stands alone: it imports neither JAX nor the JAX package, nor
``ml_dtypes`` (the machine with the card lacks it: the port rounds its bf16
weights with torch), nor optax or orbax (its optimizers and checkpoints are
its own torch code), never falls back to the CPU when a card was asked for,
and never falls back to a plain version when its kernels cannot be built."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pkgutil

import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    # The xdist workers share the host's cores: one torch thread each.
    torch.set_num_threads(1)

import vit_with_opencl_tpu_torch
from vit_with_opencl_tpu_torch import ViTConfig
from vit_with_opencl_tpu_torch.harness import fixtures
from vit_with_opencl_tpu_torch.ops import _build

PACKAGE_DIR = Path(vit_with_opencl_tpu_torch.__file__).parent
REPO = PACKAGE_DIR.parent


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PACKAGE_DIR)], prefix="vit_with_opencl_tpu_torch."))


def test_importing_every_module_loads_no_jax():
    modules = _port_modules()
    for name in ("ops.fused_block", "ops.quantize", "models.quant", "train",
                 "optim", "data", "parallel.spmd", "io.checkpoint",
                 "io.export", "ops.softmax", "perf.profiler",
                 "perf.kernel_trace", "parallel.mesh", "parallel.collectives",
                 "ops.ring_attention", "debug", "scripts.probe_w8a8_overlap",
                 "scripts.make_fixtures", "scripts.soak", "scripts.trace_table",
                 "scripts.bench_train", "serve", "io.preprocess", "runtime",
                 "runtime.native", "scripts.soak_serve", "augment",
                 "augment_device", "scripts.recipe_smoke", "ops.substitutions",
                 "scripts.probe_tiny_bound", "scripts.probe_midsize"):
        assert f"vit_with_opencl_tpu_torch.{name}" in modules
    code = "\n".join([
        "import importlib, sys",
        f"for name in {modules!r}: importlib.import_module(name)",
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')",
        "             or m == 'vit_with_opencl_tpu'",
        "             or m.startswith('vit_with_opencl_tpu.')",
        "             or m.split('.')[0] in ('ml_dtypes', 'optax', 'orbax'))",
        "print(bad)",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


FORBIDDEN = [re.compile(p, re.MULTILINE) for p in (
    r"^\s*(import|from)\s+jax\b",
    r"^\s*(import|from)\s+vit_with_opencl_tpu\b",  # \b: not ..._torch
    r"\bvit_with_opencl_tpu\.",
    r"^\s*(import|from)\s+ml_dtypes\b",  # also a lazy import in a function
    r"^\s*(import|from)\s+(optax|orbax)\b",
)]


def test_sources_do_not_name_jax():
    files = sorted(PACKAGE_DIR.rglob("*.py")) + [
        REPO / name for name in ("chip_smoke.py", "before_after.py", "wgrad_split_rules.py",
                                 "step_noise.py")]
    for path in files:
        text = path.read_text()
        for pattern in FORBIDDEN:
            match = pattern.search(text)
            assert match is None, f"{path}: {match and match.group(0)!r}"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    assert _build.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library()


def test_build_failure_carries_nvcc_stderr(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such intrinsic' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _build.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_resource_usage_reads_the_ptxas_report(monkeypatch, tmp_path):
    """Each entry function's registers, spills and warnings, the names
    demangled by the toolkit's cu++filt beside nvcc."""
    report = ("ptxas info    : Compiling entry function '_Z1av' for 'sm_90a'\n"
              "ptxas info    : Function properties for _Z1av\n"
              "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
              "ptxas info    : Used 168 registers, used 1 barriers\n"
              "ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'\n"
              "ptxas warning : (C7508) setmaxnreg ignored; unable to determine "
              "register count at entry\n"
              "ptxas info    : Function properties for _Z1bv\n"
              "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
              "ptxas info    : Used 40 registers, used 0 barriers\n")
    (tmp_path / "report").write_text(report)
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!/bin/sh\ncat {tmp_path / 'report'} >&2\n")
    (tmp_path / "cu++filt").write_text("#!/bin/sh\nsed 's/_Z1\\(.\\)v/\\1()/'\n")
    for tool in (fake, tmp_path / "cu++filt"):
        tool.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert _build.resource_usage("quantize.cu") == [
        {"name": "a()", "registers": 168, "spill_stores": 8, "spill_loads": 4,
         "warnings": []},
        {"name": "b()", "registers": 40, "spill_stores": 0, "spill_loads": 0,
         "warnings": ["ptxas warning : (C7508) setmaxnreg ignored; unable to "
                      "determine register count at entry"]}]


def test_build_key_follows_the_sources(monkeypatch, tmp_path):
    for name in ("a.cu", "common.cuh"):
        (tmp_path / name).write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build.source_key()
    assert _build.source_key() == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert _build.source_key() != first


def test_engine_needs_cuda_unless_cpu_is_asked(monkeypatch):
    from vit_with_opencl_tpu_torch.engine import InferenceEngine

    cfg = ViTConfig(name="iso", img_size=16, patch_size=8, embed_dim=16,
                    depth=1, num_heads=2, num_classes=3)
    params = fixtures.random_params(cfg, seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(cfg, params, device="cuda")
    assert InferenceEngine(cfg, params, device="cpu").device.type == "cpu"


def test_mesh_needs_cuda_unless_devices_are_given(monkeypatch):
    """``make_mesh`` and ``DataParallelEngine`` default to every CUDA device
    and raise without one; CPU devices run only when passed."""
    from vit_with_opencl_tpu_torch.engine import DataParallelEngine
    from vit_with_opencl_tpu_torch.parallel import spmd

    cfg = ViTConfig(name="iso", img_size=16, patch_size=8, embed_dim=16,
                    depth=1, num_heads=2, num_classes=3)
    params = fixtures.random_params(cfg, seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        spmd.make_mesh(1, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        DataParallelEngine(cfg, params, batch_size=2)
    assert spmd.make_mesh(1, 2, devices=["cpu"] * 2).shape == {"data": 1, "model": 2}
    engine = DataParallelEngine(cfg, params, batch_size=2, devices=["cpu"] * 2)
    assert engine.device.type == "cpu"
