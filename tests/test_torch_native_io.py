"""The port's native IO layer (``runtime``, libvitio) on the CPU.

Mirrors ``tests/test_native_io.py``: the port's libvitio against the port's
NumPy io layer (``io.binfmt``, ``harness.results``) and the JAX package's,
byte for byte. Adds the build's race fix: three processes building into one
fresh build directory at once all load the one finished library; and the
CLI with libvitio (its default) and ``--pure-python`` writing identical
result files. Skips only where ``g++`` is absent.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    # The xdist workers share the host's cores: one torch thread each.
    torch.set_num_threads(1)

from vit_with_opencl_tpu.harness import results as jresults
from vit_with_opencl_tpu.io import binfmt as jbinfmt
from vit_with_opencl_tpu_torch import VIT_TINY_16_224 as CFG
from vit_with_opencl_tpu_torch import ViTConfig, cli
from vit_with_opencl_tpu_torch import config as config_lib
from vit_with_opencl_tpu_torch.harness import fixtures, results
from vit_with_opencl_tpu_torch.io import binfmt
from vit_with_opencl_tpu_torch.runtime import native

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def nio():
    if shutil.which("g++") is None:
        pytest.skip("no g++: libvitio cannot be built")
    io = native.get_native_io()
    assert io is not None, native._build_error
    return io


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("native_torch")
    params = fixtures.random_params(CFG, seed=1)
    images = fixtures.random_images(CFG, n=3, seed=1)
    binfmt.save_image_data(root / "input.bin", images)
    binfmt.save_weights(root / "Network", fixtures.params_to_positional(params, CFG), CFG)
    return root, images


def test_load_images_matches_numpy(nio, workspace):
    root, images = workspace
    got = nio.load_images(root / "input.bin")
    np.testing.assert_array_equal(got, binfmt.load_image_data(root / "input.bin"))
    np.testing.assert_array_equal(got, jbinfmt.load_image_data(root / "input.bin"))
    np.testing.assert_array_equal(got, images)


def test_load_images_error(nio, tmp_path):
    with pytest.raises(IOError, match="cannot open"):
        nio.load_images(tmp_path / "nope.bin")


@pytest.mark.parametrize("round_to_6dp", [True, False], ids=["rounded", "raw"])
def test_load_weights_matches_numpy(nio, workspace, round_to_6dp):
    root, _ = workspace
    count = len(binfmt.weight_names(CFG))
    got = nio.load_weights(root / "Network", count, round_to_6dp=round_to_6dp)
    port = binfmt.load_weights(root / "Network", CFG, round_to_6dp=round_to_6dp)
    jax = jbinfmt.load_weights(root / "Network", CFG, round_to_6dp=round_to_6dp)
    assert set(got) == set(port) == set(jax) == set(range(count))
    for idx in port:
        np.testing.assert_array_equal(got[idx], port[idx])
        np.testing.assert_array_equal(got[idx], jax[idx])


def test_load_weights_strict_missing(nio, workspace, tmp_path):
    root, _ = workspace
    part = tmp_path / "Partial"
    shutil.copytree(root / "Network", part)
    os.remove(part / sorted(os.listdir(part))[3])
    count = len(binfmt.weight_names(CFG))
    with pytest.raises(FileNotFoundError, match="missing weight indices"):
        nio.load_weights(part, count, strict=True)
    assert len(nio.load_weights(part, count, strict=False)) == count - 1


def test_write_results_matches_python(nio, tmp_path):
    probs = np.random.default_rng(0).dirichlet(np.ones(50), size=5).astype(np.float32)
    results.write_results(tmp_path / "port.txt", probs)
    jresults.write_results(tmp_path / "jax.txt", probs)
    nio.write_results(tmp_path / "cc.txt", probs)
    text = (tmp_path / "cc.txt").read_bytes()
    assert text == (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


def test_compare_results_native(nio, tmp_path):
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    a.write_text("[0] label: 5 / prob: 0.900000\n[1] label: 7 / prob: 0.500000\n")
    b.write_text("[0] label: 5 / prob: 0.905000\n[1] label: 7 / prob: 0.500000\n")
    assert nio.compare_results(a, b) == 0 == results.compare_result_files(a, b)
    b.write_text("[0] label: 6 / prob: 0.905000\n[1] label: 7 / prob: 0.600000\n")
    assert nio.compare_results(a, b) == 2  # label + prob mismatches
    assert nio.compare_results(a, b, image_count=1) == 1
    with pytest.raises(IOError, match="cannot open"):
        nio.compare_results(a, tmp_path / "missing.txt")


def test_malformed_inputs_rejected(nio, tmp_path):
    """Every malformed file errors cleanly (no crash, no silent wrap — incl.
    header dimensions that overflow size_t), as the NumPy loader does."""
    cases = {
        "empty.bin": b"",
        "short.bin": b"\x01\x00",
        "zero.bin": np.asarray([0, 3, 8, 8], "<i4").tobytes(),
        "neg.bin": np.asarray([-1, 3, 8, 8], "<i4").tobytes(),
        "huge.bin": np.asarray([2**30] * 4, "<i4").tobytes(),
        "trunc.bin": np.asarray([2, 3, 8, 8], "<i4").tobytes() + b"\x00" * 10,
    }
    for name, payload in cases.items():
        p = tmp_path / name
        p.write_bytes(payload)
        with pytest.raises(IOError):
            nio.load_images(p)
    wdir = tmp_path / "W"
    wdir.mkdir()
    (wdir / "Weight_0_class_token.bin").write_bytes(b"\x00" * 7)
    with pytest.raises(IOError, match="bad size"):
        nio.load_weights(wdir, 4)


_BUILD_AND_LOAD = """
import sys
from pathlib import Path
import numpy as np
from vit_with_opencl_tpu_torch.runtime import native
lib = native.build(Path(sys.argv[1]))
io = native.NativeIO(lib)
probs = np.eye(3, dtype=np.float32)
io.write_results(sys.argv[2], probs)
print(lib)
"""


def test_concurrent_builds_all_load(tmp_path):
    """Three processes build into one fresh directory at once: each loads
    the finished library (compiled to a temporary file, then renamed), and
    the directory ends with that one library and nothing half-written."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: libvitio cannot be built")
    build_dir = tmp_path / "build"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_AND_LOAD, str(build_dir),
         str(tmp_path / f"r{i}.txt")], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(3)]
    outs = [p.communicate(timeout=180) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], [err for _out, err in outs]
    libs = {out.strip() for out, _err in outs}
    assert libs == {str(native.library_path(build_dir))}
    assert sorted(os.listdir(build_dir)) == [native.library_path(build_dir).name]
    want = (tmp_path / "r0.txt").read_bytes()
    assert want.startswith(b"[0] label: 0 / prob: 1.000000\n")
    assert (tmp_path / "r1.txt").read_bytes() == (tmp_path / "r2.txt").read_bytes() == want


def test_no_toolchain_gives_none(monkeypatch, tmp_path):
    """Without g++ (and no earlier build), ``get_native_io`` returns None and
    the CLI falls back to the NumPy io layer."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_cached", None)
    monkeypatch.setattr(native, "_build_error", None)
    assert native.get_native_io() is None
    assert "g++" in native._build_error
    assert not native.native_available()


SMALL = ViTConfig(name="native_small", img_size=32, patch_size=8, embed_dim=48,
                  depth=2, num_heads=4, num_classes=13)


def test_cli_libvitio_and_pure_python_write_identical_files(nio, tmp_path,
                                                            monkeypatch, capsys):
    monkeypatch.setitem(config_lib.PRESETS, SMALL.name, SMALL)
    params = fixtures.random_params(SMALL, seed=6, scale=0.05)
    binfmt.save_weights(tmp_path / "Network",
                        fixtures.params_to_positional(params, SMALL), SMALL)
    binfmt.save_image_data(tmp_path / "input.bin",
                           fixtures.random_images(SMALL, n=5, seed=7))
    binfmt.save_image_data(tmp_path / "calib.bin",
                           fixtures.random_images(SMALL, n=4, seed=8))
    common = ["--input", str(tmp_path / "input.bin"), "--weights",
              str(tmp_path / "Network"), "--config", SMALL.name, "--backend", "gpu",
              "--device", "cpu", "--attention", "flash", "--batch-size", "2"]
    for tag, flags in (("native", []), ("numpy", ["--pure-python"]),
                       ("native_cal", ["--calibrate", str(tmp_path / "calib.bin")]),
                       ("numpy_cal", ["--pure-python", "--calibrate",
                                      str(tmp_path / "calib.bin")])):
        assert cli.main([*common, "--output", str(tmp_path / f"{tag}.txt"), *flags]) == 0
    out = capsys.readouterr().out
    assert out.count("(libvitio io)") == 2 and out.count("(numpy io)") == 2
    for a, b in (("native", "numpy"), ("native_cal", "numpy_cal")):
        text = (tmp_path / f"{a}.txt").read_bytes()
        assert text == (tmp_path / f"{b}.txt").read_bytes() and text.count(b"\n") == 5
