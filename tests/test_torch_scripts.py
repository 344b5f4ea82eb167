"""The port's record-producing scripts (``vit_with_opencl_tpu_torch.scripts``)
on the CPU, at ``vit_tiny_16_224`` and a batch of 2.

``make_fixtures`` writes the JAX script's files byte for byte (weights,
input, answers); ``soak``, ``trace_table`` and ``bench_train`` run their
main paths on the plain versions and print finite results, and refuse what
the port does not have yet (``bench_train``'s split routes, TUNE=1 and
AUG=1) or never had (an unknown quant mode). Every script's ``main`` needs a
card unless ``device="cpu"`` is passed.
"""

import importlib.util
import math
import os
from pathlib import Path

import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    # The xdist workers share the host's cores: one torch thread each.
    torch.set_num_threads(1)

from vit_with_opencl_tpu_torch.scripts import (bench_train, make_fixtures,
                                               probe_w8a8_overlap, soak,
                                               trace_table)

REPO = Path(__file__).resolve().parent.parent
TINY = "vit_tiny_16_224"


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_make_fixtures_writes_the_jax_scripts_files(tmp_path, capsys):
    args = ["--config", TINY, "--images", "2"]
    assert _jax_script("make_fixtures").main(["--out", str(tmp_path / "jax")] + args) == 0
    assert make_fixtures.main(["--out", str(tmp_path / "port")] + args,
                              device="cpu") == 0
    out = capsys.readouterr().out
    assert out.count("answers: ") == 2 and "inputs:  " in out
    jax_files = sorted(p.relative_to(tmp_path / "jax")
                       for p in (tmp_path / "jax").rglob("*") if p.is_file())
    port_files = sorted(p.relative_to(tmp_path / "port")
                        for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert jax_files == port_files
    assert {"answer_result.txt", "input-2.bin"} <= {str(p) for p in jax_files}
    assert sum(str(p).startswith("Network") for p in jax_files) > 100
    for rel in jax_files:
        assert (tmp_path / "port" / rel).read_bytes() == \
            (tmp_path / "jax" / rel).read_bytes(), rel


@pytest.mark.parametrize("quant", [[], ["int8"], ["int8-w8a8"]])
def test_soak_runs_and_checks_finite(quant, capsys):
    res = soak.main([TINY, "2", "3", "2"] + quant, device="cpu")
    assert len(res["rates"]) == 2 and all(r > 0 for r in res["rates"])
    assert res["finite"] is True
    out = capsys.readouterr().out
    assert "window   2:" in out and "finite=True" in out
    assert "soak: 3 batches x 2 = 6 images" in out


@pytest.mark.parametrize("script", [soak, trace_table])
def test_unknown_quant_mode_is_refused(script):
    with pytest.raises(SystemExit, match="unknown quant mode"):
        script.main([TINY, "2", "1", "1", "int4"], device="cpu")


def test_trace_table_on_cpu_tensors(capsys):
    """On CPU tensors the table holds the host ops (the card's kernels only
    on the card)."""
    table = trace_table.main([TINY, "1", "1", "5"], device="cpu")
    assert 0 < len(table) <= 5 and all(s.total_ms > 0 for s in table)
    assert "device total" in capsys.readouterr().out


def test_bench_train_routes_give_finite_losses(capsys):
    res = bench_train.main([TINY, "2", "1", "xla,fused"], device="cpu")
    assert set(res) == {"xla", "fused"}
    for r in res.values():
        assert r["ms"] > 0 and math.isfinite(r["loss"])
    out = capsys.readouterr().out
    assert "xla   : " in out and "fused : " in out and "fused vs xla:" in out


def test_bench_train_accumulation_and_bf16_masters(monkeypatch):
    monkeypatch.setenv("ACCUM", "2")
    monkeypatch.setenv("PARAM_DTYPE", "bf16")
    monkeypatch.setenv("UNROLL", "4")
    res = bench_train.main([TINY, "2", "1", "flash"], device="cpu")
    assert math.isfinite(res["flash"]["loss"])


@pytest.mark.parametrize("env,impls,item", [
    ({"TUNE": "1"}, "fused", "item 6"),
    ({"AUG": "1"}, "fused", "item 3"),
    ({}, "fused_split4", "item 8"),
    ({}, "flash,flash_split", "item 8"),
])
def test_bench_train_refuses_what_is_not_ported(monkeypatch, env, impls, item):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    with pytest.raises(NotImplementedError, match=item):
        bench_train.main([TINY, "2", "1", impls], device="cpu")


@pytest.mark.parametrize("script,argv", [
    (soak, [TINY, "2", "1", "1"]),
    (trace_table, [TINY, "1", "1"]),
    (bench_train, [TINY, "2", "1", "xla"]),
    (make_fixtures, ["--out", "unused", "--config", TINY]),
    (probe_w8a8_overlap, []),
])
def test_scripts_need_a_card_unless_cpu_is_asked(monkeypatch, tmp_path, script, argv):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        script.main(argv)
    assert not (tmp_path / "unused").exists()
