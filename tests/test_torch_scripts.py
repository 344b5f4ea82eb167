"""The port's record-producing scripts (``vit_with_opencl_tpu_torch.scripts``)
on the CPU, at ``vit_tiny_16_224`` and a batch of 2.

``make_fixtures`` writes the JAX script's files byte for byte (weights,
input, answers); ``soak``, ``soak_serve``, ``trace_table``, ``bench_train``
(also with AUG=1, the augment probe) and ``recipe_smoke`` run their main
paths on the plain versions and print finite results, and refuse what the
port does not have yet (``bench_train``'s split routes and TUNE=1) or never
had (an unknown quant mode). ``probe_tiny_bound`` and ``probe_midsize`` run
at a test size (depth 2, 32-pixel images, a batch of 2: their config
patched in) and print the JAX scripts' labels. Every script's ``main``
needs a card unless ``device="cpu"`` is passed.
"""

import importlib.util
import math
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    # The xdist workers share the host's cores: one torch thread each.
    torch.set_num_threads(1)

from vit_with_opencl_tpu_torch import get_config, serve
from vit_with_opencl_tpu_torch.engine import InferenceEngine
from vit_with_opencl_tpu_torch.harness import fixtures
from vit_with_opencl_tpu_torch.ops import fused_block
from vit_with_opencl_tpu_torch.scripts import (bench_train, make_fixtures,
                                               probe_midsize, probe_tiny_bound,
                                               probe_w8a8_overlap, recipe_smoke,
                                               soak, soak_serve, trace_table)

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


@pytest.mark.parametrize("quant", ["none", "int8-w8a8"])
def test_soak_serve_answers_through_the_socket(quant, capsys):
    """Two clients pump uint8 payloads at the daemon for a second: every
    request answered, no failed batch, the daemon counts what was served."""
    res = soak_serve.main([TINY, "2", "1", "2", quant], device="cpu")
    assert res["images"] > 0 and res["requests"] == res["images"]  # 1 a request
    assert res["img_per_s"] > 0 and 0 < res["p50_ms"] <= res["max_ms"]
    # p99 only where the window answered 100 requests or more.
    assert (res["p99_ms"] is None) == (res["requests"] < 100)
    if res["p99_ms"] is not None:
        assert res["p50_ms"] <= res["p99_ms"] <= res["max_ms"]
    assert res["stats"]["batch_errors"] == 0
    assert res["stats"]["images_served"] >= res["images"]
    out = capsys.readouterr().out
    assert "img/s through the socket" in out and "daemon stats: " in out


@pytest.mark.parametrize("n, shown", [(1, {}), (2, {50: 1.0}), (19, {50: 9.0}),
                                      (20, {50: 10.0, 95: 19.0}),
                                      (99, {50: 49.0, 95: 94.0}),
                                      (100, {50: 50.0, 95: 95.0, 99: 99.0})])
def test_soak_serve_prints_a_percentile_only_where_the_sample_holds_it(n, shown):
    """p50 needs 2 requests, p95 20, p99 100: at least one request lies
    above the percentile."""
    lat = np.arange(n, dtype=np.float64)
    assert {q: soak_serve.percentile_ms(lat, q) for q in (50, 95, 99)} == \
        {q: shown.get(q) for q in (50, 95, 99)}


def test_soak_serve_window_closes_at_its_request_count():
    """``load`` with ``requests`` ends once that many are answered, long
    before its time limit."""
    params = fixtures.random_params(get_config(TINY), seed=0, scale=0.05)
    engine = InferenceEngine(get_config(TINY), params, batch_size=2,
                             device="cpu", normalize_uint8=True)
    srv = serve.InferenceServer(engine, port=0, max_wait_ms=1.0)
    srv.start_background()
    try:
        images = np.zeros((1, 3, 224, 224), np.uint8)
        t0 = time.perf_counter()
        res = soak_serve.load(srv.address[1], images, 2, 120.0, requests=5)
        assert time.perf_counter() - t0 < 60
    finally:
        srv.shutdown()
    # The clients' requests in flight when the fifth answer comes are answered too.
    assert res["requests"] >= 5 and res["images"] == res["requests"]
    assert res["p99_ms"] is None and res["p50_ms"] is not None


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


# The ids keep the ROADMAP items these refusals once named; the messages now
# name the module. AUG=1 (the augment pipeline) and TUNE=1 (the autotune
# cache's train entry, from a cache of the test's own) are ported: they must
# run.
@pytest.mark.parametrize("env,impls,refusal", [
    ({"TUNE": "1"}, "fused", None),
    ({"AUG": "1"}, "fused", None),
    ({}, "fused_split4", "parallel/split_step"),
    ({}, "flash,flash_split", "parallel/split_step"),
], ids=["env0-fused-item 6", "env1-fused-item 3", "env2-fused_split4-item 8",
        "env3-flash,flash_split-item 8"])
def test_bench_train_refuses_what_is_not_ported(monkeypatch, tmp_path, env, impls,
                                               refusal):
    monkeypatch.setenv("VIT_TORCH_TUNING", str(tmp_path / "tuning.json"))
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    if refusal is None:
        assert math.isfinite(bench_train.main([TINY, "2", "1", impls],
                                              device="cpu")["fused"]["loss"])
        return
    with pytest.raises(NotImplementedError, match=refusal) as exc:
        bench_train.main([TINY, "2", "1", impls], device="cpu")
    assert "item" not in str(exc.value)


def test_bench_train_augment_probe(monkeypatch, capsys):
    """AUG=1: the host pipeline's img/s (1 producer, both mix placements,
    and a pool), the on-card pipeline's ms a batch, each route's verdict."""
    monkeypatch.setenv("AUG", "1")
    monkeypatch.setattr(os, "cpu_count", lambda: 2)
    res = bench_train.main([TINY, "2", "1", "xla"], device="cpu")
    aug = res["augment"]
    assert aug["workers"] == 2 and aug["pool_img_per_s"] > 0
    assert set(aug["host_img_per_s"]) == {"host", "device"}
    assert aug["device_augment_ms"] > 0 and aug["device_mixup_ms"] > 0
    out = capsys.readouterr().out
    for line in ("augment(mix=host  , workers=1)", "augment(mix=device, workers=2)",
                 "device_augment: ", "  vs xla   ", "the pipeline on the CPU adds"):
        assert line in out
    assert "feeds the CPU" in out or "STARVES the CPU" in out


def test_recipe_smoke_on_cpu(capsys):
    """The recipe (raw uint8 → on-card augment + mixup → AdamW + EMA → the
    EMA export) on the plain versions: finite, and its prints."""
    res = recipe_smoke.main([TINY, "2", "1", "fused"], device="cpu")
    assert math.isfinite(res["loss"]) and res["export_files"] > 100
    assert res["staged_recipe_ms"] > 0 and res["staged_bare_ms"] > 0
    out = capsys.readouterr().out
    for line in ("recipe step (augment + mixup + EMA on the CPU)",
                 "bare step (pre-normalized fp32 in)", "EMA shadow: ",
                 "the pipeline on the CPU: "):
        assert line in out


@pytest.mark.parametrize("script,argv", [
    (soak, [TINY, "2", "1", "1"]),
    (soak_serve, [TINY, "2", "1", "1"]),
    (trace_table, [TINY, "1", "1"]),
    (bench_train, [TINY, "2", "1", "xla"]),
    (make_fixtures, ["--out", "unused", "--config", TINY]),
    (probe_w8a8_overlap, []),
    (recipe_smoke, [TINY, "2", "1"]),
    (probe_tiny_bound, ["2", "1", TINY]),
    (probe_midsize, ["vit_s_16_224", "2", "1"]),
])
def test_scripts_need_a_card_unless_cpu_is_asked(monkeypatch, tmp_path, script, argv):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        script.main(argv)
    assert not (tmp_path / "unused").exists()


PROBE_CFG = dict(name="probe_small", img_size=32, patch_size=8, embed_dim=64,
                 depth=2, num_heads=4, num_classes=9)


def _jax_labels(name: str) -> set:
    """The labels (the text before " : ") of the JAX script's printed lines."""
    import re

    text = (REPO / "scripts" / f"{name}.py").read_text()
    return set(re.findall(r'print\(f"([A-Za-z ]+?)\s*:', text))


@pytest.mark.parametrize("quant", [None, "int8-w8a8"])
def test_probe_tiny_bound_prints_the_jax_lines(monkeypatch, capsys, quant):
    from vit_with_opencl_tpu_torch import ViTConfig

    monkeypatch.setattr(probe_tiny_bound, "config_for",
                        lambda name: ViTConfig(**PROBE_CFG))
    res = probe_tiny_bound.main(["2", "1", TINY] + ([quant] if quant else []),
                                device="cpu")
    out = capsys.readouterr().out
    labels = {line.split(":")[0].strip() for line in out.splitlines() if ":" in line}
    want = _jax_labels("probe_tiny_bound")
    if quant is None:
        want.discard("quantize share")
    assert want and want == labels
    assert res["total_ms"] > 0 and res["skeleton_tflops"] > 0
    assert ("quantize_share" in res) == (quant == "int8-w8a8")
    for key in ("gelu_share", "softmax_share", "vpu_share"):
        assert 0.0 <= res[key] <= 1.0
    with pytest.raises(SystemExit, match="unknown quant"):
        probe_tiny_bound.main(["2", "1", TINY, "fp8"], device="cpu")


def test_probe_tiny_bound_d512_is_the_jax_preset():
    cfg = probe_tiny_bound.config_for("d512")
    assert (cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.img_size) == (512, 12, 8, 224)


def test_probe_midsize_runs_every_variant(monkeypatch, capsys):
    """Each variant's line (the JAX script's format), ``fusedipc*`` refused
    as FAILED with its reason while the run goes on, the patched routing
    restored."""
    from vit_with_opencl_tpu_torch import ViTConfig

    monkeypatch.setattr(probe_midsize, "config_for", lambda name: ViTConfig(**PROBE_CFG))
    real = (fused_block.supports, fused_block.supports_stack,
            fused_block.fused_encoder_layer)
    variants = ["perop", "fused", "fusedflat", "int8perop", "int8fused", "fusedipc1",
                "group2", "stack", "fusedipc4"]
    res = probe_midsize.main(["vit_s_16_224", "2", "1", ",".join(variants)], device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("probe_small bs2 (")
    assert (fused_block.supports, fused_block.supports_stack,
            fused_block.fused_encoder_layer) == real
    for label in variants:
        line = next(x for x in out if x.startswith(f"  {label:6s}: "))
        if label.startswith("fusedipc"):
            assert res[label] is None
            assert "FAILED NotImplementedError" in line and "grid" in line
        else:
            assert res[label] > 0
            assert "ms/batch" in line and "img/s" in line and "TF/s" in line
    with pytest.raises(SystemExit, match="unknown variants"):
        probe_midsize.main(["vit_s_16_224", "2", "1", "fusedX"], device="cpu")
