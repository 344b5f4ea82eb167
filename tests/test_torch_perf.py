"""The port's perf tools against the JAX package's, on the CPU:
``profile_ops`` (stage names and calls per image under ``xla`` and
``flash``), the text of ``format_profile`` and ``format_kernel_table`` for
the same spans, ``throughput_report``'s arithmetic, ``device_kernel_table``
parsed from a real ``torch.profiler`` trace of CPU tensors (the mirror of
``tests/test_perf.py::test_device_kernel_table_from_trace``), and ``trace``.

Times here are CPU times, asserted only to be non-negative.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    # The xdist workers share the host's cores: one torch thread each.
    torch.set_num_threads(1)

from vit_with_opencl_tpu import config as jconfig
from vit_with_opencl_tpu import perf as jperf
from vit_with_opencl_tpu.harness import fixtures as jfixtures
from vit_with_opencl_tpu.models import vit as jvit
from vit_with_opencl_tpu.perf import kernel_trace as jkernel_trace
from vit_with_opencl_tpu_torch import ViTConfig, perf
from vit_with_opencl_tpu_torch.models import vit
from vit_with_opencl_tpu_torch.ops import attention
from vit_with_opencl_tpu_torch.perf import kernel_trace, profiler

KW = dict(name="perf_small", img_size=32, patch_size=8, embed_dim=64, depth=2,
          num_heads=4, num_classes=11)
CFG, JCFG = ViTConfig(**KW), jconfig.ViTConfig(**KW)
STAGES = ["patch_embed(+cls+pos)", "layer_norm", "qkv_proj", "attention_core",
          "out_proj", "mlp_fc1_gelu", "mlp_fc2", "head+softmax"]


@pytest.fixture(scope="module")
def setup():
    params = jfixtures.random_params(JCFG, seed=0)
    images = jfixtures.random_images(JCFG, n=4, seed=0)
    stacked = jvit.stack_params(params, JCFG, param_dtype=jnp.float32)
    return stacked, images


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_profile_ops_stages_match_jax(setup, impl):
    """The same stages, in the same order, with the same calls per image
    (``flash`` times the packed kernel the engine uses); the generic slot's
    call before timing runs ``flash_attention`` on CPU tensors, so nothing
    launches."""
    stacked, images = setup
    jstages = jperf.profile_ops(JCFG, stacked, jnp.asarray(images),
                                compute_dtype=jnp.float32,
                                attention_impl=impl, iters=1)
    before = (attention.LAUNCHES, attention.LAUNCHES_SINGLE)
    stages = perf.profile_ops(CFG, vit.params_from_jax(stacked, device="cpu"),
                              torch.from_numpy(images),
                              compute_dtype=torch.float32,
                              attention_impl=impl, iters=1)
    assert (attention.LAUNCHES, attention.LAUNCHES_SINGLE) == before
    pairs = [(s.name, s.calls_per_image) for s in stages]
    assert pairs == [(s.name, s.calls_per_image) for s in jstages]
    want = [n + "(packed)" if n == "attention_core" and impl == "flash" else n
            for n in STAGES]
    assert [name for name, _ in pairs] == want
    assert dict(pairs)["layer_norm"] == 2 * CFG.depth + 1
    assert all(s.per_call_ms >= 0 for s in stages)


def test_format_profile_is_jax_s_text():
    spans = [("patch_embed(+cls+pos)", 1, 0.51234), ("layer_norm", 25, 0.0123),
             ("a_much_longer_stage_name_than_24", 12, 12.5)]
    got = perf.format_profile([perf.OpProfile(*s) for s in spans], batch=64)
    want = jperf.format_profile([jperf.OpProfile(*s) for s in spans], batch=64)
    assert got == want
    assert perf.OpProfile(*spans[1]).per_image_total_ms == pytest.approx(25 * 0.0123)


@pytest.mark.parametrize("iters", [1, 3])
def test_format_kernel_table_is_jax_s_text(iters):
    """Demangled CUDA names run long; both truncate at 47 characters."""
    spans = [("void vit::single::single_pass_bf16_kernel<64>(__nv_bfloat16 "
              "const*, __nv_bfloat16 const*)", 36, 1.2345),
             ("void vit::layernorm_kernel<float, __nv_bfloat16>", 24, 0.25),
             ("short", 3, 0.001)]
    got = perf.format_kernel_table([perf.KernelSpan(*s) for s in spans],
                                   iters=iters)
    want = jkernel_trace.format_kernel_table(
        [jkernel_trace.KernelSpan(*s) for s in spans], iters=iters)
    assert got == want
    assert perf.KernelSpan("x", 0, 1.0).avg_ms == 1.0


def test_throughput_report_matches_jax_arithmetic():
    """JAX's keys and arithmetic against the card's dense bf16 peak (989
    TFLOP/s, the H100 SXM's) instead of a TPU's."""
    got = perf.throughput_report(CFG, batch=8, elapsed_s=2.0, iters=10)
    want = jperf.throughput_report(JCFG, batch=8, elapsed_s=2.0, iters=10,
                                   tpu_gen="v5e")
    assert set(got) == set(want)
    for key in ("images_per_sec", "gflop_per_image", "achieved_tflops"):
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    peak = profiler.PEAK_BF16_TFLOPS["h100"]
    assert peak == 989.0
    assert got["mfu"] == pytest.approx(got["achieved_tflops"] / peak)
    assert got["roofline_images_per_sec"] == pytest.approx(
        peak * 1e3 / got["gflop_per_image"])
    with pytest.raises(ValueError, match="gpu"):
        perf.throughput_report(CFG, 8, 2.0, 10, gpu="v5e")


def test_device_kernel_table_from_trace(tmp_path):
    """Per-kernel table parsed from a real ``torch.profiler`` trace: on CPU
    tensors there are no kernels, so it degrades to the host op spans, as
    JAX's degrades on a CPU backend."""

    def f(a, b):
        return torch.tanh(a @ b).sum(dim=0)

    a = torch.ones((256, 256))
    b = torch.ones((256, 256))
    table = perf.device_kernel_table(f, (a, b), iters=2, trace_dir=str(tmp_path))
    assert table, "no events parsed from the profiler trace"
    assert all(s.total_ms >= 0 and s.calls >= 1 for s in table)
    totals = [s.total_ms for s in table]
    assert totals == sorted(totals, reverse=True)
    text = perf.format_kernel_table(table, iters=2)
    assert "kernel" in text and "avg ms" in text
    assert table[0].name.split("(")[0][:12] in text
    assert any("mm" in s.name and s.calls == 2 for s in table)
    assert os.path.isfile(tmp_path / "trace.json")
    assert perf.device_kernel_table(f, (a, b), iters=1, top=2).__len__() <= 2


def test_kernel_events_on_the_card_or_none():
    """On the card only spans of category ``kernel`` count, and a trace
    without them raises rather than report host op times."""
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 5.0},
              {"ph": "X", "cat": "kernel", "name": "void k<64>()", "dur": 2.5},
              {"ph": "X", "cat": "kernel", "name": "void k<64>()", "dur": 0},
              {"ph": "M", "name": "process_name"}]
    assert kernel_trace._select_events(events, on_card=True) == [events[1]]
    assert kernel_trace._select_events(events, on_card=False) == events[:2]
    with pytest.raises(RuntimeError, match="no kernel events"):
        kernel_trace._select_events(events[:1], on_card=True)


@pytest.mark.parametrize("on_card", [True, False])
def test_marks_fence_the_traced_runs(on_card):
    """Only the events between the two marks count; a trace that lost a
    mark (the tracer dropped events at an edge of its window) raises."""
    if on_card:
        mark = {"ph": "X", "cat": "kernel", "dur": 1.0,
                "name": "void at::cuda::(anonymous namespace)::spin_kernel(long)"}
    else:
        mark = {"ph": "X", "cat": "user_annotation", "dur": 1.0,
                "name": kernel_trace._MARK}
    k = {"ph": "X", "cat": "kernel", "name": "void k<64>()", "dur": 2.0}
    events = [dict(k, ts=0.0), dict(mark, ts=3.0), dict(k, ts=4.0),
              dict(k, ts=7.0), dict(mark, ts=9.0), dict(k, ts=10.0),
              {"ph": "M", "name": "process_name"}]
    assert kernel_trace._between_marks(events, on_card) == events[2:4]
    with pytest.raises(RuntimeError, match="1 of its 2 marks"):
        kernel_trace._between_marks(events[2:], on_card)


def test_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    with perf.trace(str(tmp_path), device="cpu") as d:
        torch.ones(8, 8) @ torch.ones(8, 8)
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        with perf.trace(str(tmp_path / "card")):
            pass


def test_tensors_in_walks_nested_args():
    a, b, c = torch.ones(1), torch.ones(2), torch.ones(3)
    found = list(kernel_trace.tensors_in((a, {"x": [b, {"y": c}]}, 3, "s")))
    assert [t.numel() for t in found] == [1, 2, 3]
    assert np.isclose(profiler._time_op(lambda x: x + 1, (a,), 2), 0, atol=1e3)
