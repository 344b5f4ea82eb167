"""The port's overlap probe against the JAX script's kernels, on the CPU.

Each of the probe's kernels (``scripts/probe_w8a8_overlap.py``: stream,
vpu:q, vpu:ln, mxu, fused, and indep with vpu_op "quant" and "ln") runs
through the JAX script's own kernel body in ``pl.pallas_call(...,
interpret=True)`` with the ``BlockSpec``s of its ``main()``, at a grid of 2
blocks and N = 256; the port's wrapper gets the same inputs as CPU tensors,
where it computes its plain version (no launch). Two kinds of input: the
script's own data (degenerate: every row of x alike, xq constant along each
row, w constant along N) and seeded random data, on which a swapped index
or a transposed tile would show.

Tolerances: the int8 values, the scales, the stream's output and the
GEMMs' bf16 outputs are bit-identical (the same IEEE operations in the same
order; the int8 sums are exact). The LN's bf16 outputs come from fp32 sums
taken in another order, so they are within one bf16 ulp (near 0, one fp32
ulp of their unit scale) and at least 99% bit-identical.
"""

import functools
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    # The xdist workers share the host's cores: one torch thread each.
    torch.set_num_threads(1)

from jax.experimental import pallas as pl

from vit_with_opencl_tpu_torch.scripts import probe_w8a8_overlap as probe

REPO = Path(__file__).resolve().parent.parent
GRID = 2
N = 256
MIN_SAME_LN = 0.99
FORMS = ("stream", "vpu:q", "vpu:ln", "mxu", "fused", "indep:q", "indep:ln")
COUNTERS = [f.counter for f in probe.FORMS.values()]


@pytest.fixture(scope="module")
def jprobe():
    """The JAX script, imported by path (scripts/ is no package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_probe_w8a8_overlap", REPO / "scripts" / "probe_w8a8_overlap.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def no_launches():
    before = [getattr(probe, c) for c in COUNTERS]
    yield
    assert [getattr(probe, c) for c in COUNTERS] == before


def _data(jprobe, kind: str, seed: int = 20) -> dict:
    """numpy xf [rows, K] fp32, xq int8, w int8 [K, N], sw fp32 [1, N]."""
    rows = GRID * probe.M_BLOCK
    if kind == "probe":
        w = jnp.clip(jprobe._x_i8(probe.K, 3)[:, :1]
                     * jnp.ones((1, N), jnp.int8), -125, 125)
        return dict(xf=np.asarray(jprobe._x_f32(rows, 7)),
                    xq=np.asarray(jprobe._x_i8(rows, 11)),
                    w=np.asarray(w), sw=np.full((1, N), 3e-4, np.float32))
    rng = np.random.default_rng(seed)
    return dict(
        xf=rng.normal(0.0, 2.0, (rows, probe.K)).astype(np.float32),
        xq=rng.integers(-127, 128, (rows, probe.K)).astype(np.int8),
        w=rng.integers(-127, 128, (probe.K, N)).astype(np.int8),
        sw=rng.uniform(1e-4, 1e-3, (1, N)).astype(np.float32))


def _jax_form(jprobe, form: str, d: dict):
    """The JAX kernel of ``form`` in interpret mode, main()'s BlockSpecs."""
    mb, k = probe.M_BLOCK, probe.K
    xf_spec = pl.BlockSpec((mb, k), jprobe._block)
    res = functools.partial(pl.BlockSpec, index_map=jprobe._resident)

    def sds(shape, dtype):
        return jax.ShapeDtypeStruct(shape, dtype)

    gemm_in = [res((k, N)), res((1, N))]
    i8, f32, bf16 = jnp.int8, jnp.float32, jnp.bfloat16
    table = {
        "stream": (jprobe._k_stream, [xf_spec], res((8, 128)),
                   sds((8, 128), f32), ["xf"]),
        "vpu:q": (jprobe._k_vpu_quant, [xf_spec], (res((mb, k)), res((mb, 1))),
                  (sds((mb, k), i8), sds((mb, 1), f32)), ["xf"]),
        "vpu:ln": (jprobe._k_vpu_ln, [xf_spec], res((mb, k)),
                   sds((mb, k), bf16), ["xf"]),
        "mxu": (jprobe._k_mxu, [xf_spec] + gemm_in, res((mb, N)),
                sds((mb, N), bf16), ["xq", "w", "sw"]),
        "fused": (jprobe._k_fused, [xf_spec] + gemm_in, res((mb, N)),
                  sds((mb, N), bf16), ["xf", "w", "sw"]),
    }
    for op, form_name, oq_dtype in (("quant", "indep:q", i8),
                                    ("ln", "indep:ln", bf16)):
        table[form_name] = (
            functools.partial(jprobe._k_indep, vpu_op=op),
            [xf_spec, xf_spec] + gemm_in,
            (res((mb, k)), res((mb, 1)), res((mb, N))),
            (sds((mb, k), oq_dtype), sds((mb, 1), f32), sds((mb, N), bf16)),
            ["xf", "xq", "w", "sw"])
    kernel, in_specs, out_specs, out_shape, names = table[form]
    out = pl.pallas_call(kernel, grid=(GRID,), in_specs=in_specs,
                         out_specs=out_specs, out_shape=out_shape,
                         interpret=True)(*(jnp.asarray(d[n]) for n in names))
    return [np.asarray(o.astype(jnp.float32) if o.dtype == bf16 else o)
            for o in (out if isinstance(out, tuple) else (out,))]


def _port_form(form: str, d: dict):
    t = {key: torch.from_numpy(np.array(v)) for key, v in d.items()}
    return [o.float().numpy() if o.dtype == torch.bfloat16 else o.numpy()
            for o in probe.run(form, t)]


def _within_one_bf16_ulp(out: np.ndarray, ref: np.ndarray) -> None:
    """One bf16 ulp of the plain value. Where x is within rounding of the
    row's mean, the output is near 0 and carries the mean's fp32 rounding
    in absolute terms: there the ulp is floored at one fp32 ulp of 1.0 (LN
    outputs are of unit scale)."""
    _, exp = np.frexp(np.abs(ref))
    ulp = np.maximum(np.ldexp(np.ones_like(ref), exp - 8),  # bf16: 8 bits
                     np.float32(2.0 ** -23))
    assert (np.abs(out - ref) <= ulp).all(), float(np.abs(out - ref).max())
    assert (out == ref).mean() >= MIN_SAME_LN, (out == ref).mean()


@pytest.mark.parametrize("kind", ["probe", "random"])
@pytest.mark.parametrize("form", FORMS)
def test_form_matches_the_jax_kernel(jprobe, form, kind, no_launches):
    d = _data(jprobe, kind)
    refs, outs = _jax_form(jprobe, form, d), _port_form(form, d)
    assert len(outs) == len(refs)
    for i, (out, ref) in enumerate(zip(outs, refs)):
        assert out.shape == ref.shape and out.dtype == ref.dtype, (i, out.dtype)
        if form.endswith("ln") and i == 0:
            _within_one_bf16_ulp(out, ref)
        else:
            np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("form", FORMS)
def test_only_the_last_block_reaches_the_outputs(jprobe, form, no_launches):
    d = _data(jprobe, "random")
    base = _port_form(form, d)
    other = _data(jprobe, "random", seed=21)
    first = {key: v.copy() for key, v in d.items()}
    last = {key: v.copy() for key, v in d.items()}
    for key in ("xf", "xq"):
        first[key][:probe.M_BLOCK] = other[key][:probe.M_BLOCK]
        last[key][-probe.M_BLOCK:] = other[key][-probe.M_BLOCK:]
    for out, ref in zip(_port_form(form, first), base):
        np.testing.assert_array_equal(out, ref)
    moved = [not np.array_equal(out, ref)
             for out, ref in zip(_port_form(form, last), base)]
    assert all(moved), moved


def test_generators_match_jax(jprobe, monkeypatch):
    for rows, salt in ((16, 7), (3, 0)):
        np.testing.assert_array_equal(probe._x_f32(rows, salt).numpy(),
                                      np.asarray(jprobe._x_f32(rows, salt)))
    for rows, salt in ((300, 11), (768, 3)):
        np.testing.assert_array_equal(probe._x_i8(rows, salt).numpy(),
                                      np.asarray(jprobe._x_i8(rows, salt)))
    monkeypatch.setattr(probe, "N", N)
    w, sw = probe.weights()
    np.testing.assert_array_equal(w.numpy(), _data(jprobe, "probe")["w"])
    assert sw.dtype == torch.float32 and (sw == np.float32(3e-4)).all()


def test_int8_generator_wraps_as_jax_int32(jprobe, monkeypatch):
    """``iota * 16807 + salt`` overflows int32 from row 127,774 on; the
    port's generator gives JAX's values at all 262,144 rows of the probe."""
    monkeypatch.setattr(jprobe, "K", 1)
    monkeypatch.setattr(probe, "K", 1)
    rows = probe.GRID * probe.M_BLOCK
    ref = np.asarray(jprobe._x_i8(rows, 11))
    out = probe._x_i8(rows, 11).numpy()
    assert out.shape == ref.shape == (rows, 1)
    np.testing.assert_array_equal(out, ref)
    plain = ((np.arange(rows, dtype=np.int64) * 16807 + 11) % 251 - 125)
    assert (plain[127774:] != ref[127774:, 0]).any()  # the wrap matters


def test_bounds_at_the_probe_size():
    rows = probe.GRID * probe.M_BLOCK
    for form in ("stream", "vpu:q", "vpu:ln"):
        ms, by = probe.bound(*probe.work(form, rows))
        assert by == "bytes" and 0.2403 < ms < 0.2410, (form, ms)
    for form in ("mxu", "fused", "indep:q", "indep:ln"):
        ms, by = probe.bound(*probe.work(form, rows))
        assert by == "operations" and abs(ms - 0.6250) < 1e-4, (form, ms)
    assert probe.work("indep:q", rows)[0] > 1006.6e6  # xa and xqb alone


def test_main_needs_a_card_unless_cpu_is_asked(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.main([])
    for name, value in (("GRID", 2), ("N", 256), ("REPS", 1), ("CHAIN", 1)):
        monkeypatch.setattr(probe, name, value)
    times = probe.main([], device="cpu")
    assert set(times) == set(FORMS) == set(probe.FORMS)
    assert all(t > 0 for t in times.values())
    out = capsys.readouterr().out.splitlines()
    starts = ["device: cpu", "card:", "stream", "vpu:q", "vpu:ln", "mxu",
              "fused", "indep   (vpu:q", "indep   (vpu:ln", "",
              "fused vs mxu+vpu:q serial sum"]
    assert len(out) == len(starts)
    for line, start in zip(out, starts):
        assert line.startswith(start), (line, start)
