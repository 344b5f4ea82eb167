"""The port's checkpoint converters (``io/export``) against the JAX
package's, on the CPU.

Mirrors ``tests/test_export.py`` on synthetic state dicts built from seeded
params (no real checkpoint is downloaded): torchvision and HuggingFace
naming through both packages' converters give the same arrays, the exported
``Weight_*.bin`` files are byte-identical to JAX's ``export_weights``,
``main --from-pth`` turns a ``torch.save``d checkpoint into a directory the
port's CLI reads, and ``export_from_pretrained`` refuses without a local
cache, as JAX's does.
"""

import os
import sys

import numpy as np
import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    # The xdist workers share the host's cores: one torch thread each.
    torch.set_num_threads(1)

from vit_with_opencl_tpu import ViTConfig as JViTConfig
from vit_with_opencl_tpu.harness import fixtures as jfixtures
from vit_with_opencl_tpu.io import export as jexport
from vit_with_opencl_tpu_torch import ViTConfig, cli
from vit_with_opencl_tpu_torch import config as config_lib
from vit_with_opencl_tpu_torch.harness import results
from vit_with_opencl_tpu_torch.io import binfmt, export
from vit_with_opencl_tpu_torch.models import golden

CFG_KW = dict(name="exp_small", img_size=32, patch_size=8, embed_dim=48, depth=2,
              num_heads=4, num_classes=9)
JCFG, CFG = JViTConfig(**CFG_KW), ViTConfig(**CFG_KW)


@pytest.fixture(scope="module")
def named_params():
    return jfixtures.random_params(JCFG, seed=4, scale=0.05)


def _tensors(state):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()}


def _hf_state(params, prefix="vit."):
    """HuggingFace ViTForImageClassification naming: q, k and v apart."""
    d = CFG.embed_dim
    state = {
        "embeddings.cls_token": params["class_token"].reshape(1, 1, d),
        "embeddings.patch_embeddings.projection.weight": params["conv_proj_weight"],
        "embeddings.patch_embeddings.projection.bias": params["conv_proj_bias"],
        "embeddings.position_embeddings":
            params["encoder_pos_embedding"].reshape(1, CFG.num_tokens, d),
        "layernorm.weight": params["encoder_ln_weight"],
        "layernorm.bias": params["encoder_ln_bias"],
    }
    for i in range(CFG.depth):
        src = f"encoder_layers_encoder_layer_{i}_"
        dst = f"encoder.layer.{i}."
        in_w = params[src + "self_attention_in_proj_weight"]
        in_b = params[src + "self_attention_in_proj_bias"]
        for j, name in enumerate(("query", "key", "value")):
            state[dst + f"attention.attention.{name}.weight"] = in_w[j * d:(j + 1) * d]
            state[dst + f"attention.attention.{name}.bias"] = in_b[j * d:(j + 1) * d]
        for hf, ref in (("attention.output.dense", "self_attention_out_proj"),
                        ("layernorm_before", "ln_1"), ("layernorm_after", "ln_2"),
                        ("intermediate.dense", "mlp_0"), ("output.dense", "mlp_3")):
            state[dst + hf + ".weight"] = params[src + ref + "_weight"]
            state[dst + hf + ".bias"] = params[src + ref + "_bias"]
    state = {prefix + k: v for k, v in state.items()}
    state["classifier.weight"] = params["heads_head_weight"]
    state["classifier.bias"] = params["heads_head_bias"]
    return state


def _assert_same(got, want):
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == np.float32
        np.testing.assert_array_equal(got[name], want[name])


def test_to_torchvision_state_dict_matches_jax(named_params):
    got = export.to_torchvision_state_dict(named_params, CFG)
    _assert_same(got, jexport.to_torchvision_state_dict(named_params, JCFG))


@pytest.mark.parametrize("as_tensors", [True, False], ids=["tensors", "arrays"])
def test_torchvision_converter_matches_jax(named_params, as_tensors):
    state = export.to_torchvision_state_dict(named_params, CFG)
    if as_tensors:
        state = _tensors(state)
    got = export.from_torchvision_state_dict(state, CFG)
    _assert_same(got, jexport.from_torchvision_state_dict(state, JCFG))
    _assert_same(got, named_params)


@pytest.mark.parametrize("prefix", ["vit.", ""], ids=["classifier", "tower"])
def test_hf_converter_matches_jax(named_params, prefix):
    state = _hf_state(named_params, prefix)
    got = export.from_hf_state_dict(_tensors(state), CFG)
    _assert_same(got, jexport.from_hf_state_dict(state, JCFG))
    _assert_same(got, named_params)


def test_bf16_tensors_convert_to_their_fp32_values(named_params):
    """The port's ``_np`` takes a tensor of any float dtype."""
    state = {k: v.to(torch.bfloat16) for k, v in
             _tensors(export.to_torchvision_state_dict(named_params, CFG)).items()}
    got = export.from_torchvision_state_dict(state, CFG)
    want = export.from_torchvision_state_dict(
        {k: v.float().numpy() for k, v in state.items()}, CFG)
    _assert_same(got, want)
    assert not np.array_equal(got["conv_proj_weight"], named_params["conv_proj_weight"])


def test_exported_files_are_jaxs_bytes(named_params, tmp_path):
    files = export.export_weights(named_params, tmp_path / "port", CFG)
    jfiles = jexport.export_weights(named_params, tmp_path / "jax", JCFG)
    assert files == jfiles and files[0] == "Weight_0_class_token.bin"
    assert sorted(os.listdir(tmp_path / "port")) == sorted(files)
    for name in files:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


@pytest.mark.parametrize("corrupt", ["shape", "missing"])
def test_export_validates_as_jax(named_params, corrupt):
    state = export.to_torchvision_state_dict(named_params, CFG)
    if corrupt == "shape":
        state["conv_proj.weight"] = state["conv_proj.weight"][:, :2]
        err = ValueError
    else:
        del state["encoder.ln.weight"]
        err = KeyError
    with pytest.raises(err) as port_err:
        export.from_torchvision_state_dict(state, CFG)
    with pytest.raises(err) as jax_err:
        jexport.from_torchvision_state_dict(state, JCFG)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("naming", ["torchvision", "hf", "wrapped"])
def test_main_from_pth_feeds_the_cli(named_params, naming, tmp_path, monkeypatch,
                                     capsys):
    """``main --from-pth``: torchvision or HF naming found by itself (also
    under a ``state_dict`` key); the files are JAX's export's bytes, and the
    port's CLI on them matches the golden model's answer."""
    monkeypatch.setitem(config_lib.PRESETS, CFG.name, CFG)
    if naming == "hf":
        state = _tensors(_hf_state(named_params))
    else:
        state = _tensors(export.to_torchvision_state_dict(named_params, CFG))
        if naming == "wrapped":
            state = {"state_dict": state}
    torch.save(state, tmp_path / "ckpt.pth")
    assert export.main(["--config", CFG.name, "--out", str(tmp_path / "Network"),
                        "--from-pth", str(tmp_path / "ckpt.pth")]) == 0
    assert f"wrote {len(binfmt.weight_names(CFG))} weight files" in capsys.readouterr().out
    jexport.export_weights(named_params, tmp_path / "jax", JCFG)
    for name in os.listdir(tmp_path / "jax"):
        assert (tmp_path / "Network" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    images = jfixtures.random_images(JCFG, n=3, seed=6)
    binfmt.save_image_data(tmp_path / "input.bin", images)
    rounded = {k: binfmt.round_6dp(v) for k, v in named_params.items()}
    results.write_results(tmp_path / "answer.txt",
                          golden.golden_forward(images, rounded, CFG))
    rc = cli.main(["--input", str(tmp_path / "input.bin"), "--weights",
                   str(tmp_path / "Network"), "--output", str(tmp_path / "result.txt"),
                   "--answer", str(tmp_path / "answer.txt"), "--config", CFG.name,
                   "--backend", "gpu", "--device", "cpu", "--batch-size", "2"])
    assert rc == 0 and "Comparator: files match." in capsys.readouterr().out


class _UncachedHub:
    """Stands in for ``transformers`` in these tests (nothing is imported or
    fetched): ``from_pretrained`` finds no local file, as for an uncached
    checkpoint, and records how it was asked."""

    calls: list = []

    class AutoModelForImageClassification:
        @staticmethod
        def from_pretrained(name, **kw):
            _UncachedHub.calls.append((name, kw))
            raise OSError(f"{name} is not in the cache")


@pytest.mark.parametrize("hub", ["uncached", "no_transformers"])
def test_export_from_pretrained_refuses_offline(hub, tmp_path, monkeypatch):
    """Only a local HuggingFace cache is read (``local_files_only=True``):
    an uncached id raises a RuntimeError, as JAX's export does, and so does
    a missing ``transformers``; ``main --from-pretrained`` raises it too, and
    nothing is written."""
    monkeypatch.setitem(sys.modules, "transformers",
                        _UncachedHub if hub == "uncached" else None)
    monkeypatch.setattr(_UncachedHub, "calls", [])
    name = "google/vit-definitely-not-cached"
    match = "local HF cache" if hub == "uncached" else "transformers not available"
    with pytest.raises(RuntimeError, match=match):
        export.export_from_pretrained(name, tmp_path / "port", CFG)
    with pytest.raises(RuntimeError, match=match):
        jexport.export_from_pretrained(name, tmp_path / "jax", JCFG)
    with pytest.raises(RuntimeError, match=match):
        export.main(["--config", "vit_tiny_16_224", "--out", str(tmp_path / "cli"),
                     "--from-pretrained", name])
    if hub == "uncached":
        assert _UncachedHub.calls == [(name, {"local_files_only": True})] * 3
    assert not any((tmp_path / d).exists() for d in ("port", "jax", "cli"))
