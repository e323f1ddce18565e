"""The port's ``load_model`` on sharded HuggingFace directories, against the
JAX package's ``load_model`` of the same directory.

The tiny synthetic HF model of ``model_utils`` is saved as two shards plus
an index (``pytorch_model.bin.index.json`` with ``.bin`` shards, or
``model.safetensors.index.json`` with ``.safetensors`` shards) and
``config.json``. The port's tree must equal the JAX package's, array for
array (the JAX tree converted by ``params_from_jax_tree``, which the port's
loader also ends in).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from model_utils import make_hf_model  # noqa: E402
from whisper_timestamped_tpu.models.load import load_model as jax_load_model  # noqa: E402
from whisper_timestamped_tpu_torch.models import WhisperDims, params_from_jax_tree  # noqa: E402
from whisper_timestamped_tpu_torch.models.load import load_model  # noqa: E402


def _save_sharded(model, directory, kind):
    """Two shards (the first half of the keys, then the rest) and the index
    that lists them, as ``save_pretrained`` writes a sharded checkpoint."""
    # cloned: the tied embedding and output projection share storage, which
    # safetensors refuses to save
    sd = {k: v.detach().contiguous().clone() for k, v in model.state_dict().items()}
    keys = sorted(sd)
    halves = [keys[: len(keys) // 2], keys[len(keys) // 2:]]
    ext = "safetensors" if kind == "safetensors" else "bin"
    stem = "model" if kind == "safetensors" else "pytorch_model"
    weight_map = {}
    for i, part in enumerate(halves, start=1):
        shard = f"{stem}-{i:05d}-of-00002.{ext}"
        tensors = {k: sd[k] for k in part}
        if kind == "safetensors":
            from safetensors.torch import save_file

            save_file(tensors, os.path.join(directory, shard))
        else:
            torch.save(tensors, os.path.join(directory, shard))
        weight_map.update({k: shard for k in part})
    index = {"metadata": {"total_size": 0}, "weight_map": weight_map}
    with open(os.path.join(directory, f"{stem}.{ext}.index.json"), "w") as f:
        json.dump(index, f)
    model.config.to_json_file(os.path.join(directory, "config.json"))


@pytest.mark.parametrize("kind", ["bin", "safetensors"])
def test_sharded_directory_loads_to_jax_tree(tmp_path, kind):
    hf = make_hf_model(seed=0)
    _save_sharded(hf, str(tmp_path), kind)
    assert not os.path.exists(tmp_path / "model.safetensors")
    assert not os.path.exists(tmp_path / "pytorch_model.bin")

    ref = jax_load_model(str(tmp_path))
    got = load_model(str(tmp_path), device="cpu")
    dims = WhisperDims(**ref.dims.__dict__)
    assert got.dims == dims
    assert got.alignment_heads == ref.alignment_heads
    want = params_from_jax_tree(jax.tree.map(np.asarray, ref.params), dims, device="cpu")
    for part in ("encoder", "decoder"):
        g, w = getattr(got.module, part), getattr(want, part)
        assert list(g.keys()) == list(w.keys())
        for k in g:
            np.testing.assert_array_equal(g[k].numpy(), w[k].numpy(), err_msg=f"{part}.{k}")


def test_empty_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="No model weights found"):
        load_model(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError, match="No model weights found"):
        jax_load_model(str(tmp_path))


def _assert_same_model(got, ref):
    dims = WhisperDims(**ref.dims.__dict__)
    assert got.dims == dims
    assert got.alignment_heads == ref.alignment_heads
    assert got.model_name == ref.model_name
    want = params_from_jax_tree(jax.tree.map(np.asarray, ref.params), dims, device="cpu")
    for part in ("encoder", "decoder"):
        g, w = getattr(got.module, part), getattr(want, part)
        assert list(g.keys()) == list(w.keys())
        for k in g:
            np.testing.assert_array_equal(g[k].numpy(), w[k].numpy(), err_msg=f"{part}.{k}")


def test_positional_download_root_as_in_jax(tmp_path):
    """The third positional argument is ``download_root`` in both packages:
    an official name resolves against it."""
    from model_utils import save_openai_pt

    save_openai_pt(make_hf_model(seed=0), str(tmp_path / "tiny.pt"))
    ref = jax_load_model("tiny", None, str(tmp_path))
    got = load_model("tiny", "cpu", str(tmp_path))
    _assert_same_model(got, ref)
    assert got.module.encoder["conv1_w"].dtype == torch.float32
    # the fourth is backend, the fifth dtype
    half = load_model("tiny", "cpu", str(tmp_path), "torch", torch.bfloat16)
    assert half.module.encoder["conv1_w"].dtype == torch.bfloat16


@pytest.mark.parametrize("backend", ["torch", "openai-whisper", "transformers"])
def test_backend_accepted(tmp_path, backend):
    from whisper_timestamped_tpu_torch.models.load import BACKENDS

    assert backend in BACKENDS
    hf = make_hf_model(seed=0)
    _save_sharded(hf, str(tmp_path), "safetensors")
    _assert_same_model(load_model(str(tmp_path), device="cpu", backend=backend),
                       jax_load_model(str(tmp_path)))


@pytest.mark.parametrize("backend", ["jax", "tpu", "ctranslate2", ""])
def test_unknown_backend_refused(tmp_path, backend):
    with pytest.raises(ValueError, match="Unsupported backend"):
        load_model(str(tmp_path), device="cpu", backend=backend)
