"""Checkpoint loading: OpenAI ``.pt`` files and HuggingFace Whisper directories.

Port of ``whisper_timestamped_tpu/models/load.py``. The state-dict
converters build the same numpy parameter tree as the JAX package (linears
``(in, out)``, convs ``(k, in, out)``, blocks stacked on a leading layer
axis); ``params_from_jax_tree`` turns such a tree, or the JAX package's own
parameters fetched as numpy, into a ``WhisperTorch`` on an explicit device
and dtype (the CUDA card unless another is named). Nothing is downloaded.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .alignment_heads import get_alignment_heads, heads_for_model_name, infer_model_name
from .whisper_torch import WhisperDims, WhisperTorch, sinusoids

OFFICIAL_MODELS = (
    "tiny.en", "tiny", "base.en", "base", "small.en", "small",
    "medium.en", "medium", "large-v1", "large-v2", "large-v3", "large",
    "large-v3-turbo", "turbo",
)


def available_models() -> Tuple[str, ...]:
    return OFFICIAL_MODELS


# ``_MODELS`` and ``_download`` are copied from ``models/load.py:36-60`` of
# the JAX package: drop-in analogs of ``whisper._MODELS`` and
# ``whisper._download`` that name the checkpoint file expected in the local
# cache and resolve against it; nothing is downloaded.
_MODELS = {name: f"{name}.pt" for name in OFFICIAL_MODELS}


def _download(url: str, root: str, in_memory: bool = False):
    """Cache-resolving analog of ``whisper._download``. Returns the cached
    checkpoint path (or its bytes when ``in_memory``); never touches the
    network."""
    path = os.path.join(root, os.path.basename(url))
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{os.path.basename(url)} not found under {root!r}. This framework "
            "does not download weights; place the checkpoint there or pass a "
            "local path to load_model()."
        )
    if in_memory:
        with open(path, "rb") as f:
            return f.read()
    return path


@dataclass
class WhisperModel:
    """A loaded model: the ``WhisperTorch`` module plus alignment metadata."""

    module: WhisperTorch
    alignment_heads: Optional[list] = None
    model_name: Optional[str] = None
    tokenizer_ranks: Optional[dict] = None  # byte->rank, when the checkpoint dir has one
    tokenizer_multilingual: Optional[bool] = None  # hint from the vocab filename

    @property
    def dims(self) -> WhisperDims:
        return self.module.dims

    @property
    def device(self) -> torch.device:
        return self.module.device

    @property
    def is_multilingual(self) -> bool:
        return self.dims.is_multilingual

    @property
    def num_languages(self) -> int:
        return self.dims.num_languages

    def to(self, *args, **kwargs) -> "WhisperModel":
        self.module.to(*args, **kwargs)
        return self


# ---------------------------------------------------------------------------
# numpy parameter tree -> WhisperTorch
# ---------------------------------------------------------------------------

_LINEARS = ("q", "k", "v", "o")


def params_from_jax_tree(tree: Dict[str, Any], dims: WhisperDims, device=None,
                         dtype=torch.float32) -> WhisperTorch:
    """Build a ``WhisperTorch`` from a JAX-layout parameter tree of numpy (or
    any array-like) leaves: linear ``w`` (L, in, out) becomes (L, out, in),
    conv ``w`` (k, in, out) becomes (out, in, k). Floating leaves are cast to
    ``dtype`` and placed on ``device``, None meaning the CUDA card
    (``default_device``, which raises without one). A tree without an
    encoder ``pos_emb`` (``init_params``') gets the fixed sinusoids, marked
    ``fixed_pos_emb`` so that training leaves them alone, as JAX does."""
    device = default_device(device)
    enc, dec = tree["encoder"], tree["decoder"]
    a = lambda x: np.asarray(x, np.float32)  # noqa: E731
    lin_w = lambda x: np.swapaxes(a(x), -1, -2)  # noqa: E731
    flat_enc = {
        "conv1_w": a(enc["conv1"]["w"]).transpose(2, 1, 0), "conv1_b": a(enc["conv1"]["b"]),
        "conv2_w": a(enc["conv2"]["w"]).transpose(2, 1, 0), "conv2_b": a(enc["conv2"]["b"]),
        "pos_emb": a(enc["pos_emb"]) if "pos_emb" in enc
        else sinusoids(dims.n_audio_ctx, dims.n_audio_state),
        "ln_post_g": a(enc["ln_post"]["g"]), "ln_post_b": a(enc["ln_post"]["b"]),
    }
    flat_dec = {
        "tok_emb": a(dec["tok_emb"]), "pos_emb": a(dec["pos_emb"]),
        "ln_g": a(dec["ln"]["g"]), "ln_b": a(dec["ln"]["b"]),
    }
    if dec.get("proj") is not None:
        flat_dec["proj_w"] = a(dec["proj"]["w"]).T
    for flat, blocks, attns in ((flat_enc, enc["blocks"], ("attn",)),
                                (flat_dec, dec["blocks"], ("attn", "cross"))):
        for p in attns:
            flat[f"{p}_ln_g"] = a(blocks[f"{p}_ln"]["g"])
            flat[f"{p}_ln_b"] = a(blocks[f"{p}_ln"]["b"])
            for n in _LINEARS:
                flat[f"{p}_{n}_w"] = lin_w(blocks[p][n]["w"])
                if "b" in blocks[p][n]:
                    flat[f"{p}_{n}_b"] = a(blocks[p][n]["b"])
        flat["mlp_ln_g"] = a(blocks["mlp_ln"]["g"])
        flat["mlp_ln_b"] = a(blocks["mlp_ln"]["b"])
        for n in ("fc1", "fc2"):
            flat[f"{n}_w"] = lin_w(blocks["mlp"][n]["w"])
            flat[f"{n}_b"] = a(blocks["mlp"][n]["b"])
    model = WhisperTorch(dims, dtype=dtype, device="meta", untied_proj="proj_w" in flat_dec,
                         n_mlp=(flat_enc["fc1_b"].shape[-1], flat_dec["fc1_b"].shape[-1]))
    for pd, flat in ((model.encoder, flat_enc), (model.decoder, flat_dec)):
        missing = set(pd.keys()) - set(flat)
        if missing:
            raise KeyError(f"parameter tree lacks {sorted(missing)}")
        for k in list(pd.keys()):
            if tuple(pd[k].shape) != flat[k].shape:
                raise ValueError(f"{k}: shape {flat[k].shape} != expected {tuple(pd[k].shape)}")
            pd[k] = torch.nn.Parameter(
                torch.tensor(flat[k]).to(device=device, dtype=dtype),
                requires_grad=False,
            )
    model.fixed_pos_emb = "pos_emb" not in enc
    return model


# ---------------------------------------------------------------------------
# State-dict -> numpy parameter tree (the JAX package's layout)
# ---------------------------------------------------------------------------


def _to_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(t)


def _lin(sd, prefix, bias=True, transpose=True):
    w = _to_np(sd[f"{prefix}.weight"])
    out = {"w": np.ascontiguousarray(w.T) if transpose else w}
    if bias and f"{prefix}.bias" in sd:
        out["b"] = _to_np(sd[f"{prefix}.bias"])
    return out


def _ln_params(sd, prefix):
    return {"g": _to_np(sd[f"{prefix}.weight"]), "b": _to_np(sd[f"{prefix}.bias"])}


def _stack(blocks):
    """Stack a list of identically-shaped nested dicts leaf-wise."""
    first = blocks[0]
    if isinstance(first, dict):
        return {k: _stack([b[k] for b in blocks]) for k in first}
    return np.stack(blocks)


def _count_layers(sd, pattern):
    rx = re.compile(pattern)
    layers = {int(m.group(1)) for k in sd if (m := rx.match(k))}
    return max(layers) + 1 if layers else 0


def _tree(sd, dims, names) -> Dict[str, Any]:
    """Shared body of the two converters; ``names`` maps roles to the
    checkpoint's key spellings."""

    def attn(prefix):
        return {
            "q": _lin(sd, f"{prefix}.{names['q']}"),
            "k": _lin(sd, f"{prefix}.{names['k']}", bias=False),
            "v": _lin(sd, f"{prefix}.{names['v']}"),
            "o": _lin(sd, f"{prefix}.{names['o']}"),
        }

    def block(p, cross):
        b = {
            "attn_ln": _ln_params(sd, f"{p}.{names['attn_ln']}"),
            "attn": attn(f"{p}.{names['attn']}"),
            "mlp_ln": _ln_params(sd, f"{p}.{names['mlp_ln']}"),
            "mlp": {"fc1": _lin(sd, f"{p}.{names['fc1']}"), "fc2": _lin(sd, f"{p}.{names['fc2']}")},
        }
        if cross:
            b["cross_ln"] = _ln_params(sd, f"{p}.{names['cross_ln']}")
            b["cross"] = attn(f"{p}.{names['cross']}")
        return b

    enc_pos = names["enc_pos"]
    return {
        "encoder": {
            "conv1": {"w": _to_np(sd["encoder.conv1.weight"]).transpose(2, 1, 0),
                      "b": _to_np(sd["encoder.conv1.bias"])},
            "conv2": {"w": _to_np(sd["encoder.conv2.weight"]).transpose(2, 1, 0),
                      "b": _to_np(sd["encoder.conv2.bias"])},
            "blocks": _stack([block(f"encoder.{names['layers']}.{i}", False)
                              for i in range(dims.n_audio_layer)]),
            "ln_post": _ln_params(sd, names["ln_post"]),
            **({"pos_emb": _to_np(sd[enc_pos])} if enc_pos in sd else {}),
        },
        "decoder": {
            "tok_emb": _to_np(sd[names["tok_emb"]]),
            "pos_emb": _to_np(sd[names["dec_pos"]]),
            "blocks": _stack([block(f"decoder.{names['layers']}.{i}", True)
                              for i in range(dims.n_text_layer)]),
            "ln": _ln_params(sd, names["dec_ln"]),
        },
    }


_OPENAI_NAMES = dict(
    q="query", k="key", v="value", o="out", attn="attn", cross="cross_attn",
    attn_ln="attn_ln", cross_ln="cross_attn_ln", mlp_ln="mlp_ln", fc1="mlp.0",
    fc2="mlp.2", layers="blocks", ln_post="encoder.ln_post",
    enc_pos="encoder.positional_embedding", tok_emb="decoder.token_embedding.weight",
    dec_pos="decoder.positional_embedding", dec_ln="decoder.ln",
)
_HF_NAMES = dict(
    q="q_proj", k="k_proj", v="v_proj", o="out_proj", attn="self_attn",
    cross="encoder_attn", attn_ln="self_attn_layer_norm",
    cross_ln="encoder_attn_layer_norm", mlp_ln="final_layer_norm", fc1="fc1",
    fc2="fc2", layers="layers", ln_post="encoder.layer_norm",
    enc_pos="encoder.embed_positions.weight", tok_emb="decoder.embed_tokens.weight",
    dec_pos="decoder.embed_positions.weight", dec_ln="decoder.layer_norm",
)


def from_openai_state_dict(
    sd: Dict[str, Any], dims: Optional[WhisperDims] = None
) -> Tuple[Dict[str, Any], WhisperDims]:
    """openai-whisper state dict (``encoder.blocks.0.attn.query.weight``) ->
    (numpy tree, dims)."""
    sd = {k.replace("model.", "", 1) if k.startswith("model.") else k: v for k, v in sd.items()}
    if dims is None:
        dims = states_to_dims_openai(sd)
    params = _tree(sd, dims, _OPENAI_NAMES)
    if "decoder.proj_out.weight" in sd:  # untied output projection
        params["decoder"]["proj"] = {"w": _to_np(sd["decoder.proj_out.weight"]).T}
    return params, dims


def states_to_dims_openai(sd: Dict[str, Any]) -> WhisperDims:
    """Geometry of an openai-format state dict (64-dim heads, as in every
    released Whisper model)."""
    n_mels = _to_np(sd["encoder.conv1.weight"]).shape[1]
    n_audio_state = _to_np(sd["encoder.conv1.weight"]).shape[0]
    n_vocab, n_text_state = _to_np(sd["decoder.token_embedding.weight"]).shape
    return WhisperDims(
        n_mels=n_mels,
        n_audio_ctx=_to_np(sd["encoder.positional_embedding"]).shape[0]
        if "encoder.positional_embedding" in sd else 1500,
        n_audio_state=n_audio_state,
        n_audio_head=max(1, n_audio_state // 64),
        n_audio_layer=_count_layers(sd, r"encoder\.blocks\.(\d+)\."),
        n_vocab=n_vocab,
        n_text_ctx=_to_np(sd["decoder.positional_embedding"]).shape[0],
        n_text_state=n_text_state,
        n_text_head=max(1, n_text_state // 64),
        n_text_layer=_count_layers(sd, r"decoder\.blocks\.(\d+)\."),
    )


def from_hf_state_dict(
    sd: Dict[str, Any], config: Optional[dict] = None
) -> Tuple[Dict[str, Any], WhisperDims]:
    """HF ``WhisperForConditionalGeneration`` state dict -> (numpy tree, dims)."""
    sd = {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}
    dims = dims_from_hf_config(config) if config is not None else states_to_dims_hf(sd)
    params = _tree(sd, dims, _HF_NAMES)
    if "proj_out.weight" in sd:
        proj = _to_np(sd["proj_out.weight"])
        if not np.array_equal(proj, params["decoder"]["tok_emb"]):
            params["decoder"]["proj"] = {"w": proj.T}
    return params, dims


def states_to_dims_hf(sd: Dict[str, Any]) -> WhisperDims:
    n_mels = _to_np(sd["encoder.conv1.weight"]).shape[1]
    n_audio_state = _to_np(sd["encoder.conv1.weight"]).shape[0]
    n_vocab, n_text_state = _to_np(sd["decoder.embed_tokens.weight"]).shape
    return WhisperDims(
        n_mels=n_mels,
        n_audio_ctx=_to_np(sd["encoder.embed_positions.weight"]).shape[0]
        if "encoder.embed_positions.weight" in sd else 1500,
        n_audio_state=n_audio_state,
        n_audio_head=max(1, n_audio_state // 64),
        n_audio_layer=_count_layers(sd, r"encoder\.layers\.(\d+)\."),
        n_vocab=n_vocab,
        n_text_ctx=_to_np(sd["decoder.embed_positions.weight"]).shape[0],
        n_text_state=n_text_state,
        n_text_head=max(1, n_text_state // 64),
        n_text_layer=_count_layers(sd, r"decoder\.layers\.(\d+)\."),
    )


def dims_from_hf_config(config: dict) -> WhisperDims:
    d = config["d_model"]
    return WhisperDims(
        n_mels=config.get("num_mel_bins", 80),
        n_audio_ctx=config.get("max_source_positions", 1500),
        n_audio_state=d,
        n_audio_head=config.get("encoder_attention_heads", max(1, d // 64)),
        n_audio_layer=config["encoder_layers"],
        n_vocab=config["vocab_size"],
        n_text_ctx=config.get("max_target_positions", 448),
        n_text_state=d,
        n_text_head=config.get("decoder_attention_heads", max(1, d // 64)),
        n_text_layer=config["decoder_layers"],
    )


# ---------------------------------------------------------------------------
# File / directory resolution
# ---------------------------------------------------------------------------


def _torch_load(path: str) -> Dict[str, Any]:
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        return torch.load(path, map_location="cpu", weights_only=False)


def _load_safetensors(path: str) -> Dict[str, Any]:
    from safetensors.torch import load_file

    return load_file(path)


def _load_sharded_hf(dirname: str, index_file: str) -> Dict[str, Any]:
    """Every shard that a HuggingFace index (``*.index.json``) lists, merged
    into one state dict (``load.py:355`` of the JAX package)."""
    with open(os.path.join(dirname, index_file)) as f:
        index = json.load(f)
    sd: Dict[str, Any] = {}
    for shard in sorted(set(index["weight_map"].values())):
        p = os.path.join(dirname, shard)
        sd.update(_load_safetensors(p) if shard.endswith(".safetensors") else _torch_load(p))
    return sd


def _load_hf_dir(dirname: str):
    config = None
    cfg_path = os.path.join(dirname, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            config = json.load(f)
    sd = None
    for fname, loader in (("model.safetensors", _load_safetensors),
                          ("pytorch_model.bin", _torch_load),
                          ("whisper.ckpt", _torch_load),
                          ("model.safetensors.index.json", None),
                          ("pytorch_model.bin.index.json", None)):
        p = os.path.join(dirname, fname)
        if os.path.exists(p):
            sd = _load_sharded_hf(dirname, fname) if loader is None else loader(p)
            break
    if sd is None:
        raise FileNotFoundError(
            f"No model weights found in {dirname} (expected model.safetensors, "
            "pytorch_model.bin, or a sharded index)."
        )
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    params, dims = from_hf_state_dict(sd, config)
    return params, dims, config


def _tokenizer_ranks_from_dir(dirname: str):
    """(byte->rank table, multilingual hint) from files next to a checkpoint."""
    from ..tokenizer import load_hf_vocab_ranks, load_tiktoken_ranks

    for cand, loader, multi in (
        ("multilingual.tiktoken", load_tiktoken_ranks, True),
        ("gpt2.tiktoken", load_tiktoken_ranks, False),
        ("vocab.json", load_hf_vocab_ranks, None),
    ):
        p = os.path.join(dirname, cand)
        if os.path.exists(p):
            return loader(p), multi
    return None, None


def _num_parameters_for_name_inference(params: Dict[str, Any]) -> int:
    """Parameter count without the untied projection and encoder positions."""

    def leaves(node):
        if isinstance(node, dict):
            for v in node.values():
                yield from leaves(v)
        else:
            yield node

    total = sum(int(np.prod(np.shape(x))) for x in leaves(params))
    proj = params["decoder"].get("proj")
    if proj is not None:
        total -= int(np.prod(np.shape(proj["w"])))
    enc_pos = params["encoder"].get("pos_emb")
    if enc_pos is not None:
        total -= int(np.prod(np.shape(enc_pos)))
    return total


def default_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card. Raises
    when the card is meant (by default or by name) and none is visible: the
    port never falls back to the CPU on its own (pass ``device="cpu"`` for
    that)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


def load_model(name_or_path: str, device=None, dtype=None,
               download_root: Optional[str] = None) -> WhisperModel:
    """Load a local OpenAI ``.pt`` file, a local HF model directory or
    safetensors file, or an official model name found under
    ``download_root`` / ``~/.cache/whisper``, onto ``device`` in ``dtype``.
    ``device`` defaults to the CUDA card (see ``default_device``; without a
    card it raises). ``dtype`` defaults to bfloat16 on CUDA, which the
    kernels take, and float32 elsewhere. Nothing is downloaded."""
    device = default_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model_name = None
    ranks, multi_hint = None, None
    if os.path.isdir(name_or_path):
        params, dims, config = _load_hf_dir(name_or_path)
        if config and config.get("_name_or_path"):
            model_name = config["_name_or_path"]
        ranks, multi_hint = _tokenizer_ranks_from_dir(name_or_path)
    elif os.path.isfile(name_or_path):
        ranks, multi_hint = _tokenizer_ranks_from_dir(os.path.dirname(os.path.abspath(name_or_path)))
        if name_or_path.endswith(".safetensors"):
            sd = _load_safetensors(name_or_path)
            try:
                params, dims = from_hf_state_dict(sd)
            except KeyError:
                params, dims = from_openai_state_dict(sd)
        else:
            ckpt = _torch_load(name_or_path)
            dims = WhisperDims(**ckpt["dims"]) if isinstance(ckpt, dict) and "dims" in ckpt else None
            sd = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
            if any(k.startswith(("encoder.layers", "model.encoder.layers")) for k in sd):
                params, dims = from_hf_state_dict(sd)
            else:
                params, dims = from_openai_state_dict(sd, dims)
        model_name = os.path.basename(name_or_path)
    elif name_or_path in OFFICIAL_MODELS:
        root = download_root or os.path.join(
            os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")), "whisper"
        )
        pt = os.path.join(root, f"{name_or_path}.pt")
        if not os.path.exists(pt):
            raise FileNotFoundError(
                f"Checkpoint for {name_or_path!r} not found at {pt}. Weights are "
                "never downloaded; place the official .pt there or pass a path."
            )
        return load_model(pt, device=device, dtype=dtype)
    else:
        raise FileNotFoundError(f"Cannot resolve model {name_or_path!r} (not a file, "
                                f"directory, or official name {OFFICIAL_MODELS})")

    inferred = heads_for_model_name(model_name) if model_name else None
    if inferred is None:
        count = _num_parameters_for_name_inference(params)
        first_pos = bool(np.asarray(params["encoder"]["conv1"]["w"]).flat[0] > 0)
        name = infer_model_name(count, first_pos)
        if name:
            inferred = get_alignment_heads(name, dims.n_text_layer, dims.n_text_head)
            model_name = model_name or name
    module = params_from_jax_tree(params, dims, device=device, dtype=dtype)
    return WhisperModel(
        module=module, alignment_heads=inferred, model_name=model_name,
        tokenizer_ranks=ranks, tokenizer_multilingual=multi_hint,
    )
