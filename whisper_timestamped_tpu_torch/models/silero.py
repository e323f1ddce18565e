"""Silero-VAD speech-timestamp extraction.

Counterpart of ``whisper_timestamped_tpu/models/silero_jax.py``. The weight
parsing (``parse_silero_state_dict``, ``match_onnx_silero_weights``), the
hysteresis state machine (``speech_probs_to_timestamps``), the loader cache
and ``silero_get_speech_timestamps`` are copies. The frame-probability
network, which the JAX package runs as a jitted program with the LSTM as a
``lax.scan``, is ``SileroVAD`` here: a torch module on an explicit device
(STFT filter-bank conv -> 4-layer conv encoder -> LSTM -> 1x1 head). The
framing, the STFT and the encoder run batched over all chunks; the LSTM is
an ``nn.LSTM`` over the chunk sequence, one call per ``LSTM_BLOCK`` steps
(cuDNN refuses a 112,500-step sequence, an hour of audio), its state
carried from the first chunk to the last. The module computes in f32 whatever the
global TF32 flags say (``_strict_f32``): a probability near the 0.5
threshold must not flip.

The ``.jit`` loader checks the module against the torchscript model on six
seeded chunks; a checkpoint it does not model (a v3/v4 revision) runs
through the torchscript model on the CPU with a warning. Nothing is
downloaded: the weights must exist locally (``SILERO_VAD_PATH`` or the
torch hub cache; ``vad.py`` finds them).
"""

from __future__ import annotations

import contextlib
import logging
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

logger = logging.getLogger("whisper_timestamped_tpu_torch")

WINDOW_SIZE_SAMPLES = 512  # silero v4/v5 @ 16 kHz
CONTEXT_SAMPLES = 64  # leading context carried from the previous chunk (v5)
FEATURE_BLOCK = 1 << 16  # chunks a block through the STFT and the encoder
LSTM_BLOCK = 1 << 14  # LSTM steps a call, the state carried between calls

# state_dict schema of the published silero-vad v5 .jit checkpoint (16 kHz
# path). Anything else falls back to the torchscript adapter.
_V5_KEYS = {
    "stft": "_model.stft.forward_basis_buffer",  # (258, 1, 256) conv, stride 128
    "enc_w": "_model.encoder.{i}.reparam_conv.weight",  # 4 conv1d layers, k=3
    "enc_b": "_model.encoder.{i}.reparam_conv.bias",
    "rnn_wi": "_model.decoder.rnn.weight_ih",  # LSTMCell(128, 128)
    "rnn_wh": "_model.decoder.rnn.weight_hh",
    "rnn_bi": "_model.decoder.rnn.bias_ih",
    "rnn_bh": "_model.decoder.rnn.bias_hh",
    "head_w": "_model.decoder.decoder.2.weight",  # (1, 128, 1) conv head
    "head_b": "_model.decoder.decoder.2.bias",
}
_ENC_STRIDES = (1, 2, 2, 1)  # per encoder layer, padding 1 each


def parse_silero_state_dict(sd: dict) -> Optional[dict]:
    """Extract the v5-schema weights as numpy arrays, or None if the
    checkpoint does not match (e.g. the v3/v4 architecture).

    Accepts torch tensors (jit state_dict) or numpy arrays (onnx
    initializers remapped by :func:`match_onnx_silero_weights`)."""

    def get(key):
        t = sd.get(key)
        if t is None:
            return None
        if hasattr(t, "detach"):
            t = t.detach().cpu().numpy()
        return np.asarray(t, np.float32)

    stft = get(_V5_KEYS["stft"])
    if stft is None or stft.ndim != 3 or stft.shape[1] != 1 or stft.shape[0] % 2:
        return None
    enc = []
    for i in range(4):
        w = get(_V5_KEYS["enc_w"].format(i=i))
        b = get(_V5_KEYS["enc_b"].format(i=i))
        if w is None or b is None or w.ndim != 3 or w.shape[2] != 3:
            return None
        enc.append((w, b))
    rnn = tuple(get(_V5_KEYS[k]) for k in ("rnn_wi", "rnn_wh", "rnn_bi", "rnn_bh"))
    head_w, head_b = get(_V5_KEYS["head_w"]), get(_V5_KEYS["head_b"])
    if any(x is None for x in rnn) or head_w is None or head_b is None:
        return None
    if rnn[0].shape[0] != 4 * rnn[1].shape[1]:
        return None
    return {"stft": stft, "enc": enc, "rnn": rnn, "head": (head_w, head_b)}


def match_onnx_silero_weights(inits: dict) -> Optional[dict]:
    """Remap ONNX initializer names onto the v5 jit state_dict schema.

    The published silero exports keep the module paths in initializer names
    (possibly without the ``_model.`` prefix, possibly under an ``If``-branch
    subgraph); match each canonical key by suffix. When name matching fails
    (e.g. an exporter that renamed everything), fall back to chaining the
    conv shapes: STFT basis (2F, 1, K) → encoder convs (out, in, 3) linked
    in→out starting from F → (1, C, 1) head; the LSTM weights are only
    accepted by name (``weight_ih``/``weight_hh`` have identical shapes).
    """
    by_suffix = {}
    for name, arr in inits.items():
        by_suffix[name] = arr

    def find(canonical: str):
        suffix = canonical[len("_model."):]  # e.g. "stft.forward_basis_buffer"
        for name, arr in by_suffix.items():
            if name == canonical or name.endswith(suffix):
                return arr
        return None

    sd = {}
    missing = []
    for slot, key in _V5_KEYS.items():
        keys = [key.format(i=i) for i in range(4)] if "{i}" in key else [key]
        for k in keys:
            arr = find(k)
            if arr is None:
                missing.append(k)
            else:
                sd[k] = arr
    if not missing:
        return sd

    # shape-chaining fallback (module paths mangled by the exporter). Bias
    # shapes alone are ambiguous (the v5 stack has two 64- and two 128-wide
    # conv biases), so each conv weight pairs with the CLOSEST unused 1-D
    # tensor of matching length in graph order — torch exporters emit a
    # node's weight and bias initializers adjacently.
    order = {n: i for i, n in enumerate(inits)}
    stfts = [a for a in inits.values() if a.ndim == 3 and a.shape[1] == 1
             and a.shape[0] % 2 == 0 and a.shape[0] > 8 and a.shape[2] > 4]
    convs = {n: a for n, a in inits.items() if a.ndim == 3 and a.shape[2] == 3}
    heads = [a for a in inits.values()
             if a.ndim == 3 and a.shape[0] == 1 and a.shape[2] == 1]
    lstm = {("w" if "weight" in n else "b") + ("i" if "_ih" in n else "h"): a
            for n, a in inits.items()
            if ("weight_ih" in n or "weight_hh" in n or "bias_ih" in n or "bias_hh" in n)}
    if len(stfts) != 1 or len(heads) != 1 or len(lstm) < 4:
        return None
    used_biases: set = set()

    def nearest_bias(anchor_name: str, length: int):
        cands = [
            (abs(order[n] - order[anchor_name]), order[n], n)
            for n, a in inits.items()
            if a.ndim == 1 and a.shape[0] == length and n not in used_biases
        ]
        if not cands:
            return None
        name = min(cands)[2]
        used_biases.add(name)
        return inits[name]

    stft = stfts[0]
    sd = {_V5_KEYS["stft"]: stft}
    in_ch = stft.shape[0] // 2
    for i in range(4):
        w_name = next((n for n, a in convs.items() if a.shape[1] == in_ch), None)
        if w_name is None:
            return None
        w = convs.pop(w_name)
        b = nearest_bias(w_name, w.shape[0])
        if b is None:
            return None
        sd[_V5_KEYS["enc_w"].format(i=i)] = w
        sd[_V5_KEYS["enc_b"].format(i=i)] = b
        in_ch = w.shape[0]
    sd[_V5_KEYS["rnn_wi"]] = lstm.get("wi")
    sd[_V5_KEYS["rnn_wh"]] = lstm.get("wh")
    sd[_V5_KEYS["rnn_bi"]] = lstm.get("bi")
    sd[_V5_KEYS["rnn_bh"]] = lstm.get("bh")
    sd[_V5_KEYS["head_w"]] = heads[0]
    sd[_V5_KEYS["head_b"]] = nearest_bias(next(iter(inits)), 1)
    if any(v is None for v in sd.values()):
        return None
    return sd


# ---------------------------------------------------------------------------
# The silero VAD network (v5 architecture) as a torch module
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _strict_f32():
    """No TF32 in cuDNN's convolutions and LSTM nor in cuBLAS while the
    module runs, whatever the caller set (``cudnn.allow_tf32`` defaults to
    True); the flags are put back after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


class SileroVAD(nn.Module):
    """``forward(chunks (N, 512) f32) -> (N,)`` speech probabilities, the
    chunks in order (``make_jax_prob_fn``, ``silero_jax.py:208``): each
    chunk framed with the last 64 samples of the previous one (zeros before
    the first) into 576 samples, the STFT as a stride-128 conv with the
    (2F, 1, 256) basis, the magnitude with ``+1e-12``, four conv + ReLU
    layers (strides 1, 2, 2, 1; padding 1), the mean over time, the LSTM
    over all chunks with its state never reset (``LSTM_BLOCK`` steps a
    call), then ReLU, the (1, H, 1) head and a sigmoid. silero's LSTM gates
    are torch's (i, f, g, o), so its weights load into ``nn.LSTM``
    unchanged."""

    def __init__(self, weights: dict, device=None):
        super().__init__()
        t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
        self.register_buffer("stft", t(weights["stft"]))
        self.enc = nn.ParameterList()
        for w, b in weights["enc"]:
            self.enc.append(nn.Parameter(t(w), requires_grad=False))
            self.enc.append(nn.Parameter(t(b), requires_grad=False))
        wi, wh, bi, bh = (t(x) for x in weights["rnn"])
        self.lstm = nn.LSTM(wi.shape[1], wh.shape[1], batch_first=True)
        with torch.no_grad():
            for name, x in (("weight_ih_l0", wi), ("weight_hh_l0", wh),
                            ("bias_ih_l0", bi), ("bias_hh_l0", bh)):
                getattr(self.lstm, name).copy_(x)
        self.lstm.requires_grad_(False)
        head_w, head_b = weights["head"]
        self.register_buffer("head_w", t(head_w)[0, :, 0])
        self.register_buffer("head_b", t(head_b).reshape(()))
        self.to(device)
        if device is not None and torch.device(device).type == "cuda":
            self.lstm.flatten_parameters()

    def features(self, chunks: torch.Tensor) -> torch.Tensor:
        """(N, 512) chunks -> (N, C) encoder features, in blocks of
        ``FEATURE_BLOCK`` chunks (each block framed with its predecessor's
        last 64 samples)."""
        n = chunks.shape[0]
        K = self.stft.shape[-1]
        Fq = self.stft.shape[0] // 2
        flat = torch.cat([chunks.new_zeros(CONTEXT_SAMPLES), chunks.reshape(-1)])
        out = []
        for c0 in range(0, n, FEATURE_BLOCK):
            c1 = min(n, c0 + FEATURE_BLOCK)
            seg = flat[c0 * WINDOW_SIZE_SAMPLES : c1 * WINDOW_SIZE_SAMPLES + CONTEXT_SAMPLES]
            frames = seg.unfold(0, WINDOW_SIZE_SAMPLES + CONTEXT_SAMPLES, WINDOW_SIZE_SAMPLES)
            x = F.conv1d(frames[:, None, :], self.stft, stride=K // 2)  # (n, 2F, T)
            h = torch.sqrt(x[:, :Fq] ** 2 + x[:, Fq:] ** 2 + 1e-12)
            for i, s in enumerate(_ENC_STRIDES):
                h = F.relu(F.conv1d(h, self.enc[2 * i], self.enc[2 * i + 1], stride=s,
                                    padding=1))
            out.append(h.mean(dim=-1))
        return torch.cat(out)

    def forward(self, chunks: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), _strict_f32():
            chunks = chunks.to(self.stft.device, torch.float32)
            if chunks.shape[0] == 0:
                return chunks.new_zeros(0)
            feat = self.features(chunks)
            hs, state = [], None  # zero initial state
            for s0 in range(0, feat.shape[0], LSTM_BLOCK):
                h, state = self.lstm(feat[None, s0 : s0 + LSTM_BLOCK], state)
                hs.append(h[0])
            # the head as a product and a sum: f32 on any device, no matmul to fall to TF32
            out = (F.relu(torch.cat(hs)) * self.head_w).sum(dim=-1) + self.head_b
            return torch.sigmoid(out)


def make_prob_fn(module: SileroVAD) -> Callable[[np.ndarray, int], np.ndarray]:
    """``probs_fn(chunks (N, 512), sr) -> (N,)`` numpy over ``module``, on
    the module's device. Carries ``is_module`` (the JAX package's
    ``is_jax``): ``silero_get_speech_timestamps`` reads it."""

    def probs_fn(chunks: np.ndarray, sample_rate: int) -> np.ndarray:
        assert sample_rate == 16000, "the silero module supports 16 kHz audio"
        x = torch.from_numpy(np.ascontiguousarray(chunks, np.float32))
        return module(x).cpu().numpy()

    probs_fn.is_module = True
    probs_fn.module = module
    return probs_fn


def load_onnx_prob_model(path: str, device=None) -> Optional[Callable[[np.ndarray, int], np.ndarray]]:
    """The silero module from a cached ``silero_vad.onnx`` on ``device``:
    the initializers lifted straight out of the protobuf
    (``onnx_weights.py``; no onnx or onnxruntime). Returns None when the
    file's weights don't match the v5 schema."""
    from .onnx_weights import parse_onnx_initializers

    try:
        inits = parse_onnx_initializers(path)
    except Exception as exc:
        logger.warning("could not parse %s as ONNX (%s)", path, exc)
        return None
    sd = match_onnx_silero_weights(inits)
    weights = parse_silero_state_dict(sd) if sd else None
    if weights is None:
        logger.warning(
            "%s does not match the silero v5 weight schema — "
            "use a .jit checkpoint or the energy VAD", path,
        )
        return None
    return make_prob_fn(SileroVAD(weights, device))


def load_module_prob_model(path: str, device=None) -> Optional[Callable[[np.ndarray, int], np.ndarray]]:
    """The silero module from ``.jit`` weights on ``device``; None on a
    schema mismatch (``load_jax_prob_model``, ``silero_jax.py:274``).

    Self-validating: on six seeded chunks the module is compared with the
    torchscript model (on the CPU) at atol 1e-4; a silero architecture the
    module does not model is detected here, not silently mis-scored."""
    model = torch.jit.load(path, map_location="cpu")
    weights = parse_silero_state_dict(dict(model.state_dict()))
    if weights is None:
        return None
    fn = make_prob_fn(SileroVAD(weights, device))
    ts_fn = load_torchscript_prob_model(path)
    rng = np.random.default_rng(0)
    chunks = (rng.standard_normal((6, WINDOW_SIZE_SAMPLES)) * 0.2).astype(np.float32)
    try:
        want = ts_fn(chunks, 16000)
        got = fn(chunks, 16000)
    except Exception as exc:  # torchscript refused our call convention
        logger.warning("silero torchscript validation failed (%s)", exc)
        return None
    if not np.allclose(got, want, atol=1e-4):
        logger.warning(
            "the silero module disagrees with the torchscript model "
            "(max diff %.3g) — falling back to the torchscript adapter",
            float(np.max(np.abs(got - want))),
        )
        return None
    return fn


def load_torchscript_prob_model(path: str) -> Callable[[np.ndarray, int], np.ndarray]:
    """Wrap a silero ``.jit`` model as a chunk->probability callable (on
    the CPU, one chunk a call)."""
    model = torch.jit.load(path, map_location="cpu")
    model.eval()

    def probs_fn(chunks: np.ndarray, sample_rate: int) -> np.ndarray:
        out = []
        if hasattr(model, "reset_states"):
            model.reset_states()
        with torch.no_grad():
            for chunk in chunks:
                p = model(torch.from_numpy(chunk).float(), sample_rate)
                out.append(float(p.item() if hasattr(p, "item") else p))
        return np.asarray(out)

    return probs_fn


def speech_probs_to_timestamps(
    speech_probs: np.ndarray,
    audio_length_samples: int,
    *,
    threshold: float = 0.5,
    neg_threshold: Optional[float] = None,
    min_speech_duration_ms: float = 250,
    min_silence_duration_ms: float = 100,
    speech_pad_ms: float = 30,
    sample_rate: int = 16000,
    window_size_samples: int = WINDOW_SIZE_SAMPLES,
) -> List[dict]:
    """Hysteresis state machine over per-window speech probabilities
    (silero ``get_speech_timestamps`` semantics).

    A host loop: one iteration per 32 ms window is ~112k trivial
    iterations for an hour of audio, and the two-threshold + min-silence
    hysteresis is sequential.
    """
    if neg_threshold is None:
        neg_threshold = max(threshold - 0.15, 0.01)
    min_speech_samples = sample_rate * min_speech_duration_ms / 1000
    min_silence_samples = sample_rate * min_silence_duration_ms / 1000
    speech_pad_samples = sample_rate * speech_pad_ms / 1000

    triggered = False
    speeches: List[dict] = []
    current: dict = {}
    temp_end = 0

    for i, prob in enumerate(speech_probs):
        pos = window_size_samples * i
        if prob >= threshold and temp_end:
            temp_end = 0
        if prob >= threshold and not triggered:
            triggered = True
            current["start"] = pos
            continue
        if prob < neg_threshold and triggered:
            if not temp_end:
                temp_end = pos
            if pos - temp_end < min_silence_samples:
                continue
            current["end"] = temp_end
            if current["end"] - current["start"] > min_speech_samples:
                speeches.append(current)
            current = {}
            triggered = False
            temp_end = 0

    if current and audio_length_samples - current["start"] > min_speech_samples:
        current["end"] = audio_length_samples
        speeches.append(current)

    # pad segments, splitting inter-segment silences
    for i, speech in enumerate(speeches):
        if i == 0:
            speech["start"] = int(max(0, speech["start"] - speech_pad_samples))
        if i != len(speeches) - 1:
            silence = speeches[i + 1]["start"] - speech["end"]
            if silence < 2 * speech_pad_samples:
                speech["end"] += int(silence // 2)
                speeches[i + 1]["start"] = int(max(0, speeches[i + 1]["start"] - silence // 2))
            else:
                speech["end"] = int(min(audio_length_samples, speech["end"] + speech_pad_samples))
                speeches[i + 1]["start"] = int(max(0, speeches[i + 1]["start"] - speech_pad_samples))
        else:
            speech["end"] = int(min(audio_length_samples, speech["end"] + speech_pad_samples))

    return speeches


_PROB_MODEL_CACHE: dict = {}


def _cached_prob_model(path: str, device=None) -> Callable[[np.ndarray, int], np.ndarray]:
    """The silero module on ``device`` (None: the CUDA card, which must
    exist) when the checkpoint matches, torchscript otherwise; cached per
    (path, device) so weight parsing and validation happen once. ONNX files
    have no torchscript fallback: a schema mismatch is a hard error."""
    from .load import default_device

    device = default_device(device)
    key = (path, str(device))
    fn = _PROB_MODEL_CACHE.get(key)
    if fn is None:
        if path.endswith(".onnx"):
            fn = load_onnx_prob_model(path, device)
            if fn is None:
                raise RuntimeError(
                    f"{path} does not match the silero v5 weight schema and "
                    "onnxruntime is not available; provide a .jit silero "
                    "model or use the energy VAD."
                )
        else:
            fn = load_module_prob_model(path, device)
            if fn is None:
                # the module models the v5 network only; v3/v4 architectures
                # run through the torchscript adapter on the CPU. Say so
                # loudly instead of silently changing engines.
                logger.warning(
                    "%s does not match the silero v5 weight schema (likely a "
                    "v3/v4 revision): running it through the torchscript "
                    "adapter on the CPU; only v5 checkpoints run on the "
                    "silero module (see MIGRATION.md)", path,
                )
                try:
                    fn = load_torchscript_prob_model(path)
                except Exception as exc:
                    raise RuntimeError(
                        f"{path} does not match the silero v5 weight schema "
                        "and the torchscript fallback failed "
                        f"({exc}); provide a v5 checkpoint or use the energy "
                        "VAD (see MIGRATION.md, 'Silero VAD revisions')."
                    ) from exc
        _PROB_MODEL_CACHE[key] = fn
    return fn


def silero_get_speech_timestamps(
    audio: np.ndarray,
    model_path: str,
    *,
    sample_rate: int = 16000,
    min_speech_duration: float = 0.1,
    min_silence_duration: float = 0.1,
    threshold: float = 0.5,
    probs_fn: Optional[Callable] = None,
    window_size_samples: Optional[int] = None,
    device=None,
) -> List[dict]:
    """Speech segments (sample units) for 16 kHz audio via silero weights,
    the module on ``device`` (None: the CUDA card).

    Normalized audio, durations in ms. ``window_size_samples`` overrides the
    chunking window — v3 revisions use the silero v3 util's 1536 default
    (vad.py passes it for ``silero:3.x`` pinnings); the v5 module requires
    512."""
    from ..vad import normalize_gain

    audio = normalize_gain(np.asarray(audio, np.float32))

    if probs_fn is None:
        probs_fn = _cached_prob_model(model_path, device)
    window = window_size_samples or WINDOW_SIZE_SAMPLES
    if window != WINDOW_SIZE_SAMPLES and getattr(probs_fn, "is_module", False):
        logger.warning(
            "the silero v5 module requires %d-sample windows; ignoring "
            "window_size_samples=%d", WINDOW_SIZE_SAMPLES, window,
        )
        window = WINDOW_SIZE_SAMPLES

    n = len(audio)
    n_chunks = int(np.ceil(n / window))
    padded = np.zeros(n_chunks * window, np.float32)
    padded[:n] = audio
    chunks = padded.reshape(n_chunks, window)
    probs = np.asarray(probs_fn(chunks, sample_rate))

    return speech_probs_to_timestamps(
        probs,
        n,
        threshold=threshold,
        min_speech_duration_ms=round(min_speech_duration * 1000),
        min_silence_duration_ms=round(min_silence_duration * 1000),
        sample_rate=sample_rate,
        window_size_samples=window,
    )
