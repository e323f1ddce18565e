"""whisper_timestamped_tpu_torch: the PyTorch/CUDA port of whisper_timestamped_tpu.

Multilingual transcription with word-level timestamps and confidences on an
NVIDIA Hopper GPU: plain PyTorch for the model math, hand-written CUDA
kernels (``csrc/``, built with nvcc at first use) for the encoder and
prefill attention, the decode step's attentions, the device word aligner
and the fused log-mel front end. ``transcribe_timestamped`` answers one
request; ``transcribe_batch`` and the serving loop
``transcribe_batch_stream`` decode many streams at once. On the CPU the
same code runs with the kernels' plain PyTorch versions. The package imports neither JAX nor the
JAX package ``whisper_timestamped_tpu``, which stays the reference. The
command line is ``python -m whisper_timestamped_tpu_torch.cli`` (and
``...make_subtitles`` for the subtitle splitter).

``import whisper_timestamped_tpu_torch as whisper`` stands in for whisper
as the JAX package does (``whisper_timestamped_tpu/__init__.py:25-74``):
``transcribe``, ``decode``, ``DecodingResult``, ``detect_language``,
``perform_word_alignment``, ``available_models``, ``Whisper``,
``ModelDimensions``, ``_MODELS``, ``_download`` and the modules
``normalizers``, ``audio``, ``decoding``, ``tokenizer``, ``utils`` and
``model`` resolve, lazily, to the port's own, and so does voice activity
detection's ``remove_non_speech``.
"""

__version__ = "0.1.0"

from .api import transcribe_timestamped  # noqa: F401
from .parallel.batch import transcribe_batch, transcribe_batch_stream  # noqa: F401
from .audio import (  # noqa: F401
    CHUNK_LENGTH,
    HOP_LENGTH,
    N_FFT,
    N_FRAMES,
    N_SAMPLES,
    SAMPLE_RATE,
    load_audio,
    log_mel_spectrogram,
    pad_or_trim,
)
from .decoding import DecodingOptions  # noqa: F401
from .models import WhisperDims, WhisperModel, WhisperTorch, init_params, load_model  # noqa: F401
from .tokenizer import Tokenizer, get_tokenizer  # noqa: F401

_LAZY = {
    "transcribe": ("whisper_timestamped_tpu_torch.api", "transcribe_timestamped"),
    "available_models": ("whisper_timestamped_tpu_torch.models.load", "available_models"),
    "decode": ("whisper_timestamped_tpu_torch.decoding", "decode"),
    "DecodingResult": ("whisper_timestamped_tpu_torch.decoding", "DecodingResult"),
    "detect_language": ("whisper_timestamped_tpu_torch.decoding", "detect_language"),
    "perform_word_alignment": ("whisper_timestamped_tpu_torch.alignment",
                               "perform_word_alignment"),
    # whisper's model names, resolving to the port's classes
    "Whisper": ("whisper_timestamped_tpu_torch.models.load", "WhisperModel"),
    "ModelDimensions": ("whisper_timestamped_tpu_torch.models.whisper_torch", "WhisperDims"),
    "_MODELS": ("whisper_timestamped_tpu_torch.models.load", "_MODELS"),
    "_download": ("whisper_timestamped_tpu_torch.models.load", "_download"),
    "remove_non_speech": ("whisper_timestamped_tpu_torch.vad", "remove_non_speech"),
}

_LAZY_MODULES = {
    "normalizers": "whisper_timestamped_tpu_torch.normalizers",
    "audio": "whisper_timestamped_tpu_torch.audio",
    "decoding": "whisper_timestamped_tpu_torch.decoding",
    "tokenizer": "whisper_timestamped_tpu_torch.tokenizer",
    "utils": "whisper_timestamped_tpu_torch.utils",  # whisper.utils' names
    "model": "whisper_timestamped_tpu_torch.models.whisper_torch",  # whisper.model's
}


def __getattr__(name):
    import importlib

    if name in _LAZY:
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    if name in _LAZY_MODULES:
        return importlib.import_module(_LAZY_MODULES[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
