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
"""

__version__ = "0.1.0"

from .api import transcribe_timestamped  # noqa: F401
from .parallel.batch import transcribe_batch, transcribe_batch_stream  # noqa: F401
from .audio import load_audio, log_mel_spectrogram, pad_or_trim  # noqa: F401
from .decoding import DecodingOptions  # noqa: F401
from .models import WhisperDims, WhisperModel, WhisperTorch, init_params, load_model  # noqa: F401
from .tokenizer import Tokenizer, get_tokenizer  # noqa: F401
