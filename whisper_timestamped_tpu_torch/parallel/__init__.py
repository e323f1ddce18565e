"""Batched multi-stream transcription (``batch``) and its device-resident
window-advance state (``deviceflow``); port of
``whisper_timestamped_tpu/parallel/``. The mesh (tensor/data parallelism
over several cards) is not yet ported."""
