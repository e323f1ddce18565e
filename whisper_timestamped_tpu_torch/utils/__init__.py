import torch

from .profiling import (  # noqa: F401
    add_count,
    get_counts,
    get_stage_timings,
    reset_stage_timings,
    stage_timer,
    trace,
)


def host_copy(tensor: torch.Tensor):
    """Start copying ``tensor`` to the host; returns a zero-argument function
    that waits for the copy and returns it as a numpy array.

    A CUDA tensor is copied into pinned memory without blocking, behind the
    work already queued on the current stream, and a recorded event marks
    its arrival (the counterpart of JAX's ``copy_to_host_async``); only the
    returned function waits. A CPU tensor is returned as it is."""
    if tensor.device.type != "cuda":
        arr = tensor.numpy()
        return lambda: arr
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    host.copy_(tensor, non_blocking=True)
    landed = torch.cuda.Event()
    landed.record(torch.cuda.current_stream(tensor.device))

    def wait():
        landed.synchronize()
        return host.numpy()

    return wait


# whisper.utils' names (``utils/__init__.py:8-24`` of the JAX package), on
# the port's own modules: ``whisper.utils.get_writer(...)`` keeps working.
# Lazy: the engine imports this package, and eager imports of the CLI and
# the decoding module would cycle back through it.
_WHISPER_UTILS = {
    "format_timestamp": ("whisper_timestamped_tpu_torch.writers", "format_timestamp"),
    "get_writer": ("whisper_timestamped_tpu_torch.writers", "get_writer"),
    "compression_ratio": ("whisper_timestamped_tpu_torch.decoding", "compression_ratio"),
    "str2bool": ("whisper_timestamped_tpu_torch.cli", "str2bool"),
    "optional_int": ("whisper_timestamped_tpu_torch.cli", "optional_int"),
    "optional_float": ("whisper_timestamped_tpu_torch.cli", "optional_float"),
}


def __getattr__(name):
    if name in _WHISPER_UTILS:
        import importlib

        module, attr = _WHISPER_UTILS[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
