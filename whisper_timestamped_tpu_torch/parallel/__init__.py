"""Batched multi-stream transcription (``batch``), its device-resident
window-advance state (``deviceflow``) and the mesh (``mesh``: data and
tensor parallelism on ``torch.distributed``); port of
``whisper_timestamped_tpu/parallel/``. ``get_mesh``, ``shard_params``,
``shard_batch`` and ``param_shard_dims`` (``param_pspec_tree``'s
counterpart) resolve lazily, so that the package imports without
``torch.distributed`` being initialized."""

_MESH = ("get_mesh", "shard_params", "shard_batch", "place_batch", "param_shard_dims")


def __getattr__(name):
    if name in _MESH:
        from . import mesh

        return getattr(mesh, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
