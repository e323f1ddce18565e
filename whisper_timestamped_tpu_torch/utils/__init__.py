from .profiling import (  # noqa: F401
    add_count,
    get_counts,
    get_stage_timings,
    reset_stage_timings,
    stage_timer,
)


def not_ported(option: str) -> NotImplementedError:
    """The error for an option of the JAX package that this port does not
    have yet: raised, never silently ignored."""
    return NotImplementedError(f"{option} is not yet ported to whisper_timestamped_tpu_torch")
