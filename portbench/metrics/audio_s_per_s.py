"""Audio seconds of every batch yielded in the window over the window's
length, from its opening to the last yield (stream cells)."""


def read(run):
    return run.out.audio_s / run.window_s if run.out.audio_s and run.window_s > 0 else None
