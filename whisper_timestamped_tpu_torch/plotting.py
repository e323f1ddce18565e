"""Diagnostic plots: alignment heatmaps and VAD overlays.

Copy of ``whisper_timestamped_tpu/plotting.py``. When ``plot`` is a path,
figures are saved as ``<plot>.alignment%03d.jpg`` / ``<plot>.VAD.jpg``;
otherwise shown. matplotlib is imported only when a figure is drawn.
"""

from __future__ import annotations

from typing import List

import numpy as np

num_alignment_for_plot = 0


def reset_plot_counter() -> None:
    """Called at the start of each transcription so figure numbering restarts
    at 001 per call (reference ``transcribe.py:300-301``)."""
    global num_alignment_for_plot
    num_alignment_for_plot = 0


def plot_alignment(
    cost: np.ndarray,  # (n_tokens, span) negative-similarity cost matrix
    index1s: np.ndarray,
    index2s: np.ndarray,
    words: List[dict],
    start_time: float,
    plot,
    mfcc: np.ndarray = None,  # (n_mels, n_frames) window mel, frames = 2x positions
    mfcc_span=None,  # (start_token, end_token) positions within the window
    peak_traces=None,  # [(begin, end, attn_row, peaks, properties)] per token
) -> None:
    """Alignment diagnostic figure, mirroring the reference's pane layout
    (``transcribe.py:1586-1646``): the attention heatmap + DTW path + word
    boundaries on top, an optional mel-spectrogram pane below it, and an
    optional disfluency pane showing each token's attention trace with its
    detected peaks (intermediate peaks red, the retained last peak green —
    ``transcribe.py:1690-1708``)."""
    global num_alignment_for_plot
    num_alignment_for_plot += 1
    import matplotlib

    if isinstance(plot, str):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n_panes = 1 + (mfcc is not None) + (peak_traces is not None)
    plt.subplots(
        n_panes, 1, figsize=(16, 9),
        gridspec_kw={"height_ratios": [3] + [1] * (n_panes - 1)},
    )
    plt.subplot(n_panes, 1, 1)
    plt.imshow(-cost, aspect="auto", origin="upper")
    plt.plot(index2s, index1s, color="red")
    for w in words:
        x = (w["start"] - start_time) / 0.02
        plt.axvline(x, color="red", linestyle="dotted")
        plt.text(x, -0.5, w["text"], color="red", ha="left", va="bottom")
    plt.ylabel("Tokens")

    pane = 2
    if mfcc is not None:
        plt.subplot(n_panes, 1, pane)
        pane += 1
        # mel frames run at 2x the token-position rate
        s, e = mfcc_span if mfcc_span is not None else (0, mfcc.shape[-1] // 2)
        plt.imshow(np.asarray(mfcc)[:, 2 * s : 2 * e], aspect="auto", origin="lower")
        plt.yticks([])
        plt.ylabel("MFCC")
        for w in words:
            x = 2 * (w["start"] - start_time) / 0.02
            plt.axvline(x, color="red", linestyle="dotted")

    if peak_traces is not None:
        plt.subplot(n_panes, 1, pane)
        xmax = 1
        for begin, end, row, peaks, properties in peak_traces:
            plt.plot(range(begin, end), row)
            xmax = max(xmax, end)
            for i, p in enumerate(peaks):
                color = "red" if (len(peaks) > 1 and i < len(peaks) - 1) else "green"
                plt.vlines(begin + p, 0, 1, color=color, linestyle="--")
            for left in properties.get("left_ips", ()):
                plt.vlines(begin + left, 0, 0.5, color="green", linestyle=":")
            for right in properties.get("right_ips", ()):
                plt.vlines(begin + right, 0, 0.5, color="red", linestyle=":")
        plt.xlim(0, xmax)
        plt.ylabel("Peaks")

    plt.xlabel("Time (20ms positions)")
    if isinstance(plot, str):
        plt.savefig(f"{plot}.alignment{num_alignment_for_plot:03d}.jpg",
                    bbox_inches="tight", pad_inches=0)
        plt.close()
    else:  # pragma: no cover - interactive
        plt.show()


def plot_vad(audio: np.ndarray, segments, sample_rate: int, plot) -> None:
    import matplotlib

    if isinstance(plot, str):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure()
    max_num_samples = 10000
    step = (audio.shape[-1] // max_num_samples) + 1
    times = np.arange(0, audio.shape[-1], step) / sample_rate
    plt.plot(times, audio[::step])
    for s, e in segments:
        plt.axvspan(s / sample_rate, e / sample_rate, color="red", alpha=0.1)
    if isinstance(plot, str):
        plt.savefig(f"{plot}.VAD.jpg", bbox_inches="tight", pad_inches=0)
        plt.close()
    else:  # pragma: no cover - interactive
        plt.show()
