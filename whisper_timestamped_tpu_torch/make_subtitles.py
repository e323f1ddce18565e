"""Subtitle splitter tool: words.json → srt/vtt with bounded line length.

A copy of ``whisper_timestamped_tpu/make_subtitles.py`` on the port's own
``alignment._punctuation`` and ``writers``: segments longer than
``max_length`` characters are split at word boundaries, preferring cut
points right after punctuation, using the word-level timestamps.

    python -m whisper_timestamped_tpu_torch.make_subtitles in.words.json out_dir --max_length 42
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

from .alignment import _punctuation
from .writers import write_srt, write_vtt


class _LineBuilder:
    """Accumulates words into a subtitle line, remembering the best
    punctuation cut point seen so far."""

    def __init__(self, start: float, use_space: bool):
        self.buf = ""
        self.start = start
        self.use_space = use_space
        # (cut position in buf, end time at the cut, start time after the cut)
        self.cut: Optional[tuple] = None

    def append(self, word: str) -> str:
        before = self.buf
        if self.buf and self.use_space:
            self.buf += " "
        self.buf += word
        return before

    def note_punctuation(self, end_time: float, next_start: Optional[float]):
        if self.buf and self.buf[-1] in _punctuation:
            self.cut = (len(self.buf), end_time, next_start)

    def flush_at_cut(self) -> dict:
        pos, end_time, next_start = self.cut
        emitted = {"text": self.buf[:pos], "start": self.start, "end": end_time}
        # NOTE: pos+1 assumes a space follows the cut; with use_space=False
        # this drops the next word's first character — a reference quirk
        # (reference make_subtitles.py:42) pinned by its goldens
        self.buf = self.buf[pos + 1 :]
        self.start = next_start
        self.cut = None
        return emitted


def split_long_segments(segments: List[dict], max_length: int, use_space: bool = True) -> List[dict]:
    """Split segments longer than ``max_length`` characters at word boundaries,
    preferring cut points right after punctuation (reference
    ``make_subtitles.py:8-65`` semantics)."""
    out: List[dict] = []
    for segment in segments:
        if len(segment["text"]) <= max_length:
            out.append(segment)
            continue

        meta_words = segment["words"]
        words = segment["text"].split() if use_space else [w["text"] for w in meta_words]
        if len(words) != len(meta_words):
            # punctuation may have been stripped from words; trust the words
            words = [w["text"] for w in meta_words]

        line = _LineBuilder(segment["start"], use_space)
        for i, (word, meta) in enumerate(zip(words, meta_words)):
            before = line.append(word)
            if len(line.buf) > max_length and before:
                if line.cut is not None:
                    out.append(line.flush_at_cut())
                else:
                    out.append({"text": before, "start": line.start,
                                "end": meta_words[i - 1]["end"]})
                    line.buf = word
                    line.start = meta["start"]
                    line.cut = None
            next_start = meta_words[i + 1]["start"] if i + 1 < len(meta_words) else None
            line.note_punctuation(meta["end"], next_start)

        if line.buf:
            out.append({"text": line.buf, "start": line.start, "end": segment["end"]})
    return out


_FORMATS = ("srt", "vtt")


def _stem(name: str) -> str:
    """`x.words.json` -> `x`; other json names lose one extension."""
    if name.endswith(".words.json"):
        return name[: -len(".words.json")]
    return os.path.splitext(name)[0]


def _plan_jobs(input_arg: str, output_arg: str, fmt: str):
    """Resolve (input json path, [output paths]) pairs.

    Two modes: an explicitly named output file (single conversion), or an
    output folder that receives one file per requested format per input
    (the input then being a single json or a folder of ``*.words.json``).
    """
    if not os.path.isdir(input_arg) and any(output_arg.endswith(e) for e in _FORMATS):
        parent = os.path.dirname(output_arg)
        if parent and not os.path.isdir(parent):
            os.makedirs(parent)
        return [(input_arg, [output_arg])]

    if os.path.isdir(input_arg):
        sources = [
            (os.path.join(input_arg, n), n)
            for n in os.listdir(input_arg)
            if n.endswith(".words.json")
        ]
    else:
        sources = [(input_arg, os.path.basename(input_arg))]
    if not os.path.isdir(output_arg):
        os.makedirs(output_arg)
    wanted = list(_FORMATS) if fmt == "all" else [fmt]
    return [
        (path, [os.path.join(output_arg, _stem(name) + "." + e) for e in wanted])
        for path, name in sources
    ]


def _convert_one(path: str, outputs: List[str], max_length: int) -> None:
    with open(path, encoding="utf-8") as f:
        transcript = json.load(f)
    segments = transcript["segments"]
    if max_length:
        # the reference CLI's unspaced-language list (make_subtitles.py:142;
        # note: without "yue", unlike the transcription-side should_use_space)
        use_space = transcript["language"] not in ("zh", "ja", "th", "lo", "my")
        segments = split_long_segments(segments, max_length, use_space=use_space)
    writers = {".srt": write_srt, ".vtt": write_vtt}
    for out in outputs:
        writer = writers.get(os.path.splitext(out)[1])
        if writer is None:
            raise RuntimeError(f"Unknown output format for {out}")
        with open(out, "w", encoding="utf-8") as f:
            writer(segments, file=f)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert .words.json transcriptions to srt/vtt, cutting long segments",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("input", type=str, help="input json file, or input folder")
    parser.add_argument("output", type=str, help="output srt/vtt file, or output folder")
    parser.add_argument("--max_length", default=200, type=int,
                        help="maximum length of a segment in characters")
    parser.add_argument("--format", type=str, default="all",
                        choices=list(_FORMATS) + ["all"],
                        help="output format (when the output is a folder)")
    args = parser.parse_args(argv)

    for path, outputs in _plan_jobs(args.input, args.output, args.format):
        _convert_one(path, outputs, args.max_length)


if __name__ == "__main__":
    main()
