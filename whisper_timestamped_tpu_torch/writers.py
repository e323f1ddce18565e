"""Output writers: txt / vtt / srt / tsv / csv / json (+ word-level variants).

A copy of ``whisper_timestamped_tpu/writers.py`` (the port imports nothing of
the JAX package, whose ``__init__`` imports JAX): ``format_timestamp``, the
six writers, ``write_all_formats``, ``get_writer`` and ``VALID_FORMATS``, the
same bytes for the same result. Each writer takes an iterable of
segment-like dicts (``{"text", "start", "end", ...}``); word dicts work too,
which is how the ``.words.*`` variants are produced.
"""

from __future__ import annotations

import csv as _csv
import json
import os
from itertools import chain
from typing import IO, Iterable, Iterator, List, Optional


def format_timestamp(
    seconds: float, always_include_hours: bool = False, decimal_marker: str = "."
) -> str:
    """``HH:MM:SS.mmm`` (hour field elided when zero unless forced)."""
    if seconds < 0:
        raise ValueError("non-negative timestamp expected")
    hours, rem_ms = divmod(round(seconds * 1000.0), 3_600_000)
    minutes, rem_ms = divmod(rem_ms, 60_000)
    secs, ms = divmod(rem_ms, 1_000)
    head = f"{hours:02d}:" if (hours or always_include_hours) else ""
    return f"{head}{minutes:02d}:{secs:02d}{decimal_marker}{ms:03d}"


def flatten(list_of_dicts: Iterable[dict], key: Optional[str] = None) -> Iterator:
    """Chain the items of each dict's ``key`` list (segments → words)."""
    per_dict = ((d.get(key) or []) for d in list_of_dicts) if key else list_of_dicts
    return chain.from_iterable(per_dict)


def remove_keys(list_of_dicts: Iterable[dict], key: str) -> Iterator[dict]:
    return ({k: v for k, v in d.items() if k != key} for d in list_of_dicts)


def write_txt(transcript: Iterable[dict], file: IO):
    for segment in transcript:
        print(segment["text"].strip(), file=file, flush=True)


def _subtitle_blocks(
    segments: Iterable[dict],
    max_line_width: Optional[int],
    max_line_count: Optional[int],
    max_words_per_line: Optional[int],
) -> Iterator[List[List[dict]]]:
    """Regroup word timings into subtitle blocks (lists of lines of words).

    Analog of the line/block logic behind ``whisper.utils.SubtitlesWriter``
    (which the reference re-exports via ``whisper.utils``, reference
    ``__init__.py:2``): a line breaks when it would exceed ``max_line_width``
    characters or ``max_words_per_line`` words; a block closes when it holds
    ``max_line_count`` lines; segment boundaries always end the current block.
    """
    for seg in segments:
        lines: List[List[dict]] = []
        line: List[dict] = []
        width = 0
        for w in seg.get("words", []):
            text = w["text"]
            needed = len(text) + (1 if line else 0)
            full = (max_words_per_line and len(line) >= max_words_per_line) or (
                max_line_width and line and width + needed > max_line_width
            )
            if full:
                lines.append(line)
                line, width = [], 0
                if max_line_count and len(lines) >= max_line_count:
                    yield lines
                    lines = []
                needed = len(text)
            line.append(w)
            width += needed
        if line:
            lines.append(line)
        if lines:
            yield lines


def _iter_cues(
    transcript: Iterable[dict],
    highlight_words: bool = False,
    max_line_width: Optional[int] = None,
    max_line_count: Optional[int] = None,
    max_words_per_line: Optional[int] = None,
) -> Iterator[tuple]:
    """Yield ``(start, end, text)`` subtitle cues.

    Without any word-level option this is one cue per segment (the classic
    writers). With options set, cues are rebuilt from word timings; with
    ``highlight_words`` each word additionally gets its own cue with that word
    underlined (``<u>…</u>``) — karaoke-style, like whisper's writers."""
    word_mode = highlight_words or max_line_width or max_line_count or max_words_per_line
    for segment in transcript:
        if not (word_mode and segment.get("words")):
            yield segment["start"], segment["end"], segment["text"].strip()
            continue
        for lines in _subtitle_blocks(
            [segment], max_line_width, max_line_count, max_words_per_line
        ):
            words = [w for ln in lines for w in ln]
            start, end = words[0]["start"], words[-1]["end"]
            plain = "\n".join(" ".join(w["text"] for w in ln) for ln in lines)
            if not highlight_words:
                yield start, end, plain
                continue
            # one cue per word: the word's span runs to the next word's start
            # (so the highlight never flickers off between words)
            for i, w in enumerate(words):
                k = 0
                marked = []
                for ln in lines:
                    out = []
                    for x in ln:
                        out.append(f"<u>{x['text']}</u>" if k == i else x["text"])
                        k += 1
                    marked.append(" ".join(out))
                w_end = words[i + 1]["start"] if i + 1 < len(words) else end
                yield w["start"], w_end, "\n".join(marked)


def write_vtt(transcript: Iterable[dict], file: IO, **options):
    print("WEBVTT\n", file=file)
    for start, end, text in _iter_cues(transcript, **options):
        print(
            f"{format_timestamp(start)} --> {format_timestamp(end)}\n"
            f"{text.replace('-->', '->')}\n",
            file=file,
            flush=True,
        )


def write_srt(transcript: Iterable[dict], file: IO, **options):
    for i, (start, end, text) in enumerate(_iter_cues(transcript, **options), start=1):
        print(
            f"{i}\n"
            f"{format_timestamp(start, always_include_hours=True, decimal_marker=',')} --> "
            f"{format_timestamp(end, always_include_hours=True, decimal_marker=',')}\n"
            f"{text.replace('-->', '->')}\n",
            file=file,
            flush=True,
        )


def write_csv(
    transcript: Iterable[dict],
    file: IO,
    sep: str = ",",
    text_first: bool = True,
    format_timestamps=None,
    header=False,
):
    fmt_ts = format_timestamps or (lambda t: t)
    columns = ("text", "start", "end") if text_first else ("start", "end", "text")
    emit = _csv.writer(file, delimiter=sep)
    if header:
        emit.writerow(list(columns) if header is True else header)
    for seg in transcript:
        cell = {
            "text": seg["text"].strip(),
            "start": fmt_ts(seg["start"]),
            "end": fmt_ts(seg["end"]),
        }
        emit.writerow([cell[c] for c in columns])


def write_tsv(transcript: Iterable[dict], file: IO):
    """start/end in integer milliseconds, tab-separated, with header.

    Plain prints like whisper's WriteTSV (which the reference reuses) — no
    csv-module quoting; tabs inside the text are replaced with spaces."""
    print("start", "end", "text", sep="\t", file=file)
    for seg in transcript:
        print(
            round(1000 * seg["start"]),
            round(1000 * seg["end"]),
            seg["text"].strip().replace("\t", " "),
            sep="\t",
            file=file,
        )


def write_json(result: dict, file: IO):
    json.dump(result, file, indent=2, ensure_ascii=False)


WRITERS = {
    "txt": write_txt,
    "vtt": write_vtt,
    "srt": write_srt,
    "tsv": write_tsv,
    "csv": write_csv,
}

VALID_FORMATS = ["txt", "vtt", "srt", "tsv", "csv", "json"]


def write_all_formats(
    result: dict, outname: str, formats: List[str],
    subtitle_options: Optional[dict] = None,
):
    """Write every requested format (+ ``.words.*`` variants) for one result.

    ``subtitle_options`` (highlight_words / max_line_width / max_line_count /
    max_words_per_line) apply to the segment-level srt+vtt outputs only; the
    ``.words.*`` variants already carry per-word cues."""
    segments = result["segments"]
    sub_opts = {k: v for k, v in (subtitle_options or {}).items() if v}
    if "json" in formats:
        with open(outname + ".words.json", "w", encoding="utf-8") as f:
            write_json(result, f)
    if "txt" in formats:
        with open(outname + ".txt", "w", encoding="utf-8") as f:
            write_txt(segments, f)
    for fmt in ("vtt", "srt", "csv", "tsv"):
        if fmt in formats:
            writer = WRITERS[fmt]
            # newline="" is required for files handed to csv.writer (else \n
            # gets platform-translated on top of csv's own \r\n terminator)
            nl = "" if fmt == "csv" else None
            with open(f"{outname}.{fmt}", "w", encoding="utf-8", newline=nl) as f:
                if fmt in ("srt", "vtt") and sub_opts:
                    writer(segments, f, **sub_opts)
                else:
                    writer(remove_keys(segments, "words"), f)
            with open(f"{outname}.words.{fmt}", "w", encoding="utf-8", newline=nl) as f:
                writer(flatten(segments, "words"), f)


def get_writer(output_format: str, output_dir: str):
    """``whisper.utils.get_writer`` analog (the writer-factory entry point
    migrating code calls; the reference reuses whisper's writers,
    ``transcribe.py:2973-2999``).

    Returns ``writer(result, audio_path)`` which writes
    ``<output_dir>/<audio basename>.<ext>`` — or every format (plus the
    ``.words.*`` word-level variants) for ``"all"``."""
    if output_format == "all":
        formats = list(VALID_FORMATS)
    else:
        if output_format not in VALID_FORMATS:
            raise ValueError(
                f"unknown output format {output_format!r}; "
                f"expected one of {VALID_FORMATS + ['all']}"
            )
        formats = [output_format]

    def writer(result: dict, audio_path: str, **options):
        # options: highlight_words / max_line_width / max_line_count /
        # max_words_per_line for srt+vtt (whisper.utils writer-option surface)
        base = os.path.join(
            output_dir, os.path.splitext(os.path.basename(audio_path))[0]
        )
        if output_format == "all":
            write_all_formats(result, base, formats)
            return
        segments = result["segments"]
        if output_format == "json":
            with open(base + ".json", "w", encoding="utf-8") as f:
                write_json(result, f)
            return
        nl = "" if output_format == "csv" else None
        with open(f"{base}.{output_format}", "w", encoding="utf-8", newline=nl) as f:
            if output_format == "txt":
                write_txt(segments, f)
            elif output_format in ("srt", "vtt") and any(options.values()):
                WRITERS[output_format](segments, f, **options)
            else:
                WRITERS[output_format](remove_keys(segments, "words"), f)

    def write_result(result: dict, file: IO, options: Optional[dict] = None, **kw):
        """Write to an open file object — the ``ResultWriter.write_result``
        interface the reference's own writer shim calls
        (``transcribe.py:2984-2991`` passes ``{"highlight_words": ...}``)."""
        if output_format == "all":
            raise ValueError("write_result needs a single output format, not 'all'")
        opts = {k: v for k, v in {**(options or {}), **kw}.items() if v}
        segments = result["segments"]
        if output_format == "json":
            write_json(result, file)
        elif output_format == "txt":
            write_txt(segments, file)
        elif output_format in ("srt", "vtt") and opts:
            WRITERS[output_format](segments, file, **opts)
        else:
            WRITERS[output_format](remove_keys(segments, "words"), file)

    writer.write_result = write_result
    return writer
