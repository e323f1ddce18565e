"""Word/segment post-processing sanitizers.

Behavioral counterparts of the reference's hallucination pruning and
monotonic-timestamp repair (reference ``transcribe.py:2202-2262`` and
``transcribe.py:2265-2295``), restructured: chunk-trailing empty words are
found by grouping words per audio chunk and taking each chunk's trailing
zero-duration run, and the timestamp repair is an iterative fixpoint sweep
rather than recursion.

Copy of ``whisper_timestamped_tpu/postprocess.py``; framework-free.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Tuple

from .alignment import round_timestamp

logger = logging.getLogger("whisper_timestamped_tpu")


def _chunk_index_per_segment(segments: List[Dict]) -> List[int]:
    """Chunk id for each segment: segments decoded from the same 30-s window
    share a ``seek``; a seek change starts a new chunk."""
    ids: List[int] = []
    for seg in segments:
        prev_seek = segments[len(ids) - 1]["seek"] if ids else None
        new_chunk = not ids or seg["seek"] != prev_seek
        ids.append((ids[-1] + 1 if new_chunk else ids[-1]) if ids else 0)
    return ids


def _strip_word_from_text(text: str, word_text: str) -> str:
    """Remove ``word_text`` from the end of ``text``.

    Tokenizer round-trips can drift by one character on either side
    (reference issue #62, handled at ``transcribe.py:2238-2245``): tolerate a
    missing final char in either string before giving up.
    """
    if text.endswith(word_text):
        return text[: len(text) - len(word_text)] if word_text else text
    if word_text and text.endswith(word_text[:-1]):
        return text[: len(text) - (len(word_text) - 1)]
    if text[:-1].endswith(word_text):
        return text[: len(text) - 1 - len(word_text)]
    raise RuntimeError(f"{text!r} not ending with {word_text!r}")


def remove_last_null_duration_words(
    transcription: Dict, words: List[Dict], recompute_text: bool = False
) -> Tuple[Dict, List[Dict]]:
    """Drop zero-duration words at the end of an audio chunk.

    Whisper hallucinates trailing tokens when a window runs dry; they align
    to a single frame (start == end) at the chunk boundary. Only the trailing
    run of each chunk is pruned — an empty word followed by a real one is
    kept (reference semantics, ``transcribe.py:2217-2254``).
    """
    segments = transcription["segments"]
    chunk_ids = _chunk_index_per_segment(segments)

    # word indices grouped per chunk, in reading order
    per_chunk: Dict[int, List[int]] = {}
    for wi, word in enumerate(words):
        per_chunk.setdefault(chunk_ids[word["idx_segment"]], []).append(wi)

    doomed: List[int] = []
    for chunk_words in per_chunk.values():
        for wi in reversed(chunk_words):
            if words[wi]["start"] != words[wi]["end"]:
                break
            doomed.append(wi)
    doomed.sort(reverse=True)

    for wi in doomed:
        word = words[wi]
        si = word["idx_segment"]
        seg = segments[si]
        shortened = _strip_word_from_text(seg["text"], "".join(word["tokens"]))
        last_of_segment = wi == 0 or words[wi - 1]["idx_segment"] != si
        if last_of_segment:
            # no words remain in this segment: drop it and shift the segment
            # indices of every later word down
            logger.debug("Removing empty segment %d", si)
            segments.pop(si)
            for later in words[wi + 1 :]:
                later["idx_segment"] -= 1
        else:
            seg["text"] = shortened

    for wi in doomed:
        words.pop(wi)

    if recompute_text or doomed:
        transcription["text"] = "".join(s["text"] for s in segments)

    return transcription, words


def ensure_increasing_positions(segments: List[Dict], min_duration: float = 0) -> List[Dict]:
    """Repair start/end so positions never run backwards.

    An overlapping start is pulled to the midpoint between it and the
    previous end (and the previous end pulled back to meet it) — unless the
    midpoint would crowd the previous segment below ``min_duration``, in
    which case the start clamps forward to the previous end instead. Pulling
    a previous end back can create a new overlap upstream, so the sweep
    repeats until it makes no backward edit (reference semantics,
    ``transcribe.py:2265-2295``).
    """
    while True:
        edited_backward = False
        prev_end = 0.0
        for idx, seg in enumerate(segments):
            if seg["start"] < prev_end:
                assert idx > 0
                midpoint = round_timestamp((prev_end + seg["start"]) / 2)
                if midpoint < segments[idx - 1]["start"] + min_duration:
                    seg["start"] = prev_end
                else:
                    segments[idx - 1]["end"] = midpoint
                    seg["start"] = midpoint
                    edited_backward = True
            if seg["end"] <= seg["start"] + min_duration:
                seg["end"] = seg["start"] + min_duration
            prev_end = seg["end"]
        if not edited_backward:
            break

    prev_end = 0.0
    for seg in segments:
        seg["start"] = round_timestamp(seg["start"])
        seg["end"] = round_timestamp(seg["end"])
        assert seg["start"] >= prev_end, (
            f"segment {seg} starts before the previous one ends ({prev_end})"
        )
        assert seg["end"] >= seg["start"], f"segment {seg} ends before it starts"
        prev_end = seg["end"]

    return segments
