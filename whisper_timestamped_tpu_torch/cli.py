"""Command-line interface of the PyTorch/CUDA port.

Port of ``whisper_timestamped_tpu/cli.py``: the same options (names,
defaults and help, with the ``--accurate``/``--efficient`` presets), the
temperature schedule built the same way, the multi-file loop, six output
formats with ``.words.*`` variants, filtered JSON on stdout, and the
``--batch_size`` route through ``transcribe_batch_stream``. It differs where
the hardware does: ``--device`` is ``cuda`` (the default; no fallback to the
CPU when there is no card) or ``cpu``, ``--dtype`` names a torch dtype,
``--threads`` sets torch's CPU threads and ``--backend`` goes to
``load_model``, which loads each format natively.
Sampling (``--temperature`` above 0), ``--best_of``, a fallback step
(``--temperature_increment_on_fallback``), the two-pass ``--naive``, beam
search (``--beam_size``, ``--patience``, ``--length_penalty``) and the
``--accurate`` preset (beam 5, best_of 5, fallback step 0.2) run, one file
at a time and with ``--batch_size``, and so does ``--vad`` (silero on the
``--device``). ``--plot [DIR]`` draws the alignment figures (matplotlib),
saved under DIR, or next to the outputs with ``-o``, one file at a time.

    python -m whisper_timestamped_tpu_torch.cli audio.wav --model large-v3.pt -o out
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np
import torch

from . import __version__
from .api import transcribe_timestamped
from .languages import LANGUAGES, TO_LANGUAGE_CODE
from .models.load import BACKENDS, available_models, load_model
from .writers import VALID_FORMATS, write_all_formats

logger = logging.getLogger("whisper_timestamped_tpu_torch")

_VAD_FALSEY = (None, False, "False", "false", "None", "none")


def str2bool(string):
    str2val = {"true": True, "false": False}
    if string and string.lower() in str2val:
        return str2val[string.lower()]
    raise ValueError(f"Expected one of {set(str2val.keys())}, got {string}")


def optional_int(string):
    return None if string == "None" else int(string)


def optional_float(string):
    return None if string == "None" else float(string)


def str2output_formats(string):
    if string == "all":
        return list(VALID_FORMATS)
    formats = string.split(",")
    for fmt in formats:
        if fmt not in VALID_FORMATS:
            raise ValueError(f"Expected one of {VALID_FORMATS}, got {fmt}")
    return formats


def filtered_keys(result, keys=(
    "text", "segments", "words", "language", "start", "end", "confidence",
    "language_probs", "speech_activity",
)):
    """Round floats + keep the user-facing keys for stdout JSON."""
    if isinstance(result, dict):
        return {
            k: (filtered_keys(v, keys) if k not in ["language_probs"] else v)
            for k, v in result.items()
            if k in keys
        }
    if isinstance(result, list):
        return [filtered_keys(v, keys) for v in result]
    if isinstance(result, float):
        return round(result, 2)
    return result


class _ActionSetAccurate(argparse.Action):
    def __init__(self, option_strings, dest, nargs=None, **kwargs):
        super().__init__(option_strings, dest, nargs=0, **kwargs)

    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, "best_of", 5)
        setattr(namespace, "beam_size", 5)
        setattr(namespace, "temperature_increment_on_fallback", 0.2)


class _ActionSetEfficient(argparse.Action):
    def __init__(self, option_strings, dest, nargs=None, **kwargs):
        super().__init__(option_strings, dest, nargs=0, **kwargs)

    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, "best_of", None)
        setattr(namespace, "beam_size", None)
        setattr(namespace, "temperature_increment_on_fallback", None)


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Transcribe audio with word timestamps on an NVIDIA GPU (PyTorch/CUDA)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("-v", "--version", action="version", version=f"{__version__}")
    parser.add_argument(
        "--versions", action="version",
        version=f"whisper_timestamped_tpu_torch {__version__} (torch {torch.__version__})",
        help="show versions and exit",
    )
    parser.add_argument("audio", help="audio file(s) to transcribe", nargs="+")
    parser.add_argument(
        "--model",
        help=f"Whisper model: a local .pt / HF dir / safetensors, or one of "
        f"{', '.join(available_models())} (resolved against --model_dir)",
        default="small",
    )
    parser.add_argument("--model_dir", default=None, type=str,
                        help="path where model files are cached (default ~/.cache/whisper)")
    parser.add_argument("--tokenizer", default=None, type=str,
                        help="path to a .tiktoken vocabulary or HF tokenizer dir "
                        "(defaults to files found next to the model)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="device to run on; cuda raises when no card is visible")
    parser.add_argument("--backend", default="torch", choices=list(BACKENDS),
                        help="model backend (accepted for reference CLI "
                        "compatibility; openai-whisper and transformers "
                        "checkpoints are loaded natively into the PyTorch runtime)")
    parser.add_argument("--dtype", default=None, choices=[None, *DTYPES],
                        help="model compute dtype (default: bfloat16 on CUDA, which the "
                        "kernels take; float32 on the CPU)")
    parser.add_argument("--output_dir", "-o", default=None, type=str,
                        help="directory to save the outputs")
    parser.add_argument("--output_format", "-f", default="all", type=str2output_formats,
                        help=f"format(s) of the output files: {', '.join(VALID_FORMATS)}, "
                        "comma-separated, or 'all'")
    parser.add_argument("--highlight_words", default=False, type=str2bool,
                        help="underline each word as it is spoken in srt/vtt outputs")
    parser.add_argument("--max_line_width", default=None, type=optional_int,
                        help="max characters per subtitle line (srt/vtt)")
    parser.add_argument("--max_line_count", default=None, type=optional_int,
                        help="max lines per subtitle cue (srt/vtt)")
    parser.add_argument("--max_words_per_line", default=None, type=optional_int,
                        help="max words per subtitle line (srt/vtt)")
    parser.add_argument("--task", default="transcribe", choices=["transcribe", "translate"],
                        help="speech recognition ('transcribe') or X->English translation ('translate')")
    parser.add_argument(
        "--language", default=None,
        choices=sorted(LANGUAGES.keys()) + sorted(k.title() for k in TO_LANGUAGE_CODE.keys()),
        help="language spoken in the audio; None for auto-detection",
    )
    parser.add_argument("--vad", default=False,
                        help="VAD before transcription: True, False, auditok, energy, silero, "
                        "silero:3.1, or explicit '[(start, end), ...]' pairs")
    parser.add_argument("--detect_disfluencies", default=False, type=str2bool,
                        help="detect disfluencies, marked as [*]")
    parser.add_argument("--recompute_all_timestamps", default=False, type=str2bool,
                        help="do not rely on Whisper timestamps (experimental)")
    parser.add_argument("--punctuations_with_words", default=True, type=str2bool,
                        help="include punctuations in the words")
    parser.add_argument("--temperature", default=0.0, type=float, help="sampling temperature")
    parser.add_argument("--best_of", type=optional_int, default=None,
                        help="candidates when sampling with non-zero temperature")
    parser.add_argument("--beam_size", type=optional_int, default=None,
                        help="number of beams in beam search (temperature zero)")
    parser.add_argument("--patience", type=optional_float, default=None,
                        help="beam decoding patience")
    parser.add_argument("--length_penalty", type=optional_float, default=None,
                        help="token length penalty (alpha)")
    parser.add_argument("--suppress_tokens", default="-1", type=str,
                        help="comma-separated token ids to suppress; '-1' = most specials")
    parser.add_argument("--initial_prompt", default=None, type=str,
                        help="prompt text for the first window")
    parser.add_argument("--condition_on_previous_text", default=True, type=str2bool,
                        help="feed previous output as prompt for the next window")
    parser.add_argument("--fp16", default=None, type=str2bool,
                        help="accepted for reference compatibility (the dtype is --dtype)")
    parser.add_argument("--temperature_increment_on_fallback", default=0.0, type=optional_float,
                        help="temperature step when decoding fails the thresholds")
    parser.add_argument("--compression_ratio_threshold", default=2.4, type=optional_float)
    parser.add_argument("--logprob_threshold", default=-1.0, type=optional_float)
    parser.add_argument("--no_speech_threshold", default=0.6, type=optional_float)
    parser.add_argument("--threads", default=0, type=optional_int,
                        help="host CPU threads for inference (torch.set_num_threads)")
    parser.add_argument("--compute_confidence", default=True, type=str2bool)
    parser.add_argument("--verbose", type=str2bool, default=False)
    parser.add_argument("--plot", default=False, nargs="?", const=True, metavar="DIR",
                        help="plot word alignments (requires matplotlib); with a "
                             "directory argument, save figures there instead of "
                             "showing them")
    parser.add_argument("--debug", default=False, action="store_true")
    parser.add_argument("--accurate", action=_ActionSetAccurate,
                        help="shortcut for best_of=5, beam_size=5, fallback step 0.2")
    parser.add_argument("--efficient", action=_ActionSetEfficient,
                        help="shortcut for single greedy decoding")
    parser.add_argument("--naive", default=False, action="store_true",
                        help="two-pass approach (decode then re-forward for alignment)")
    parser.add_argument("--batch_size", default=0, type=int,
                        help="decode multiple input files through the batched "
                        "pipeline with this many streams in flight (0 = one "
                        "file at a time like the reference CLI)")
    return parser


def _run_batched(
    model, audio_files, batch_size, args, temperature, tokenizer,
    output_dir, output_format, subtitle_options=None,
):
    """Multi-file decoding through the serving loop: one batch of
    ``batch_size`` files at a time, the next batch's load and mel in flight
    while one decodes."""
    from .api import _resolve_tokenizer
    from .decoding import DecodingOptions
    from .parallel.batch import transcribe_batch_stream

    tok = _resolve_tokenizer(model, tokenizer, args.get("language"), args["task"])
    batches = [
        {p: p for p in audio_files[i : i + batch_size]}
        for i in range(0, len(audio_files), batch_size)
    ]
    results = {}
    gen = transcribe_batch_stream(
        model,
        batches,
        tok,
        language=args.get("language"),
        batch_size=batch_size,
        compute_word_confidence=args["compute_word_confidence"],
        detect_disfluencies=args["detect_disfluencies"],
        remove_punctuation_from_words=args["remove_punctuation_from_words"],
        vad=args["vad"],
        task=args["task"],
        temperature=temperature,
        compression_ratio_threshold=args["compression_ratio_threshold"],
        logprob_threshold=args["logprob_threshold"],
        no_speech_threshold=args["no_speech_threshold"],
        condition_on_previous_text=args["condition_on_previous_text"],
        initial_prompt=args["initial_prompt"],
        decode_options=DecodingOptions(
            beam_size=args.get("beam_size"),
            best_of=args["best_of"],
            patience=args["patience"],
            length_penalty=args["length_penalty"],
            suppress_tokens=args["suppress_tokens"],
        ),
    )
    for batch_results in gen:
        results.update(batch_results)
    for audio_path in audio_files:
        result = results[audio_path]
        if output_dir:
            outname = os.path.join(output_dir, os.path.basename(audio_path))
            write_all_formats(result, outname, output_format, subtitle_options)
        else:
            json.dump(filtered_keys(result), sys.stdout, indent=2, ensure_ascii=False)


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv).__dict__
    args.pop("accurate", None)
    args.pop("efficient", None)

    temperature = args.pop("temperature")
    increment = args.pop("temperature_increment_on_fallback")
    if increment:
        temperature = tuple(np.arange(temperature, 1.0 + 1e-6, increment))
    else:
        temperature = [temperature]

    threads = args.pop("threads")
    if threads:
        torch.set_num_threads(threads)

    device = args.pop("device")
    backend = args.pop("backend")
    audio_files = args.pop("audio")
    model_name = args.pop("model")
    model_dir = args.pop("model_dir")
    dtype = args.pop("dtype")
    tokenizer = args.pop("tokenizer")
    output_format = args.pop("output_format")
    plot_word_alignment = args.pop("plot")
    args.pop("fp16")

    debug = args.pop("debug")
    logging.basicConfig()
    if debug:
        logger.setLevel(logging.DEBUG)
    if backend != "torch":
        logger.info("backend %r checkpoints are loaded natively into PyTorch", backend)

    output_dir = args.pop("output_dir")
    if output_dir and not os.path.isdir(output_dir):
        os.makedirs(output_dir)

    if args["vad"] in _VAD_FALSEY:
        args["vad"] = False
    args["naive_approach"] = args.pop("naive")
    args["remove_punctuation_from_words"] = not args.pop("punctuations_with_words")
    args["compute_word_confidence"] = args.pop("compute_confidence")
    args["trust_whisper_timestamps"] = not args.pop("recompute_all_timestamps")

    model = load_model(model_name, device=device, download_root=model_dir, backend=backend,
                       dtype=DTYPES.get(dtype))

    subtitle_options = {
        k: args.pop(k)
        for k in ("highlight_words", "max_line_width", "max_line_count",
                  "max_words_per_line")
    }

    batch_size = args.pop("batch_size")
    if batch_size and len(audio_files) > 1:
        blockers = [
            label for label, flag in (
                ("naive/two-pass", args["naive_approach"]),
                ("verbose live printing", args["verbose"]),
                ("plot", plot_word_alignment),
                ("recompute_all_timestamps", not args["trust_whisper_timestamps"]),
            ) if flag
        ]
        if blockers:
            logger.warning(
                "--batch_size ignored (%s unsupported in the batched "
                "pipeline); processing files serially", ", ".join(blockers)
            )
        else:
            _run_batched(
                model, audio_files, batch_size, args, temperature, tokenizer,
                output_dir, output_format, subtitle_options,
            )
            return

    for audio_path in audio_files:
        outname = (
            os.path.join(output_dir, os.path.basename(audio_path)) if output_dir else None
        )
        # --plot DIR saves the figures under DIR; with an output directory,
        # bare --plot saves them next to the outputs; else they are shown
        if isinstance(plot_word_alignment, str):
            if not os.path.isdir(plot_word_alignment):
                os.makedirs(plot_word_alignment)
            args["plot_word_alignment"] = os.path.join(
                plot_word_alignment, os.path.basename(audio_path)
            )
        else:
            args["plot_word_alignment"] = (
                outname if (outname and plot_word_alignment) else plot_word_alignment
            )
        result = transcribe_timestamped(
            model, audio_path, temperature=temperature, tokenizer=tokenizer, **args
        )
        if output_dir:
            write_all_formats(result, outname, output_format, subtitle_options)
        elif not args["verbose"]:
            json.dump(filtered_keys(result), sys.stdout, indent=2, ensure_ascii=False)


if __name__ == "__main__":
    main()
