"""The port's command line, writers and subtitle tool against the JAX package's.

On the CPU with the tiny synthetic checkpoint of ``model_utils`` written as
an OpenAI ``.pt`` with its ``.tiktoken`` vocabulary beside it. The writers
and the subtitle tool must give the same bytes as the JAX package's on the
stored goldens; the two CLIs the same words under the goldens' ``loose``
rounding (one decimal). Runs in-process wherever it can (``main(argv)``);
one subprocess shows that the port's CLI imports no JAX.
"""

import base64
import glob
import json
import os
import subprocess
import sys
import wave

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from model_utils import make_hf_model, save_openai_pt  # noqa: E402
from test_golden import EXPECTED_DIR, loose  # noqa: E402
from whisper_timestamped_tpu import cli as jax_cli  # noqa: E402
from whisper_timestamped_tpu import make_subtitles as jax_subs  # noqa: E402
from whisper_timestamped_tpu import writers as jax_writers  # noqa: E402
from whisper_timestamped_tpu_torch import cli  # noqa: E402
from whisper_timestamped_tpu_torch import make_subtitles as subs  # noqa: E402
from whisper_timestamped_tpu_torch import writers  # noqa: E402
from whisper_timestamped_tpu_torch.tokenizer import synthetic_ranks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = sorted(glob.glob(os.path.join(EXPECTED_DIR, "*.words.json")))
# random weights: no EOT, no thresholds, as the goldens' runs
QUIET = ["--language", "en", "--no_speech_threshold", "None", "--logprob_threshold", "None",
         "--compression_ratio_threshold", "None"]
SIX = (".words.json", ".txt", ".srt", ".vtt", ".csv", ".tsv")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_wav(path, seed, seconds, rate=16000):
    rng = np.random.default_rng(seed)
    sig = (rng.standard_normal(int(rate * seconds)) * 0.1 * 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(sig.tobytes())
    return str(path)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The tiny checkpoint and three WAVs (2, 3 and 4 s; the 3 s one at
    44.1 kHz, so the resampler runs)."""
    d = tmp_path_factory.mktemp("cli")
    path = save_openai_pt(make_hf_model(seed=0), str(d / "model.pt"))
    with open(d / "multilingual.tiktoken", "wb") as f:
        for k, v in synthetic_ranks().items():
            f.write(base64.b64encode(k) + b" " + str(v).encode() + b"\n")
    wavs = [_write_wav(d / "a.wav", 0, 2), _write_wav(d / "b.wav", 1, 3, rate=44100),
            _write_wav(d / "c.wav", 2, 4)]
    return path, wavs


def _outputs(directory):
    return {name: open(os.path.join(directory, name), "rb").read()
            for name in sorted(os.listdir(directory))}


def test_parser_matches_jax():
    """The same options with the same defaults, except the device and the
    backend, which name the port's runtime."""
    def options(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices) for a in parser._actions}

    ours, theirs = options(cli.build_parser()), options(jax_cli.build_parser())
    assert set(ours) == set(theirs)
    for dest in set(ours) - {"device", "backend"}:
        assert ours[dest] == theirs[dest], dest
    assert ours["device"][1:] == ("cuda", ["cuda", "cpu"])
    assert ours["backend"][1] == "torch"
    args = cli.build_parser().parse_args(["a.wav", "--accurate"])
    assert (args.beam_size, args.best_of, args.temperature_increment_on_fallback) == (5, 5, 0.2)


@pytest.mark.parametrize("options", [
    {}, {"max_line_width": 12}, {"max_words_per_line": 2}, {"highlight_words": True},
    {"max_line_width": 16, "max_line_count": 2, "highlight_words": True},
])
def test_writers_match_jax(options, tmp_path):
    """Every golden result through both packages' ``write_all_formats``:
    the same files, byte for byte."""
    for name, mod in (("ours", writers), ("jax", jax_writers)):
        os.makedirs(tmp_path / name)
        for path in GOLDENS:
            result = json.load(open(path, encoding="utf-8"))
            stem = os.path.basename(path)[: -len(".words.json")]
            mod.write_all_formats(result, str(tmp_path / name / stem), list(mod.VALID_FORMATS),
                                  options)
    ours = _outputs(tmp_path / "ours")
    assert len(ours) == 10 * len(GOLDENS) and ours == _outputs(tmp_path / "jax")


@pytest.mark.parametrize("max_length", [6, 20, 50])
def test_make_subtitles_matches_jax(max_length, tmp_path):
    """A folder of the goldens that carry words (the tool's input) through
    both subtitle tools: the same srt/vtt."""
    inputs = tmp_path / "in"
    os.makedirs(inputs)
    for path in GOLDENS:
        result = json.load(open(path, encoding="utf-8"))
        if result["segments"] and all("words" in s for s in result["segments"]):
            with open(inputs / os.path.basename(path), "w", encoding="utf-8") as f:
                json.dump(result, f)
    n = len(os.listdir(inputs))
    assert n >= 20
    subs.main([str(inputs), str(tmp_path / "ours"), "--max_length", str(max_length)])
    jax_subs.main([str(inputs), str(tmp_path / "jax"), "--max_length", str(max_length)])
    ours = _outputs(tmp_path / "ours")
    assert len(ours) == 2 * n and ours == _outputs(tmp_path / "jax")


def test_cli_matches_jax_cli(ckpt, tmp_path, capsys):
    """One WAV through both CLIs on the CPU: the six formats, the same text
    and the same words JSON under the goldens' loose rounding; without
    ``--output_dir`` the port prints the filtered JSON."""
    path, wavs = ckpt
    cli.main([wavs[0], "--model", path, "--device", "cpu", "-o", str(tmp_path / "ours"), *QUIET])
    jax_cli.main([wavs[0], "--model", path, "--device", "cpu", "-o", str(tmp_path / "jax"),
                  *QUIET])
    base = os.path.basename(wavs[0])
    assert sorted(os.listdir(tmp_path / "ours")) == sorted(os.listdir(tmp_path / "jax"))
    for ext in SIX:
        assert os.path.exists(tmp_path / "ours" / (base + ext)), ext
    ours = json.load(open(tmp_path / "ours" / (base + ".words.json"), encoding="utf-8"))
    theirs = json.load(open(tmp_path / "jax" / (base + ".words.json"), encoding="utf-8"))
    assert ours["text"] == theirs["text"]
    assert loose(ours) == loose(theirs)
    capsys.readouterr()
    cli.main([wavs[0], "--model", path, "--device", "cpu", *QUIET])
    assert loose(json.loads(capsys.readouterr().out)) == loose(cli.filtered_keys(ours))


def test_cli_batch_size_matches_serial(ckpt, tmp_path):
    """``--batch_size 2`` over three files (two batches through the serving
    loop) gives each file the serial run's tokens and words."""
    path, wavs = ckpt
    common = ["--model", path, "--device", "cpu", "-f", "json", *QUIET]
    cli.main([*wavs, "-o", str(tmp_path / "serial"), *common])
    cli.main([*wavs, "-o", str(tmp_path / "batched"), "--batch_size", "2", *common])
    for wav in wavs:
        name = os.path.basename(wav) + ".words.json"
        a = json.load(open(tmp_path / "serial" / name, encoding="utf-8"))
        b = json.load(open(tmp_path / "batched" / name, encoding="utf-8"))
        assert a["text"] == b["text"]
        assert [s["tokens"] for s in a["segments"]] == [s["tokens"] for s in b["segments"]]
        assert [w["text"] for s in a["segments"] for w in s.get("words", [])] == \
            [w["text"] for s in b["segments"] for w in s.get("words", [])]


@pytest.mark.parametrize("flags,option", [
    (["--vad", "True"], "vad"),
    (["--plot"], "plot"),
])
def test_cli_refuses_unported_options(ckpt, tmp_path, monkeypatch, flags, option):
    """``--vad`` and ``--plot``, once refused, now run and match JAX's CLI:
    ``--vad True`` (silero, the fake v5 weights of test_vad.py through
    ``SILERO_VAD_PATH``) gives the same words JSON under ``loose``, with
    ``speech_activity``; bare ``--plot`` with ``-o`` saves the same figure
    files next to the outputs."""
    from test_vad import _make_fake_silero_jit

    path, wavs = ckpt
    monkeypatch.setenv("SILERO_VAD_PATH", _make_fake_silero_jit(tmp_path))
    for name, main in (("ours", cli.main), ("jax", jax_cli.main)):
        main([*wavs[:2], "--model", path, "--device", "cpu", "-o", str(tmp_path / name), *QUIET,
              *flags])
    ours, theirs = _outputs(tmp_path / "ours"), _outputs(tmp_path / "jax")
    assert sorted(ours) == sorted(theirs)
    for wav in wavs[:2]:
        name = os.path.basename(wav) + ".words.json"
        a, b = (json.loads(d[name].decode("utf-8")) for d in (ours, theirs))
        assert loose(a) == loose(b)
        assert ("speech_activity" in a) == (option == "vad")
    figures = [n for n in ours if n.endswith(".jpg")]
    assert (len(figures) > 0) == (option == "plot")


def test_cli_plot_dir_matches_jax(ckpt, tmp_path):
    """``--plot DIR`` saves each file's figures under DIR, named after the
    audio (the alignments and, with ``--vad``, the VAD overlay): the same
    files as JAX's CLI."""
    path, wavs = ckpt
    for name, main in (("ours", cli.main), ("jax", jax_cli.main)):
        main([wavs[0], "--model", path, "--device", "cpu", "-o", str(tmp_path / (name + "_out")),
              *QUIET, "--vad", "auditok", "--plot", str(tmp_path / name)])
    ours = sorted(os.listdir(tmp_path / "ours"))
    assert ours == sorted(os.listdir(tmp_path / "jax"))
    base = os.path.basename(wavs[0])
    assert base + ".VAD.jpg" in ours and base + ".alignment001.jpg" in ours


SAMPLING_FLAGS = {
    "naive": [*QUIET, "--naive"],
    "best_of": [*QUIET, "--best_of", "2", "--temperature", "0.7"],
    # the default compression-ratio threshold: greedy output of the random
    # model is too repetitive, its sample at 0.2 is not
    "fallback": ["--language", "en", "--no_speech_threshold", "None", "--logprob_threshold",
                 "None", "--temperature_increment_on_fallback", "0.2"],
    # beam 5 at temperature 0, then best_of 5 at 0.2: the beam output of
    # the random model is too repetitive for the default threshold
    "accurate": ["--language", "en", "--no_speech_threshold", "None", "--logprob_threshold",
                 "None", "--accurate"],
}


@pytest.mark.parametrize("case", sorted(SAMPLING_FLAGS))
def test_cli_sampling_and_two_pass_match_jax_cli(ckpt, tmp_path, monkeypatch, case):
    """``--naive``, ``--best_of 2 --temperature 0.7`` and a fallback step
    run (the first was refused before): with JAX's noise substituted in
    process, the port's words JSON equals the JAX CLI's under the goldens'
    loose rounding."""
    from test_torch_sampling import jax_gumbel_source
    from whisper_timestamped_tpu_torch import decoding

    monkeypatch.setattr(decoding, "make_gumbel_source", jax_gumbel_source)
    path, wavs = ckpt
    common = [wavs[2], "--model", path, "--device", "cpu", "-f", "json", *SAMPLING_FLAGS[case]]
    cli.main([*common, "-o", str(tmp_path / "ours")])
    jax_cli.main([*common, "-o", str(tmp_path / "jax")])
    name = os.path.basename(wavs[2]) + ".words.json"
    ours = json.load(open(tmp_path / "ours" / name, encoding="utf-8"))
    theirs = json.load(open(tmp_path / "jax" / name, encoding="utf-8"))
    assert [s["tokens"] for s in ours["segments"]] == [s["tokens"] for s in theirs["segments"]]
    assert loose(ours) == loose(theirs)
    assert [w for s in ours["segments"] for w in s.get("words", [])]
    if case != "naive":
        assert all(s["temperature"] > 0 for s in ours["segments"])


def test_cli_beam_batch_matches_jax_cli(ckpt, tmp_path):
    """``--beam_size 3 --batch_size 2`` over the three files (two batches
    through the serving loop, beam decode and the batched teacher-forced
    pass): each words JSON equals the JAX CLI's under ``loose``."""
    path, wavs = ckpt
    common = [*wavs, "--model", path, "--device", "cpu", "-f", "json", *QUIET,
              "--beam_size", "3", "--batch_size", "2"]
    cli.main([*common, "-o", str(tmp_path / "ours")])
    jax_cli.main([*common, "-o", str(tmp_path / "jax")])
    for wav in wavs:
        name = os.path.basename(wav) + ".words.json"
        ours = json.load(open(tmp_path / "ours" / name, encoding="utf-8"))
        theirs = json.load(open(tmp_path / "jax" / name, encoding="utf-8"))
        assert [s["tokens"] for s in ours["segments"]] == [s["tokens"] for s in theirs["segments"]]
        assert loose(ours) == loose(theirs)
        assert [w for s in ours["segments"] for w in s.get("words", [])]


def test_cli_needs_the_card_by_default(ckpt, monkeypatch):
    """``--device`` defaults to cuda: with no card visible it raises
    instead of running on the CPU."""
    path, wavs = ckpt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([wavs[0], "--model", path, *QUIET])


def test_cli_subprocess_without_jax(ckpt, tmp_path):
    """``python -m``-style run with JAX made unimportable: exit 0, the six
    formats, and the subtitle tool on its words JSON. (A 16 kHz file: with
    ``sys.modules['jax'] = None`` scipy's resampler fails on its own check
    for JAX arrays.)"""
    path, wavs = ckpt
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.modules['jax'] = None\n"
         "from whisper_timestamped_tpu_torch.cli import main\nmain()",
         wavs[0], "--model", path, "--device", "cpu", "-o", str(out), "--threads", "1", *QUIET],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    base = os.path.basename(wavs[0])
    assert {base + ext for ext in SIX} <= set(os.listdir(out))
    subs.main([str(out / (base + ".words.json")), str(tmp_path / "subs"), "--max_length", "20"])
    assert sorted(os.listdir(tmp_path / "subs")) == ["a.wav.srt", "a.wav.vtt"]
