"""The benchmark's own tests on the CPU: work counts against hand counts,
the manifests, the import guard, the reference against the system at a
tiny size, and the comparison failing on a broken system.

    python -m pytest portbench/tests -q
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from pbcore import check, harness, manifest, traffic, work
from reference import mel as ref_mel
from reference import rules

import tiny

ROOT = manifest.CHECKOUT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


# --- work counts -----------------------------------------------------------

def test_flash_attention_work_by_hand():
    fa = manifest.load_module("roofline", "flash_attention")
    # B=2, Sq=Sk=3, D=4: 9 pairs x 4 dims x 2 products x 2 FLOPs x 2 rows
    assert fa.work(2, 3, 3, 4, False) == (4.0 * 2 * 9 * 4, 2.0 * 2 * (2 * 3 + 2 * 3) * 4)
    # causal: pairs (0,0) (1,0) (1,1) (2,0) (2,1) (2,2)
    assert fa.work(1, 3, 3, 4, True)[0] == 4.0 * 6 * 4


def test_xattn_decode_int8_work_by_hand():
    xa = manifest.load_module("roofline", "xattn_decode_int8")

    class Tr:
        def kernel_time(self, prefix, exclude):
            return 1.0, 7

    class Run:
        config = {"dims": {"n_audio_ctx": 5, "n_text_state": 8}}
        spec = {"batch_size": 3}
        tracer = Tr()

    ((flops, nbytes), calls), = xa.calls(Run()).items()
    assert calls == 7
    assert flops == 2 * (3 * 5 * 8) * 2  # q.k and p.v, 3 rows, 5 frames, 8 wide
    # int8 K and V, f32 scale per frame for each, bf16 q in and out
    assert nbytes == 2 * 3 * 5 * 8 + 2 * 4 * 3 * 5 + 2 * 2 * 3 * 8


def test_model_flops_by_hand():
    d = {"n_mels": 1, "n_audio_ctx": 2, "n_audio_state": 1, "n_audio_ffn": 1,
         "n_audio_layer": 1, "n_text_state": 1, "n_text_ffn": 1, "n_text_layer": 1,
         "n_vocab": 3}
    # convs: 2*4*1*3*1 + 2*2*1*3*1 = 36; layer: 2*2*4 + 4*4 + 4*2 = 40
    assert work.encoder_flops(d) == 36 + 40
    assert work.cross_kv_flops(d) == 8
    # context 2: 8 + 8 + 4 + 8 + 4
    assert work.decoder_position_flops(d, 2) == 32
    # prompt 2 + one more position (3 sampled), 3 logits rows of 2*1*3
    positions = sum(work.decoder_position_flops(d, c) for c in (1, 2, 3, 4))
    assert work.window_flops(d, 2, 3) == 76 + 8 + positions + 3 * 6


# --- manifests -------------------------------------------------------------

def test_manifest_finds_every_file_of_every_cell():
    bench = manifest.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for entry in bench["workloads"]:
        cell = manifest.cell(entry["name"], bench)
        assert cell.config["name"] == entry["config"]
        assert os.path.exists(os.path.join(manifest.HERE, "entries", cell.spec["entry"] + ".py"))
        assert {"setup_s", "peak_mem_gib"} <= {m["name"] for m in cell.end_to_end}
        assert len(cell.end_to_end) >= 3 and cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(manifest.load_module("metrics", m["name"]).read)
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert manifest.load_json("configs", c["name"])["source"] == c["source"]


def test_names_units_and_lines_follow_the_contract():
    bench = manifest.benchmark()
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in bench["workloads"]] + \
        [c["name"] for c in bench["configs"]] + [w["traffic"] for w in bench["workloads"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(bench)) < 64 * 1024


# --- guard -----------------------------------------------------------------

def test_guard_refuses_jax_and_the_jax_package_by_whole_name():
    code = ("import sys; sys.path.insert(0, %r); from pbcore import guard; guard.install()\n"
            "import whisper_timestamped_tpu_torch\n"
            "for name in ('jax', 'jaxlib.xla_client', 'whisper_timestamped_tpu', "
            "'whisper_timestamped_tpu.api'):\n"
            "    try:\n"
            "        __import__(name)\n"
            "    except ImportError:\n"
            "        continue\n"
            "    raise SystemExit('imported ' + name)\n"
            "assert guard.loaded() == [], guard.loaded()\n"
            "sys.modules['jax.numpy'] = object()\n"
            "assert guard.loaded() == ['jax'], guard.loaded()\n" % manifest.HERE)
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_run_refuses_without_a_card_and_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "large-v3.stream-b40-int8", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "cuda" in out.stderr.lower() and "{" not in out.stdout


# --- reference pieces --------------------------------------------------------

def test_reference_mel_matches_the_system_front_end():
    from whisper_timestamped_tpu_torch.audio import log_mel_spectrogram, mel_filters

    assert np.allclose(ref_mel.mel_filters(80), mel_filters(80), atol=1e-6)
    pool = traffic.make_pool(tiny.cell().traffic["audio"], 5, "cpu")
    x = torch.from_numpy(pool[: 16000 * 7])
    want = ref_mel.log_mel(x, 80)
    got = log_mel_spectrogram(x, n_mels=80, padding=ref_mel.PAD_SAMPLES)
    assert got.shape == want.shape
    assert float((got.double() - want).abs().max()) < 2e-4


def test_rules_advance_matches_whisper_segmentation():
    from whisper_timestamped_tpu_torch.engine import WindowDecodeResult, extract_window_segments

    tok = __import__("pbcore.program", fromlist=["x"]).build_tokenizer(tiny.cell().config)
    vocab = tiny.cell().config["vocabulary"]
    ts = vocab["timestamp_begin"]
    cases = [[ts, 5, 6, ts + 10, ts + 10, 7, ts + 20],  # ends on a lone timestamp
             [ts, 5, ts + 10, ts + 10, 7, 8],  # ends inside a segment
             [ts, 5, 6, 7],  # no pair
             [ts + 3, 9, ts + 40, ts + 40, 4, ts + 50, ts + 50]]  # ends on a pair
    for toks in cases:
        res = WindowDecodeResult(tokens=toks, text="", avg_logprob=0.0, no_speech_prob=0.0,
                                 temperature=0.0, compression_ratio=1.0,
                                 token_logprobs=np.zeros(len(toks)))
        segs, seek = extract_window_segments(res, 600, 3000, tok, None, None)
        used, new_seek = rules.advance(vocab, toks, 600, 10000)
        assert new_seek == seek
        assert toks[:used] == [t for s in segs for t in s.tokens]


def test_sample_holds_the_longest_and_depends_on_the_seed():
    items = [traffic.Item(f"s{i}", 0, 100 + i) for i in range(20)]
    a, b = check.sample(items, 4, 1), check.sample(items, 4, 2)
    assert a[0].name == b[0].name == "s19" and len(a) == 4
    assert check.sample(items, 4, 1) == a and a != b


def test_traffic_gives_every_seed_the_same_sizes_in_another_order():
    t = manifest.load_json("traffic", "long-form-10-120s")
    a = next(traffic.batches(t, 1, 10 ** 7))
    b = next(traffic.batches(t, 2 ** 33 + 5, 10 ** 7))
    assert sorted(i.samples for i in a) == sorted(i.samples for i in b)
    assert [i.samples for i in a] != [i.samples for i in b]
    c = manifest.load_json("traffic", "clips-3-30s-poisson")
    x = traffic.arrivals(c, 1, 10 ** 7, 20.0, 30.0)
    assert 450 < len(x) < 750 and all(p.due_s < q.due_s for p, q in zip(x, x[1:]))


# --- the whole run at a tiny size --------------------------------------------

def _run(cell, seed=11, seconds=1.0, break_program=None, control=None):
    return harness.run_cell(cell, seed, seconds, False, "cpu", time.perf_counter(),
                            log=lambda m: None, break_program=break_program, control=control)


@pytest.mark.parametrize("entry", ["stream", "serve"])
def test_reference_agrees_with_the_system_at_a_tiny_size(entry):
    res = _run(tiny.cell(entry))
    checks = res["checks"]
    assert res["correct"], checks
    assert res["attempted"] > 0 and res["failed"] == 0
    assert checks["window_mismatches"]["value"] == 0
    assert checks["token_gap"]["value"] < 1e-3
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "levers",
                         "checks"]
    assert checks["align_unjudged"]["value"] == 0 and checks["align_start_mismatches"]["value"] == 0
    assert checks["align_cost_error"]["value"] < 1e-6
    assert "setup_s" in res["metrics"]


def _alter_a_token():
    """A token altered where it is produced: at the sixth step the loop
    takes the allowed token the filtered logits like least."""
    import whisper_timestamped_tpu_torch.decoding as dec

    rules_fn = dec.apply_timestamp_rules

    def broken(logits, last, penult, max_ts, n_sampled, **kw):
        out = rules_fn(logits, last, penult, max_ts, n_sampled, **kw)
        worst = torch.where(torch.isfinite(out), out, torch.full_like(out, float("inf"))).argmin(-1)
        bump = torch.zeros_like(out).scatter_(1, worst[:, None], 1e4)
        return torch.where(torch.as_tensor(n_sampled) == 5, out + bump, out)

    dec.apply_timestamp_rules = broken
    return lambda: setattr(dec, "apply_timestamp_rules", rules_fn)


@pytest.mark.parametrize("entry", ["stream", "serve"])
def test_an_altered_token_is_not_correct(entry):
    undo = []
    try:
        res = _run(tiny.cell(entry), break_program=lambda: undo.append(_alter_a_token()))
    finally:
        for u in undo:
            u()
    assert not res["correct"]
    assert res["checks"]["token_gap"]["value"] > res["checks"]["token_gap"]["limit"]


def _alter_the_alignment(stage: str):
    """An alignment altered where it is produced: the alignment heads'
    scores of the third row of every window, the cost of the second token
    of every segment, or the start frame the DTW finds for it."""
    import whisper_timestamped_tpu_torch.decoding as dec
    from whisper_timestamped_tpu_torch import device_align as da

    if stage == "rows":
        drain = dec._drain_rows

        def broken(st, out, first, last, max_new):
            drain(st, out, first, last, max_new)
            if out["attn"] is not None and first <= 2 < last:
                out["attn"][:, 2] += 0.5

        dec._drain_rows = broken
        return lambda: setattr(dec, "_drain_rows", drain)
    name = "align_cost_gather" if stage == "cost" else "dtw_starts"
    fn = getattr(da, name)

    def altered(*args):
        out = fn(*args).clone()
        out[:, 1] += 0.05 if stage == "cost" else 1
        return out

    setattr(da, name, altered)
    return lambda: setattr(da, name, fn)


@pytest.mark.parametrize("stage,number", [("rows", "align_score_error"),
                                          ("cost", "align_cost_error"),
                                          ("start", "align_start_mismatches")])
def test_an_altered_alignment_is_not_correct(stage, number):
    undo = []
    try:
        res = _run(tiny.cell("stream"), break_program=lambda: undo.append(_alter_the_alignment(stage)))
    finally:
        for u in undo:
            u()
    assert not res["correct"]
    assert res["checks"][number]["value"] > res["checks"][number]["limit"], res["checks"]


def test_the_float8_control_is_not_correct_at_a_tiny_size():
    res = _run(tiny.cell("stream"), control="fp8")
    assert not res["correct"]
    assert res["checks"]["logprob_error_mean"]["value"] > res["checks"]["logprob_error_mean"]["limit"]
    assert res["checks"]["align_cost_error"]["value"] > res["checks"]["align_cost_error"]["limit"]
