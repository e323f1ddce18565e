"""A cell at a size the CPU holds: the configurations' full vocabulary and
layout, two layers of width 64, four streams a batch."""

import copy

from pbcore import manifest

DIMS = {"n_mels": 80, "n_audio_ctx": 1500, "n_audio_state": 64, "n_audio_head": 1,
        "n_audio_layer": 2, "n_audio_ffn": 256, "n_vocab": 51866, "n_text_ctx": 448,
        "n_text_state": 64, "n_text_head": 1, "n_text_layer": 2, "n_text_ffn": 256}


def cell(entry: str = "stream", **spec) -> manifest.Cell:
    config = copy.deepcopy(manifest.load_json("configs", "whisper-large-v3"))
    config["dims"] = dict(DIMS)
    config["alignment_heads"] = [[1, 0]]
    if entry == "stream":
        traffic = copy.deepcopy(manifest.load_json("traffic", "long-form-10-120s"))
        traffic.update(count=4, seconds={"kind": "log_uniform", "low": 10, "high": 45})
        base = {"warm_seconds": 35, "sample_requests": 2}
    else:
        traffic = copy.deepcopy(manifest.load_json("traffic", "clips-3-30s-poisson"))
        traffic.update(count=8)
        base = {"warm_seconds": 10, "sample_requests": 3, "rate_per_s": 4.0}
    traffic["audio"]["pool_seconds"] = 60
    full = {"config": "tiny", "traffic": "tiny", "chips": 1, "entry": entry, "batch_size": 4,
            "levers": {}, "tokens": 24, "condition_on_previous_text": True,
            "trace_seconds": 1.0, "limits": {"token_gap": 1e-3, "logprob_error": 0.05, "logprob_error_mean": 0.02,
                       "align_score_error": 0.2, "align_score_error_mean": 0.03,
                       "align_cost_error": 1e-4}, **base, **spec}
    bench = manifest.benchmark()
    metrics = lambda kind: [m for m in bench[kind]  # noqa: E731
                            if not m.get("workloads") or any(
                                entry in w.split(".")[-1] for w in m["workloads"])]
    return manifest.Cell(name=f"tiny.{entry}", spec=full, config=config, traffic=traffic,
                         end_to_end=metrics("end_to_end"), per_layer=metrics("per_layer"))
