"""Model FLOPs of the work a window completed, from the architecture's
shapes (a multiply-add is 2 FLOPs; layer norms, softmax and GELU are not
counted). A decoded window row is: the encoder over its 3000 mel frames
(1500 positions), the cross-attention keys and values of every decoder
layer over those positions, the decoder over the prompt, then one decoder
position for each sampled token after the first, and the vocabulary
projection for each sampled token."""

from __future__ import annotations

from typing import Iterable, Tuple


def encoder_flops(d: dict) -> float:
    D, F, T, L = d["n_audio_state"], d["n_audio_ffn"], d["n_audio_ctx"], d["n_audio_layer"]
    convs = 2 * (2 * T) * d["n_mels"] * 3 * D + 2 * T * D * 3 * D
    layer = 2 * T * 4 * D * D + 2 * 2 * T * T * D + 2 * 2 * T * D * F
    return convs + L * layer


def cross_kv_flops(d: dict) -> float:
    D = d["n_text_state"]
    return d["n_text_layer"] * 2 * 2 * d["n_audio_ctx"] * D * D


def decoder_position_flops(d: dict, context: int) -> float:
    """One decoder position attending ``context`` positions of its own."""
    D, F, L = d["n_text_state"], d["n_text_ffn"], d["n_text_layer"]
    layer = (2 * 4 * D * D + 2 * 2 * context * D + 2 * 2 * D * D
             + 2 * 2 * d["n_audio_ctx"] * D + 2 * 2 * D * F)
    return L * layer


def window_flops(d: dict, prompt_len: int, sampled: int) -> float:
    positions = prompt_len + max(sampled - 1, 0)
    dec = sum(decoder_position_flops(d, p + 1) for p in range(positions))
    return (encoder_flops(d) + cross_kv_flops(d) + dec
            + sampled * 2 * d["n_text_state"] * d["n_vocab"])


def completed_flops(d: dict, rows: Iterable[Tuple[int, int]]) -> float:
    """Sum over the live (prompt length, sampled tokens) window rows."""
    cache = {}
    total = 0.0
    for row in rows:
        if row not in cache:
            cache[row] = window_flops(d, *row)
        total += cache[row]
    return total
