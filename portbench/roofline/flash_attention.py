"""Work of one call of the inference ``flash_attention``: B rows of H
heads, Sq queries attending Sk keys, width D = 64 H. Read once: the bf16
q (B, Sq, D), k and v (B, Sk, D); written once: the bf16 output (B, Sq, D).
Operations: 2 multiply-adds a query-key pair a head dimension (scores and
weighted values); a causal call (Sq = Sk) counts its Sq (Sq + 1) / 2 pairs.
A prompt's left padding is not subtracted: those calls are bound by their
bytes, which it does not change. Shapes are those the benchmark counted
at the calls (``program.Spans``)."""

KERNEL = "flash_attention_kernel"
EXCLUDE = "<true>"  # the training forward's instance


def work(B: int, Sq: int, Sk: int, D: int, causal: bool):
    pairs = Sq * (Sq + 1) / 2 if causal else Sq * Sk
    return (4.0 * B * pairs * D, 2.0 * B * (2 * Sq + 2 * Sk) * D)


def calls(run):
    out = {}
    for (B, Sq, Sk, D, _H, causal), n in run.spans.flash_calls.items():
        w = work(B, Sq, Sk, D, causal)
        out[w] = out.get(w, 0) + n
    return out
