"""Work of one call of the decode step's cross-attention over the int8
encoder keys and values of one layer: B query rows of width D attend T
frames. Read once: the int8 keys and values (B, T, D), their f32 per-frame
scales (B, T) each, the bf16 queries (B, D); written once: the bf16 output
(B, D). The alignment heads' score rows, which some layers also write, are
not counted, so the share reads low rather than high there."""

KERNEL = "xattn_decode_int8_kernel"
EXCLUDE = None


def calls(run):
    """{(flops, bytes): calls} for the traced calls; every call of a cell has
    the cell's shape, so the count is the trace's."""
    d = run.config["dims"]
    B, T, D = run.spec["batch_size"], d["n_audio_ctx"], d["n_text_state"]
    _, n = run.tracer.kernel_time(KERNEL, EXCLUDE)
    work = (4.0 * B * T * D, 2.0 * B * T * D + 2 * 4.0 * B * T + 2 * 2.0 * B * D)
    return {work: n} if n else {}
