"""Clips a batch over the batch size B, in %, averaged over the batches
the benchmark's batcher handed the program in the window."""


def read(run):
    fills = getattr(run.out, "fills", None)
    return 100.0 * sum(fills) / (len(fills) * run.spec["batch_size"]) if fills else None
