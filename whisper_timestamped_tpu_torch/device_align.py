"""Batched word alignment on the device.

Port of ``whisper_timestamped_tpu/device_align.py``:

    attention buffer (device, from decode_window)
      -> fused cost of each segment's token rows and frame window, read in
         place: median9, softmax, head mean, L2, negate  (align_cost kernel, two launches)
      -> DTW and the walk back to per-token start frames (dtw_codes kernel, one launch)

and only the (S, N) int32 start frames cross to the host: the ``jumps``
``perform_word_alignment`` takes as ``precomputed_jumps`` (with
``fetch_cost``, the cost matrices too, for disfluency detection). No window
copy and no step codes are made in device memory. On CPU tensors the plain
versions run: the gather and slice, the cost, the DP and a Python loop of
small tensor ops for the backtrace (``ops.kernels.backtrace_batch``).
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .alignment import AlignmentPlan, plan_alignment
from .audio import N_FRAMES
from .ops.kernels import align_cost_gather, dtw_starts
from .utils import host_copy

M_PAD = ((N_FRAMES // 2 + 127) // 128) * 128  # 1536: frame capacity per segment
TOKEN_BUCKET = 64  # token rows pad to multiples of 64 (up to 256)
SEG_BUCKET_MIN = 8  # segment counts pad geometrically: 8, 16, 32, ...
MAX_K = 32  # most alignment heads the device aligner takes


def default_device_alignment(device) -> bool:
    """Resolve ``device_alignment=None`` (``device_align.py:65-81``): the
    WTT_DEVICE_ALIGN env var wins ("1"/"0"); otherwise on when the model's
    ``device`` is CUDA (the JAX package asks its default backend). The
    callers still take the host path when the device aligner's gates fail
    (more than ``MAX_K`` heads, ``trust_whisper_timestamps=False``)."""
    env = os.environ.get("WTT_DEVICE_ALIGN")
    if env is not None:
        return env == "1"
    return torch.device(device).type == "cuda"


def _seg_bucket(S: int) -> int:
    b = SEG_BUCKET_MIN
    while b < S:
        b *= 2
    return b


class SegmentAlignTask(NamedTuple):
    """One segment's device-alignment request."""

    plan: AlignmentPlan
    flat_rows: np.ndarray  # row of the flattened attention buffer per planned token
    max_duration: Optional[int]  # absolute column cap (segment_frames // 2)


def _align_jumps(attn_flat: torch.Tensor, rows: np.ndarray, dims: np.ndarray):
    """Cost, DTW and backtrace for a padded batch of segments. rows (S, N)
    row indices into attn_flat (R, K, T); dims (S, 4) (n_tokens, span,
    maxdur_col, start). Returns (starts (S, N) int32, cost (S, N, M_PAD))."""
    if rows.size and not 0 <= int(rows.min()) <= int(rows.max()) < attn_flat.shape[0]:
        raise ValueError(f"row indices outside the {attn_flat.shape[0]} attention rows")
    dev = attn_flat.device
    rows_t = torch.as_tensor(rows, dtype=torch.int32, device=dev)
    dims_t = torch.as_tensor(dims, dtype=torch.int32, device=dev)
    cost = align_cost_gather(attn_flat, rows_t, dims_t, M_PAD)
    return dtw_starts(cost, dims_t), cost


def make_task(
    tokens: Sequence[int],
    row_offset: int,
    local_rows: Sequence[int],
    tokenizer,
    *,
    refine_whisper_precision_nframes: int = 0,
    unfinished_decoding: bool = False,
    max_duration: Optional[int] = None,
) -> Optional[SegmentAlignTask]:
    """Plan one segment. ``local_rows[k]`` is the attention row (within the
    window's buffer) feeding token k; ``row_offset`` places the window's rows
    in the flattened buffer. None when the plan is empty."""
    plan = plan_alignment(
        tokens, tokenizer, refine_whisper_precision_nframes, unfinished_decoding
    )
    if plan.empty:
        return None
    local = np.asarray(local_rows, np.int64)
    flat = row_offset + local[plan.row_indices]
    return SegmentAlignTask(plan=plan, flat_rows=flat, max_duration=max_duration)


def compute_jumps_batch(attn_flat, tasks: List[SegmentAlignTask], fetch: bool = True,
                        fetch_cost: bool = False):
    """Run the device aligner for a batch of segments. Returns, per task,
    the (n_tokens + 1,) int64 jumps array for ``precomputed_jumps``, or with
    ``fetch_cost`` a (jumps, cost) pair, cost the segment's (n_tokens, span)
    f32 cost matrix with the weight edits applied (``precomputed_cost``, the
    rows disfluency detection reads).

    ``fetch=False`` (``device_align.py:178-244``) queues the aligner and
    non-blocking copies of its start frames (and cost) into pinned host
    memory, and returns a zero-argument resolver for the same list: the
    batch pipeline resolves at assembly time, so no read blocks its window
    loop."""
    if not tasks:
        return [] if fetch else (lambda: [])
    attn_flat = torch.as_tensor(attn_flat)
    S = len(tasks)
    n_max = max(len(t.plan.tokens) for t in tasks)
    n_pad = int(np.ceil(max(n_max, TOKEN_BUCKET) / TOKEN_BUCKET) * TOKEN_BUCKET)
    S_pad = _seg_bucket(S)

    rows = np.zeros((S_pad, n_pad), np.int64)
    dims = np.zeros((S_pad, 4), np.int32)
    dims[:, 0] = 2  # dummy segments: 2 tokens, 2 frames
    dims[:, 1] = 2
    dims[:, 2] = M_PAD
    for s, t in enumerate(tasks):
        n = len(t.plan.tokens)
        span = t.plan.end_token - t.plan.start_token
        rows[s, :n] = t.flat_rows
        maxdur = M_PAD  # sentinel: no masking
        if t.max_duration and t.plan.start_token < t.max_duration:
            maxdur = min(t.max_duration, M_PAD)
        dims[s] = (n, span, maxdur, t.plan.start_token)

    starts_dev, cost_dev = _align_jumps(attn_flat, rows, dims)
    starts_host = host_copy(starts_dev)
    cost_host = host_copy(cost_dev) if fetch_cost else None

    def resolve() -> List:
        starts = starts_host()
        cost = cost_host() if fetch_cost else None
        out = []
        for s, t in enumerate(tasks):
            n = len(t.plan.tokens)
            span = t.plan.end_token - t.plan.start_token
            jumps = np.concatenate([starts[s, :n], [span - 1]]).astype(np.int64)
            out.append((jumps, cost[s, :n, :span]) if fetch_cost else jumps)
        return out

    return resolve() if fetch else resolve
