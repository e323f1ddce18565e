"""Registry of cross-attention heads suitable for word alignment.

The (layer, head) pairs below are facts about OpenAI's released checkpoints
(the reference stores them as base85+gzip boolean masks, reference
``transcribe.py:2343-2357``; decoded here into plain literals). Model-name
inference from parameter counts mirrors reference ``transcribe.py:2359-2402``.

Copy of ``whisper_timestamped_tpu/models/alignment_heads.py``; framework-free.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

ALIGNMENT_HEADS = {
    "tiny.en": [(1, 0), (2, 0), (2, 5), (3, 0), (3, 1), (3, 2), (3, 3), (3, 4)],
    "tiny": [(2, 2), (3, 0), (3, 2), (3, 3), (3, 4), (3, 5)],
    "base.en": [(3, 3), (4, 7), (5, 1), (5, 5), (5, 7)],
    "base": [(3, 1), (4, 2), (4, 3), (4, 7), (5, 1), (5, 2), (5, 4), (5, 6)],
    "small.en": [(6, 6), (7, 0), (7, 3), (7, 8), (8, 2), (8, 5), (8, 7), (9, 0), (9, 4),
                 (9, 8), (9, 10), (10, 0), (10, 1), (10, 2), (10, 3), (10, 6), (10, 11),
                 (11, 2), (11, 4)],
    "small": [(5, 3), (5, 9), (8, 0), (8, 4), (8, 7), (8, 8), (9, 0), (9, 7), (9, 9), (10, 5)],
    "medium.en": [(11, 4), (14, 1), (14, 12), (14, 14), (15, 4), (16, 0), (16, 4), (16, 9),
                  (17, 12), (17, 14), (18, 7), (18, 10), (18, 15), (20, 0), (20, 3), (20, 9),
                  (20, 14), (21, 12)],
    "medium": [(13, 15), (15, 4), (15, 15), (16, 1), (20, 0), (23, 4)],
    "large-v1": [(9, 19), (11, 2), (11, 4), (11, 17), (22, 7), (22, 11), (22, 17), (23, 2),
                 (23, 15)],
    "large-v2": [(10, 12), (13, 17), (16, 11), (16, 12), (16, 13), (17, 15), (17, 16),
                 (18, 4), (18, 11), (18, 19), (19, 11), (21, 2), (21, 3), (22, 3), (22, 9),
                 (22, 12), (23, 5), (23, 7), (23, 13), (25, 5), (26, 1), (26, 12), (27, 15)],
    "large-v3": [(7, 0), (10, 17), (12, 18), (13, 12), (16, 1), (17, 14), (19, 11), (21, 4),
                 (24, 1), (25, 6)],
    "large-v3-turbo": [(2, 4), (2, 11), (3, 3), (3, 6), (3, 11), (3, 14)],
    "turbo": [(2, 4), (2, 11), (3, 3), (3, 6), (3, 11), (3, 14)],
}

# Parameter count (excluding untied proj / HF encoder positions) -> model name,
# reference ``transcribe.py:2359-2370``.
PARAMETERS_TO_MODEL_NAME = {
    37184256: "tiny.en",
    37184640: "tiny",
    71825408: "base.en",
    71825920: "base",
    240582144: "small.en",
    240582912: "small",
    762320896: "medium.en",
    762321920: "medium",
    1541384960: "large",
    1541570560: "large-v3",
    808786944: "turbo",
}


def heads_for_model_name(name: str) -> Optional[List[Tuple[int, int]]]:
    name = name.split("/")[-1].replace("whisper-", "")
    if name.endswith(".pt"):
        name = name[:-3]
    return ALIGNMENT_HEADS.get(name)


def infer_model_name(
    num_parameters: int, first_weight_positive: bool = True
) -> Optional[str]:
    """Infer the official model name from the parameter count.

    ``first_weight_positive`` is the sign of ``conv1.weight[0,0,0]``, which the
    reference uses to disambiguate the two checkpoints that share a parameter
    count (large-v1 vs large-v3 there — reference ``transcribe.py:2382-2386``;
    mirrored verbatim for parity).
    """
    name = PARAMETERS_TO_MODEL_NAME.get(num_parameters)
    if name == "large":
        name = "large-v1" if first_weight_positive else "large-v3"
    return name


def get_alignment_heads(
    model_name: Optional[str],
    n_text_layer: int,
    n_text_head: int,
) -> Optional[List[Tuple[int, int]]]:
    """(layer, head) pairs for alignment, or None (caller falls back to the
    top-of-stack layers, reference ``transcribe.py:259-261``)."""
    if model_name is None:
        return None
    heads = heads_for_model_name(model_name)
    if heads is None:
        return None
    assert all(l < n_text_layer and h < n_text_head for l, h in heads)
    return heads
