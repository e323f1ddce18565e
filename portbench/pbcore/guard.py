"""Keep JAX and the JAX package out of the benchmark's process.

Names are compared by their top-level part, whole: ``whisper_timestamped_tpu``
is refused, ``whisper_timestamped_tpu_torch`` (the system under test) is
not. A meta-path finder refuses the import; ``sys.modules['jax'] = None``
would trip scipy, which reads that entry."""

from __future__ import annotations

import importlib.abc
import sys
from typing import List

REFUSED = ("jax", "jaxlib", "flax", "whisper_timestamped_tpu")


class RefuseJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"portbench: refused import of {name}")
        return None


def install() -> None:
    if not any(isinstance(f, RefuseJax) for f in sys.meta_path):
        sys.meta_path.insert(0, RefuseJax())


def loaded() -> List[str]:
    """The refused top-level names that ``sys.modules`` holds."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(REFUSED))
