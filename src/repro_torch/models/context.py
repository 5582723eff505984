"""Per-call context threaded through model applies."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Ctx:
    """seed: the step's EMT noise seed (a Python int, uint32 range).
    key:  the threefry noise backend's key, JAX's two uint32 key words
          (``core.noise.prng_key``; None with the hash backend: the
          engines' and the train step's contexts leave it None, as JAX's
          do)."""
    seed: int = 0
    key: Optional[Tuple[int, int]] = None

    def with_seed(self, seed: int) -> "Ctx":
        return dataclasses.replace(self, seed=seed)
