"""Per-call context threaded through model applies."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Ctx:
    """seed: the step's EMT noise seed (a Python int, uint32 range)."""
    seed: int = 0

    def with_seed(self, seed: int) -> "Ctx":
        return dataclasses.replace(self, seed=seed)
