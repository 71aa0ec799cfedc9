"""Device-agnostic constants for batch-leading callbacks."""
from __future__ import annotations

import numpy as np
import torch


class Const:
    """A numpy constant materialised once per (device, dtype).

    Model callbacks take tensors on any device; the first call on a device
    copies the constant there, every later call reuses that copy.  The
    planner's warmup reaches every callback, so no copy (and no host sync)
    happens inside a timed chunk.
    """

    def __init__(self, value):
        self.value = np.array(value)   # an owned, writable copy
        self._on = {}

    def like(self, t: torch.Tensor, dtype=None) -> torch.Tensor:
        if dtype is None:
            dtype = (t.dtype if self.value.dtype.kind == "f"
                     else torch.from_numpy(self.value[:0]).dtype)
        key = (t.device, dtype)
        out = self._on.get(key)
        if out is None:
            out = torch.as_tensor(self.value, dtype=dtype, device=t.device)
            self._on[key] = out
        return out
