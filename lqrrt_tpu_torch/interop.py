"""State carried between the JAX package and this port, as numpy.

``tree_from_numpy`` turns a JAX ``TreeArrays`` (after ``jax.device_get``, or
a dict with the same field names) into this package's
``TreeArrays`` on a device; ``tree_to_numpy`` goes back to a dict of numpy
arrays with the JAX dtypes, from which ``lqrrt_tpu.core.tree.TreeArrays(**d)``
rebuilds the JAX tree.  Every field is carried row for row, so a tree with
a per-node metric (the car's and the quadrotor's re-linearized S and K)
comes over whole.  ``lqr_from_numpy`` serves a JAX ``(S, K)`` as this
package's constant ``lqr``.  With these, both packages compute on the same
trees and metrics.  This module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.tree import TreeArrays
from .ops.riccati import constant_lqr

_DTYPES = dict(parent=np.int32, edge_len=np.int32, n_children=np.int32,
               size=np.int32, in_goal=np.bool_, goal_found=np.bool_)


def tree_from_numpy(tree, device="cuda") -> TreeArrays:
    """A tree with TreeArrays' field names (a NamedTuple or a dict of
    arrays) -> port TreeArrays on ``device``: the card unless the caller
    asks for the CPU, as ``Planner``."""
    d = tree if isinstance(tree, dict) else tree._asdict()
    out = {}
    for f in TreeArrays._fields:
        a = np.array(d[f], dtype=_DTYPES.get(f, np.float32))  # owned copy
        out[f] = torch.from_numpy(a).to(device)
    return TreeArrays(**out)


def tree_to_numpy(tree: TreeArrays) -> dict:
    """Port TreeArrays -> dict of numpy arrays with the JAX dtypes."""
    return {f: np.asarray(getattr(tree, f).cpu().numpy(),
                          dtype=_DTYPES.get(f, np.float32))
            for f in TreeArrays._fields}


def lqr_from_numpy(S, K):
    """A JAX (S, K) pair -> this package's constant lqr(x, u)."""
    return constant_lqr(np.asarray(S), np.asarray(K))
