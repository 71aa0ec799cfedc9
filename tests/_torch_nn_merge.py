"""The NN kernels' block merge in plain PyTorch, for the port's CPU tests:
the reference that the partitioned-merge tests hold the blocked scans of
kernels A, C and E against."""
import torch

from lqrrt_tpu_torch.ops.kernels.nn_kernel import (EMPTY_KEY, pack_keys,
                                                   unpack_keys)


def partitioned_argmin(dist, size: int, B: int, parts: int, device):
    """The CUDA kernels' merge: the live rows [0, size) cut into ``parts``
    slices of a multiple of 4 rows, as the kernels' blocks take them
    (``block_rows`` in csrc/nn_common.cuh); each slice's first minimum (a
    strict '<' over increasing j) packed with ``pack_keys`` and merged by
    the keys' minimum.  ``dist(j0, j1)`` gives (B, j1 - j0) costs with dead
    rows and non-finite costs at +inf (as ``_mask`` leaves them), which
    never enter the merge.  Returns (ids, cost)."""
    keys = torch.full((B,), EMPTY_KEY, dtype=torch.int64, device=device)
    per = -(-(-(-size // parts)) // 4) * 4
    for lo in range(0, size, max(per, 1)):
        hi = min(lo + per, size)
        c, j = dist(lo, hi).min(dim=1)
        k = pack_keys(c, j + lo)
        keys = torch.where(torch.isfinite(c), torch.minimum(keys, k), keys)
    return unpack_keys(keys)
