"""Published peaks of the card and the operation and byte counts that the
roofline and utilisation readers divide by them.

Peaks: NVIDIA's data sheet for one H100 SXM at its 700 W limit, dense
rates.  A card set to a lower power limit reaches less; the run reports
the card's ``power.limit`` beside every share.
"""
from __future__ import annotations

import math

PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def nn_const_pair_flops(n: int, wrapped: bool) -> int:
    """fp32 flops of one (candidate, row) pair of the constant-metric
    nearest-node search: n subs, the squares summed (a mul and n - 1
    FMAs, each two flops: 3n - 1) and, with one wrapped dim, the turn and
    its correction (4)."""
    return 3 * n - 1 + (4 if wrapped else 0)


def block_write_bytes(horizon_steps: int, rows: int, batch: int) -> int:
    """Bytes one commit's edge writes must move: the (H, rows, B) float32
    rollouts read once and written once."""
    return 2 * horizon_steps * rows * batch * 4


def restart_tree_sizes(batch: int, capacity: int) -> list:
    """Rows of a fresh tree before each grow round of one restart cycle of
    ``Planner``'s fused restart chunk: the dense commit adds ``batch`` rows
    a round from the root pad (512 rows when batch and capacity are
    512-aligned and capacity >= 4096, else 1) until the capacity is
    reached."""
    pad = 512 if (batch % 512 == 0 and capacity % 512 == 0
                  and capacity >= 8 * 512) else 1
    rounds = math.ceil((capacity - pad) / batch)
    return [pad + r * batch for r in range(rounds)]
