"""Host-facing ``Tree`` with the reference's API (port of lqrrt_tpu/tree.py).

Parallel lists as in the reference's lqrrt/tree.py: a state array, per-node
(S, K), per-edge rollouts, parent IDs with the root at -1, and ``size``;
``add_node``, ``climb`` (the root -> ID chain) and ``trajectory`` (the
chain's rollouts concatenated).  The planner keeps its tree on the device
(``core/tree.py``) and snapshots it into this class on demand
(``Planner.get_tree``).  Only numpy here; the snapshot reads tensors.
"""
from __future__ import annotations

import math

import numpy as np


class Tree:
    def __init__(self, seed_state, seed_lqr):
        seed_state = np.asarray(seed_state, np.float32)
        self.state = seed_state[None, :].copy()
        self.lqr = [seed_lqr]
        self.x_seq = [seed_state[None, :]]
        self.u_seq = [np.zeros((0, 0), np.float32)]
        self.pID = [-1]
        self.size = 1

    def add_node(self, ID: int, state, lqr, x_seq, u_seq) -> int:
        """Append a node whose incoming edge rollout is (x_seq, u_seq) and
        whose parent is ID. Returns the new node's index."""
        if not (0 <= ID < self.size):
            raise IndexError(f"parent {ID} out of range (size={self.size})")
        self.state = np.vstack([self.state,
                                np.asarray(state, np.float32)[None, :]])
        self.lqr.append(lqr)
        self.x_seq.append(np.asarray(x_seq, np.float32))
        self.u_seq.append(np.asarray(u_seq, np.float32))
        self.pID.append(int(ID))
        self.size += 1
        return self.size - 1

    def climb(self, ID: int):
        """Index chain from root to ID (inclusive)."""
        chain = []
        while ID != -1:
            chain.append(int(ID))
            ID = self.pID[ID]
        return chain[::-1]

    def trajectory(self, IDs):
        """Concatenate the per-edge rollouts along the chain IDs."""
        xs, us = [], []
        for ID in IDs:
            if ID == 0:
                continue  # root has no incoming edge
            xs.append(self.x_seq[ID])
            us.append(self.u_seq[ID])
        if not xs:
            return (self.state[:1].copy(),
                    np.zeros((0, 0), np.float32))
        return np.concatenate(xs, axis=0), np.concatenate(us, axis=0)

    @classmethod
    def from_device_arrays(cls, arrays) -> "Tree":
        """Snapshot a ``core.tree.TreeArrays`` into a host Tree (edges
        trimmed to their lengths; one copy of each field to the host).

        The dense commit stores an empty rollout as a zero-length copy of
        its parent, a row the reference's tree does not have, so the
        snapshot leaves such rows out and gives a child of one the row's
        nearest kept ancestor-equivalent (exact: a zero-length row's state
        is its parent's).  Rows with no parent (the root and the inert
        root copies of ``root_pad``) resolve to the root.  Equivalents are
        resolved by pointer jumping, which needs no row order: after
        refinement a parent may sit at a higher row than its child."""
        host = {f: np.asarray(getattr(arrays, f).detach().cpu().numpy())
                for f in ("state", "S", "K", "parent", "edge_x", "edge_u",
                          "edge_len", "size")}
        size = int(host["size"])
        lens = host["edge_len"][:size].astype(np.int64)
        parent = host["parent"][:size].astype(np.int64)
        keep = lens > 0
        keep[0] = True
        # a kept row is its own equivalent, a dropped one its parent's
        up = np.where(keep, np.arange(size), np.maximum(parent, 0))
        for _ in range(max(int(math.ceil(math.log2(max(size, 2)))), 1)):
            up = up[up]
        new_idx = np.cumsum(keep) - 1          # kept-row renumbering
        rows = np.flatnonzero(keep)

        state, S, K = host["state"], host["S"], host["K"]
        edge_x, edge_u = host["edge_x"], host["edge_u"]
        t = cls(state[0], (S[0], K[0]))
        t.state = np.asarray(state[rows], np.float32).copy()
        t.lqr = [(S[i], K[i]) for i in rows]
        # device edge storage is time-major (H, ., N); slice per node
        t.x_seq = [t.state[:1].copy()] + [
            np.asarray(edge_x[:lens[i], :, i], np.float32) for i in rows[1:]]
        t.u_seq = [np.zeros((0, 0), np.float32)] + [
            np.asarray(edge_u[:lens[i], :, i], np.float32) for i in rows[1:]]
        t.pID = [-1] + [int(new_idx[up[parent[i]]]) for i in rows[1:]]
        t.size = len(rows)
        return t
