"""Neighbour topologies for decentralized FL (a numpy copy of
`fedml_tpu/comm/topology.py`; reference:
core/distributed/topology/symmetric_topology_manager.py:7,
asymmetric_topology_manager.py:7).

Each manager holds a row-stochastic mixing matrix (numpy f64, bitwise the
JAX package's); the decentralized runtimes take it as gossip weights, one
[n, n] x [n, D] product a leaf.
"""
from __future__ import annotations

import numpy as np


class SymmetricTopologyManager:
    """A ring with `neighbor_num` symmetric neighbours a node (the
    reference's undirected ring extension)."""

    def __init__(self, n: int, neighbor_num: int = 2):
        self.n = n
        self.neighbor_num = min(neighbor_num, n - 1)
        self.topology = self._build()

    def _build(self) -> np.ndarray:
        W = np.eye(self.n)
        half = max(1, self.neighbor_num // 2)
        for i in range(self.n):
            for d in range(1, half + 1):
                W[i, (i + d) % self.n] = 1.0
                W[i, (i - d) % self.n] = 1.0
        return W / W.sum(axis=1, keepdims=True)  # row-stochastic

    def get_in_neighbor_idx_list(self, node: int) -> list[int]:
        return [j for j in range(self.n)
                if self.topology[node, j] > 0 and j != node]

    get_out_neighbor_idx_list = get_in_neighbor_idx_list  # symmetric


class AsymmetricTopologyManager:
    """A directed ring: each node listens to `in_num` predecessors, and
    `out_num` adds directed out-edges to its successors. The push and
    listen graphs are two views of one matrix (out-neighbours of j are the
    rows that listen to j; reference asymmetric_topology_manager.py:91-110),
    so a push can never miss an edge the mixing step needs."""

    def __init__(self, n: int, in_num: int = 2, out_num: int = 1):
        self.n = n
        self.in_num = min(in_num, n - 1)
        self.out_num = min(out_num, n - 1)
        W = np.eye(n)
        for i in range(n):
            # row i listens to in_num predecessors
            for d in range(1, self.in_num + 1):
                W[i, (i - d) % n] = 1.0
            # directed push links i -> i+1..i+out_num (rows listening to i)
            for d in range(1, self.out_num + 1):
                W[(i + d) % n, i] = 1.0
        self.topology = W / W.sum(axis=1, keepdims=True)

    def get_in_neighbor_idx_list(self, node: int) -> list[int]:
        return [j for j in range(self.n)
                if self.topology[node, j] > 0 and j != node]

    def get_out_neighbor_idx_list(self, node: int) -> list[int]:
        return [i for i in range(self.n)
                if self.topology[i, node] > 0 and i != node]
