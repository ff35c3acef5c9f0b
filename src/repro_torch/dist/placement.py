"""Cost-ranked partition→host placement (distributed GNN-PE, arXiv
2511.09052 §load balancing).

The cluster tier assigns every graph partition to an owning host.  The
distributed GNN-PE paper ranks partitions by an estimated workload cost
and places them greedily on the least-loaded host — classic LPT
(longest-processing-time) list scheduling, which carries Graham's
additive guarantee

    max_load  ≤  total_cost / n_hosts  +  max_partition_cost

without needing the (unknowable) optimal assignment: when the greedy
pass places the partition that ends up defining ``max_load``, every
other host already carries at least ``max_load − that partition's
cost``, so ``total ≥ n · (max_load − c) + c``.  ``Placement.bound``
exposes exactly this quantity and the balance property test asserts
``max_load ≤ bound`` on adversarially skewed cost sets.

Costs come from ``GnnPeEngine.partition_stats()`` — the stacked probe's
per-partition scanned leaf pairs (the dynamic probe-work signal), the
candidate rows each partition served, its live row count and its index
bytes.  Dynamic signals dominate once observed; a cold engine (no
probes yet) degrades to the static row/byte proxy, so placement is
always defined.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["PartitionCost", "Placement", "partition_costs", "place_partitions", "load_bound"]


@dataclasses.dataclass(frozen=True)
class PartitionCost:
    """Scalar placement cost of one partition, plus its raw signals."""

    part_id: int
    cost: float
    leaf_pairs: int = 0
    probe_rows: int = 0
    rows: int = 0
    nbytes: int = 0


# weights over (leaf_pairs, probe_rows, rows, nbytes).  Scanned leaf
# pairs are the probe's actual work unit; candidate rows feed the join;
# live rows are the static stand-in before any probe ran; bytes break
# ties so two idle empty-ish partitions still order deterministically.
DEFAULT_WEIGHTS = (1.0, 4.0, 1.0, 1e-6)


def partition_costs(stats: list, weights: tuple = DEFAULT_WEIGHTS) -> list:
    """``GnnPeEngine.partition_stats()`` records → ``PartitionCost`` list."""
    w_lp, w_pr, w_rows, w_b = weights
    out = []
    for s in stats:
        lp = int(s.get("leaf_pairs", 0))
        pr = int(s.get("probe_rows", 0))
        rows = int(s.get("rows", 0))
        nb = int(s.get("nbytes", 0))
        out.append(
            PartitionCost(
                part_id=int(s["part_id"]),
                cost=w_lp * lp + w_pr * pr + w_rows * rows + w_b * nb,
                leaf_pairs=lp,
                probe_rows=pr,
                rows=rows,
                nbytes=nb,
            )
        )
    return out


def load_bound(costs: list, n_hosts: int) -> float:
    """Graham's additive LPT guarantee: ``total/n + max`` (see module doc)."""
    if not costs:
        return 0.0
    vals = [c.cost for c in costs]
    return sum(vals) / max(n_hosts, 1) + max(vals)


@dataclasses.dataclass
class Placement:
    """Partition→host assignment with its per-host load accounting.

    ``host_of[i]`` is the owning host of the partition at engine model
    index ``i`` (NOT ``part_id`` — the cluster tier addresses partitions
    the way the engine does, by model position).
    """

    host_of: np.ndarray  # (n_parts,) int64: model index -> host id
    loads: np.ndarray  # (n_hosts,) float64 assigned cost per host
    bound: float  # Graham bound the greedy assignment respects
    costs: list  # the PartitionCost inputs, engine model order

    @property
    def n_hosts(self) -> int:
        return int(self.loads.size)

    def owned(self, host: int) -> list:
        """Model indices owned by ``host``, ascending (probe order)."""
        return [int(i) for i in np.nonzero(self.host_of == host)[0]]

    def max_load(self) -> float:
        return float(self.loads.max()) if self.loads.size else 0.0

    def balanced(self) -> bool:
        """The testable LPT property: max host load within the bound."""
        return self.max_load() <= self.bound + 1e-9

    def as_dict(self) -> dict:
        return {
            "host_of": [int(h) for h in self.host_of],
            "loads": [float(x) for x in self.loads],
            "bound": float(self.bound),
            "max_load": self.max_load(),
            "balanced": self.balanced(),
        }


def place_partitions(costs: list, n_hosts: int) -> Placement:
    """Cost-ranked greedy placement (LPT): partitions sorted by cost
    descending (``part_id`` ascending on ties, so placement is
    deterministic), each assigned to the currently least-loaded host
    (lowest host id on ties).

    ``costs`` is in engine model order; the returned ``host_of`` is too.
    """
    if n_hosts < 1:
        raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
    n = len(costs)
    host_of = np.zeros(n, np.int64)
    loads = np.zeros(n_hosts, np.float64)
    order = sorted(range(n), key=lambda i: (-costs[i].cost, costs[i].part_id))
    for i in order:
        h = int(np.argmin(loads))  # argmin takes the lowest id on ties
        host_of[i] = h
        loads[h] += costs[i].cost
    return Placement(
        host_of=host_of, loads=loads, bound=load_bound(costs, n_hosts), costs=list(costs)
    )
