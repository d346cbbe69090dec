"""Replica routing strategies (control plane, DESIGN.md §10); counterpart of
``repro.cluster.router`` (a copy).

Clipper replicates containers for throughput (paper §4.4.1, Fig 6) but its
dispatch assumes homogeneous replicas. A dynamic cluster is heterogeneous:
a logical model may be served by a fast small variant and a slow large one,
or by replicas on differently-loaded hosts. ``least_loaded`` (the
frontend's default, queue-length balancing) sends half the traffic to the
slow replica; ``LeastExpectedCompletion`` instead routes each query to the
replica that would *finish* it first, using the per-replica service-time
stats ``ReplicaSet`` tracks.

Routers are plain callables ``(replica_set, now) -> replica_index`` so the
frontend stays decoupled from this package.
"""

from __future__ import annotations

from repro_torch.core.containers import ReplicaSet


def least_loaded(rs: ReplicaSet, now: float) -> int:
    """Shortest queue among routable replicas — the frontend's default,
    exposed here so plans can name it."""
    return min(rs.candidates(), key=lambda i: (len(rs.queues[i]), i))


class LeastExpectedCompletion:
    """Route to the replica with the earliest expected completion time:

        ECT(i) = max(free_at[i] - now, 0) + (backlog_i + 1) * E[service_i]

    where ``E[service_i]`` is the replica's observed mean service seconds
    per query (``ReplicaSet.est_service``). Replicas without observations
    use ``default_service`` (0 = optimistic, so fresh replicas attract work
    and build stats immediately). Ties break on backlog then index, so the
    choice is deterministic.

    Each call leaves the decision's evidence in ``last_attrs`` — the
    chosen replica's expected completion seconds — which the frontend
    merges into the query's queue span when tracing is on, so a flamegraph
    shows what the router *predicted* next to what actually happened."""

    def __init__(self, default_service: float = 0.0):
        self.default_service = default_service
        self.last_attrs = {}

    def __call__(self, rs: ReplicaSet, now: float) -> int:
        ri = min(rs.candidates(), key=lambda i: (
            rs.expected_completion(i, now, self.default_service),
            len(rs.queues[i]), i))
        self.last_attrs = {
            "ect_s": rs.expected_completion(ri, now, self.default_service)}
        return ri


ROUTERS = {
    "least_loaded": lambda: least_loaded,
    "lect": LeastExpectedCompletion,
}


def make_router(name: str):
    if name not in ROUTERS:
        raise KeyError(f"unknown router {name!r}; have {sorted(ROUTERS)}")
    return ROUTERS[name]()
