"""Spawn a multiplexed estimator-server fleet as real OS processes: the
port's own copy of ``karmada_tpu/estimator/fleet.py``.

Shard the cluster list over N server processes (``python -m
karmada_tpu_torch.estimator --spec-file``, each on torch ``device``,
MultiClusterEstimatorService routing by request.cluster), connect one gRPC
channel per server, and register a RemoteAccurateEstimator per cluster.
Ref: cmd/scheduler-estimator (per-member deployment), client/service.go
(discovery); the consolidated N-clusters-per-process shape is the
operator's answer at hundreds of members.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from dataclasses import dataclass, field


@dataclass
class EstimatorFleet:
    """Handles for a spawned estimator-server fleet; ``close()`` tears
    everything down (kill + wait + unlink)."""

    registry: object = None
    procs: list = field(default_factory=list)
    conns: list = field(default_factory=list)
    spec_paths: list = field(default_factory=list)

    def close(self) -> None:
        for conn in self.conns:
            try:
                conn.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
        for proc in self.procs:
            try:
                proc.wait(timeout=5)
            except Exception:  # noqa: BLE001
                pass
        for path in self.spec_paths:
            try:
                os.unlink(path)
            except OSError:
                pass

    def __enter__(self) -> "EstimatorFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def spawn_estimator_fleet(
    names: list,
    free_caps,
    dims: list,
    *,
    n_servers: int = 2,
    index=None,
    timeout_seconds: float = 10.0,
    device: str = "cuda",
) -> EstimatorFleet:
    """Spawn ``n_servers`` estimator processes hosting ``names`` between
    them, each cluster's single node holding the ``free_caps`` row for it
    (capacities keyed positionally via ``index`` — a name->row mapping —
    or by list order), every server's node sums on torch ``device``.
    Returns an EstimatorFleet whose ``registry`` holds a
    RemoteAccurateEstimator per cluster."""
    from ..localup import scrape_line, spawn_child
    from .accurate import EstimatorRegistry
    from .grpc_transport import GrpcEstimatorConnection, RemoteAccurateEstimator

    fleet = EstimatorFleet(registry=EstimatorRegistry())
    try:
        if index is None:
            # one name->row map up front: names.index(name) inside the
            # spec comprehension is O(n) per lookup — an O(n^2 x dims)
            # spec build at 512+ clusters
            index = {name: i for i, name in enumerate(names)}
        shard = (len(names) + n_servers - 1) // n_servers
        for s in range(n_servers):
            names_s = names[s * shard:(s + 1) * shard]
            if not names_s:
                continue
            spec = {
                name: {
                    d: int(free_caps[index[name]][r])
                    for r, d in enumerate(dims)
                }
                for name in names_s
            }
            f = tempfile.NamedTemporaryFile("w", suffix=".json", delete=False)
            json.dump(spec, f)
            f.close()
            fleet.spec_paths.append(f.name)
            proc = spawn_child(
                [sys.executable, "-m", "karmada_tpu_torch.estimator",
                 "--spec-file", f.name],
                device=device,
            )
            fleet.procs.append(proc)
            port = scrape_line(proc, r"port (\d+)", timeout=120)
            conn = GrpcEstimatorConnection(
                "multi", f"127.0.0.1:{port}",
                timeout_seconds=timeout_seconds,
            )
            fleet.conns.append(conn)
            for name in names_s:
                fleet.registry.register(
                    RemoteAccurateEstimator(name, conn, lambda: list(dims))
                )
        return fleet
    except Exception:
        fleet.close()
        raise
