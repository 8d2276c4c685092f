"""Out-of-process pull-mode agent: ``cmd/agent`` run over the store bus.
The port's own copy of ``karmada_tpu/bus/agent.py``.

Ref: cmd/agent/app/agent.go — the reference agent is a separate process
INSIDE the member cluster that talks to the control plane over the
network: it pulls Works for its execution namespace, applies them into the
local cluster, reflects status back, and keeps the cluster Lease renewed
so the control plane's lease-freshness health check holds.

This module is that process for the TPU-native plane: the network channel
is the store bus (bus.service) — a ``StoreReplica`` mirrors the plane's
state over the gRPC watch stream, and every agent write (Work status,
Lease renewal) rounds-trip through the primary via the bus Apply RPC. The
agent logic itself is the SAME ``KarmadaAgent`` controller that runs
in-process for locally-joined Pull members (controllers/remedy.py) —
``ReplicaStoreFacade`` gives it the Store surface over the replica.

Run: ``python -m karmada_tpu_torch.bus.agent --target host:port --cluster
name``. The agent builds no engine, so it takes no ``--device``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

from ..estimator.accurate import NodeState
from ..utils.member import MemberCluster
from ..utils.worker import Runtime


class ReplicaStoreFacade:
    """The Store surface a controller needs, over a ``StoreReplica``:
    reads and watches hit the local mirror (always cheap, never a network
    round-trip); writes go through the primary and become visible locally
    only via the echoed watch event — the replica can never diverge from
    the primary's admission decisions."""

    def __init__(self, replica) -> None:
        self._replica = replica

    # -- reads (mirror) ----------------------------------------------------

    def get(self, kind: str, key: str):
        return self._replica.store.get(kind, key)

    def list(self, kind: str, namespace: Optional[str] = None):
        return self._replica.store.list(kind, namespace)

    def watch(self, kind: str, fn, replay: bool = True):
        return self._replica.store.watch(kind, fn, replay=replay)

    # -- writes (primary, over the bus) ------------------------------------

    def apply(self, obj, *, expected_rv=None):
        return self._replica.apply(obj, expected_rv=expected_rv)

    def apply_many(self, objs):
        """Batched write-through (Store.apply_many contract): one
        ApplyBatch RPC per KARMADA_TPU_BUS_BATCH ops instead of one
        round-trip per object — the controllers' per-drain write sets
        ride this over the bus."""
        return self._replica.apply_many(objs)

    def delete(self, kind: str, key: str, force: bool = False):
        return self._replica.delete(kind, key, force=force)

    def delete_many(self, keys):
        return self._replica.delete_many(keys)


def _default_member(name: str) -> MemberCluster:
    """The member cluster this agent lives in. In this simulated world the
    'cluster' is a MemberCluster object local to the agent process — the
    same runtime seam every in-proc test drives."""
    member = MemberCluster(name)
    member.nodes = [
        NodeState(
            name=f"{name}-node-{i}",
            allocatable={"cpu": 8000, "memory": 32 << 30, "pods": 110},
        )
        for i in range(2)
    ]
    return member


def _simulate_kubelet(member: MemberCluster) -> None:
    """Bring applied workloads 'up': any replica-bearing resource without a
    ready status reports all replicas ready — the stand-in for kubelets
    starting pods, so health interpretation returns Healthy and the plane
    sees the propagation complete."""
    for obj in member.list():
        reps = obj.spec.get("replicas") if isinstance(obj.spec, dict) else None
        if reps is None:
            continue
        st = obj.status or {}
        if st.get("readyReplicas") != reps:
            member.set_workload_status(
                f"{obj.api_version}/{obj.kind}",
                obj.meta.namespace,
                obj.meta.name,
                {
                    "replicas": reps,
                    "readyReplicas": reps,
                    "updatedReplicas": reps,
                    "availableReplicas": reps,
                },
            )


def agent_main(
    target: str,
    cluster_name: str,
    *,
    loop_interval: float = 0.05,
    lease_interval: float = 0.5,
    simulate_ready: bool = True,
    max_seconds: Optional[float] = None,
    member: Optional[MemberCluster] = None,
    root_ca: Optional[bytes] = None,
    client_cert: Optional[bytes] = None,
    client_key: Optional[bytes] = None,
    leader_elect: bool = False,
    identity: str = "",
) -> None:
    from ..controllers.remedy import KarmadaAgent
    from ..interpreter import default_interpreter
    from .service import StoreReplica

    replica = StoreReplica(
        target,
        root_ca=root_ca,
        client_cert=client_cert,
        client_key=client_key,
    )
    replica.start()
    if not replica.wait_synced(10.0):
        print(f"agent {cluster_name}: bus sync timeout", file=sys.stderr)
        sys.exit(2)
    store = ReplicaStoreFacade(replica)
    runtime = Runtime()
    member = member or _default_member(cluster_name)
    agent = KarmadaAgent(store, runtime, member, default_interpreter())

    # HA agents: N replicas per member cluster, one active (the reference
    # agent's --leader-elect over a Lease resource lock). Standbys keep
    # their replica synced and queues filling; on takeover the first
    # settle drains the backlog and rebuilds member state from Works.
    elector = None
    if leader_elect:
        from ..utils.leaderelect import LeaderElector

        ident = identity or f"{cluster_name}-{os.getpid()}"
        elector = LeaderElector(
            store,
            name=f"karmada-agent-{cluster_name}",
            identity=ident,
            lease_duration=max(4 * lease_interval, 2.0),
            renew_deadline=max(2 * lease_interval, 1.0),
            on_started_leading=lambda: print(
                f"agent {cluster_name}: leading as {ident}", flush=True
            ),
            on_stopped_leading=lambda: print(
                f"agent {cluster_name}: lost leadership ({ident})",
                flush=True,
            ),
        )
    print(f"agent {cluster_name}: synced, serving", flush=True)

    start = time.time()
    last_tick = 0.0
    try:
        while max_seconds is None or time.time() - start < max_seconds:
            now = time.time()
            tick = now - last_tick >= lease_interval
            if tick:
                last_tick = now
            if elector is not None and tick:
                elector.tick()
            if elector is None or elector.is_leader:
                if tick and simulate_ready:
                    _simulate_kubelet(member)
                runtime.run_until_settled(tick=tick)
            time.sleep(loop_interval)
    finally:
        if elector is not None:
            elector.release()
        replica.close()
    # agent object kept alive by the loop above; reference it so linters
    # don't flag the construction as unused
    del agent


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--target", required=True, help="bus host:port")
    p.add_argument("--cluster", required=True, help="member cluster name")
    p.add_argument("--loop-interval", type=float, default=0.05)
    p.add_argument("--lease-interval", type=float, default=0.5)
    p.add_argument("--max-seconds", type=float, default=None)
    p.add_argument(
        "--no-simulate-ready", action="store_true",
        help="do not mark applied workloads ready (failure-injection runs)",
    )
    p.add_argument(
        "--leader-elect", action="store_true",
        help="run as one of N HA replicas for this cluster; only the Lease "
        "holder syncs (reference agent's --leader-elect)",
    )
    p.add_argument(
        "--leader-elect-identity", default="",
        help="lease holder identity (default: <cluster>-<pid>)",
    )
    args = p.parse_args(argv)
    # chaos: arm deterministic fault injection from the environment — the
    # agent's bus channel (StoreReplica Apply/Delete/Watch) carries the
    # bus.rpc/bus.watch injection points
    from ..utils.faultinject import arm_from_env
    from ..utils.tracing import tracer

    arm_from_env()
    # the agent's bus.rpc client spans record as proc="agent"
    tracer.set_process("agent")
    agent_main(
        args.target,
        args.cluster,
        loop_interval=args.loop_interval,
        lease_interval=args.lease_interval,
        simulate_ready=not args.no_simulate_ready,
        max_seconds=args.max_seconds,
        leader_elect=args.leader_elect,
        identity=args.leader_elect_identity,
    )


if __name__ == "__main__":
    main()
