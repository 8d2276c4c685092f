"""ControlPlane: the propagation path wired together in one process.

The port's own copy of ``karmada_tpu/controlplane.py``, reduced to the
controllers the port carries: a store (the apiserver role) behind the
admission chain, the resource detector, the binding, execution, work-status
and binding-status controllers over one shared Work index, the cluster
status and cluster controllers, unified auth, and the scheduler process on
``device``. Tests drive it deterministically with ``settle()``.

Usage:
    cp = ControlPlane(device="cuda")
    cp.join_cluster(new_cluster("member1"), member_state)
    cp.store.apply(template); cp.store.apply(policy)
    cp.settle()          # -> works applied into member clusters

The JAX plane's other components (failover and taint eviction, the
descheduler tiers, dependencies, quota status, namespace sync, the
rebalancer, autoscaling, multi-cluster services and ingress, remedy and the
Pull agents, search and proxy, the accurate estimators, the solver sidecar,
the declarative and webhook interpreters) and the constructor options that
configure them come with their controllers.
"""

from __future__ import annotations

import time
from typing import Optional

from .api.cluster import PULL, Cluster
from .controllers import (
    BindingController,
    BindingStatusController,
    ClusterController,
    ClusterStatusController,
    ExecutionController,
    ResourceDetector,
    SchedulerController,
    UnifiedAuthController,
    WorkIndex,
    WorkStatusController,
)
from .interpreter import default_interpreter
from .utils import Runtime, Store
from .utils.member import MemberClientRegistry, MemberCluster
from .webhook import default_admission_chain


class ControlPlane:
    def __init__(
        self,
        *,
        clock=None,
        device="cuda",
    ) -> None:
        self.clock = clock or time.time
        self.admission = default_admission_chain()
        self.store = Store(
            admission=self.admission.admit,
            delete_admission=self.admission.admit_delete,
        )
        self.runtime = Runtime()
        self.members = MemberClientRegistry()
        self.interpreter = default_interpreter()

        self.detector = ResourceDetector(self.store, self.runtime, self.interpreter)
        # one shared Work index (informer-indexer analogue) serves the
        # binding, work-status and binding-status controllers
        self.work_index = WorkIndex(self.store)
        self.binding_controller = BindingController(
            self.store, self.runtime, self.interpreter,
            work_index=self.work_index,
        )
        self.execution_controller = ExecutionController(
            self.store, self.runtime, self.members, self.interpreter
        )
        self.work_status_controller = WorkStatusController(
            self.store, self.runtime, self.members, self.interpreter,
            work_index=self.work_index,
        )
        self.binding_status_controller = BindingStatusController(
            self.store, self.runtime, self.detector,
            work_index=self.work_index,
        )
        self.cluster_status_controller = ClusterStatusController(
            self.store, self.runtime, self.members
        )
        self.cluster_controller = ClusterController(self.store, self.runtime)
        self.scheduler = SchedulerController(
            self.store, self.runtime, clock=self.clock, device=device,
        )
        self.unified_auth = UnifiedAuthController(self.store, self.runtime)

    # -- cluster lifecycle (karmadactl join/unjoin analogue) ---------------

    def join_cluster(
        self, cluster: Cluster, member: Optional[MemberCluster] = None
    ) -> MemberCluster:
        """Register a Push-mode member: the control plane owns its client
        (karmadactl join). Pull mode needs the in-cluster agent, which the
        port does not carry yet."""
        if cluster.spec.sync_mode == PULL:
            raise NotImplementedError(
                "Pull-mode clusters need the karmada agent, which is not "
                "ported to karmada_tpu_torch yet; the JAX plane "
                "(karmada_tpu.controlplane.ControlPlane) serves them"
            )
        member = member or MemberCluster(cluster.name)
        self.members.register(member)
        self.work_status_controller.watch_member(member)
        self.store.apply(cluster)
        return member

    def unjoin_cluster(self, name: str) -> None:
        self.members.deregister(name)
        self.store.delete("Cluster", name)

    # -- driving -----------------------------------------------------------

    def settle(self, max_steps: int = 100_000) -> int:
        """Run all reconcilers to a fixed point (deterministic e2e driver)."""
        total = 0
        for _ in range(16):  # tickers can cascade new work
            steps = self.runtime.run_until_settled(max_steps)
            total += steps
            if self.runtime.pending() == 0 and steps == 0:
                break
        return total
