"""ControlPlane: the whole ported system wired together in one process.

The port's own copy of ``karmada_tpu/controlplane.py``: a store (the
apiserver role) behind the admission chain, the reconciler fleet, the
scheduler process on ``device``, the accurate estimators and the member
clients, composed for in-process operation. Tests drive it deterministically
with ``settle()``. The components, in the JAX constructor's order: the
resource detector; the binding, execution, work-status and binding-status
controllers over one shared Work index; the cluster status controller (Push
probes, Pull agents' Leases, the ``cluster.health`` fault seam), the cluster
controller and the NoExecute taint manager; graceful eviction and
application failover; the estimator refresh ticker; the scheduler; the
descheduler and the drift rebalancer (both opt-in); the dependencies
distributor, namespace sync, the workload rebalancer and the FRQ status
controller; FederatedHPA and CronFederatedHPA; the ServiceExport,
MultiClusterService and MultiClusterIngress controllers; remedy; the
search controller (its ResourceRegistry watch and ticker, and the
multi-cluster cache) and the proxy over that cache; the metrics adapter,
which the FederatedHPA controller reads through; the member HPA syncers
(opt-in); unified auth; the configuration managers of the declarative and
webhook interpreters; the registration authority with its
certificate-rotation ticker; and, per member, Pull agents and
service-name-resolution detectors.

Usage:
    cp = ControlPlane(device="cuda")
    cp.join_cluster(new_cluster("member1"), member_state)
    cp.store.apply(template); cp.store.apply(policy)
    cp.settle()          # -> works applied into member clusters

``solver=`` routes scheduling through an out-of-process solver sidecar
(either package's ``RemoteSolver`` or ``HASolver``; the scheduler reroutes
quota and priority waves, and passes whose sidecar is down, to its
in-process engine on ``device``).

``store=`` runs the whole fleet over an external store: a bus
``ReplicaStoreFacade`` (reads hit the local mirror, writes round-trip the
primary, which owns admission). Two planes over one store with Lease
leader election are the active-standby replica
(``localup.serve_plane_replica``); ``join_cluster(remote_agent=True)``
registers only the inventory shell of a Pull member whose agent runs out
of process (``python -m karmada_tpu_torch.bus.agent``).

Not ported yet, so absent here: the metrics server and the tracer's peers
(ROADMAP A17), prewarm (A14) and a device mesh (A15).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from .api.cluster import PULL, Cluster
from .controllers import (
    ApplicationFailoverController,
    BindingController,
    BindingStatusController,
    ClusterController,
    ClusterStatusController,
    CronFederatedHPAController,
    DependenciesDistributor,
    Descheduler,
    ExecutionController,
    FederatedHPAController,
    FederatedResourceQuotaController,
    GracefulEvictionController,
    MultiClusterIngressController,
    MultiClusterServiceController,
    NamespaceSyncController,
    ResourceDetector,
    SchedulerController,
    ServiceExportController,
    TaintManager,
    UnifiedAuthController,
    WorkIndex,
    WorkloadRebalancerController,
    WorkStatusController,
)
from .estimator import AccurateEstimator, EstimatorRegistry, NodeSnapshot
from .interpreter import default_interpreter
from .interpreter.declarative import CustomizationConfigManager
from .interpreter.webhook import WebhookConfigManager
from .metricsadapter import MetricsAdapter
from .search import Proxy, SearchController
from .utils import Runtime, Store
from .utils.member import MemberClientRegistry, MemberCluster
from .webhook import default_admission_chain

#: the resource dimensions of an accurate estimator's node snapshot
SNAP_DIMS = ["cpu", "memory", "pods", "ephemeral-storage"]


class ControlPlane:
    def __init__(
        self,
        *,
        enable_descheduler: bool = False,
        # the continuous drift-rebalance tier (bounded-disruption
        # re-placement off a per-tick dry solve); opt-in like the estimator
        # descheduler
        enable_drift_rebalancer: bool = False,
        enable_accurate_estimator: bool = False,
        # disabled by default like the reference (controllermanager.go:213-214)
        enable_member_hpa_sync: bool = False,
        eviction_timeout: float = 600.0,
        clock=None,
        # Pull-cluster lease staleness threshold (ClusterLeaseDuration
        # analogue)
        lease_grace_seconds: float = None,
        # --plugins enable/disable list + out-of-tree filter plugins
        # (cmd/scheduler/app/options/options.go:130-165 analogue)
        disabled_scheduler_plugins=(),
        scheduler_filter_plugins=(),
        # out-of-process solver sidecar (a RemoteSolver of either package):
        # routes Score/Assign over gRPC instead of the in-process engine
        solver=None,
        # external admission hooks: every store write goes through these
        # instead of the in-process chain
        admission_override=None,
        delete_admission_override=None,
        # HA replica mode: run the controller fleet over an EXTERNAL store
        # (a bus ReplicaStoreFacade) — reads hit the local mirror, writes
        # round-trip the primary which owns admission
        store=None,
        device="cuda",
    ) -> None:
        self.clock = clock or time.time
        self.device = device
        self.admission = default_admission_chain()
        if store is not None:
            self.store = store
        else:
            self.store = Store(
                admission=admission_override or self.admission.admit,
                delete_admission=delete_admission_override or self.admission.admit_delete,
            )
        self.runtime = Runtime()
        self.members = MemberClientRegistry()
        self.interpreter = default_interpreter()
        self.estimators = EstimatorRegistry()

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
        status_kw = (
            {"lease_grace_seconds": lease_grace_seconds}
            if lease_grace_seconds is not None
            else {}
        )
        self.cluster_status_controller = ClusterStatusController(
            self.store, self.runtime, self.members, clock=self.clock,
            **status_kw,
        )
        self.cluster_controller = ClusterController(self.store, self.runtime)
        self.taint_manager = TaintManager(self.store, self.runtime, clock=self.clock)
        self.graceful_eviction = GracefulEvictionController(
            self.store, self.runtime, timeout_seconds=eviction_timeout,
            clock=self.clock,
        )
        self.app_failover = ApplicationFailoverController(
            self.store, self.runtime, clock=self.clock
        )
        self._accurate_enabled = enable_accurate_estimator
        # node snapshots track member state (the estimator server's informer
        # refresh); rebuilt each settle pass. No-op while accurate estimators
        # are disabled so the addon toggle works after construction.
        self.runtime.add_ticker(self._refresh_estimators)
        self.scheduler = SchedulerController(
            self.store,
            self.runtime,
            extra_estimators=[],
            disabled_plugins=disabled_scheduler_plugins,
            custom_filters=scheduler_filter_plugins,
            clock=self.clock,
            solver=solver,
            estimator_registry=self.estimators,
            device=device,
        )
        self.descheduler = (
            Descheduler(self.store, self.runtime, self.members, clock=self.clock)
            if enable_descheduler
            else None
        )
        if enable_drift_rebalancer:
            from .controllers.rebalance import ContinuousDescheduler

            self.drift_rebalancer = ContinuousDescheduler(
                self.store, self.runtime, self.scheduler, clock=self.clock
            )
        else:
            self.drift_rebalancer = None
        self.dependencies_distributor = DependenciesDistributor(
            self.store, self.runtime, self.interpreter
        )
        self.namespace_sync = NamespaceSyncController(self.store, self.runtime)
        self.workload_rebalancer = WorkloadRebalancerController(
            self.store, self.runtime, clock=self.clock
        )
        self.frq_controller = FederatedResourceQuotaController(
            self.store, self.runtime, self.members
        )
        self.federated_hpa = FederatedHPAController(
            self.store, self.runtime, self.members, clock=self.clock
        )
        self.cron_federated_hpa = CronFederatedHPAController(
            self.store, self.runtime, clock=self.clock
        )
        self.service_export = ServiceExportController(
            self.store, self.runtime, self.members
        )
        self.multicluster_service = MultiClusterServiceController(
            self.store, self.runtime, self.members
        )
        self.multicluster_ingress = MultiClusterIngressController(
            self.store, self.runtime, self.members
        )
        from .controllers.remedy import RemedyController

        self.remedy_controller = RemedyController(self.store, self.runtime)
        self.search = SearchController(self.store, self.runtime, self.members)
        self.proxy = Proxy(self.store, self.members, self.search.cache)
        self.metrics_adapter = MetricsAdapter(self.members)
        # the HPA controller consumes the SAME adapter facade (one cache/
        # state surface), not a private duplicate over the registry
        self.federated_hpa._metrics_adapter = self.metrics_adapter
        if enable_member_hpa_sync:
            from .controllers.hpa_sync import (
                DeploymentReplicasSyncer,
                HpaScaleTargetMarker,
            )

            self.hpa_marker = HpaScaleTargetMarker(self.store, self.runtime)
            self.replicas_syncer = DeploymentReplicasSyncer(
                self.store, self.runtime, self.members
            )
        else:
            self.hpa_marker = None
            self.replicas_syncer = None
        self.unified_auth = UnifiedAuthController(self.store, self.runtime)
        self.interpreter_config = CustomizationConfigManager(
            self.store, self.runtime, self.interpreter
        )
        self.interpreter_webhooks = WebhookConfigManager(
            self.store, self.runtime, self.interpreter
        )
        self.agents: dict[str, object] = {}
        from .utils.register import RegistrationAuthority

        # token issuance + CSR approval + cert rotation for pull-mode agents
        # (pkg/karmadactl/register, agent-CSR-approving controller,
        # pkg/controllers/certificate/)
        self.authority = RegistrationAuthority(clock=self.clock)
        self.runtime.add_ticker(self._rotate_certificates)
        # per-member coredns-failure detectors (deployed explicitly via
        # add_sn_detector, like the reference's example binary)
        self.sn_detectors: dict[str, object] = {}

    # -- cluster lifecycle (karmadactl join/unjoin analogue) ---------------

    def join_cluster(
        self,
        cluster: Cluster,
        member: Optional[MemberCluster] = None,
        *,
        remote_agent: bool = False,
    ) -> MemberCluster:
        """Register a member. Push mode: the control plane owns the client
        (karmadactl join); Pull mode: a KarmadaAgent runs "inside" the member
        and drives the work application itself (karmadactl register).
        ``remote_agent`` marks a Pull member whose agent runs out of process:
        the plane registers only the inventory shell and never constructs a
        local agent."""
        member = member or MemberCluster(cluster.name)
        self.members.register(member)
        if cluster.spec.sync_mode == PULL and not remote_agent:
            from .controllers.remedy import KarmadaAgent

            self.agents[cluster.name] = KarmadaAgent(
                self.store, self.runtime, member, self.interpreter,
                clock=self.clock,
            )
        self.work_status_controller.watch_member(member)
        if self._accurate_enabled:
            self._register_estimator(cluster.name, member)
        self.store.apply(cluster)
        return member

    def unjoin_cluster(self, name: str) -> None:
        self.members.deregister(name)
        self.estimators.deregister(name)
        det = self.sn_detectors.pop(name, None)
        if det is not None:
            det.active = False
        self.store.delete("Cluster", name)
        # re-point the scheduler's estimator fan-out at the surviving
        # members — a stale batch estimator keeps the old cluster-column
        # layout and breaks the min-merge shape on the next reconcile
        if self._accurate_enabled:
            names = sorted(self.members.names())
            self.scheduler.extra_estimators = (
                [self.estimators.make_batch_estimator(names)] if names else []
            )

    # -- optional components (karmadactl addons analogue) ------------------

    def _register_estimator(self, cluster_name: str, member) -> None:
        est = AccurateEstimator(
            cluster_name, NodeSnapshot(member.nodes, SNAP_DIMS), device=self.device
        )
        self.estimators.register(est)
        names = sorted(self.members.names())
        self.scheduler.extra_estimators = [self.estimators.make_batch_estimator(names)]

    def enable_accurate_estimators(self) -> None:
        """addons enable karmada-scheduler-estimator: deploy one estimator
        per member and point the scheduler's fan-out at them."""
        if self._accurate_enabled:
            return
        self._accurate_enabled = True
        for name in sorted(self.members.names()):
            self._register_estimator(name, self.members.get(name))

    def disable_accurate_estimators(self) -> None:
        if not self._accurate_enabled:
            return
        self._accurate_enabled = False
        for name in list(self.members.names()):
            self.estimators.deregister(name)
        self.scheduler.extra_estimators = []

    def add_sn_detector(self, cluster_name: str, probe=None):
        """Deploy the service-name-resolution detector into one member
        (cmd/service-name-resolution-detector-example)."""
        from .controllers.remedy import ServiceNameResolutionDetector

        member = self.members.get(cluster_name)
        if member is None:
            raise KeyError(f"unknown cluster {cluster_name}")
        prev = self.sn_detectors.get(cluster_name)
        if prev is not None:
            prev.active = False
        det = ServiceNameResolutionDetector(
            self.store, self.runtime, member, probe=probe
        )
        self.sn_detectors[cluster_name] = det
        return det

    def _rotate_certificates(self) -> None:
        """cert-rotation controller sweep over registered agent certs."""
        for cluster_name in list(self.authority.certificates):
            self.authority.rotate_if_needed(cluster_name)

    def _refresh_estimators(self) -> None:
        if not self._accurate_enabled:
            return
        for name in self.members.names():
            member = self.members.get(name)
            est = self.estimators.get(name)
            if member is None or est is None:
                continue
            new = NodeSnapshot(member.nodes, SNAP_DIMS)
            old = est.snapshot
            # generation gate (EstimatorRegistry delta refresh): a fresh
            # NodeSnapshot always stamps a NEW generation, so carry the old
            # one forward when the packed capacities provably did not move —
            # the memoized estimates stay valid and the registry's refresh
            # pass skips this cluster. The packed array is a copy made at
            # build time, so comparing old vs new detects drift even though
            # both snapshots reference the same NodeState objects.
            if old is not None and np.array_equal(old.available, new.available):
                new.generation = old.generation
            est.snapshot = new
            est.unschedulable = member.count_unschedulable(self.clock())

    # -- driving -----------------------------------------------------------

    def settle(self, max_steps: int = 100_000) -> int:
        """Run all reconcilers to a fixed point (deterministic e2e driver)."""
        total = 0
        for _ in range(16):  # tickers can cascade new work
            steps = self.runtime.run_until_settled(max_steps)
            total += steps
            if self.runtime.deposed or (self.runtime.pending() == 0 and steps == 0):
                break  # quiescent, or deposed mid-drain (it stops writing)
        return total
