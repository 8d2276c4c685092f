"""Control-plane reconcilers (ref: pkg/controllers, pkg/detector,
pkg/scheduler, pkg/descheduler): the propagation path from a template and
its policy to objects in member clusters and status back, the cluster
status loop and taint manager, the failover controllers (graceful eviction,
application failover, the descheduler), dependencies, namespace sync, the
workload rebalancer, FRQ status, FederatedHPA and CronFederatedHPA (with the
replica calculator), multi-cluster services and ingress, remedy and the Pull
agent, the scheduler process and the drift descheduler that scores through
it."""

from .autoscaling import CronFederatedHPAController, FederatedHPAController  # noqa: F401
from .cluster import (  # noqa: F401
    ClusterController,
    ClusterStatusController,
    TaintManager,
    evict_binding,
)
from .dependencies import DependenciesDistributor  # noqa: F401
from .detector import ResourceDetector, binding_name  # noqa: F401
from .extras import (  # noqa: F401
    FederatedResourceQuotaController,
    NamespaceSyncController,
    ObjectReferenceSelector,
    WorkloadRebalancer,
    WorkloadRebalancerController,
    WorkloadRebalancerSpec,
)
from .failover import (  # noqa: F401
    ApplicationFailoverController,
    Descheduler,
    GracefulEvictionController,
)
from .hpa_sync import UnifiedAuthController  # noqa: F401
from .mci import MultiClusterIngressController  # noqa: F401
from .mcs import (  # noqa: F401
    MultiClusterServiceController,
    ServiceExportController,
    derived_service_name,
)
from .overridemanager import OverrideManager  # noqa: F401
from .propagation import (  # noqa: F401
    BindingController,
    BindingStatusController,
    ExecutionController,
    WorkIndex,
    WorkStatusController,
    execution_namespace,
)
from .rebalance import ContinuousDescheduler, disruption_budget  # noqa: F401
from .scheduler_controller import SchedulerController  # noqa: F401
