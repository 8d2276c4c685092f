"""Control-plane reconcilers (ref: pkg/controllers, pkg/detector,
pkg/scheduler, pkg/descheduler): the propagation path from a template and
its policy to objects in member clusters and status back, the cluster
status loop, the scheduler process and the drift descheduler that scores
through it."""

from .cluster import ClusterController, ClusterStatusController, evict_binding  # noqa: F401
from .detector import ResourceDetector, binding_name  # noqa: F401
from .hpa_sync import UnifiedAuthController  # noqa: F401
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
