"""Control-plane reconcilers (ref: pkg/scheduler, pkg/descheduler): the
scheduler process and the drift descheduler that scores through it."""

from .cluster import evict_binding  # noqa: F401
from .rebalance import ContinuousDescheduler, disruption_budget  # noqa: F401
from .scheduler_controller import SchedulerController  # noqa: F401
