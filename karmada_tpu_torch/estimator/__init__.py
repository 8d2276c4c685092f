"""Capacity estimators (ref: pkg/estimator): the node-level accurate
estimator and its scheduler-side registry, in process, with the node sum
on the hand-written kernel K8 (``node_sum_estimate``)."""

from .accurate import (  # noqa: F401
    AccurateEstimator,
    EstimatorRegistry,
    NodeCache,
    NodeSnapshot,
    NodeState,
    ResourceQuotaPlugin,
    node_sum_estimate,
    node_sum_estimate_ref,
)
