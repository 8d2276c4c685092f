"""Capacity estimators (ref: pkg/estimator): the node-level accurate
estimator and its scheduler-side registry, with the node sum on the
hand-written kernel K8 (``node_sum_estimate``); the estimator service
contract and its in-process connection (``service``); the gRPC transport,
its server and ``RemoteAccurateEstimator`` (``grpc_transport``); the
server process (``python -m karmada_tpu_torch.estimator``) and a spawned
multi-process fleet of them (``fleet``).

Still to come: the estimator server's ``/metrics`` endpoint and the
tracer's cross-process peers (ROADMAP A17), prewarm (A14), a device mesh
(A15) and an external store (``store=``, A7b)."""

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
