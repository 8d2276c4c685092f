"""Estimator server process: ``python -m karmada_tpu_torch.estimator``.

The port's own copy of ``karmada_tpu/estimator/__main__.py``. Ref:
cmd/scheduler-estimator — one estimator deployment per member cluster,
serving MaxAvailableReplicas / GetUnschedulableReplicas over gRPC from the
member's node/pod state. In this simulated world the member's nodes are
synthesized in-process (the node-informer stand-in); the wire contract and
the scheduler-side fan-out are the real thing. ``--device`` (default
``cuda``) is where each estimator's node sum runs (K8 above its cell
threshold); pass ``--device cpu`` where there is no card.

Not part of this copy: ``--metrics-port`` and the tracer's peers, which
come with the port's observability (ROADMAP A17).
"""

from __future__ import annotations

import argparse

from .accurate import AccurateEstimator, NodeCache, NodeState
from .grpc_transport import EstimatorGrpcServer
from .service import EstimatorService

DIMS = ["cpu", "memory", "pods", "ephemeral-storage"]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="karmada-tpu estimator server (torch)")
    p.add_argument("--cluster", default="")
    p.add_argument("--address", default="127.0.0.1:0")
    p.add_argument("--nodes", type=int, default=3)
    p.add_argument("--cpu", type=int, default=16000, help="milli-cpu per node")
    p.add_argument("--memory", type=int, default=64 << 30)
    p.add_argument("--pods", type=int, default=110)
    p.add_argument(
        "--spec-file", default="",
        help="JSON {cluster: {dim: capacity}} — host MANY clusters' "
        "estimators in THIS process (MultiClusterEstimatorService routes "
        "by request.cluster; the consolidated deployment shape for "
        "hundreds of members). Each cluster gets one node whose "
        "allocatable IS the given free capacity.",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device of the estimators' node sums (default cuda)",
    )
    args = p.parse_args(argv)
    # chaos: arm deterministic fault injection from the environment
    # (KARMADA_TPU_FAULT_SPEC; disarmed when empty — zero overhead)
    from ..utils.faultinject import arm_from_env
    from ..utils.tracing import tracer

    arm_from_env()
    # handler spans record this process as their caller's peer
    tracer.set_process("estimator")
    if bool(args.cluster) == bool(args.spec_file):
        p.error("exactly one of --cluster / --spec-file is required")

    if args.spec_file:
        import json

        from .service import MultiClusterEstimatorService

        with open(args.spec_file) as f:
            spec: dict = json.load(f)
        dims = sorted({d for caps in spec.values() for d in caps})
        # NodeCache (not NodeSnapshot): the long-lived server's snapshot
        # generation stays pinned between member events, so the scheduler
        # side's GetGenerations ping can prove "nothing moved" and skip the
        # profile fan-out entirely (the generation-gated refresh contract)
        services = {
            name: EstimatorService(
                AccurateEstimator(
                    name,
                    NodeCache(
                        dims,
                        [NodeState(name=f"{name}-node-0",
                                   allocatable=dict(caps))],
                    ),
                    device=args.device,
                )
            )
            for name, caps in spec.items()
        }
        server = EstimatorGrpcServer(
            MultiClusterEstimatorService(services), args.address,
            max_workers=32,
        )
        port = server.start()
        print(
            f"estimator multi ({len(services)} clusters) listening on "
            f"port {port}",
            flush=True,
        )
    else:
        nodes = [
            NodeState(
                name=f"{args.cluster}-node-{i}",
                allocatable={
                    "cpu": args.cpu,
                    "memory": args.memory,
                    "pods": args.pods,
                    "ephemeral-storage": 100 << 30,
                },
            )
            for i in range(args.nodes)
        ]
        est = AccurateEstimator(args.cluster, NodeCache(DIMS, nodes), device=args.device)
        server = EstimatorGrpcServer(EstimatorService(est), args.address)
        port = server.start()
        # the parent process scrapes this line to learn the bound port
        print(f"estimator {args.cluster} listening on port {port}", flush=True)
    try:
        server._server.wait_for_termination()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()


if __name__ == "__main__":
    main()
