"""Solver sidecar process entry: ``python -m karmada_tpu_torch.solver``.

The port's own copy of ``karmada_tpu/solver/__main__.py``: the sidecar's
engine runs on ``--device`` (default ``cuda``; ``--device cpu`` where there
is no card). ``--report-backend`` prints ``solver backend <type>`` after the
port line, once the device answers; a device that is asked for and absent
prints ``solver backend error`` and exits 4, one that hangs past
``--backend-timeout`` prints ``solver backend timeout`` and exits 3.
``--estimator NAME=HOST:PORT`` makes the sidecar estimator-aware
(``estimator_service``).

Not part of this copy: the trace-manifest prewarm (ROADMAP A14), the
``/metrics`` endpoint and the tracer's peers (A17), and the mesh report
(A15).
"""

from __future__ import annotations

import argparse
import sys

from .service import SolverGrpcServer, SolverService


def estimator_service(conns: dict, device="cuda", base_factory=None):
    """(SolverService, EstimatorRegistry): a sidecar whose engines min-merge
    live estimator answers into availability, as the in-process plane does.
    ``conns`` maps each cluster name to its estimator connection (clusters
    of one server share one); a ``RemoteAccurateEstimator`` a cluster is
    registered, each engine the service builds gets the registry's batch
    estimator as ``extra_estimators``, and every solve first revalidates
    the registry generation-gated (``invalidate()``): the sidecar has no
    member-event channel, so each pass pings each server once and
    re-fetches only the clusters whose snapshot moved."""
    from ..estimator.accurate import EstimatorRegistry
    from ..estimator.grpc_transport import RemoteAccurateEstimator
    from ..scheduler import TensorScheduler

    registry = EstimatorRegistry()
    cell: list = []  # the service, once built

    def engine_dims():
        return list(cell[0]._engine.snapshot.dims)

    for name, conn in conns.items():
        registry.register(RemoteAccurateEstimator(name, conn, engine_dims))
    base = base_factory or (lambda snap: TensorScheduler(snap, device=device))

    def engine_factory(snap):
        eng = base(snap)
        eng.extra_estimators = [registry.make_batch_estimator(list(snap.names))]
        return eng

    service = SolverService(engine_factory=engine_factory, device=device)
    cell.append(service)
    solve = service.solve

    def solve_revalidated(*args):
        registry.invalidate()
        return solve(*args)

    service.solve = solve_revalidated
    return service, registry


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="karmada-tpu solver sidecar (torch)")
    p.add_argument("--address", default="127.0.0.1:0")
    p.add_argument("--server-cert", default="", help="PEM file (TLS)")
    p.add_argument("--server-key", default="", help="PEM file (TLS)")
    p.add_argument("--client-ca", default="", help="PEM file (mTLS client auth)")
    p.add_argument(
        "--device", default="cuda",
        help="torch device of the sidecar's engine (default cuda)",
    )
    p.add_argument(
        "--report-backend", action="store_true",
        help="print the device type after binding ('solver backend cuda'); "
        "the orchestrator scrapes it to confirm which component owns the card",
    )
    p.add_argument(
        "--backend-timeout", type=float, default=90.0,
        help="seconds to wait for the device to answer before printing "
        "'solver backend timeout' and exiting rc=3",
    )
    p.add_argument(
        "--estimator", action="append", default=[],
        help="NAME=HOST:PORT of an accurate-estimator server for cluster "
        "NAME (repeatable; same HOST:PORT shares one channel): the "
        "sidecar's engines min-merge live estimator answers into "
        "availability exactly like the in-proc plane does",
    )
    args = p.parse_args(argv)
    # chaos: arm deterministic fault injection from the environment
    # (KARMADA_TPU_FAULT_SPEC; disarmed when empty — zero overhead)
    from ..utils.faultinject import arm_from_env
    from ..utils.tracing import tracer

    arm_from_env()
    # handler spans record this process as their caller's peer
    tracer.set_process("solver")

    def read(path):
        return open(path, "rb").read() if path else None

    # graceful SIGTERM: run the interpreter's normal exit path
    import signal as _signal

    _signal.signal(_signal.SIGTERM, lambda s, f: sys.exit(0))

    if args.estimator:
        from ..estimator.grpc_transport import GrpcEstimatorConnection

        conns: dict = {}
        by_target: dict = {}
        for spec in args.estimator:
            name, _, target = spec.partition("=")
            if not name or not target:
                p.error(f"--estimator wants NAME=HOST:PORT, got {spec!r}")
            conn = by_target.get(target)
            if conn is None:
                conn = GrpcEstimatorConnection(name, target)
                by_target[target] = conn
            conns[name] = conn
        service, _registry = estimator_service(conns, device=args.device)
    else:
        service = SolverService(device=args.device)

    server = SolverGrpcServer(
        service,
        args.address,
        server_cert=read(args.server_cert),
        server_key=read(args.server_key),
        client_ca=read(args.client_ca),
    )
    port = server.start()
    # the parent process scrapes this line to learn the bound port
    print(f"solver listening on port {port}", flush=True)
    if args.report_backend:
        import os as _os
        import threading
        import traceback

        done = threading.Event()
        kind = [""]
        failure = [None]

        def probe() -> None:
            try:
                import torch

                dev = torch.device(args.device)
                if dev.type == "cuda" and not torch.cuda.is_available():
                    raise RuntimeError(
                        f"--device {args.device}: torch sees no CUDA device")
                torch.zeros(1, device=dev)
                kind[0] = dev.type
            except BaseException as e:  # noqa: BLE001 — reported below
                failure[0] = e
            finally:
                done.set()

        threading.Thread(target=probe, daemon=True).start()
        if not done.wait(args.backend_timeout):
            print("solver backend timeout", flush=True)
            _os._exit(3)
        if failure[0] is not None:
            # a deterministic failure: the traceback follows the marker so
            # the orchestrator can surface it
            print("solver backend error", flush=True)
            traceback.print_exception(failure[0], file=sys.stdout)
            sys.stdout.flush()
            _os._exit(4)
        print(f"solver backend {kind[0]}", flush=True)
    try:
        server.wait()
    except KeyboardInterrupt:
        server.stop()
        sys.exit(0)


if __name__ == "__main__":
    main()
