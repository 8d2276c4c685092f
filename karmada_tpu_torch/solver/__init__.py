"""Out-of-process solver sidecar (gRPC Score/Assign service) on the port's
engine.

``python -m karmada_tpu_torch.solver --address 127.0.0.1:PORT`` runs the
server process; the scheduler controller (either package's) connects with a
``RemoteSolver``. The exports load lazily, so importing
``karmada_tpu_torch.solver.service`` (the protobuf-free ``SolverService``
core) imports neither grpc nor protobuf.
"""

_EXPORTS = {
    "HASolver": "client",
    "RemoteScheduleResult": "client",
    "RemoteSolver": "client",
    "SolverGrpcServer": "service",
    "SolverService": "service",
    "StaleSnapshotError": "service",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
