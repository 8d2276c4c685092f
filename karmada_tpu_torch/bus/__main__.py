"""Standalone store-bus process: the apiserver+etcd role of the deployment.
The port's own copy of ``karmada_tpu/bus/__main__.py``.

``python -m karmada_tpu_torch.bus --address 127.0.0.1:0`` hosts ONE
authoritative Store (the default admission chain) behind the gRPC store
bus. Plane replicas (``localup serve --connect-bus``), agents and clients
are all ``StoreReplica`` clients of this process — killing a plane replica
never loses state, which is what makes active-standby plane HA possible
(ref: every reference binary runs --leader-elect against the shared
apiserver, cmd/scheduler/app/options/options.go:130-165). A process of
either package serves a replica of the other's: the wire is the same.

Prints ONE JSON line {"bus": port} when serving; SIGTERM checkpoints to
--state-file (etcd persistence analogue) and exits. The store bus builds no
engine, so it takes no ``--device``; the JAX process's ``/metrics`` server
comes with the port's metrics server (ROADMAP A17).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="karmada-tpu-torch-bus")
    p.add_argument("--address", default="127.0.0.1:0")
    p.add_argument("--state-file", default="")
    p.add_argument(
        "--checkpoint-interval", type=float, default=0.0,
        help="seconds between periodic store checkpoints (0 = only on exit)",
    )
    args = p.parse_args(argv)
    # chaos: arm deterministic fault injection from the environment
    # (KARMADA_TPU_FAULT_SPEC; disarmed when empty — zero overhead)
    from ..utils import Store
    from ..utils.faultinject import arm_from_env
    from ..utils.tracing import tracer
    from ..webhook import default_admission_chain
    from .service import StoreBusServer

    arm_from_env()
    # handler spans record as proc="bus"
    tracer.set_process("bus")
    chain = default_admission_chain()
    store = Store(admission=chain.admit, delete_admission=chain.admit_delete)
    if args.state_file and os.path.exists(args.state_file):
        restored = store.restore(args.state_file)
        print(f"# restored {restored} objects from {args.state_file}", file=sys.stderr)
    bus = StoreBusServer(store, args.address)
    print(json.dumps({"bus": bus.start()}), flush=True)

    stop = [False]

    def on_term(signum, frame):
        stop[0] = True

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)
    last_ckpt = time.time()
    last_rv = -1
    try:
        while not stop[0]:
            time.sleep(0.05)
            if (
                args.state_file
                and args.checkpoint_interval > 0
                and time.time() - last_ckpt >= args.checkpoint_interval
            ):
                if store.rv != last_rv:
                    store.checkpoint(args.state_file)
                    last_rv = store.rv
                last_ckpt = time.time()
    finally:
        if args.state_file:
            saved = store.checkpoint(args.state_file)
            print(f"# checkpointed {saved} objects to {args.state_file}", file=sys.stderr)
        bus.stop()


if __name__ == "__main__":
    main()
