"""Component processes of the port: the child spawner, and the plane
process in its active-standby replica shape.

The port's own copy of ``karmada_tpu/localup.py``'s ``spawn_child``,
``scrape_line`` and ``serve_plane_replica``:

- ``spawn_child`` starts a component entry point (``python -m
  karmada_tpu_torch.<component>``) with the package importable from any
  working directory, and its torch device chosen when the component builds
  an engine; ``scrape_line`` reads the line it prints once it serves.
- ``python -m karmada_tpu_torch.localup serve --connect-bus HOST:PORT
  --leader-elect`` is one HA plane replica: the controller fleet over a
  ``StoreReplica`` of an external store-bus process (``python -m
  karmada_tpu_torch.bus``), its engine on ``--device``, and only the
  Lease-elected leader reconciles.

The rest of the JAX module — the plane that hosts its own store and the
bus server (``serve`` without ``--connect-bus``, which needs
``cli.cmd_init``) and the multi-process ``LocalUp`` orchestrator — comes
with the CLI (ROADMAP A7c).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import time

#: the component entry points that build an engine and so take ``--device``
DEVICE_ENTRY_POINTS = (
    "karmada_tpu_torch.solver",
    "karmada_tpu_torch.estimator",
    "karmada_tpu_torch.localup",
)


def spawn_child(
    cmd: list[str], device: str = "cuda", extra_env: dict | None = None
) -> subprocess.Popen:
    """Spawn a component child process on torch ``device`` (default the
    card, as every entry point of the port): when the component builds an
    engine (``python -m`` one of ``DEVICE_ENTRY_POINTS``), ``--device
    DEVICE`` is appended to ``cmd`` unless it names one; a child spawned
    with ``device="cpu"`` sees no CUDA device at all
    (``CUDA_VISIBLE_DEVICES`` empty). The package is importable regardless
    of the caller's cwd.
    ``extra_env`` overlays the inherited environment. Stdout and stderr
    come back merged on ``proc.stdout`` (text)."""
    cmd = list(cmd)
    takes_device = any(a == "-m" and b in DEVICE_ENTRY_POINTS for a, b in zip(cmd, cmd[1:]))
    if takes_device and "--device" not in cmd:
        cmd += ["--device", device]
    env = dict(os.environ, **(extra_env or {}))
    if device == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = (
        pkg_parent + os.pathsep + env["PYTHONPATH"]
        if env.get("PYTHONPATH")
        else pkg_parent
    )
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env,
    )


def scrape_line(proc: subprocess.Popen, pattern: str, timeout: float = 240.0) -> str:
    """First regex group of the first stdout line matching ``pattern``.

    select()-gated so a child that hangs BEFORE printing (import stall,
    bind wait) raises after ``timeout`` instead of blocking readline
    forever; a child that dies mid-startup raises immediately — with its
    recent output in the error, so startup failures are diagnosable from
    the orchestrator's traceback alone."""
    import collections
    import select

    tail: collections.deque = collections.deque(maxlen=15)

    def die(reason: str) -> None:
        if proc.poll() is not None:
            try:
                rest = proc.stdout.read() or ""
                tail.extend(rest.splitlines()[-10:])
            except Exception:  # noqa: BLE001 — best-effort diagnostics
                pass
        out = "\n".join(f"    | {ln.rstrip()}" for ln in tail)
        raise RuntimeError(
            f"{reason} (cmd: {' '.join(proc.args[:6])}...)\n"
            f"  recent child output:\n{out or '    | <none>'}"
        )

    deadline = time.time() + timeout
    while True:
        remaining = deadline - time.time()
        if remaining <= 0:
            die(f"no line matching {pattern!r} within {timeout}s")
        ready, _, _ = select.select([proc.stdout], [], [], min(remaining, 0.5))
        if not ready:
            if proc.poll() is not None:
                die(f"child exited rc={proc.returncode} during startup")
            continue
        line = proc.stdout.readline()
        if not line:
            if proc.poll() is not None:
                die(f"child exited rc={proc.returncode} during startup")
            time.sleep(0.05)  # stdout closed but child alive: avoid spin
            continue
        tail.append(line)
        m = re.search(pattern, line)
        if m:
            return m.group(1)


# --------------------------------------------------------------------------
# the plane process
# --------------------------------------------------------------------------


def plane_heartbeat(elector, lease_duration: float, clock=time.time):
    """The HA replica's ``runtime.heartbeat``: renewals must survive long
    settles (client-go renews on its own goroutine; this runtime is
    cooperative, so renewal rides the drain loop), throttled to
    ``lease_duration / 5`` so neither the settle loop nor the serve loop
    hammers the bus with CAS writes. It answers ``elector.is_leader``: the
    moment leadership is lost mid-settle, its False stops the drain, and
    the scheduler's write barrier discards a pass it was in."""
    last_tick = [float("-inf")]

    def renew_tick() -> bool:
        now = clock()
        if now - last_tick[0] >= lease_duration / 5:
            last_tick[0] = now
            elector.tick()
        return elector.is_leader

    return renew_tick


def serve_plane_replica(args) -> None:
    """HA plane replica (the reference's --leader-elect active-standby
    shape, cmd/scheduler/app/options/options.go:130-165): the controller
    fleet runs over a bus StoreReplica of an EXTERNAL store process
    (python -m karmada_tpu_torch.bus), and only the Lease-elected leader
    reconciles. Standbys stay warm — their mirrors track every event and
    their workqueues accumulate keys — so takeover is one settle away. No
    double-scheduling: leadership is CAS-exclusive per tick, the
    scheduler's write barrier drops a pass its plane was deposed in, and
    its observed-generation guard makes a raced duplicate reconcile
    idempotent. Until the port's prewarm (ROADMAP A14) and metrics server
    (A17) come, the replica takes no ``--warmup-manifest`` and prints
    ``{"identity": ...}`` with no ``"metrics"`` key."""
    from .bus.agent import ReplicaStoreFacade
    from .bus.service import StoreReplica
    from .controlplane import ControlPlane
    from .utils.builders import new_cluster
    from .utils.leaderelect import LeaderElector
    from .utils.member import MemberCluster
    from .utils.store import ConflictError
    from .utils.tracing import tracer

    tracer.set_process("plane")
    replica = StoreReplica(args.connect_bus)
    replica.start()
    if not replica.wait_synced(30):
        print("error: bus replica failed to sync", file=sys.stderr)
        sys.exit(2)
    facade = ReplicaStoreFacade(replica)
    cp = ControlPlane(
        store=facade,
        enable_descheduler=args.descheduler,
        lease_grace_seconds=args.lease_grace or None,
        device=args.device,
    )
    for name in args.pull:
        # every replica registers the local inventory shell + status
        # watch; the Cluster OBJECT is created create-only (expected_rv=0)
        # so two concurrently booting replicas cannot clobber the agent's
        # already-written status through their async mirrors (a check-
        # then-act on the mirror races; the CAS loses cleanly instead)
        member = MemberCluster(name)
        cp.members.register(member)
        cp.work_status_controller.watch_member(member)
        if facade.get("Cluster", name) is None:
            cluster = new_cluster(name, cpu="100", memory="200Gi")
            cluster.spec.sync_mode = "Pull"
            try:
                facade.apply(cluster, expected_rv=0)
            except ConflictError:
                pass  # a peer replica won the create
    cp.runtime.realtime = True
    identity = args.identity or f"plane-{os.getpid()}"
    elector = LeaderElector(
        facade,
        "karmada-plane",
        identity,
        lease_duration=args.lease_duration,
        renew_deadline=args.renew_deadline,
        on_started_leading=lambda: print(json.dumps({"leading": identity}), flush=True),
        on_stopped_leading=lambda: print(json.dumps({"standby": identity}), flush=True),
    )
    renew_tick = plane_heartbeat(elector, args.lease_duration)
    cp.runtime.heartbeat = renew_tick
    print(json.dumps({"identity": identity}), flush=True)

    stop = [False]

    def on_term(signum, frame):
        stop[0] = True

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)
    try:
        while not stop[0]:
            if renew_tick():
                cp.settle()
                due = cp.runtime.next_due()
                time.sleep(
                    max(0.001, min(args.loop_interval, due))
                    if due is not None
                    else args.loop_interval
                )
            else:
                time.sleep(args.loop_interval)
    finally:
        elector.release()
        replica.close()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)
    sv = sub.add_parser("serve", help="run a plane replica over a store bus")
    sv.add_argument("--connect-bus", default="",
                    help="HA replica mode: run the controller fleet over a "
                    "StoreReplica of this external store-bus address "
                    "(python -m karmada_tpu_torch.bus); pairs with "
                    "--leader-elect")
    sv.add_argument("--leader-elect", action="store_true",
                    help="Lease-CAS active-standby (every reference binary's "
                    "--leader-elect); implied by --connect-bus")
    sv.add_argument("--identity", default="",
                    help="leader-election identity (default plane-<pid>)")
    sv.add_argument("--pull", action="append", default=[])
    sv.add_argument("--lease-duration", type=float, default=15.0)
    sv.add_argument("--renew-deadline", type=float, default=10.0)
    sv.add_argument("--loop-interval", type=float, default=0.05)
    sv.add_argument("--lease-grace", type=float, default=0.0)
    sv.add_argument("--descheduler", action="store_true")
    sv.add_argument("--device", default="cuda",
                    help="torch device of the replica's scheduling engine")
    args = p.parse_args(argv)
    # chaos: arm deterministic fault injection from the environment
    # (KARMADA_TPU_FAULT_SPEC; disarmed when empty — zero overhead)
    from .utils.faultinject import arm_from_env

    arm_from_env()
    if not args.connect_bus:
        if args.leader_elect:
            # election needs the shared store: a lone plane hosting its own
            # store has nothing to elect against
            p.error("--leader-elect requires --connect-bus (the shared "
                    "store-bus the replicas elect over)")
        raise NotImplementedError(
            "serve without --connect-bus (the plane hosting its own store and "
            "the bus server) needs cli.cmd_init, which comes with the CLI "
            "(ROADMAP A7c)")
    serve_plane_replica(args)


if __name__ == "__main__":
    main()
