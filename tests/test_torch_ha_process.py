"""The port's HA plane as processes, on the CPU: ``tests/test_plane_ha.py``'s
scenario against the port's entry points.

One store-bus process (``python -m karmada_tpu_torch.bus``, the
apiserver+etcd role), two Pull agents (``python -m
karmada_tpu_torch.bus.agent``) and two plane replicas (``python -m
karmada_tpu_torch.localup serve --connect-bus ... --leader-elect --device
cpu``) whose controller fleets run over ``StoreReplica`` mirrors. A storm of
Deployments; the leader is killed (SIGKILL) mid-storm; the standby takes the
lease within a lease window and finishes the storm, every binding placed
once a cluster at its latest generation.

Across the packages on one wire: the same scenario with the JAX bus process
and a JAX replica beside a port replica, electing on the same Lease (either
may lead first; the leader is killed), the JAX package's client mirroring
the bus. Tolerance: exact equality of the checked counts."""

import os
import signal
import sys
import time

import pytest

from karmada_tpu_torch.api import PropagationPolicy, PropagationSpec, ResourceSelector
from karmada_tpu_torch.api.core import ObjectMeta
from karmada_tpu_torch.bus.service import StoreReplica
from karmada_tpu_torch.localup import scrape_line, spawn_child
from karmada_tpu_torch.utils.builders import dynamic_weight_placement, new_deployment

LEASE = 2.0
RENEW = 1.0


def wait_for(predicate, timeout=30.0, interval=0.05, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {what}")


def spawn_jax(cmd):
    """A JAX package's process, on the CPU."""
    from karmada_tpu.localup import spawn_child as jax_spawn

    return jax_spawn(cmd)


@pytest.fixture(params=["port", "mixed"])
def ha_plane(request):
    mixed = request.param == "mixed"
    procs = {}
    replica = None
    try:
        if mixed:
            procs["bus"] = spawn_jax([sys.executable, "-m", "karmada_tpu.bus"])
        else:
            procs["bus"] = spawn_child([sys.executable, "-m", "karmada_tpu_torch.bus"])
        bus_port = int(scrape_line(procs["bus"], r'"bus": (\d+)', timeout=120))
        target = f"127.0.0.1:{bus_port}"
        for name in ("pull1", "pull2"):
            procs[f"agent-{name}"] = spawn_child([
                sys.executable, "-m", "karmada_tpu_torch.bus.agent",
                "--target", target, "--cluster", name, "--max-seconds", "240"])
        for ident in ("pa", "pb"):
            args = ["serve", "--connect-bus", target, "--leader-elect", "--identity", ident,
                    "--pull", "pull1", "--pull", "pull2", "--lease-duration", str(LEASE),
                    "--renew-deadline", str(RENEW), "--loop-interval", "0.02"]
            if mixed and ident == "pa":
                procs[ident] = spawn_jax([sys.executable, "-m", "karmada_tpu.localup"] + args)
            else:
                procs[ident] = spawn_child(
                    [sys.executable, "-m", "karmada_tpu_torch.localup"] + args, device="cpu")
        for ident in ("pa", "pb"):
            scrape_line(procs[ident], r'"identity": "(p[ab])"', timeout=180)
        if mixed:
            from karmada_tpu.bus.service import StoreReplica as JaxReplica

            replica = JaxReplica(target)
        else:
            replica = StoreReplica(target)
        replica.start()
        assert replica.wait_synced(60)
        yield procs, replica, mixed
    finally:
        if replica is not None:
            replica.close()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        for p in procs.values():
            try:
                p.wait(timeout=5)
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass


def test_leader_kill_mid_storm_standby_converges(ha_plane):
    procs, replica, mixed = ha_plane
    store = replica.store
    if mixed:
        from karmada_tpu.api import (
            PropagationPolicy as P,
            PropagationSpec as S,
            ResourceSelector as R,
        )
        from karmada_tpu.api.core import ObjectMeta as M
        from karmada_tpu.utils.builders import (
            dynamic_weight_placement as placement,
            new_deployment as deployment,
        )
    else:
        P, S, R, M = PropagationPolicy, PropagationSpec, ResourceSelector, ObjectMeta
        placement, deployment = dynamic_weight_placement, new_deployment

    def holder():
        lease = store.get("Lease", "karmada-plane")
        return lease.holder_identity if lease is not None else ""

    wait_for(lambda: holder() in ("pa", "pb"), timeout=60,
             what="a plane replica to take the lease")
    first = holder()
    standby = "pb" if first == "pa" else "pa"

    def clusters_ready():
        ready = 0
        for name in ("pull1", "pull2"):
            cl = store.get("Cluster", name)
            if cl is None:
                return False
            cond = next((c for c in cl.status.conditions if c.type == "Ready"), None)
            ready += bool(cond and cond.status)
        return ready == 2

    wait_for(clusters_ready, timeout=90, what="pull clusters Ready")
    replica.apply(P(meta=M(name="ha-policy", namespace="default"),
                    spec=S(resource_selectors=[R(api_version="apps/v1", kind="Deployment")],
                           placement=placement())))
    n1 = 40
    for i in range(n1):
        replica.apply(deployment(f"app{i}", replicas=4))

    def scheduled(n):
        done = [rb for rb in store.list("ResourceBinding")
                if rb.meta.namespace == "default" and rb.spec.clusters
                and sum(tc.replicas for tc in rb.spec.clusters) == 4
                and rb.status.scheduler_observed_generation == rb.meta.generation]
        return len(done) >= n

    wait_for(lambda: scheduled(n1), timeout=120, what=f"{n1} bindings scheduled by {first}")
    more = [deployment(f"app{n1 + i}", replicas=4) for i in range(n1)]
    for d in more[: n1 // 2]:
        replica.apply(d)
    os.kill(procs[first].pid, signal.SIGKILL)
    for d in more[n1 // 2:]:
        replica.apply(d)
    t_kill = time.time()
    wait_for(lambda: holder() == standby, timeout=LEASE * 4 + 30,
             what=f"standby {standby} to take the lease")
    assert time.time() - t_kill < LEASE * 4 + 30
    assert store.get("Lease", "karmada-plane").lease_transitions >= 1
    wait_for(lambda: scheduled(2 * n1), timeout=180,
             what=f"all {2 * n1} bindings scheduled after failover")
    for rb in store.list("ResourceBinding"):
        if rb.meta.namespace != "default":
            continue
        names = [tc.name for tc in rb.spec.clusters]
        assert len(names) == len(set(names)), names
        assert sum(tc.replicas for tc in rb.spec.clusters) == 4
        assert rb.status.scheduler_observed_generation == rb.meta.generation
