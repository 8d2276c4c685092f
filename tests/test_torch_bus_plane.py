"""The port's control plane over its store bus against the JAX plane over
the JAX bus, on the CPU.

``ControlPlane(store=ReplicaStoreFacade(StoreReplica(...)), device="cpu")``:
the whole fleet reading a bus mirror and writing through the primary.
``tests/test_bus_batch.py`` builds these planes with
``karmada_tpu.cli.cmd_init`` (the CLI, ROADMAP A7c), so its two plane
classes run here with the port's ``ControlPlane`` in its place:

- ``TestTemplateDeltaRendering``: the JAX cases (template-delta Works,
  rehydration byte-equal to full rendering, the override-matched target's
  full render, template collection, a Work delivered before its template)
  on the port's in-process store;
- ``TestPlaneOverBusParity``: the plane over a gRPC bus replica, batched
  against unary (``KARMADA_TPU_BUS_BATCH=0`` and
  ``KARMADA_TPU_BUS_TEMPLATE_DELTA=0``): placements and rehydrated Work
  manifests equal;
- the same scenario on both packages: the port's plane over the port's bus
  (gRPC and the in-process channel) against the JAX plane over the JAX
  bus, batched and unary: placements and rehydrated Work manifests equal.

Tolerance: exact equality."""

import time

import pytest

import test_bus_batch as jax_cases
from port_cases import cpu_plane, port_cases  # noqa: F401 (fixture)

_cases = port_cases("test_bus_batch")


class TestTemplateDeltaRendering(_cases["TestTemplateDeltaRendering"]):
    def _plane(self, n_deploys=6, n_clusters=3):
        """``test_bus_batch``'s plane: three members under a static 2:1:1
        division, ``n_deploys`` Deployments, on the port's
        ``ControlPlane(device="cpu")``."""
        from karmada_tpu_torch.api import PropagationPolicy, PropagationSpec, ResourceSelector
        from karmada_tpu_torch.api.core import ObjectMeta
        from karmada_tpu_torch.controlplane import ControlPlane
        from karmada_tpu_torch.utils.builders import (
            new_cluster,
            new_deployment,
            static_weight_placement,
        )

        cp = ControlPlane(device="cpu")
        for i in range(1, n_clusters + 1):
            cp.join_cluster(new_cluster(f"member{i}", cpu="100", memory="200Gi"))
        cp.settle()
        cp.store.apply(PropagationPolicy(
            meta=ObjectMeta(name="p", namespace="default"),
            spec=PropagationSpec(
                resource_selectors=[ResourceSelector(api_version="apps/v1",
                                                     kind="Deployment")],
                placement=static_weight_placement({
                    f"member{i}": (2 if i == 1 else 1) for i in range(1, n_clusters + 1)}),
            ),
        ))
        for i in range(n_deploys):
            cp.store.apply(new_deployment(f"app{i}", replicas=8 + i,
                                          image="docker.io/nginx:1.25"))
        cp.settle()
        return cp


def run_plane_over_bus(pkg_name: str, channel: str = "grpc", n: int = 12, c: int = 3):
    """``TestPlaneOverBusParity._run_plane`` for either package: a plane over
    a replica of a primary Store behind a bus (``channel`` "grpc", or
    "in-process" on the port), three members, a dynamic-weight policy and
    ``n`` Deployments, settled through the echoes until every placement has
    its Work. Returns (placements, canonical rehydrated Work manifests)."""
    import importlib

    def m(name):
        return importlib.import_module(f"{pkg_name}.{name}")

    api, core, b = m("api"), m("api.core"), m("utils.builders")
    bus = m("bus.service")
    primary = m("utils").Store()
    server = bus.StoreBusServer(primary, "127.0.0.1:0")
    port = server.start()
    target = (f"127.0.0.1:{port}" if channel == "grpc"
              else bus.InProcessChannel(server.core))
    replica = bus.StoreReplica(target)
    replica.start()
    assert replica.wait_synced(30)
    kw = {"device": "cpu"} if pkg_name == "karmada_tpu_torch" else {}
    cp = m("controlplane").ControlPlane(store=m("bus.agent").ReplicaStoreFacade(replica), **kw)
    try:
        for i in range(1, c + 1):
            cp.join_cluster(b.new_cluster(f"member{i}", cpu="100", memory="200Gi"))
        settle(cp)
        cp.store.apply(api.PropagationPolicy(
            meta=core.ObjectMeta(name="p", namespace="default"),
            spec=api.PropagationSpec(
                resource_selectors=[api.ResourceSelector(api_version="apps/v1",
                                                         kind="Deployment")],
                placement=b.dynamic_weight_placement()),
        ))
        for i in range(n):
            cp.store.apply(b.new_deployment(f"app{i}", replicas=(i % 4) + 1))
        settle(cp)

        def works_match_placements() -> bool:
            settle(cp)
            want = sum(len(rb.spec.clusters) for rb in primary.list("ResourceBinding"))
            have = sum(1 for w in primary.list("Work") if ".app" in w.meta.name)
            return want > 0 and have == want

        deadline = time.monotonic() + 120
        while not works_match_placements():
            assert time.monotonic() < deadline, "works never converged to the placements"
        return state(m, primary)
    finally:
        replica.close()
        server.stop()


def settle(cp):
    """Settle through the write-echo stream until three settles in a row do
    nothing (a deadline, not a count of sleeps)."""
    cp.settle()
    idle = 0
    deadline = time.monotonic() + 120
    while idle < 3:
        assert time.monotonic() < deadline, "plane never settled through echoes"
        time.sleep(0.05)
        idle = idle + 1 if cp.settle() == 0 else 0


def state(m, primary):
    """Timestamp-free plane state: binding placements and rehydrated Work
    manifests (``test_bus_batch._state``)."""
    work_manifests = m("controllers.propagation").work_manifests
    to_jsonable = m("utils.codec").to_jsonable
    placements = {rb.meta.namespaced_name: sorted((tc.name, tc.replicas)
                                                  for tc in rb.spec.clusters)
                  for rb in primary.list("ResourceBinding")}
    manifests = {}
    for w in primary.list("Work"):
        docs = work_manifests(primary, w)
        assert docs, f"work {w.meta.namespaced_name} has no manifest"
        manifests[w.meta.namespaced_name] = [jax_cases._canon(to_jsonable(d)) for d in docs]
    return placements, manifests


class TestPlaneOverBusParity:
    def test_final_state_identical_batched_vs_unary(self, monkeypatch):
        batched = run_plane_over_bus("karmada_tpu_torch")
        monkeypatch.setenv("KARMADA_TPU_BUS_BATCH", "0")
        monkeypatch.setenv("KARMADA_TPU_BUS_TEMPLATE_DELTA", "0")
        unary = run_plane_over_bus("karmada_tpu_torch")
        assert batched[0] == unary[0], "binding placements diverged"
        assert batched[1] == unary[1], "rehydrated work manifests diverged"


@pytest.mark.parametrize("channel", ["grpc", "in-process"])
@pytest.mark.parametrize("mode", ["batched", "unary"])
def test_plane_over_bus_equals_jax(mode, channel, monkeypatch):
    """The port's plane over the port's bus and the JAX plane over the JAX
    bus, on the same scenario: equal placements and rehydrated manifests."""
    if mode == "unary":
        monkeypatch.setenv("KARMADA_TPU_BUS_BATCH", "0")
        monkeypatch.setenv("KARMADA_TPU_BUS_TEMPLATE_DELTA", "0")
    want = run_plane_over_bus("karmada_tpu")
    got = run_plane_over_bus("karmada_tpu_torch", channel)
    assert got[0] == want[0], "binding placements differ from the JAX plane's"
    assert got[1] == want[1], "rehydrated Work manifests differ from the JAX plane's"
    assert len(got[0]) == 12 and sum(map(len, got[1].values())) >= 12
