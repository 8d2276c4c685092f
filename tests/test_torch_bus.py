"""The port's store bus against the JAX package on the CPU.

``bus/service.py`` (the protobuf-free ``StoreBusCore``, the gRPC
``StoreBusServer`` over it, ``StoreReplica`` over a ``GrpcChannel`` or an
``InProcessChannel``, the codec and the kind registry), the store's replica
seams (``rv``, ``advance_rv``, ``kinds``, ``unwatch_all``), the ``bus_*``
metrics, the ``bus.rpc``/``bus.watch`` injection points and the worker's
wall-clock backoff (``runtime.realtime``, ``next_due``):

- the cases of ``tests/test_store_bus.py`` and ``tests/test_worker_backoff.py``
  run whole on the port (``port_cases``), and those of
  ``tests/test_bus_batch.py`` without ``TestTemplateDeltaRendering`` and
  ``TestPlaneOverBusParity``, which build their planes with
  ``karmada_tpu.cli.cmd_init`` (the CLI, ROADMAP A7c): their scenarios run
  on ``ControlPlane(store=..., device="cpu")`` in
  ``tests/test_torch_bus_plane.py``. Its
  ``TestWatchBatchParity.test_reconnect_replays_batched_and_heals_gap``
  waits 10 s for the reconnect, which gRPC's own reconnect backoff can
  outlast on a loaded machine (ROADMAP lists it among the JAX cases that
  fail under ``-n 6`` and pass alone): the port's module runs the same case
  with a 60 s deadline;
- across the packages, on one wire: a port ``StoreReplica`` mirrors a JAX
  ``StoreBusServer`` and a JAX replica mirrors the port's server, batched
  and unary, each mirror holding the primary's objects byte for byte at the
  primary's resource versions;
- the codec: both packages' ``kind_registry()`` have the same keys, and
  ``encode_object`` gives the same bytes for every registered kind (seeded
  metadata) and for every object a JAX plane holds after a propagation
  scenario, decoded by the port and encoded again;
- the in-process channel against gRPC: on the same writes (batched and
  unary applies, CAS conflicts, deletes), a replica over an
  ``InProcessChannel`` and one over gRPC hold equal mirrors at equal
  resource versions, and the primary's objects are never shared with a
  mirror;
- imports: ``karmada_tpu_torch.bus``, ``karmada_tpu_torch.localup`` and
  ``chip_smoke`` import with ``grpc``, ``google.protobuf``, ``jax`` and
  ``karmada_tpu`` blocked, and a replica over the in-process channel
  mirrors a write there.

Tolerance: exact equality."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest

import karmada_tpu.bus as JB
import karmada_tpu_torch.bus as TB
from port_cases import cpu_plane, port_cases  # noqa: F401 (fixture)
from test_torch_controlplane import PKGS, mod

globals().update(port_cases("test_store_bus"))
globals().update(port_cases("test_worker_backoff"))
globals().update(port_cases("test_bus_batch", leave_out=(
    "TestTemplateDeltaRendering", "TestPlaneOverBusParity",
    "TestWatchBatchParity.test_reconnect_replays_batched_and_heals_gap")))


def wait_for(cond, timeout=20.0):
    """Poll ``cond`` until it holds or ``timeout`` passes (a deadline, not a
    fixed sleep: a loaded machine only waits longer)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def test_reconnect_replays_batched_and_heals_gap():
    """``tests/test_bus_batch.py``'s case of that name on the port, with a
    60 s deadline for the reconnect: a write made while the server was
    down reaches the mirror through the reconnected stream's replay, and
    the stream re-negotiates the batched watch."""
    core = mod(PKGS[1], "api.core")
    store = mod(PKGS[1], "utils").Store()

    def cm(name, payload):
        return core.Resource(api_version="v1", kind="ConfigMap",
                             meta=core.ObjectMeta(name=name, namespace="ns"),
                             spec={"payload": payload})

    server = TB.StoreBusServer(store, "127.0.0.1:0")
    port = server.start()
    store.apply(cm("g0", 0))
    replica = TB.StoreReplica(f"127.0.0.1:{port}")
    replica.start()
    try:
        assert wait_for(lambda: replica.store.get("Resource", "ns/g0") is not None, 60)
        server.stop(grace=0)
        store.apply(cm("g1", 1))  # written while disconnected
        server2 = TB.StoreBusServer(store, f"127.0.0.1:{port}")
        server2.start()
        try:
            assert wait_for(lambda: replica.store.get("Resource", "ns/g1") is not None, 60)
            assert replica._watch_supports_batch is True
        finally:
            server2.stop()
    finally:
        replica.close()


def seeded_objects(pkg, seed: int) -> list:
    """A few objects of several kinds made from ``seed`` with the modules of
    ``pkg``: ConfigMap-like resources, Deployments, a Cluster, a policy, a
    Lease."""
    core = mod(pkg, "api.core")
    b = mod(pkg, "utils.builders")
    cl = mod(pkg, "api.cluster")
    pol = mod(pkg, "api.policy")
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        out.append(core.Resource(
            api_version="v1", kind="ConfigMap",
            meta=core.ObjectMeta(name=f"cm{i}", namespace=str(rng.choice(["a", "b"])),
                                 labels={"k": str(int(rng.integers(0, 5)))}),
            spec={"payload": int(rng.integers(0, 1000)), "list": [int(x) for x in
                                                                  rng.integers(0, 9, 3)]}))
    for i in range(6):
        out.append(b.new_deployment(f"d{i}", replicas=int(rng.integers(1, 9))))
    out.append(b.new_cluster(f"m{seed}", cpu="100", memory="200Gi"))
    out.append(pol.PropagationPolicy(
        meta=core.ObjectMeta(name="p", namespace="default"),
        spec=pol.PropagationSpec(
            resource_selectors=[pol.ResourceSelector(api_version="apps/v1", kind="Deployment")],
            placement=b.dynamic_weight_placement())))
    out.append(cl.Lease(meta=core.ObjectMeta(name="karmada-plane"), holder_identity="x",
                        renew_time=float(seed), lease_duration_seconds=15.0))
    return out


def mirror_state(store) -> dict:
    """Every object of ``store`` as (resource version, canonical JSON), by
    (kind, key); the codec is the JAX package's or the port's, equal bytes
    either way."""
    out = {}
    for kind in store.kinds():
        for obj in store.list(kind):
            out[(kind, obj.meta.namespaced_name)] = (obj.meta.resource_version,
                                                     TB.encode_object(obj))
    return out


def write_sequence(pkg, replica_or_store) -> None:
    """The same writes, whichever package's objects: batched applies, unary
    applies, a CAS conflict, updates and deletes."""
    objs = seeded_objects(pkg, 3)
    target = replica_or_store
    errors = target.apply_many(objs[:10])
    assert errors == []
    for o in objs[10:]:
        target.apply(o)
    conflict = mod(pkg, "utils.store").ConflictError
    with pytest.raises(conflict):
        target.apply(seeded_objects(pkg, 4)[0], expected_rv=1_000_000)
    upd = seeded_objects(pkg, 5)[:4]
    assert target.apply_many(upd) == []
    assert target.delete("Resource", objs[1].meta.namespaced_name)
    assert target.delete_many([("Resource", objs[12].meta.namespaced_name),
                               ("Resource", objs[13].meta.namespaced_name, True)]) == []


@pytest.mark.parametrize("batch", ["4096", "0"])
@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_replica_mirrors_the_other_packages_server(server_pkg, batch, monkeypatch):
    """A port replica over a JAX server, and a JAX replica over the port's
    server: the mirror holds the primary's objects byte for byte at the
    primary's resource versions, batched and unary."""
    monkeypatch.setenv("KARMADA_TPU_BUS_BATCH", batch)
    server_mod, client_mod = (JB, TB) if server_pkg == "jax" else (TB, JB)
    spkg, cpkg = (PKGS[0], PKGS[1]) if server_pkg == "jax" else (PKGS[1], PKGS[0])
    primary = mod(spkg, "utils").Store()
    server = server_mod.StoreBusServer(primary, "127.0.0.1:0")
    port = server.start()
    replica = client_mod.StoreReplica(f"127.0.0.1:{port}")
    replica.start()
    try:
        assert replica.wait_synced(20)
        write_sequence(cpkg, replica)
        assert wait_for(lambda: mirror_state(replica.store) == mirror_state(primary))
        assert replica.supports_batch is (None if batch == "0" else True)
        assert len(mirror_state(primary)) > 10
    finally:
        replica.close()
        server.stop()


def test_kind_registries_have_the_same_keys():
    assert sorted(JB.kind_registry()) == sorted(TB.kind_registry())


@pytest.mark.parametrize("seed", range(3))
def test_every_kind_encodes_to_the_same_bytes(seed):
    """Every registered kind, default-built with seeded metadata in each
    package: equal bytes; the JAX bytes decode on the port to an object
    that encodes to them again."""
    rng = np.random.default_rng(seed)
    for kind in sorted(JB.kind_registry()):
        encoded = []
        name = f"o{int(rng.integers(0, 1000))}"
        labels = {f"l{int(rng.integers(0, 9))}": str(int(rng.integers(0, 99)))}
        gen, rv = int(rng.integers(1, 9)), int(rng.integers(1, 10_000))
        for bus in (JB, TB):
            obj = bus.kind_registry()[kind]()
            obj.meta.name, obj.meta.namespace = name, "ns" if seed % 2 else ""
            obj.meta.labels, obj.meta.generation, obj.meta.resource_version = \
                dict(labels), gen, rv
            encoded.append(bus.encode_object(obj))
        assert encoded[0] == encoded[1], kind
        assert TB.encode_object(TB.decode_object(kind, encoded[0])) == encoded[0], kind


def test_a_jax_planes_objects_round_trip_through_the_port_codec():
    """Every object a JAX plane holds after propagating Deployments over
    three members (bindings, Works, templates, Clusters, Leases, policies):
    the port decodes its JAX bytes and encodes the same bytes."""
    jb = mod(PKGS[0], "utils.builders")
    cp = mod(PKGS[0], "controlplane").ControlPlane()
    for i in range(1, 4):
        cp.join_cluster(jb.new_cluster(f"member{i}", cpu="100", memory="200Gi"))
    for obj in seeded_objects(PKGS[0], 7)[12:]:
        cp.store.apply(obj)
    cp.settle()
    n = 0
    for kind in cp.store.kinds():
        for obj in cp.store.list(kind):
            doc = JB.encode_object(obj)
            assert TB.encode_object(TB.decode_object(kind, doc)) == doc, (kind, obj.meta.name)
            n += 1
    assert n > 30 and {"ResourceBinding", "Work", "Cluster"} <= set(cp.store.kinds())


@pytest.mark.parametrize("batch", ["4096", "0"])
def test_in_process_channel_mirrors_like_grpc(batch, monkeypatch):
    """On the same writes through each, a replica over the in-process
    channel and one over gRPC hold equal mirrors at equal resource
    versions, equal to the primary; no mirror object is the primary's."""
    monkeypatch.setenv("KARMADA_TPU_BUS_BATCH", batch)
    pkg = PKGS[1]
    primary = mod(pkg, "utils").Store()
    server = TB.StoreBusServer(primary, "127.0.0.1:0")
    port = server.start()
    inproc = TB.StoreReplica(TB.InProcessChannel(server.core))
    wire = TB.StoreReplica(f"127.0.0.1:{port}")
    for r in (inproc, wire):
        r.start()
        assert r.wait_synced(20)
    try:
        write_sequence(pkg, inproc)
        write_sequence(pkg, wire)  # the same writes again, through the wire
        want = mirror_state(primary)
        assert wait_for(lambda: mirror_state(inproc.store) == want
                        and mirror_state(wire.store) == want)
        assert inproc.wait_rv(primary.rv, 5) and inproc.events > 0
        assert inproc._channel.writes > 0
        ids = {id(o) for k in primary.kinds() for o in primary.list(k)}
        assert not ids & {id(o) for k in inproc.store.kinds() for o in inproc.store.list(k)}
    finally:
        inproc.close()
        wire.close()
        server.stop()


def test_in_process_replica_replays_templates_first_then_bookmarks():
    """The core's replay order (WorkloadTemplates first, then the kinds in
    order), its bookmark, and a late subscriber's live events, as records."""
    pkg = PKGS[1]
    store = mod(pkg, "utils").Store()
    core = TB.StoreBusCore(store)
    work = mod(pkg, "api.work")
    core_mod = mod(pkg, "api.core")
    store.apply(core_mod.Resource(api_version="v1", kind="ConfigMap",
                                  meta=core_mod.ObjectMeta(name="c", namespace="n")))
    store.apply(work.WorkloadTemplate(meta=core_mod.ObjectMeta(name="t")))
    live = [True]
    frames = core.watch_frames((), True, lambda: live[0])
    first = next(frames)
    assert [e.kind for e in first.events] == ["WorkloadTemplate", "Resource"]
    assert next(frames).bookmark
    store.apply(core_mod.Resource(api_version="v1", kind="ConfigMap",
                                  meta=core_mod.ObjectMeta(name="d", namespace="n")))
    ev = next(frames).events[0]
    assert (ev.type, ev.kind, ev.key, ev.resource_version) == ("Added", "Resource", "n/d", 3)
    live[0] = False
    assert list(frames) == []
    core.close()


def test_bus_imports_without_grpc_protobuf_jax_or_the_jax_package():
    """``karmada_tpu_torch.bus``, ``karmada_tpu_torch.localup`` and
    ``chip_smoke`` import with grpc, protobuf, jax and karmada_tpu blocked,
    and a replica over the in-process channel mirrors a write there."""
    code = r"""
import importlib.abc, sys
for name in ("grpc", "google.protobuf", "jax"):
    sys.modules[name] = None
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name == "karmada_tpu" or name.startswith("karmada_tpu."):
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Refuse())
import chip_smoke, karmada_tpu_torch.bus as bus, karmada_tpu_torch.localup
from karmada_tpu_torch.bus.agent import ReplicaStoreFacade
from karmada_tpu_torch.utils import Store
from karmada_tpu_torch.utils.builders import new_deployment
primary = Store()
core = bus.StoreBusCore(primary)
replica = bus.StoreReplica(bus.InProcessChannel(core))
replica.start()
assert replica.wait_synced(20)
ReplicaStoreFacade(replica).apply(new_deployment("x", replicas=2))
assert replica.wait_rv(primary.rv, 20)
assert replica.store.get("Resource", "default/x").spec["replicas"] == 2
replica.close()
bad = [m for m in sys.modules if m.startswith(("karmada_tpu.", "jax", "grpc"))
       or m == "karmada_tpu" or m.startswith("google.protobuf")]
assert not [m for m in bad if sys.modules[m] is not None], bad
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=str(__import__("pathlib").Path(__file__).parents[1]))
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-3000:]


def test_fault_points_fire_on_the_in_process_channel():
    """``bus.rpc`` fires once per write attempt on the in-process channel
    too (the retry commits), and ``bus.watch`` once per connect."""
    fi = mod(PKGS[1], "utils.faultinject")
    pkg = PKGS[1]
    primary = mod(pkg, "utils").Store()
    core = TB.StoreBusCore(primary)
    fi.arm("bus.rpc=error,count=1,match=ApplyBatch;bus.watch=delay,count=1,delay=0.01",
           seed=3)
    try:
        replica = TB.StoreReplica(TB.InProcessChannel(core))
        replica.start()
        assert replica.wait_synced(20)
        assert replica.apply_many(seeded_objects(pkg, 1)[:5]) == []
        fired = [(e.point, e.key) for e in fi.injector().log]
        assert fired.count(("bus.rpc", "ApplyBatch")) == 1
        assert ("bus.watch", "Watch") in fired
        assert len(primary.list("Resource")) == 5
        replica.close()
    finally:
        fi.disarm()
        core.close()


def test_store_replica_seams_equal_jax():
    """``rv``, ``advance_rv``, ``kinds`` and ``unwatch_all`` on the same
    calls in both packages."""
    out = []
    for pkg in PKGS:
        store = mod(pkg, "utils").Store()
        seen = []
        handler = seen.append
        store.watch_all(handler)
        for obj in seeded_objects(pkg, 2)[:3]:
            store.apply(obj)
        store.advance_rv(40)
        store.apply(seeded_objects(pkg, 2)[3])
        store.unwatch_all(handler)
        store.apply(seeded_objects(pkg, 2)[4])
        out.append((store.rv, sorted(store.kinds()), len(seen),
                    [o.meta.resource_version for o in store.list("Resource")]))
    assert out[0] == out[1]
    assert json.dumps(out[1])
