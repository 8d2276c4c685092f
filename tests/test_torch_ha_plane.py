"""The port's HA plane replica against the JAX package's on the CPU.

Two plane replicas of one primary Store over the store bus, each a
``ControlPlane(store=ReplicaStoreFacade(...))`` with a ``LeaderElector`` on
one Lease and the throttled renew as its ``runtime.heartbeat``
(``chip_smoke.ha_plane_waves``, the card's HA phase, here on config 4 cut
to 60 Deployments x 20 clusters): pa leads and places the first half; the
second half is applied and pa is deposed inside its engine pass (the
injected clock passes its lease and pb's elector takes it); pa's write
barrier discards the pass; pb settles and places the second half.

- the JAX replicas over the JAX bus (gRPC) and the port's over the port's
  bus (the in-process channel, as on the card, and gRPC): equal placements
  after the cold wave and at the end, no write of the deposed pa reaching
  the primary, no binding of the second half placed by pa, the Lease held
  by pb after one transition;
- ``chip_smoke.run_ha_plane`` rehearsed small on the CPU: its waves and
  checks (every row to the numpy divider on each replica's engine, one
  engine pass of pb over exactly the new rows, no first-wave Work written
  again).

Both planes beat after every item (``HEARTBEAT_EVERY = 1``): the JAX
runtime re-runs a discarded pass until its next heartbeat, which at the
default of 256 items would repeat it hundreds of times here.

Tolerance: exact equality."""

import importlib

import pytest
import torch

import chip_smoke
import karmada_tpu
import karmada_tpu_torch


def jax_heartbeat(elector):
    """The JAX replica's ``renew_tick`` (``karmada_tpu/localup.py``), on the
    elector's injected clock."""
    last = [float("-inf")]

    def renew_tick() -> bool:
        now = elector.clock()
        if now - last[0] >= chip_smoke.HA_LEASE / 5:
            last[0] = now
            elector.tick()
        return elector.is_leader

    return renew_tick


def count_writes(replica) -> None:
    """Count the objects ``replica``'s write calls carry to the primary in
    ``replica.writes_seen`` (either package, either channel)."""
    replica.writes_seen = 0

    def wrap(fn, many):
        def counted(arg, *a, **kw):
            if many:
                arg = list(arg)
            replica.writes_seen += len(arg) if many else 1
            return fn(arg, *a, **kw)
        return counted

    for name, many in (("apply", False), ("delete", False), ("apply_many", True),
                       ("delete_many", True)):
        setattr(replica, name, wrap(getattr(replica, name), many))


def run(pkg, channel: str, templates: int = 60, clusters: int = 20) -> dict:
    bus = importlib.import_module(f"{pkg.__name__}.bus.service")
    primary = importlib.import_module(f"{pkg.__name__}.utils").Store(
        admission=(chain := importlib.import_module(
            f"{pkg.__name__}.webhook").default_admission_chain()).admit,
        delete_admission=chain.admit_delete)
    server = bus.StoreBusServer(primary, "127.0.0.1:0")
    port = server.start()
    replicas = []

    def make_replica():
        target = (f"127.0.0.1:{port}" if channel == "grpc"
                  else bus.InProcessChannel(server.core))
        replica = bus.StoreReplica(target)
        replica.start()
        assert replica.wait_synced(30)
        count_writes(replica)
        replicas.append(replica)
        return replica

    if pkg is karmada_tpu_torch:
        localup = importlib.import_module("karmada_tpu_torch.localup")
        heartbeat_of = lambda e: localup.plane_heartbeat(e, chip_smoke.HA_LEASE, e.clock)  # noqa: E731
        plane_kw = {"device": "cpu"}
    else:
        heartbeat_of, plane_kw = jax_heartbeat, {}
    try:
        out = chip_smoke.ha_plane_waves(pkg, primary, make_replica, plane_kw, heartbeat_of,
                                        templates, clusters,
                                        lambda r: r.writes_seen, beat_every=1)
        lease = out["lease"]
        return {"cold": out["cold_placements"], "final": out["final_placements"],
                "pa_writes_after": out["pa_writes_after"], "pa_placed": out["pa_placed"],
                "lease": (lease.holder_identity, lease.lease_transitions),
                "leaders": (out["pa"].elector.is_leader, out["pb"].elector.is_leader)}
    finally:
        for r in replicas:
            r.close()
        server.stop()


@pytest.fixture(scope="module")
def jax_run():
    return run(karmada_tpu, "grpc")


@pytest.mark.parametrize("channel", ["in-process", "grpc"])
def test_ha_takeover_equals_jax(jax_run, channel):
    got = run(karmada_tpu_torch, channel)
    assert got["cold"] == jax_run["cold"]
    assert got["final"] == jax_run["final"]
    for r in (jax_run, got):
        assert r["pa_writes_after"] == 0 and r["pa_placed"] == 0
        assert r["lease"] == ("pb", 1) and r["leaders"] == (False, True)
        assert len(r["final"]) == 60 and all(p[0] for p in r["final"].values())
    assert all(got["final"][k] == v for k, v in got["cold"].items())


def test_run_ha_plane_rehearsal():
    """The card's HA phase, small, on the CPU: every check of
    ``run_ha_plane`` holds (it raises otherwise). pa runs one engine pass
    in the takeover and is deposed in it; that pass holds the new bindings
    whose echoes had reached pa's mirror when its scheduler drained (all
    of them on an idle machine, fewer under load), and pb's one pass holds
    all of them."""
    out = chip_smoke.run_ha_plane(torch.device("cpu"), "cpu", templates=200, clusters=40)
    assert set(out["waves"]) == {"join", "cold", "takeover pa", "takeover pb"}
    assert out["waves"]["takeover pb"]["passes"] == [100]
    [deposed_pass] = out["waves"]["takeover pa"]["passes"]
    assert 0 < deposed_pass <= 100
