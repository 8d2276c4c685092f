"""The port's leader election and the scheduler's lease write barrier
against the JAX package on the CPU.

- the cases of ``tests/test_leader_election.py`` run whole on the port
  (``port_cases``): the store's and the bus's CAS precondition, acquire,
  renew, expiry takeover, the renew deadline, release;
- ``LeaderElector`` on both packages through one scripted sequence (three
  candidates on one injected clock: acquisition, renewals, expiry, a
  takeover, a transient write failure inside and past the renew deadline,
  a release): leadership and the Lease after every step equal;
- the write barrier (``SchedulerController`` after the engine pass asks
  ``runtime.beat()``): a plane whose heartbeat turns False inside its
  engine pass writes nothing of that pass, keeps every key of the batch
  queued and stops its drain (the port runs the pass once; the JAX runtime
  runs it again until its next heartbeat, ``HEARTBEAT_EVERY``, so both
  planes here beat after every item); once it leads again, it schedules
  them; the states after each settle equal the JAX plane's (``run_both``).

Tolerance: exact equality."""

import pytest

from port_cases import cpu_plane, port_cases  # noqa: F401 (fixture)
from test_torch_controlplane import PKGS, mod, placed, run_both

globals().update(port_cases("test_leader_election"))


class FlakyStore:
    """A store whose writes fail while ``down`` (an unreachable bus)."""

    def __init__(self, store):
        self.store, self.down = store, False

    def get(self, kind, key):
        return self.store.get(kind, key)

    def apply(self, obj, **kw):
        if self.down:
            raise RuntimeError("bus unreachable")
        return self.store.apply(obj, **kw)


def elector_run(pkg) -> list:
    le = mod(pkg, "utils.leaderelect")
    store = FlakyStore(mod(pkg, "utils").Store())
    now = [100.0]
    events = []
    electors = {
        name: le.LeaderElector(
            store, "lock", name, lease_duration=10.0, renew_deadline=6.0,
            clock=lambda: now[0],
            on_started_leading=lambda name=name: events.append(("start", name)),
            on_stopped_leading=lambda name=name: events.append(("stop", name)))
        for name in ("a", "b", "c")}
    script = [
        ("tick", "a", 0), ("tick", "b", 0), ("tick", "a", 3), ("tick", "c", 3),
        ("tick", "b", 11), ("tick", "b", 15), ("tick", "a", 0), ("down", "", 0),
        ("tick", "b", 4), ("tick", "b", 3), ("up", "", 0), ("tick", "b", 0),
        ("tick", "c", 30), ("release", "c", 0), ("tick", "a", 0), ("tick", "b", 1),
        ("release", "b", 0), ("tick", "a", 1),
    ]
    out = []
    for op, name, dt in script:
        now[0] += dt
        if op == "tick":
            electors[name].tick()
        elif op == "release":
            electors[name].release()
        else:
            store.down = op == "down"
        lease = store.get("Lease", "lock")
        out.append((op, name, {n: e.is_leader for n, e in electors.items()},
                    None if lease is None else (lease.holder_identity, lease.renew_time,
                                                lease.acquire_time, lease.lease_transitions,
                                                lease.meta.resource_version),
                    list(events)))
    return out


def test_elector_sequence_equals_jax():
    want, got = (elector_run(pkg) for pkg in PKGS)
    assert got == want
    assert any(step[3] and step[3][3] >= 2 for step in got)  # two transitions


def hooked(p, cp, leading: list, passes: list) -> None:
    """A heartbeat that answers ``leading[0]`` after every item, and an
    engine whose ``schedule`` (counted in ``passes``) turns it False at the
    start of the first pass ``leading[1]`` arms."""
    cp.runtime.HEARTBEAT_EVERY = 1
    cp.runtime.heartbeat = lambda: leading[0]
    ctl = cp.scheduler
    get_engine = ctl._get_engine

    def engine():
        eng = get_engine()
        if not getattr(eng, "_hooked", False):
            schedule = eng.schedule

            def hooked_schedule(problems, *a, **kw):
                passes.append(len(problems))
                if leading[1]:
                    leading[0], leading[1] = False, False
                return schedule(problems, *a, **kw)

            eng.schedule, eng._hooked = hooked_schedule, True
        return eng

    ctl._get_engine = engine


def barrier_scenario(p, record, outcome):
    cp = p.make_plane(3)
    leading, passes = [True, False], []
    hooked(p, cp, leading, passes)
    cp.store.apply(p.deployment_policy(p.b.dynamic_weight_placement()))
    for i in range(4):
        cp.store.apply(p.b.new_deployment(f"first{i}", replicas=i + 2))
    cp.settle()
    record(cp)
    first = {rb.meta.namespaced_name: placed(rb) for rb in cp.store.list("ResourceBinding")}
    writes = []
    cp.store.watch_all(lambda e: writes.append((e.kind, e.key)) if not leading[0] else None)
    leading[1] = True  # deposed inside the next engine pass
    for i in range(6):
        cp.store.apply(p.b.new_deployment(f"app{i}", replicas=i + 1))
    n_passes = len(passes)
    cp.settle()
    record(cp)
    new = [rb for rb in cp.store.list("ResourceBinding") if "app" in rb.meta.name]
    outcome.append({
        "deposed_writes": list(writes), "new_placed": sum(bool(rb.spec.clusters) for rb in new),
        "queued": len(cp.scheduler.worker), "passes_deposed": passes[n_passes:],
        "first_kept": first == {rb.meta.namespaced_name: placed(rb)
                                for rb in cp.store.list("ResourceBinding") if rb.meta.name
                                .startswith("first")},
        "deposed": getattr(cp.runtime, "deposed", None),
    })
    leading[0] = True  # leads again: the parked keys are scheduled
    cp.settle()
    record(cp)
    assert all(rb.spec.clusters for rb in cp.store.list("ResourceBinding"))


def test_deposed_in_the_engine_pass_writes_nothing(monkeypatch):
    outcomes = []
    run_both(lambda p, record: barrier_scenario(p, record, outcomes), monkeypatch)
    jax, port = outcomes
    for o in (jax, port):
        assert o["deposed_writes"] == [] and o["new_placed"] == 0 and o["first_kept"]
        assert o["queued"] == 6
    # the port's deposed drain stops after the discarded pass; the JAX
    # plane re-runs it once a drain until its settle's 16 drains are spent
    assert port["deposed"] is True and port["passes_deposed"] == [6]
    assert jax["passes_deposed"] == [6] * len(jax["passes_deposed"])


@pytest.mark.parametrize("every", [1, 256])
def test_beat_without_a_heartbeat_passes(every):
    """``Runtime.beat`` answers True with no heartbeat (an in-process plane),
    and a False heartbeat marks the runtime deposed until the next drain."""
    rt = mod(PKGS[1], "utils").Runtime()
    rt.HEARTBEAT_EVERY = every
    assert rt.beat() is True and rt.deposed is False
    rt.heartbeat = lambda: False
    assert rt.beat() is False and rt.deposed is True
    rt.heartbeat = lambda: True
    w = rt.new_worker("w", lambda key: mod(PKGS[1], "utils.worker").DONE)
    w.enqueue("k")
    assert rt.run_until_settled() == 1 and rt.deposed is False
