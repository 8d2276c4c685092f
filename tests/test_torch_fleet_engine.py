"""The port's TensorScheduler on its fleet route against the JAX engine on
its own, on the CPU, through a sequence of passes: cold, an identical
re-pass, rebuilt problem objects, a few changed rows, availability drift,
new keys past the table's cap (growth), deleted keys (compaction) and slot
eviction. After every step the outcomes must be equal, and so must the
table state: the host entry and meta mirrors and both residents.
Tolerance: exact. Inputs come from numpy seeds; each package builds its
own objects from them."""

import importlib

import numpy as np
import pytest
import torch

import karmada_tpu
import karmada_tpu.scheduler as JS
import karmada_tpu.scheduler.fleet as jfleet
import karmada_tpu.utils.builders  # noqa: F401
import karmada_tpu.utils.quantity  # noqa: F401

import karmada_tpu_torch
import karmada_tpu_torch.scheduler as TS
import karmada_tpu_torch.scheduler.fleet as tfleet

import chip_smoke

PKGS = (karmada_tpu, karmada_tpu_torch)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one intra-op thread keeps this module
    from contending with the other test workers for the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def outcome(results):
    return [(r.key, dict(r.clusters), r.error, r.affinity_name, tuple(r.feasible))
            for r in results]


def table_state(fleet):
    n = fleet.n_rows
    return (
        fleet.n_rows, fleet.cap,
        np.asarray(fleet._host_entries)[:n].copy(),
        np.asarray(fleet._host_meta).copy(),
        np.asarray(fleet._res_dense).copy() if not hasattr(fleet._res_dense, "numpy")
        else fleet._res_dense.numpy().copy(),
        np.asarray(fleet._res_meta).copy() if not hasattr(fleet._res_meta, "numpy")
        else fleet._res_meta.numpy().copy(),
        len(fleet._cp_pl),
    )


def assert_same_state(jax_fleet, port_fleet):
    a, b = table_state(jax_fleet), table_state(port_fleet)
    assert a[0:2] == b[0:2], (a[0:2], b[0:2])
    for x, y in zip(a[2:6], b[2:6]):
        np.testing.assert_array_equal(x, y)
    assert a[6] == b[6]


class Pair:
    """One JAX engine and one port engine fed the same seeded problems."""

    def __init__(self, n_clusters=60, chunk=256):
        self.fleets = [importlib.import_module(f"{p.__name__}.utils.builders")
                       .synthetic_fleet(n_clusters, seed=21) for p in PKGS]
        self.engines = [
            JS.TensorScheduler(JS.ClusterSnapshot(self.fleets[0]), chunk_size=chunk),
            TS.TensorScheduler(TS.ClusterSnapshot(self.fleets[1]), chunk_size=chunk,
                               device="cpu"),
        ]
        self.placements = [self._placements(p, f) for p, f in zip(PKGS, self.fleets)]

    @staticmethod
    def _placements(pkg, fleet):
        b = importlib.import_module(f"{pkg.__name__}.utils.builders")
        return [
            b.dynamic_weight_placement(),
            b.duplicated_placement(),
            b.static_weight_placement({c.name: (i % 3) + 1 for i, c in enumerate(fleet[:10])}),
            b.aggregated_placement(),
        ]

    def problems(self, keys, seed, placements=None):
        """Per package: problems for ``keys`` (ints) from one numpy seed."""
        out = []
        for k, (pkg, fleet) in enumerate(zip(PKGS, self.fleets)):
            s = importlib.import_module(f"{pkg.__name__}.scheduler")
            q = importlib.import_module(f"{pkg.__name__}.utils.quantity")
            pls = (placements or self.placements)[k]
            req = q.parse_resource_list({"cpu": "250m", "memory": "512Mi"})
            rng = np.random.default_rng(seed)
            batch = []
            for key in keys:
                prev_idx = rng.choice(len(fleet), int(rng.integers(0, 5)), replace=False)
                batch.append(s.BindingProblem(
                    key=f"b{key}", placement=pls[key % len(pls)],
                    replicas=int(rng.integers(0, 40)), requests=req,
                    gvk="apps/v1/Deployment",
                    prev={fleet[j].name: int(rng.integers(1, 9)) for j in prev_idx},
                    fresh=bool(rng.random() < 0.2),
                ))
            out.append(batch)
        return out

    def step(self, batches, label):
        got = [outcome(e.schedule(b)) for e, b in zip(self.engines, batches)]
        assert got[0] == got[1], label
        assert all(e._fleet is not None for e in self.engines), label
        assert_same_state(self.engines[0]._fleet, self.engines[1]._fleet)
        return got[1]

    def drift(self, seed):
        for k, (pkg, fleet) in enumerate(zip(PKGS, self.fleets)):
            s = importlib.import_module(f"{pkg.__name__}.scheduler")
            rng = np.random.default_rng(seed)
            for cl in fleet:
                rs = cl.status.resource_summary
                for dim, q in list(rs.allocated.items()):
                    alloc = rs.allocatable.get(dim, 0)
                    rs.allocated[dim] = int(min(max(0, q + int(rng.integers(-30, 31))
                                                    * max(1, alloc // 200)), alloc))
            assert self.engines[k].update_snapshot(s.ClusterSnapshot(fleet))


def test_fleet_sequence_equals_jax():
    pair = Pair()
    keys = list(range(400))
    batches = pair.problems(keys, 1)
    first = pair.step(batches, "cold")
    assert sum(1 for o in first if o[2] == "") > 200
    pair.step(batches, "identical re-pass")
    # rebuilt problem objects, same content (the controller case)
    rebuilt = pair.problems(keys, 1)
    pair.step(rebuilt, "rebuilt objects")
    # a few changed rows
    changed = pair.problems(keys, 1)
    other = pair.problems(keys, 2)
    for b, o in zip(changed, other):
        for i in (3, 50, 51, 222, 399):
            b[i] = o[i]
    pair.step(changed, "changed rows")
    # availability drift on the same cluster set
    pair.drift(7)
    pair.step(changed, "drift")
    pair.step(changed, "drift, identical re-pass")
    # new keys past the cap: the table grows
    cap0 = pair.engines[1]._fleet.cap
    grown = pair.problems(list(range(cap0 + 100)), 3)
    pair.step(grown, "growth")
    assert pair.engines[1]._fleet.cap > cap0
    # a subset for COMPACT_IDLE_PASSES + 1 passes, then new keys: the idle
    # rows are compacted away before the table would grow
    live = list(range(0, 300))
    sub = pair.problems(live, 4)
    for _ in range(tfleet.FleetTable.COMPACT_IDLE_PASSES + 1):
        pair.step(sub, "subset")
    cap1 = pair.engines[1]._fleet.cap
    fresh_keys = live + list(range(5000, 5000 + cap1 - 250))
    pair.step(pair.problems(fresh_keys, 5), "compaction")
    assert pair.engines[1]._fleet.n_rows == len(fresh_keys)
    pair.drift(8)
    pair.step(pair.problems(fresh_keys, 5), "drift after compaction")


def test_slot_eviction_equals_jax(monkeypatch):
    """A placement budget of 8 slots: each wave re-issues the fleet with 4
    new placement objects, so the slots of two waves ago are unreferenced
    and the aggressive sweep evicts them (a remap and a full table
    rebuild), in both engines alike."""
    for mod in (jfleet, tfleet):
        monkeypatch.setattr(mod, "MAX_SLOTS", 8)
        monkeypatch.setattr(mod, "CP_TABLE_MAX_BYTES", 1)
    pair = Pair()
    keys = list(range(300))
    slots = []
    for wave in range(5):
        pls = [pair._placements(p, f) for p, f in zip(PKGS, pair.fleets)]
        pair.step(pair.problems(keys, 10 + wave, placements=pls), f"wave {wave}")
        slots.append(len(pair.engines[1]._fleet._cp_pl))
    # the sweep runs before a pass once the slots exceed the budget: the
    # slots of the waves before the last are evicted, then the pass adds 4
    assert slots == [4, 8, 12, 8, 12], slots


def test_config4_spread_rows_ride_the_fleet_in_both_engines():
    """Config 4's spread rows take derived selections onto the fleet in
    both engines; a drift re-derives them."""
    wj = chip_smoke.build_workload(karmada_tpu, 4, 600)
    wt = chip_smoke.build_workload(karmada_tpu_torch, 4, 600)
    ej, et = JS.TensorScheduler(wj[0]), TS.TensorScheduler(wt[0], device="cpu")
    a, b = outcome(ej.schedule(wj[1])), outcome(et.schedule(wt[1]))
    assert a == b and sum(o[2] == "" for o in b) > 500
    assert ej._fleet is not None and et._fleet is not None
    assert any(getattr(cp, "derived", False) for _, cp in et._fleet._cp_pl)
    assert outcome(et.schedule(wt[1])) == b
    for pkg, eng, snap in ((karmada_tpu, ej, wj[0]), (karmada_tpu_torch, et, wt[0])):
        s = importlib.import_module(f"{pkg.__name__}.scheduler")
        for cl in snap.clusters:
            rs = cl.status.resource_summary
            for dim in list(rs.allocated):
                rs.allocated[dim] = int(rs.allocated[dim] * 0.5)
        assert eng.update_snapshot(s.ClusterSnapshot(snap.clusters))
    assert outcome(ej.schedule(wj[1])) == outcome(et.schedule(wt[1]))


def test_mixed_batch_splits_between_fleet_and_host_path():
    """Rows the fleet does not take (more than K_PREV previous sites) go to
    the general path in the same pass, in both engines alike."""
    pair = Pair()
    batches = pair.problems(list(range(300)), 11)
    for k, (pkg, fleet) in enumerate(zip(PKGS, pair.fleets)):
        s = importlib.import_module(f"{pkg.__name__}.scheduler")
        p = batches[k][7]
        batches[k][7] = s.BindingProblem(
            key=p.key, placement=p.placement, replicas=30, requests=p.requests,
            gvk=p.gvk, prev={c.name: 1 for c in fleet[:40]})
    got = [outcome(e.schedule(b)) for e, b in zip(pair.engines, batches)]
    assert got[0] == got[1]
    assert pair.engines[1]._fleet.n_rows == 299


def test_dense_budget_overrun_raises(monkeypatch):
    """A table over the dense budget no longer raises: at the same budget
    (1 KiB) both engines take the entry-resident route (the JAX
    ``_fleet_solve``) and answer alike, with equal host mirrors and
    resident entries; the port allocates no dense resident."""
    for mod in (jfleet, tfleet):
        monkeypatch.setattr(mod, "DENSE_RESIDENT_MAX_BYTES", 1024)
    pair = Pair()
    batches = pair.problems(list(range(300)), 12)
    for label in ("cold", "again"):
        got = [outcome(e.schedule(b)) for e, b in zip(pair.engines, batches)]
        assert got[0] == got[1], label
        jt, tt = (e._fleet for e in pair.engines)
        assert tt._res_dense is None and tt._resident_entries is not None
        np.testing.assert_array_equal(tt._host_entries, np.asarray(jt._host_entries))
        np.testing.assert_array_equal(tt._host_meta, jt._host_meta)
        np.testing.assert_array_equal(tt._resident_entries.numpy(),
                                      np.asarray(jt._resident_entries))


def test_budgets_scale_with_the_device():
    assert tfleet._budgets(torch.device("cpu")) == (
        tfleet.DENSE_RESIDENT_MAX_BYTES, tfleet.CP_TABLE_MAX_BYTES)
    assert tfleet.DENSE_RESIDENT_MAX_BYTES == 6 << 30
    assert tfleet.CP_TABLE_MAX_BYTES == 1536 << 20


def test_stale_results_raise_after_a_later_pass():
    pair = Pair()
    batch = pair.problems(list(range(300)), 13)[1]
    eng = pair.engines[1]
    res = eng.schedule(batch)
    eng.schedule(pair.problems(list(range(300)), 14)[1])
    placed = next(i for i in range(300) if batch[i].replicas and i % 4 != 1)
    with pytest.raises(RuntimeError, match="stale"):
        res[placed].clusters


def test_lazy_feasible_sets_keep_their_pass_state():
    """A Duplicated row's feasible set is computed lazily, on first access,
    from the inputs of the pass that produced it. The port scatters dirty
    rows in place, so a pass that armed the lazy bitsets must make the next
    pass write into a copy. The port's first-pass set, read after a second
    pass moved the row to a narrower placement, equals the JAX engine's
    first-pass set read before that second pass. (Read after it, the JAX
    engine's set is empty on the forced 8-device CPU backend the tests run
    on: its captured state aliases the host staging — ROADMAP.md, section
    C.)"""
    pair = Pair()
    keys = list(range(300))
    first = pair.problems(keys, 15)
    second = pair.problems(keys, 15)
    for k, (pkg, fleet) in enumerate(zip(PKGS, pair.fleets)):
        api = importlib.import_module(f"{pkg.__name__}.api")
        b = importlib.import_module(f"{pkg.__name__}.utils.builders")
        s = importlib.import_module(f"{pkg.__name__}.scheduler")
        narrow = b.duplicated_placement(cluster_affinity=api.ClusterAffinity(
            cluster_names=[c.name for c in fleet[:5]]))
        p = first[k][1]  # key 1: a Duplicated row
        second[k][1] = s.BindingProblem(
            key=p.key, placement=narrow, replicas=p.replicas or 3,
            requests=p.requests, gvk=p.gvk, prev=p.prev, fresh=p.fresh)
    held = [e.schedule(b) for e, b in zip(pair.engines, first)]
    want = sorted(held[0][1].clusters)  # JAX: decoded before the next pass
    later = [outcome(e.schedule(b)) for e, b in zip(pair.engines, second)]
    assert later[0] == later[1]
    assert sorted(held[1][1].clusters) == want
    assert len(want) > 5  # the first pass's wide placement, not the new one


def test_chip_smoke_phases_rehearse_on_cpu(capsys):
    """chip_smoke's fleet phases run end to end on the CPU at a small size
    (the plain versions stand in for the kernels, so no counter moves):
    config 4 on the fleet, the config-5 storm with the kernel checks on
    its table, the mixed phase and the general path, each with its own
    oracle or referent."""
    cpu = torch.device("cpu")
    assert chip_smoke.run_config(4, cpu, "cpu", passes=1, bindings=600)["route"] == "fleet"
    storm = chip_smoke.run_fleet_storm(cpu, "cpu", bindings=1500, clusters=200,
                                       steady=2, churn=2)
    assert set(storm["stats"]) == {
        "fleet_masks", "fleet_bits", "fleet_diff", "fleet_wire",
        "fleet_entry_rows", "entry_wire", "scatter_rows", "gather_meta"}
    chip_smoke.run_mixed(cpu, "cpu", bindings=800, clusters=100, changed=40)
    chip_smoke.run_general(cpu, "cpu", storm["cold_out"], bindings=1500, clusters=200)
    # each phase raises on any row that differs from its referent
    assert capsys.readouterr().out.count("ok / 0 bad") >= 4
