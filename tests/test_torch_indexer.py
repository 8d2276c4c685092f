"""The port's search indexer (``search/indexer.py``) against the JAX package
on the CPU.

- the cases of ``tests/test_search_indexer.py`` run whole on the port
  (``port_cases``): a bulk round trip against ``python -m
  karmada_tpu_torch.search.indexer``, the client's buffer and retry on an
  unreachable indexer, a poison op dropped without its batchmates, and the
  search controller shipping documents to the external process;
- across the packages on one wire: an ``HttpIndexerBackend`` of either
  package against an indexer process of either package (all four pairs),
  through one seeded sequence of upserts, deletes, a poison op and a
  cluster drop: the same counts, the same dropped ops and the same hits
  for every query, their objects encoded by the bus codec.

Tolerance: exact equality."""

import itertools
import json
import sys

import numpy as np
import pytest

from port_cases import cpu_plane, port_cases  # noqa: F401 (fixture)
from test_torch_controlplane import PKGS, mod

globals().update(port_cases("test_search_indexer"))

QUERIES = ("", "kind:deployment", "name:web*", "name:web name:3", "kind:deployment name:api",
           "name:nothing-here", "app*")


@pytest.fixture(scope="module")
def indexers():
    """One indexer process of each package: {package name: host:port}."""
    from karmada_tpu_torch.localup import scrape_line, spawn_child

    procs = {pkg.__name__: spawn_child([sys.executable, "-m", f"{pkg.__name__}.search.indexer"],
                                       device="cpu")
             for pkg in PKGS}
    try:
        yield {name: "127.0.0.1:" + scrape_line(p, r"listening on port (\d+)", timeout=120)
               for name, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
            p.wait(timeout=10)


def client_run(client, target: str, seed: int, monkeypatch) -> list:
    """A seeded sequence of ``client``'s ``HttpIndexerBackend`` ops against
    the indexer at ``target``, under cluster names of its own (its object
    uids from a counter of its own): what the client saw after each
    phase."""
    monkeypatch.setattr(mod(client, "api.core"), "_uid_counter", itertools.count(1))
    new_deployment = mod(client, "utils.builders").new_deployment
    rng = np.random.default_rng(seed)
    be = mod(client, "search.indexer").HttpIndexerBackend(target, batch_size=int(
        rng.integers(2, 9)))
    tag = f"{client.__name__}-{seed}"
    clusters = [f"{tag}-m{i}" for i in range(3)]
    seen = []

    def observe():
        hits = []
        for q in QUERIES:
            got = be.search(q, clusters=clusters)
            hits.append(sorted(json.dumps(dict(h, object=json.loads(
                mod(client, "bus.service").encode_object(h["object"])),
                cluster=h["cluster"].replace(tag, "")), sort_keys=True) for h in got))
        seen.append((len(be.search("", clusters=clusters)), be.dropped, hits))

    for i in range(40):
        name = ("web-" if rng.random() < 0.6 else "api-") + str(int(rng.integers(0, 12)))
        be.upsert(clusters[int(rng.integers(0, 3))],
                  new_deployment(name, replicas=int(rng.integers(1, 9))))
    assert be.flush()
    observe()
    for i in range(10):
        be.delete(clusters[int(rng.integers(0, 3))], "apps/v1/Deployment", "default",
                  f"web-{int(rng.integers(0, 12))}")
    be._enqueue({"op": "bogus-op"})
    be.upsert(clusters[0], new_deployment("after-poison", replicas=2))
    assert be.flush()
    observe()
    be.drop_cluster(clusters[1])
    assert be.flush()
    observe()
    return seen


@pytest.mark.parametrize("seed", [0, 1])
def test_indexer_wire_across_the_packages(indexers, seed, monkeypatch):
    runs = {(c.__name__, s): client_run(c, target, seed, monkeypatch)
            for c in PKGS for s, target in indexers.items()}
    want = runs[("karmada_tpu", "karmada_tpu")]
    assert want[0][0] > 0 and want[1][1] == 1
    for pair, got in runs.items():
        assert got == want, pair

