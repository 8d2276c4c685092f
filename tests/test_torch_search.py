"""The port's search cache, backends and proxy against the JAX package on
the CPU.

``search/backend.py`` (the inverted index), ``search/registry.py``
(ResourceRegistry, the multi-cluster cache and its page tokens, the search
controller), ``search/proxy.py``, ``search/opensearch.py`` (the
OpenSearch-compatible backend and its HTTP server),
``search/proxyserver.py`` (the cluster proxy passthrough) and the member
seams they serve (pod logs, exec, the proxy audit):

- the cases of ``tests/test_search_backend.py``,
  ``tests/test_search_opensearch.py``, ``tests/test_opensearch_conformance.py``,
  ``tests/test_search_remedy_agent.py`` and ``tests/test_proxy_passthrough.py``
  run on the port (``port_cases``): the same calls, the same asserted
  answers. Three cases reach ``karmada_tpu.cli``, which the port does not
  carry, and are left out: ``TestPullClusterLease``'s two (its plane comes
  from ``cli.cmd_init``) and ``test_remote_cli_exec_rides_the_proxy``
  (``cli._RemoteProxyChain``);
- seeded resources on several clusters through both packages' inverted
  index (queries by term, prefix, field, label and cluster; deletes and
  cluster drops), multi-cluster cache (every page of ``list_paged`` at
  several limits, with its continue tokens and resource version) and
  OpenSearch document codec: the same answers.

Tolerance: exact equality."""

import numpy as np
import pytest

from port_cases import cpu_plane, port_cases  # noqa: F401 (fixture)
from test_torch_controlplane import PKGS, mod
from test_torch_interpreter import plain

globals().update(port_cases("test_search_backend"))
globals().update(port_cases("test_search_opensearch"))
globals().update(port_cases("test_opensearch_conformance"))
globals().update(port_cases("test_search_remedy_agent", leave_out=(
    "TestPullClusterLease.test_lease_renewed_keeps_ready",
    "TestPullClusterLease.test_dead_agent_degrades_after_grace_only")))
globals().update(port_cases("test_proxy_passthrough", leave_out=(
    "TestExecStreaming.test_remote_cli_exec_rides_the_proxy",)))

GVKS = ("apps/v1/Deployment", "v1/ConfigMap", "apps.kruise.io/v1alpha1/CloneSet")
WORDS = ("web", "web-frontend", "db", "cache", "api-gateway", "batch.job", "front")


def seeded_objects(pkg, seed: int) -> list:
    """(cluster, resource) pairs made from ``seed``, the same in every
    package: names from a small vocabulary so that terms repeat, three
    namespaces, labels, creation stamps."""
    core = mod(pkg, "api.core")
    rng = np.random.default_rng(seed)
    out = []
    for i in range(60):
        gvk = str(rng.choice(GVKS))
        api_version, kind = gvk.rsplit("/", 1)
        labels = {"app": str(rng.choice(["web", "db", "cache"]))}
        if rng.random() < 0.5:
            labels["tier"] = str(rng.choice(["gold", "silver"]))
        obj = core.Resource(
            api_version=api_version, kind=kind,
            meta=core.ObjectMeta(name=f"{rng.choice(WORDS)}-{i % 7}",
                                 namespace=str(rng.choice(["default", "prod", "kube-system"])),
                                 labels=labels, resource_version=int(rng.integers(1, 100)),
                                 creation_timestamp=float(rng.integers(0, 2)) * 1.7e9),
            spec={"replicas": int(rng.integers(0, 9))})
        out.append((f"m{int(rng.integers(0, 5))}", obj))
    return out


QUERIES = ("web", "front*", "kind:deployment", "kind:cloneset", "label:app=db",
           "label:tier=gold web", "namespace:prod", "cluster:m2", "web cluster:m3",
           "api-gateway", "batch", "job", "nothing-matches", "", "db namespace:kube-system")


@pytest.mark.parametrize("seed", range(3))
def test_inverted_index_equals_jax(seed):
    out = []
    for pkg in PKGS:
        be = mod(pkg, "search.backend").InvertedIndexBackend()
        pairs = seeded_objects(pkg, seed)
        for cluster, obj in pairs:
            be.upsert(cluster, obj)
        answers = [be.count()] + [plain(be.search(q)) for q in QUERIES]
        answers.append(plain(be.search("web", clusters=["m1", "m4"])))
        for cluster, obj in pairs[::4]:
            be.delete(cluster, f"{obj.api_version}/{obj.kind}", obj.meta.namespace,
                      obj.meta.name)
        be.drop_cluster("m0")
        answers += [be.count()] + [plain(be.search(q)) for q in QUERIES]
        out.append(answers)
    assert out[0] == out[1]
    assert out[1][0] > 0


@pytest.mark.parametrize("seed", range(3))
def test_cache_pages_equal_jax(seed):
    out = []
    for pkg in PKGS:
        reg = mod(pkg, "search.registry")
        cache = reg.MultiClusterCache()
        for cluster, obj in seeded_objects(pkg, seed):
            cache.put(cluster, obj)
        answers = []
        for gvk in GVKS:
            for namespace, labels, cluster in ((None, None, None), ("prod", None, None),
                                               (None, {"app": "web"}, None),
                                               (None, None, "m2")):
                for limit in (0, 1, 3, 7):
                    token, pages = "", []
                    while True:
                        items, token, rv = cache.list_paged(gvk, namespace, labels, limit,
                                                            token, cluster)
                        pages.append(([(c, plain(o)) for c, o in items], token,
                                      reg.decode_token(rv), reg.decode_token(token)))
                        if not token or len(pages) > 100:
                            break
                    answers.append(pages)
            answers.append([(c, plain(o)) for c, o in cache.list(gvk)])
            first = cache.list(gvk)
            if first:
                _, obj = first[0]
                answers.append(plain(cache.get(gvk, obj.meta.namespace, obj.meta.name)))
        cache.drop_cluster("m1")
        answers.append([(c, plain(o)) for gvk in GVKS for c, o in cache.list(gvk)])
        out.append(answers)
    assert out[0] == out[1]


@pytest.mark.parametrize("seed", range(3))
def test_opensearch_documents_equal_jax(seed):
    out = []
    for pkg in PKGS:
        os_mod = mod(pkg, "search.opensearch")
        docs = []
        for cluster, obj in seeded_objects(pkg, seed):
            doc = os_mod.resource_to_doc(cluster, obj)
            back_cluster, back = os_mod.doc_to_resource(doc)
            docs.append((os_mod.index_name(obj.kind), os_mod.doc_id(cluster, obj), doc,
                         back_cluster, plain(back)))
        out.append(docs)
    assert out[0] == out[1]
