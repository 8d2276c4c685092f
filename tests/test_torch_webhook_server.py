"""The port's admission webhook server (``webhook/server.py``) against the
JAX package on the CPU.

- the cases of ``tests/test_webhook_https.py`` run whole on the port
  (``port_cases``): a mutation round-trips over TLS, a denial raises, an
  unreachable webhook fails closed, or open when asked;
- across the packages on one wire: a ``Store`` of either package with
  ``RemoteAdmission`` hooks against an ``AdmissionWebhookServer`` of
  either package (all four pairs), through one sequence of writes (valid
  and denied creates, updates, deletes): the same outcome for every write
  and, encoded by the bus codec, the same stored objects (their
  wall-clock stamps zeroed); each chain draws
  its permanent IDs, and each package its object uids, from one counter
  a run;
- the server as a process: ``python -m karmada_tpu_torch.webhook.server``
  admits the JAX package's ``RemoteAdmission`` writes (mutations come
  back, denials raise) and answers a ConversionReview as the JAX
  package's ``handle_conversion_review`` does.

Tolerance: exact equality."""

import itertools
import json
import re
import ssl
import sys
import types
import urllib.request
import uuid

import pytest

import karmada_tpu
from port_cases import cpu_plane, port_cases  # noqa: F401 (fixture)
from test_torch_controlplane import PKGS, mod

globals().update(port_cases("test_webhook_https"))


#: the fields the store and the object constructors stamp from the wall
#: clock, zeroed before the comparison
WALL_CLOCK = re.compile(r'"(creation_timestamp|last_transition_time)":[-+.e0-9]+')


def writes(pkg) -> list:
    """(operation, object) pairs of ``pkg``'s types: creates the chain
    mutates or denies, updates and deletes."""
    api = mod(pkg, "api")
    core = mod(pkg, "api.core")
    builders = mod(pkg, "utils.builders")

    def policy(name, **kw):
        return api.PropagationPolicy(
            meta=core.ObjectMeta(name=name, namespace="default"),
            spec=api.PropagationSpec(
                resource_selectors=[api.ResourceSelector(api_version="apps/v1",
                                                         kind="Deployment")],
                placement=builders.dynamic_weight_placement(), **kw))

    bad = api.Cluster(meta=core.ObjectMeta(name="Bad_Name!"),
                      spec=api.ClusterSpec(sync_mode="Push"))
    return [
        ("apply", policy("pp")),
        ("apply", policy("pp-prio", priority=5)),
        ("apply", builders.new_cluster("member1", cpu="100", memory="200Gi")),
        ("apply", builders.new_cluster("member2", cpu="8", memory="16Gi", region="eu")),
        ("apply", bad),
        ("apply", builders.new_deployment("web", replicas=3)),
        ("apply", builders.new_deployment("web", replicas=5)),
        ("apply", policy("pp")),
        ("delete", ("PropagationPolicy", "default/pp-prio")),
        ("delete", ("Cluster", "member2")),
    ]


def run_pair(client, server_pkg, tls_files, monkeypatch) -> tuple[list, list]:
    """The writes of ``client``'s package through a webhook server of
    ``server_pkg``: each write's outcome, then every stored object's
    canonical JSON."""
    for pkg in PKGS:
        counter = itertools.count(1)
        monkeypatch.setattr(mod(pkg, "webhook.chain"), "uuid", types.SimpleNamespace(
            uuid4=lambda c=counter: uuid.UUID(int=next(c))))
        monkeypatch.setattr(mod(pkg, "api.core"), "_uid_counter", itertools.count(1))
    server = mod(server_pkg, "webhook.server").AdmissionWebhookServer(
        certfile=str(tls_files / "srv.crt"), keyfile=str(tls_files / "srv.key"))
    url = server.start()
    try:
        remote = mod(client, "webhook.server").RemoteAdmission(
            url, ca_bundle=(tls_files / "srv.crt").read_bytes())
        store = mod(client, "utils").Store(admission=remote.admit,
                                           delete_admission=remote.admit_delete)
        outcomes = []
        for op, arg in writes(client):
            try:
                if op == "apply":
                    store.apply(arg)
                else:
                    store.delete(*arg)
                outcomes.append((op, "ok"))
            except Exception as exc:  # noqa: BLE001 — compared across packages
                outcomes.append((op, type(exc).__name__, str(exc)))
    finally:
        server.stop()
    encode = mod(client, "bus.service").encode_object
    stored = sorted(WALL_CLOCK.sub(r'"\1":0', encode(o))
                    for kind in store.kinds() for o in store.list(kind))
    return outcomes, stored


def test_remote_admission_across_the_packages(tls_files, monkeypatch):
    runs = {(c.__name__, s.__name__): run_pair(c, s, tls_files, monkeypatch)
            for c in PKGS for s in PKGS}
    want = runs[("karmada_tpu", "karmada_tpu")]
    assert any(o[1] != "ok" for o in want[0]), "no write was denied"
    for pair, got in runs.items():
        assert got == want, pair


def test_webhook_process_serves_the_jax_client(tls_files):
    from karmada_tpu.api.versioning import HUB_VERSION, handle_conversion_review
    from karmada_tpu.utils import Store
    from karmada_tpu.webhook.chain import PERMANENT_ID_ANNOTATION
    from karmada_tpu.webhook.server import RemoteAdmission
    from karmada_tpu_torch.localup import scrape_line, spawn_child

    proc = spawn_child([sys.executable, "-m", "karmada_tpu_torch.webhook.server",
                        "--address", "127.0.0.1:0",
                        "--certfile", str(tls_files / "srv.crt"),
                        "--keyfile", str(tls_files / "srv.key")], device="cpu")
    try:
        port = scrape_line(proc, r"listening on port (\d+)")
        ca = (tls_files / "srv.crt").read_bytes()
        remote = RemoteAdmission(f"https://127.0.0.1:{port}/admit", ca_bundle=ca,
                                 timeout_seconds=60)
        store = Store(admission=remote.admit, delete_admission=remote.admit_delete)
        policy, bad = writes(karmada_tpu)[0][1], writes(karmada_tpu)[4][1]
        store.apply(policy)
        assert PERMANENT_ID_ANNOTATION in store.get(
            "PropagationPolicy", "default/pp").meta.annotations
        with pytest.raises(ValueError):
            store.apply(bad)
        assert store.get("Cluster", "Bad_Name!") is None
        store.delete("PropagationPolicy", "default/pp")
        review = {"apiVersion": "apiextensions.k8s.io/v1", "kind": "ConversionReview",
                  "request": {"uid": "u", "desiredAPIVersion": HUB_VERSION, "objects": [{
                      "apiVersion": "work.karmada.io/v1alpha1", "kind": "ResourceBinding",
                      "meta": {"name": "a", "namespace": "default"},
                      "spec": {"resource": {"kind": "Deployment", "name": "a",
                                            "replicas": 3}}}]}}
        req = urllib.request.Request(f"https://127.0.0.1:{port}/convert",
                                     data=json.dumps(review).encode(),
                                     headers={"Content-Type": "application/json"})
        ctx = ssl.create_default_context(cadata=ca.decode())
        with urllib.request.urlopen(req, timeout=60, context=ctx) as r:
            assert json.loads(r.read()) == handle_conversion_review(review)
    finally:
        proc.terminate()
        proc.wait(timeout=10)

