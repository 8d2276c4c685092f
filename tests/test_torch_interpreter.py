"""The port's resource interpreter and override functions against the JAX
package's, on seeded resources.

``karmada_tpu_torch.interpreter.default_interpreter()`` against a JAX
``ResourceInterpreter`` holding ``register_native_interpreters``, on
resources of every gvk the native interpreters name (made from a seed with
numpy, the same in both packages): replicas and requirements, revise
replica (and the template-delta ``revise_patch``), retain against an
observed member object, reflect status, aggregate status over seeded member
items, health and dependencies. Then the override manager's JSON patch,
image edits and ``apply_overriders`` (plaintext, image, command, args,
labels, annotations and field overriders) on seeded documents. Tolerance:
exact equality."""

import copy
import dataclasses
import importlib

import numpy as np
import pytest

import karmada_tpu
import karmada_tpu.controllers.overridemanager  # noqa: F401
import karmada_tpu.interpreter  # noqa: F401
import karmada_tpu_torch
import karmada_tpu_torch.controllers.overridemanager  # noqa: F401
import karmada_tpu_torch.interpreter  # noqa: F401

PKGS = (karmada_tpu, karmada_tpu_torch)
SEEDS = range(6)

#: every gvk ``register_native_interpreters`` names
GVKS = (
    "apps/v1/Deployment", "apps/v1/StatefulSet", "apps/v1/DaemonSet", "batch/v1/Job",
    "v1/Pod", "v1/Service", "networking.k8s.io/v1/Ingress", "v1/PersistentVolumeClaim",
    "policy/v1/PodDisruptionBudget", "autoscaling/v2/HorizontalPodAutoscaler",
    "batch/v1/CronJob", "v1/ConfigMap",
)


def mod(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.{name}")


def interpreters():
    """(JAX native-only interpreter, the port's default_interpreter())."""
    jax_facade = mod(karmada_tpu, "interpreter.facade")
    jax = jax_facade.ResourceInterpreter()
    mod(karmada_tpu, "interpreter.native").register_native_interpreters(jax)
    return jax, mod(karmada_tpu_torch, "interpreter").default_interpreter()


def plain(x):
    """Dataclasses to (type name, fields) trees, for cross-package equality."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    return x


def resource_doc(rng, gvk: str) -> dict:
    """A seeded resource of ``gvk`` as plain data: apiVersion, kind, name,
    labels, spec and status."""
    api_version, kind = gvk.rsplit("/", 1)
    containers = []
    for c in range(int(rng.integers(1, 4))):
        ctr = {"name": f"c{c}", "image": f"docker.io/lib/app{c}:1.{c}"}
        if rng.random() < 0.8:
            ctr["resources"] = {"requests": {
                "cpu": f"{int(rng.integers(1, 4000))}m",
                "memory": f"{int(rng.integers(1, 64))}{rng.choice(['Mi', 'Gi'])}"}}
        if rng.random() < 0.5:
            ctr["env"] = [{"name": "A", "valueFrom": {"configMapKeyRef": {"name": f"cm{c}"}}},
                          {"name": "B", "valueFrom": {"secretKeyRef": {"name": f"s{c}"}}}]
        if rng.random() < 0.5:
            ctr["envFrom"] = [{"configMapRef": {"name": "shared"}},
                              {"secretRef": {"name": f"s{c}"}}]
        containers.append(ctr)
    pod_spec = {"containers": containers}
    if rng.random() < 0.5:
        pod_spec["nodeSelector"] = {"disk": str(rng.choice(["ssd", "hdd"]))}
    if rng.random() < 0.4:
        pod_spec["tolerations"] = [{"key": "k", "operator": "Exists"}]
    if rng.random() < 0.5:
        pod_spec["priorityClassName"] = "high"
    if rng.random() < 0.7:
        pod_spec["volumes"] = [{"configMap": {"name": "shared"}},
                               {"secret": {"secretName": "tls"}},
                               {"persistentVolumeClaim": {"claimName": "data"}}]
    if rng.random() < 0.6:
        pod_spec["serviceAccountName"] = str(rng.choice(["default", "runner"]))
    replicas = int(rng.integers(0, 50))
    spec: dict = {}
    status: dict = {}
    if kind in ("Deployment", "StatefulSet", "DaemonSet"):
        spec = {"replicas": replicas, "template": {"spec": pod_spec}}
        status = {"readyReplicas": int(rng.integers(0, replicas + 2)),
                  "updatedReplicas": int(rng.integers(0, replicas + 2))}
    elif kind == "Job":
        spec = {"template": {"spec": pod_spec}}
        if rng.random() < 0.6:
            spec["parallelism"] = replicas
        if rng.random() < 0.5:
            spec["completions"] = int(rng.integers(1, 100))
        status = {"failed": int(rng.integers(0, 2)), "active": 1}
    elif kind == "Pod":
        spec = dict(pod_spec)
        status = {"phase": str(rng.choice(["Pending", "Running", "Succeeded", "Failed"]))}
    elif kind == "Service":
        spec = {"type": str(rng.choice(["ClusterIP", "LoadBalancer"])), "ports": [{"port": 80}]}
    elif kind == "HorizontalPodAutoscaler":
        spec = {"minReplicas": 1, "maxReplicas": replicas + 1}
    elif kind == "CronJob":
        spec = {"schedule": "*/5 * * * *", "jobTemplate": {"spec": {"template": {"spec": pod_spec}}}}
    elif kind == "ConfigMap":
        spec = {"data": {"k": "v"}}
    if rng.random() < 0.3:
        status = {}
    labels = {"app": "x"}
    if rng.random() < 0.3:
        labels["resourcetemplate.karmada.io/retain-replicas"] = "true"
    return {"api_version": api_version, "kind": kind, "name": f"{kind.lower()}-obj",
            "labels": labels, "spec": spec, "status": status}


def observed_doc(rng, doc: dict) -> dict:
    """The member's copy of ``doc``, with the fields the member owns."""
    spec = dict(doc["spec"])
    if rng.random() < 0.7:
        spec["nodeName"] = "node-3"
    if rng.random() < 0.7:
        spec["clusterIP"] = "10.0.0.7"
    if rng.random() < 0.7:
        spec["replicas"] = int(rng.integers(0, 40))
    return dict(doc, spec=spec, status={"observed": True})


def member_status(rng, kind: str, cluster: str) -> dict | None:
    if rng.random() < 0.15:
        return None
    if kind == "Service" or kind == "Ingress":
        ing = [{"ip": f"1.2.3.{int(rng.integers(0, 9))}"} for _ in range(int(rng.integers(0, 3)))]
        if ing and rng.random() < 0.5:
            ing[0]["hostname"] = "lb.example.com"
        return {"loadBalancer": {"ingress": ing}}
    if kind == "Pod":
        st = {"phase": str(rng.choice(["Pending", "Running", "Succeeded", "Failed"]))}
        st["containerStatuses"] = [{"ready": bool(rng.random() < 0.5), "state": {"running": {}}}]
        if rng.random() < 0.5:
            st["initContainerStatuses"] = [{"ready": True, "state": {}}]
        return st
    if kind == "PersistentVolumeClaim":
        return {"phase": str(rng.choice(["Bound", "Pending", "Lost"]))}
    if kind == "PodDisruptionBudget":
        return {"currentHealthy": int(rng.integers(0, 5)), "desiredHealthy": 2,
                "expectedPods": 5, "disruptionsAllowed": int(rng.integers(0, 2)),
                "disruptedPods": {"p1": "2024-01-01T00:00:00Z"} if rng.random() < 0.5 else {}}
    if kind == "CronJob":
        fmt = ["2024-05-0{}T10:00:00Z", "2024-05-0{}T10:00:00+00:00",
               "2024-05-0{}T10:00:00.5Z", "not-a-time-{}"]
        return {"active": [{"name": f"job-{cluster}"}],
                "lastScheduleTime": str(rng.choice(fmt)).format(int(rng.integers(1, 9))),
                "lastSuccessfulTime": str(rng.choice(fmt)).format(int(rng.integers(1, 9)))}
    counters = ("replicas", "readyReplicas", "updatedReplicas", "availableReplicas",
                "unavailableReplicas", "currentNumberScheduled", "numberReady",
                "numberAvailable", "desiredNumberScheduled", "active", "succeeded", "failed",
                "currentReplicas", "desiredReplicas")
    return {c: int(rng.integers(0, 9)) for c in counters if rng.random() < 0.8}


def build(pkg, doc: dict):
    core = mod(pkg, "api.core")
    return core.Resource(api_version=doc["api_version"], kind=doc["kind"],
                         meta=core.ObjectMeta(name=doc["name"], namespace="default",
                                              labels=dict(doc["labels"])),
                         spec=copy.deepcopy(doc["spec"]), status=copy.deepcopy(doc["status"]))


def items(pkg, docs: list):
    work = mod(pkg, "api.work")
    return [work.AggregatedStatusItem(cluster_name=c, status=copy.deepcopy(st), applied=True,
                                      health=h) for c, st, h in docs]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("gvk", GVKS)
def test_native_interpreter_equals_jax(gvk, seed):
    jax, port = interpreters()
    rng = np.random.default_rng(seed)
    doc = resource_doc(rng, gvk)
    observed = observed_doc(rng, doc)
    kind = doc["kind"]
    statuses = [(f"m{k}", member_status(rng, kind, f"m{k}"), "Healthy")
                for k in range(int(rng.integers(0, 5)))]
    reps = int(rng.integers(0, 30))
    out = []
    for pkg, interp in zip(PKGS, (jax, port)):
        obj = build(pkg, doc)
        res = {
            "hooks": [interp.hook_enabled(gvk, op) for op in
                      ("GetReplicas", "ReviseReplica", "Retain", "AggregateStatus",
                       "GetDependencies", "ReflectStatus", "InterpretHealth")],
            "replicas": plain(interp.get_replicas(obj)),
            "revise": plain(interp.revise_replica(obj, reps)),
            "revise_patch": interp.revise_patch(obj, reps),
            "retain": plain(interp.retain(obj, build(pkg, observed))),
            "reflect": interp.reflect_status(obj),
            "aggregate": plain(interp.aggregate_status(obj, items(pkg, statuses))),
            "health": interp.interpret_health(obj),
            "dependencies": plain(interp.get_dependencies(obj)),
            # the template stays as it was
            "template": plain(obj),
        }
        out.append(res)
    assert out[0] == out[1]
    assert out[1]["template"] == plain(build(karmada_tpu_torch, doc))


# --------------------------------------------------------------------------
# the override manager's patch and image functions
# --------------------------------------------------------------------------

IMAGES = ("nginx", "nginx:1.25", "docker.io/nginx:1.25", "localhost:5000/team/app:v2",
          "registry.eu.example.com/a/b/c@sha256:abc", "quay.io/org/img", "host:99/img:t",
          "team/app", "app@sha256:ff")


@pytest.mark.parametrize("image", IMAGES)
def test_image_split_join_equal_jax(image):
    out = []
    for pkg in PKGS:
        om = mod(pkg, "controllers.overridemanager")
        parts = om._split_image(image)
        out.append((parts, om._join_image(*parts),
                    [om._edit(parts[1], op, "x") for op in ("replace", "add", "remove")]))
    assert out[0] == out[1]
    assert out[1][1] == image


def patch_doc(rng) -> dict:
    return {"spec": {"replicas": int(rng.integers(1, 9)), "list": list(range(4)),
                     "nested": {"a": {"b": 1}}},
            "metadata": {"labels": {"x": "1"}, "annotations": {}}}


@pytest.mark.parametrize("seed", SEEDS)
def test_json_patch_equal_jax(seed):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(12):
        op = str(rng.choice(["add", "replace", "remove"]))
        path = str(rng.choice(["/spec/replicas", "/spec/list/1", "/spec/list/-",
                               "/spec/nested/a/c", "/spec/new/deep/leaf",
                               "/metadata/labels/y", "/spec/list/0"]))
        if op == "remove" and path.endswith("/-"):
            path = "/spec/list/0"
        ops.append((op, path, int(rng.integers(0, 100))))
    out = []
    for pkg in PKGS:
        om = mod(pkg, "controllers.overridemanager")
        doc = patch_doc(np.random.default_rng(seed))
        log = []
        for op, path, value in ops:
            try:
                om.apply_json_patch(doc, op, path, value)
                log.append("ok")
            except (IndexError, ValueError, KeyError, TypeError) as e:
                log.append(type(e).__name__)
        out.append((doc, log))
    assert out[0] == out[1]


def overriders(pkg, rng, pod_spec: str):
    pol = mod(pkg, "api.policy")
    comp = ("Registry", "Repository", "Tag")
    return pol.Overriders(
        plaintext=[pol.PlaintextOverrider(path=f"{pod_spec}/hostNetwork",
                                          operator="add", value=bool(rng.random() < 0.5)),
                   pol.PlaintextOverrider(path="/metadata/labels/tier", operator="replace",
                                          value="edge")],
        image_overrider=[pol.ImageOverrider(component=str(rng.choice(comp)),
                                            operator=str(rng.choice(["replace", "add",
                                                                     "remove"])),
                                            value=str(rng.choice(["mirror.io", "-dbg",
                                                                  "v9"])))
                         for _ in range(int(rng.integers(1, 3)))],
        command_overrider=[pol.CommandArgsOverrider(container_name=str(rng.choice(["c0", ""])),
                                                    operator="add", value=["--x", "--y"])],
        args_overrider=[pol.CommandArgsOverrider(container_name="c1", operator="remove",
                                                 value=["--v"])],
        labels_overrider=[pol.LabelAnnotationOverrider(operator="add", value={"a": "1"}),
                          pol.LabelAnnotationOverrider(operator="remove", value={"app": ""})],
        annotations_overrider=[pol.LabelAnnotationOverrider(operator="replace",
                                                            value={"note": "n"})],
        field_overrider=[
            pol.FieldOverrider(field_path=f"{pod_spec}/cfg", json=[
                pol.FieldPatchOperation(sub_path="/debug", operator="add", value=True),
                pol.FieldPatchOperation(sub_path="/level", operator="replace",
                                        value=int(rng.integers(0, 5)))]),
            pol.FieldOverrider(field_path=f"{pod_spec}/yml", yaml=[
                pol.FieldPatchOperation(sub_path="/host", operator="replace", value="h"),
                pol.FieldPatchOperation(sub_path="/port", operator="remove")]),
        ],
    )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("gvk", ("apps/v1/Deployment", "v1/Pod"))
def test_apply_overriders_equal_jax(gvk, seed):
    rng = np.random.default_rng(seed)
    doc = resource_doc(rng, gvk)
    target = doc["spec"] if doc["kind"] == "Pod" else doc["spec"]["template"]["spec"]
    target["cfg"] = '{"level": 1}'
    target["yml"] = "host: a\nport: 5432\n"
    for ctr in target["containers"]:
        ctr["args"] = ["--v", "--w"]
    out = []
    for pkg in PKGS:
        obj = build(pkg, doc)
        mod(pkg, "controllers.overridemanager").apply_overriders(
            obj, overriders(pkg, np.random.default_rng(seed + 100),
                            "/spec" if doc["kind"] == "Pod" else "/spec/template/spec"))
        out.append(plain(obj))
    assert out[0] == out[1]
    assert out[1] != plain(build(karmada_tpu_torch, doc))
