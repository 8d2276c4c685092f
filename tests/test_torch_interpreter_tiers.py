"""The port's interpreter tiers against the JAX package on the CPU.

The facade's customized, webhook, thirdparty and native tiers
(``interpreter/facade.py``), the expression VM (``interpreter/exprlang.py``),
the declarative customizations and their configuration manager
(``interpreter/declarative.py``), the embedded third-party corpus
(``interpreter/thirdparty.py``), the interpreter webhooks
(``interpreter/webhook.py``), the binding controller's full-render fallback
for a custom ReviseReplica and the admission chain's validators of the
interpreter configurations:

- the cases of ``tests/test_thirdparty_corpus.py``, ``tests/test_exprlang.py``,
  ``tests/test_interpreter_custom.py`` and ``tests/test_interpreter_webhook.py``
  run on the port (``port_cases``): the same calls, the same asserted
  answers (the webhook's TLS case makes its certificate with ``openssl``);
- every operation of each of the 16 third-party kinds on seeded objects (made
  with numpy, the same in both packages), through each package's
  ``default_interpreter()``, the CloneSet of the tiers' missing registration
  among them;
- the tiers' order, the kind wildcard, ``has_custom_revise``,
  ``revise_patch`` and the webhook tier's stale-owner guard, by the same
  registrations in both packages;
- scripts' answers and ``ScriptError`` messages of both packages' VMs;
- both admission chains' verdicts and messages on interpreter
  configurations;
- a plane through ``run_both`` (``tests/test_torch_controlplane.py``): a
  CloneSet, a kind under a ResourceInterpreterCustomization whose scripts
  give its replicas and revise them (deriving ``spec.shards`` from the count)
  and a kind served by an ``InterpreterWebhookServer``, propagated, reported
  and rescaled; then ``chip_smoke.plane_interpret_waves``' waves on config 4
  at 300 templates x 40 clusters. After every settle the two planes' states
  are equal.

Tolerance: exact equality."""

import copy

import numpy as np
import pytest

import chip_smoke
import karmada_tpu
import karmada_tpu.interpreter.thirdparty  # noqa: F401
import karmada_tpu_torch
from port_cases import cpu_plane, port_cases  # noqa: F401 (fixture)
from test_torch_autoscaling import config4_plane
from test_torch_controlplane import (  # noqa: F401 (fixture)
    PKGS,
    _one_torch_thread,
    mod,
    run_both,
)
from test_torch_interpreter import items as status_items
from test_torch_interpreter import plain, resource_doc

globals().update(port_cases("test_thirdparty_corpus"))
globals().update(port_cases("test_exprlang"))
globals().update(port_cases("test_interpreter_custom"))
globals().update(port_cases("test_interpreter_webhook"))

CORPUS = karmada_tpu.interpreter.thirdparty.THIRDPARTY_CUSTOMIZATIONS
OPERATIONS = ("GetReplicas", "ReviseReplica", "Retain", "AggregateStatus",
              "GetDependencies", "ReflectStatus", "InterpretHealth")
SEEDS = range(4)


def outcome(fn, *args):
    """``fn(*args)`` as plain data, or the exception's type name and
    message."""
    try:
        return "ok", plain(fn(*args))
    except Exception as exc:  # noqa: BLE001 (compared across packages)
        return "raises", type(exc).__name__, str(exc)


# --------------------------------------------------------------------------
# the embedded corpus, every kind and operation, on seeded objects
# --------------------------------------------------------------------------

CONDITION_REASONS = ("Succeeded", "ReconciliationSucceeded", "ChartPullSucceeded", "Failed")
SOURCE_KINDS = ("GitRepository", "HelmRepository", "HelmChart", "OCIRepository", "Bucket",
                "Unlisted")


def set_path(obj: dict, path: str, value) -> None:
    parts = path.split(".")
    for part in parts[:-1]:
        obj = obj.setdefault(part, {})
    obj[parts[-1]] = value


def health_paths(preds) -> list:
    out = []
    for pred in preds:
        out += health_paths(pred.get("any", []))
        out += [pred[k] for k in ("path", "status_path") if k in pred]
    return out


def status_value(rng, field: str, generation: int):
    leaf = field.rsplit(".", 1)[-1]
    if leaf == "conditions":
        return [{"type": str(rng.choice(["Ready", "Reconciling"])),
                 "status": str(rng.choice(["True", "False"])),
                 "reason": str(rng.choice(CONDITION_REASONS))}
                for _ in range(int(rng.integers(0, 3)))]
    if leaf in ("observedGeneration", "generation"):
        return int(generation + rng.integers(-1, 2))
    if leaf == "phase":
        return str(rng.choice(["Pending", "Running", "Succeeded", "Failed", "Error", ""]))
    if leaf == "state":
        return str(rng.choice(["CREATED", "RECONCILING", "RUNNING", "FINISHED", "SUSPENDED",
                               "CANCELED", "FAILED"]))
    if leaf == "jobStatus":
        return {"state": status_value(rng, "state", generation), "jobName": "job"}
    if leaf == "jobManagerDeploymentStatus":
        return str(rng.choice(["READY", "ERROR", "DEPLOYING"]))
    if leaf == "ready":
        return bool(rng.random() < 0.5)
    if leaf in ("artifact", "inventory", "helmChart", "autogen"):
        return {"entries": int(rng.integers(0, 3))}
    if leaf.endswith(("Revision", "Hash", "Selector", "url", "State", "error", "type",
                      "At", "Time", "progress")):
        return f"{leaf}-{int(rng.integers(0, 3))}"
    return int(rng.integers(0, 4))


def seeded_status(rng, rules, generation: int) -> dict:
    fields = ({p for p in rules.status_paths if not p.startswith("meta.")}
              | set(rules.status_aggregation) | set(rules.status_zero_fields)
              | set(health_paths(rules.health)))
    status: dict = {}
    for field in sorted(fields, key=lambda f: (f.count("."), f)):
        if rng.random() < 0.85:
            set_path(status, field, status_value(rng, field, generation))
    return status


def pod_template(rng) -> dict:
    template = resource_doc(rng, "apps/v1/Deployment")["spec"]["template"]
    template["metadata"] = {"labels": {"app": str(rng.choice(["a", "b"]))}}
    return template


def thirdparty_doc(rng, gvk: str) -> dict:
    """A seeded object of a corpus kind as plain data: every field its rules
    read (replica path, pod templates, retained paths, references and
    reference lists, the status fields its health, reflection and
    aggregation read), each left out at times."""
    rules = CORPUS[gvk]
    generation = int(rng.integers(1, 6))
    spec: dict = {}
    if rules.replica_path:
        r = rng.random()
        if r < 0.75:
            set_path(spec, rules.replica_path, int(rng.integers(0, 41)))
        elif r < 0.85:
            set_path(spec, rules.replica_path, "50%")
    paths = [rules.pod_requests_path] + [d["pod_template_path"] for d in rules.dependencies
                                         if d.get("pod_template_path")]
    for path in filter(None, paths):
        if rng.random() < 0.9:
            set_path(spec, path, pod_template(rng))
    for path in rules.retain_paths:
        if rng.random() < 0.7:
            set_path(spec, path, bool(rng.random() < 0.5) if path == "suspend"
                     else {"tier": str(rng.choice(["x", "y"]))})
    for dep in rules.dependencies:
        if dep.get("name_path") and rng.random() < 0.8:
            set_path(spec, dep["name_path"], f"src{int(rng.integers(0, 3))}")
        if dep.get("namespace_path") and rng.random() < 0.5:
            set_path(spec, dep["namespace_path"], "flux-system")
        if dep.get("kind_path") and rng.random() < 0.8:
            set_path(spec, dep["kind_path"], str(rng.choice(SOURCE_KINDS)))
        if dep.get("list_path"):
            entries = [{"name": f"v{j}", "kind": str(rng.choice(["ConfigMap", "Secret"]))}
                       for j in range(int(rng.integers(0, 3)))]
            if rng.random() < 0.3:
                entries += ["not-a-ref", {"kind": "Secret"}]
            set_path(spec, dep["list_path"], entries)
    api_version, kind = gvk.rsplit("/", 1)
    return {"api_version": api_version, "kind": kind, "name": f"{kind.lower()}-obj",
            "generation": generation, "labels": {"app": "x"}, "spec": spec,
            "status": seeded_status(rng, rules, generation)}


def build(pkg, doc: dict):
    core = mod(pkg, "api.core")
    return core.Resource(api_version=doc["api_version"], kind=doc["kind"],
                         meta=core.ObjectMeta(name=doc["name"], namespace="default",
                                              labels=dict(doc["labels"]),
                                              generation=doc["generation"]),
                         spec=copy.deepcopy(doc["spec"]), status=copy.deepcopy(doc["status"]))


def interpret_all(pkg, doc, observed, items, reps) -> dict:
    """Every operation of ``pkg``'s ``default_interpreter()`` on ``doc``."""
    interp = mod(pkg, "interpreter").default_interpreter()
    gvk = f"{doc['api_version']}/{doc['kind']}"
    obj = build(pkg, doc)
    out = {
        "hooks": [interp.hook_enabled(gvk, op) for op in OPERATIONS],
        "custom_revise": interp.has_custom_revise(gvk),
        "replicas": outcome(interp.get_replicas, obj),
        "revise": outcome(interp.revise_replica, obj, reps),
        "revise_patch": outcome(interp.revise_patch, obj, reps),
        "retain": outcome(interp.retain, obj, build(pkg, observed)),
        "reflect": outcome(interp.reflect_status, obj),
        "aggregate": outcome(interp.aggregate_status, obj, status_items(pkg, items)),
        "health": outcome(interp.interpret_health, obj),
        "dependencies": outcome(interp.get_dependencies, obj),
    }
    out["template"] = plain(obj)  # the template stays as it was
    return out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("gvk", sorted(CORPUS))
def test_thirdparty_kind_equals_jax(gvk, seed):
    rng = np.random.default_rng(seed)
    doc = thirdparty_doc(rng, gvk)
    observed = thirdparty_doc(rng, gvk)
    observed["name"] = doc["name"]
    items = []
    for k in range(int(rng.integers(0, 4))):
        st = seeded_status(rng, CORPUS[gvk], doc["generation"])
        st["generation"] = int(rng.integers(1, 6))
        items.append((f"m{k}", st if rng.random() < 0.9 else None,
                      str(rng.choice(["Healthy", "Unhealthy"]))))
    reps = int(rng.integers(0, 30))
    jax, port = (interpret_all(pkg, doc, observed, items, reps) for pkg in PKGS)
    assert port == jax
    assert port["hooks"] != [False] * len(OPERATIONS)
    assert port["template"] == plain(build(karmada_tpu_torch, doc))


def test_corpus_kinds_equal_jax():
    port = mod(karmada_tpu_torch, "interpreter.thirdparty").THIRDPARTY_CUSTOMIZATIONS
    assert len(CORPUS) == 16
    assert {gvk: plain(rules) for gvk, rules in port.items()} == {
        gvk: plain(rules) for gvk, rules in CORPUS.items()}


def test_cloneset_five_replicas_one_cpu_equals_jax():
    """A CloneSet of 5 replicas of 1 cpu: 5 replicas of 1000 milli-cpu and
    unhealthy (no status yet) through both packages' default interpreters."""
    out = []
    for pkg in PKGS:
        core = mod(pkg, "api.core")
        obj = core.Resource(
            api_version="apps.kruise.io/v1alpha1", kind="CloneSet",
            meta=core.ObjectMeta(name="cs", namespace="default", generation=1),
            spec={"replicas": 5, "template": {"spec": {"containers": [
                {"name": "app", "resources": {"requests": {"cpu": "1"}}}]}}})
        interp = mod(pkg, "interpreter").default_interpreter()
        replicas, reqs = interp.get_replicas(obj)
        out.append((replicas, plain(reqs), interp.interpret_health(obj)))
    assert out[0] == out[1]
    assert out[1][0] == 5 and out[1][1][1]["resource_request"] == {"cpu": 1000}
    assert out[1][2] is False


# --------------------------------------------------------------------------
# the tiers' order
# --------------------------------------------------------------------------


def tier_walk(pkg) -> list:
    """The same registrations on a bare facade of ``pkg``, each step's
    resolution recorded: native, thirdparty, webhook and customized handlers
    for one kind and the wildcard, removed again from the top; a stale
    webhook owner's deregistration; ``has_custom_revise`` and
    ``revise_patch`` at each step."""
    facade = mod(pkg, "interpreter.facade")
    core = mod(pkg, "api.core")
    interp = facade.ResourceInterpreter()
    gvk = "example.io/v1/Widget"
    obj = core.Resource(api_version="example.io/v1", kind="Widget",
                        meta=core.ObjectMeta(name="w", namespace="default"),
                        spec={"replicas": 3})
    seen = []

    def look(tag):
        seen.append((tag, interp.get_replicas(obj), interp.has_custom_revise(gvk),
                     interp.revise_patch(obj, 7), interp.hook_enabled(gvk, "Retain"),
                     interp.hook_enabled("other.io/v1/Thing", "GetReplicas")))

    def answer(n):
        return lambda o: (n, None)

    def revise(o, n):
        return o

    look("empty")
    interp.register_native("*", "GetReplicas", answer(1))
    interp.register_native(gvk, "ReviseReplica", revise)
    look("native")
    interp.register_thirdparty("*", "GetReplicas", answer(2))
    look("thirdparty wildcard")
    interp.register_thirdparty(gvk, "ReviseReplica", revise)
    look("thirdparty revise")
    first, second = answer(3), answer(4)
    interp.register_webhook(gvk, "GetReplicas", first)
    look("webhook")
    interp.register_webhook(gvk, "GetReplicas", second)
    interp.deregister_webhook(gvk, "GetReplicas", first)  # a stale owner
    look("webhook stale owner")
    interp.register_customized("*", "GetReplicas", answer(5))
    interp.register_customized(gvk, "Retain", lambda d, o: d)
    look("customized wildcard")
    interp.deregister_customized("*", "GetReplicas")
    look("customized gone")
    interp.deregister_webhook(gvk, "GetReplicas")
    look("webhook gone")
    return seen


def test_tier_order_equals_jax():
    jax, port = (tier_walk(pkg) for pkg in PKGS)
    assert port == jax
    answers = [step[1][0] for step in port]
    assert answers == [0, 1, 2, 2, 3, 4, 5, 4, 2]
    assert [step[3] for step in port][:3] == [{}, {"replicas": 7}, {"replicas": 7}]
    assert all(step[3] is None for step in port[3:])


# --------------------------------------------------------------------------
# the expression VM: answers and ScriptError messages
# --------------------------------------------------------------------------

SCRIPTS = [
    # (source, function, arguments)
    ("import os", "f", ()),
    ("def f():\n    return open('/etc/passwd')", "f", ()),
    ("def f():\n    return ().__class__", "f", ()),
    ("x = lambda: 1", "f", ()),
    ("def f():\n    exec('1')", "f", ()),
    ("def f(*a):\n    return a", "f", ()),
    ("def f(:\n    return 1", "f", ()),
    ("def f():\n    x = 0\n    while True:\n        x = x + 1\n    return x", "f", ()),
    ("def f():\n    s = 'x' * 1000\n    for i in range(40):\n        s = s + s\n", "f", ()),
    ("def f():\n    l = [1] * 1000\n    for i in range(40):\n        l.extend(l)\n", "f", ()),
    ("def f():\n    s = 'a' * 100000\n    return s.replace('a', s)\n", "f", ()),
    ("def f():\n    l = [1] * 100000\n    return sum([l] * 200, [])\n", "f", ()),
    ("def f():\n    return '%999999999d' % 1\n", "f", ()),
    ("def f():\n    return '%*d' % (1000000000, 1)\n", "f", ()),
    ("def f():\n    return 'id-%05d of 100000' % 7\n", "f", ()),
    ("def f():\n    return 10 ** 100000\n", "f", ()),
    ("def f():\n    return 1 / 0\n", "f", ()),
    ("def f():\n    return [1, 2][5]\n", "f", ()),
    ("def f():\n    return undefined_name\n", "f", ()),
    ("def f():\n    return math.floor(2.5) + math.ceil(2.5)\n", "f", ()),
    ("def f():\n    return math.pi\n", "f", ()),
    ("def f():\n    return kube.nothing\n", "f", ()),
    ("def f():\n    x = 3\n    return x()\n", "f", ()),
    ("def f():\n    a, b = [1, 2, 3]\n", "f", ()),
    ("def g():\n    return 1\n", "f", ()),
    ("def f(obj):\n    if obj.spec.missing.deeply.nested == None:\n        return 1\n"
     "    return 2\n", "f", ({"spec": {}},)),
    ("def f(obj):\n    return obj.spec.replicas + obj['spec']['replicas']\n", "f",
     ({"spec": {"replicas": 4}},)),
    ("def f(obj):\n    return [c.name for c in obj.spec.containers if c.name != 'b']\n", "f",
     ({"spec": {"containers": [{"name": "a"}, {"name": "b"}, {"name": "c"}]}},)),
    ("def f(obj):\n    return kube.getResourceQuantity(obj.q) + kube.getResourceQuantity('1Gi')\n",
     "f", ({"q": "250m"},)),
    ("def f(t):\n    return kube.accuratePodRequirements(t)\n", "f",
     ({"spec": {"containers": [{"resources": {"requests": {"cpu": "1", "memory": "1Gi"}}}]}},)),
    ("def f(t):\n    return kube.getPodDependencies(t, 'ns')\n", "f",
     ({"spec": {"volumes": [{"configMap": {"name": "c"}}, {"secret": {"secretName": "s"}}],
                "serviceAccountName": "sa"}},)),
    ("def f(d):\n    out = {}\n    for k in sorted(d):\n        if d[k] > 1:\n"
     "            continue\n        out[k] = d[k] * 2\n    return out\n", "f",
     ({"a": 1, "b": 2, "c": 0},)),
    ("def f(n):\n    i = 0\n    while i < n:\n        i += 1\n        if i == 5:\n"
     "            break\n    return i, str(i), float(i), int('7'), abs(-i), min(i, 2)\n",
     "f", (9,)),
]


def vm_outcome(pkg, source, name, args):
    exprlang = mod(pkg, "interpreter.exprlang")

    def run():
        vm = exprlang.ExprVM(source)
        return vm.has(name), vm.call(name, *copy.deepcopy(args))

    return outcome(run)


@pytest.mark.parametrize("case", range(len(SCRIPTS)))
def test_script_outcomes_equal_jax(case):
    source, name, args = SCRIPTS[case]
    jax, port = (vm_outcome(pkg, source, name, args) for pkg in PKGS)
    assert port == jax
    if port[0] == "raises":
        assert port[1] == "ScriptError"


@pytest.mark.parametrize("script", ["CLONESET_AGGREGATE", "FLINK_HEALTH", "FLINK_REPLICAS"])
def test_ported_reference_scripts_equal_jax(script):
    """The reference scripts of ``tests/test_exprlang.py`` on seeded inputs."""
    source = globals()["TestPortedScripts"].test_flink_health.__globals__[script]
    rng = np.random.default_rng(7)
    inputs = []
    for _ in range(20):
        desired = {"metadata": {"generation": int(rng.integers(1, 4)), "namespace": "flink"},
                   "spec": {"jobManager": {"resource": {"cpu": int(rng.integers(1, 4)),
                                                        "memory": "2048m"}},
                            "taskManager": {"resource": {"cpu": int(rng.integers(1, 4)),
                                                         "memory": "1Gi"}},
                            "job": {"parallelism": int(rng.integers(1, 9))},
                            "flinkConfiguration": {"taskmanager.numberOfTaskSlots": 2}},
                   "status": {"observedGeneration": int(rng.integers(0, 3)),
                              "jobStatus": {"state": str(rng.choice(["CREATED", "RUNNING"]))},
                              "jobManagerDeploymentStatus": str(rng.choice(["READY", "ERROR"]))}}
        items = [{"clusterName": f"m{k}", "status": {
            "replicas": int(rng.integers(0, 5)), "readyReplicas": int(rng.integers(0, 5)),
            "resourceTemplateGeneration": int(rng.integers(1, 4)),
            "generation": 2, "observedGeneration": int(rng.integers(1, 3)),
            "updateRevision": f"r{int(rng.integers(0, 3))}"}}
            for k in range(int(rng.integers(0, 4)))]
        inputs.append((desired, items))
    name, arity = {"CLONESET_AGGREGATE": ("AggregateStatus", 2),
                   "FLINK_HEALTH": ("InterpretHealth", 1),
                   "FLINK_REPLICAS": ("GetReplicas", 1)}[script]
    jax, port = ([vm_outcome(pkg, source, name, args[:arity]) for args in inputs]
                 for pkg in PKGS)
    assert port == jax
    assert all(o[0] == "ok" for o in port)


# --------------------------------------------------------------------------
# the admission chain on interpreter configurations
# --------------------------------------------------------------------------


def customization(pkg, **rules):
    decl = mod(pkg, "interpreter.declarative")
    target = rules.pop("target", ("example.io/v1", "Thing"))
    return decl.ResourceInterpreterCustomization(
        meta=mod(pkg, "api.core").ObjectMeta(name="c"), target_api_version=target[0],
        target_kind=target[1], rules=decl.CustomizationRules(**rules))


def webhook_config(pkg, hooks):
    hook = mod(pkg, "interpreter.webhook")
    return hook.ResourceInterpreterWebhookConfiguration(
        meta=mod(pkg, "api.core").ObjectMeta(name="w"), webhooks=[
            hook.InterpreterWebhook(
                name=name, client_config=hook.WebhookClientConfig(url=url),
                rules=[hook.RuleWithOperations(operations=ops, api_versions=versions,
                                               kinds=kinds)
                       for ops, versions, kinds in rules])
            for name, url, rules in hooks])


GOOD_RULE = (["InterpretReplica"], ["example.io/v1"], ["Thing"])
CONFIGS = {
    "customization ok": lambda p: customization(p, replica_path="replicas", health=[
        {"any": [{"path": "phase", "op": "in", "value": ["Running"]},
                 {"condition": "Ready"}]}, {"observed_generation": True}],
        status_aggregation={"ready": "sum", "phase": "last"}),
    "customization no target": lambda p: customization(p, target=("", "Thing")),
    "customization no kind": lambda p: customization(p, target=("v1", "")),
    "health without path": lambda p: customization(p, health=[{"op": "=="}]),
    "health bad op": lambda p: customization(p, health=[{"path": "x", "op": "~"}]),
    "nested health bad op": lambda p: customization(p, health=[
        {"any": [{"path": "x"}, {"any": [{"path": "y", "op": ">"}]}]}]),
    "bad aggregation": lambda p: customization(p, status_aggregation={"ready": "avg"}),
    "webhook ok": lambda p: webhook_config(p, [("a", "http://127.0.0.1:1/i", [GOOD_RULE]),
                                              ("b", "http://127.0.0.1:2/i",
                                               [(["*"], ["*"], ["*"])])]),
    "webhook no name": lambda p: webhook_config(p, [("", "http://x", [GOOD_RULE])]),
    "webhook duplicate": lambda p: webhook_config(p, [("a", "http://x", [GOOD_RULE]),
                                                     ("a", "http://y", [GOOD_RULE])]),
    "webhook no url": lambda p: webhook_config(p, [("a", "", [GOOD_RULE])]),
    "webhook no rules": lambda p: webhook_config(p, [("a", "http://x", [])]),
    "webhook bad operation": lambda p: webhook_config(p, [(
        "a", "http://x", [(["InterpretReplica", "Explode", "Boom"], ["v1"], ["Thing"])])]),
    "webhook rule without kinds": lambda p: webhook_config(p, [(
        "a", "http://x", [(["Retain"], ["v1"], [])])]),
}


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_configuration_admission_equals_jax(case):
    out = []
    for pkg in PKGS:
        store = mod(pkg, "utils").Store(admission=mod(pkg, "webhook").default_admission_chain()
                                        .admit)
        verdict = outcome(store.apply, CONFIGS[case](pkg))
        out.append(verdict[:1] if verdict[0] == "ok" else verdict)
    assert out[0] == out[1]
    assert (out[1][0] == "ok") == case.endswith("ok"), out[1]


# --------------------------------------------------------------------------
# the tiers on the plane, through run_both
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hooked_server():
    server = karmada_tpu_torch.interpreter.webhook.InterpreterWebhookServer(
        chip_smoke.hooked_handlers())
    server.start()
    yield server
    server.stop()


def interpret_bindings(cp) -> list:
    gvks = set(chip_smoke.INTERPRET_COUNT)
    return [rb for rb in chip_smoke.sorted_bindings(cp.store)
            if f"{rb.spec.resource.api_version}/{rb.spec.resource.kind}" in gvks]


def expected_bindings(cp, rbs) -> None:
    for rb in rbs:
        reps, req = chip_smoke.interpret_expected(
            cp.store.get("Resource", f"default/{rb.spec.resource.name}"))
        assert rb.spec.replicas == reps
        assert rb.spec.replica_requirements.resource_request == req


def interpret_scenario(url):
    def scenario(p, record):
        """A CloneSet, two objects of the customized kind and one of the
        webhook-served kind on three members under a dynamic-weight policy;
        the members report status; then every template rescales."""
        cp = p.make_plane(3)
        chip_smoke.install_interpret_apis(cp)
        objs = chip_smoke.interpret_objects(p.pkg, 2, 2, 1, url,
                                            placement=p.b.dynamic_weight_placement())
        cp.store.apply(objs["customization"])
        cp.store.apply(objs["webhook"])
        cp.settle()
        record(cp)
        cp.store.apply(objs["policy"])
        for t in (*objs["clonesets"], *objs["custom"], *objs["hooked"]):
            cp.store.apply(t)
        cp.settle()
        record(cp)
        rbs = interpret_bindings(cp)
        assert len(rbs) == 5 and all(rb.spec.clusters for rb in rbs)
        expected_bindings(cp, rbs)
        assert chip_smoke.interpret_members_check(cp, rbs) == 0
        shards = [o.spec["shards"] for n in sorted(cp.members.names())
                  for o in cp.members.get(n).list(chip_smoke.CUSTOM_GVK)]
        assert shards and all(shards)
        chip_smoke.interpret_report(cp)
        cp.settle()
        record(cp)
        assert chip_smoke.interpret_status_check(cp, interpret_bindings(cp)) == (0, 0)
        for t in list(cp.store.list("Resource")):
            field = chip_smoke.INTERPRET_COUNT.get(f"{t.api_version}/{t.kind}")
            if field:
                t.spec[field] += 3
                t.meta.generation += 1
                cp.store.apply(t)
        cp.settle()
        record(cp)
        rbs = interpret_bindings(cp)
        expected_bindings(cp, rbs)
        assert chip_smoke.interpret_members_check(cp, rbs) == 0

    return scenario


def test_interpreter_tiers_plane_equals_jax(monkeypatch, hooked_server):
    run_both(interpret_scenario(hooked_server.url), monkeypatch)


def config4_interpret_waves(url, caches):
    def scenario(p, record):
        """``chip_smoke.plane_interpret_waves``' waves on config 4 at 300
        templates x 40 clusters: 300 CloneSets, 60 customized and 10
        webhook-served objects (370 rows: the fleet route), their status
        round, a rescale of 20 customized templates and a ResourceRegistry
        over the CloneSets; each wave's checks on both planes."""
        cp = config4_plane(p)
        record(cp)
        chip_smoke.install_interpret_apis(cp)
        objs = chip_smoke.interpret_objects(p.pkg, 300, 60, 10, url)
        cp.store.apply(objs["customization"])
        cp.store.apply(objs["webhook"])
        cp.settle()
        record(cp)
        cp.store.apply(objs["policy"])
        for t in (*objs["clonesets"], *objs["custom"], *objs["hooked"]):
            cp.store.apply(t)
        cp.settle()
        record(cp)
        rbs = interpret_bindings(cp)
        assert len(rbs) == 370
        expected_bindings(cp, rbs)
        assert chip_smoke.interpret_members_check(cp, rbs) == 0
        chip_smoke.interpret_report(cp)
        cp.settle()
        record(cp)
        assert chip_smoke.interpret_status_check(cp, interpret_bindings(cp)) == (0, 0)
        moved = chip_smoke.interpret_scale(cp.store, chip_smoke.interpret_scale_picks(60, 20))
        cp.settle()
        record(cp)
        rbs = interpret_bindings(cp)
        assert {rb.meta.namespaced_name: rb.spec.replicas for rb in rbs
                if rb.meta.namespaced_name in moved} == moved
        assert chip_smoke.interpret_members_check(cp, rbs) == 0
        cp.store.apply(chip_smoke.registry_object(p.pkg))
        cp.settle()
        record(cp)
        bad, cached = chip_smoke.registry_check(cp)
        assert bad == 0 and cached > 300
        caches.append(sorted((c, o.meta.name, o.spec["replicas"])
                             for c, o in cp.search.cache.list(chip_smoke.CLONESET_GVK)))
        cp.store.delete("ResourceRegistry", "clonesets")
        cp.settle()
        record(cp)

    return scenario


def test_config4_interpret_waves_equal_jax_plane(monkeypatch, hooked_server):
    caches = []
    run_both(config4_interpret_waves(hooked_server.url, caches), monkeypatch)
    assert caches[0] == caches[1]
