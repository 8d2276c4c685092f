"""The cases of a JAX package's test module, run on the port.

``port_cases(name, leave_out)`` compiles ``tests/<name>.py`` with every
``karmada_tpu`` module name pointed at ``karmada_tpu_torch`` and returns its
test classes, test functions and fixtures, for a ``tests/test_torch_*.py``
module to take into its namespace, where pytest collects them under that
module's name: each case makes the same calls on the port and asserts the
same answers that the JAX package's run of the module asserts.
``leave_out`` names the cases (``"Class.method"`` or ``"function"``) that
reach a part of the JAX package the port does not carry; the caller's
docstring says which and why. ``swaps`` are (old, new) text replacements
made after that, each of which must match: a module that runs the cases
across the packages points some names back at the JAX package with them
(a JAX process on the port's wire).

``cpu_plane`` is an autouse fixture for such a module: the port's
``ControlPlane`` is built on the CPU (its ``device`` default is the card),
as the JAX cases build theirs without naming a device."""

import importlib
import pathlib
import re
import types

import pytest

_PACKAGE = re.compile(r"\bkarmada_tpu\b(?!_torch)")


def port_cases(name: str, leave_out=(), swaps=()) -> dict:
    path = pathlib.Path(__file__).with_name(f"{name}.py")
    source = _PACKAGE.sub("karmada_tpu_torch", path.read_text())
    for old, new in swaps:
        if old not in source:
            raise ValueError(f"{name}: {old!r} not found")
        source = source.replace(old, new)
    module = types.ModuleType(f"{name}_on_the_port")
    module.__file__ = str(path)
    exec(compile(source, str(path), "exec"), module.__dict__)
    for case in leave_out:
        owner, _, attr = case.rpartition(".")
        delattr(getattr(module, owner) if owner else module, attr)
    return {
        key: value
        for key, value in vars(module).items()
        if key.startswith(("Test", "test_")) or _is_fixture(value)
    }


def _is_fixture(value) -> bool:
    return (type(value).__name__ == "FixtureFunctionDefinition"
            or hasattr(value, "_pytestfixturefunction"))


@pytest.fixture(autouse=True)
def cpu_plane(monkeypatch):
    controlplane = importlib.import_module("karmada_tpu_torch.controlplane")
    monkeypatch.setitem(controlplane.ControlPlane.__init__.__kwdefaults__, "device", "cpu")
