"""Resource interpreter: pluggable semantics for arbitrary resource kinds.

The port's own copy of ``karmada_tpu/interpreter``. Ref:
pkg/resourceinterpreter/interpreter.go:39-143 — the interpreter operations,
registered as Python callables per (kind, operation) and resolved through a
chain of responsibility: user customizations (declarative rules and
expression scripts, ``declarative``), interpreter webhooks (``webhook``),
the embedded third-party corpus (``thirdparty``), then the native defaults
(``native``).
"""

from .facade import (  # noqa: F401
    AGGREGATE_STATUS,
    GET_DEPENDENCIES,
    GET_REPLICAS,
    INTERPRET_HEALTH,
    REFLECT_STATUS,
    RETAIN,
    REVISE_REPLICA,
    ResourceInterpreter,
)
from .native import register_native_interpreters  # noqa: F401
from .thirdparty import (  # noqa: F401
    THIRDPARTY_CUSTOMIZATIONS,
    register_thirdparty_interpreters,
)


def default_interpreter() -> ResourceInterpreter:
    interp = ResourceInterpreter()
    register_native_interpreters(interp)
    register_thirdparty_interpreters(interp)
    return interp
