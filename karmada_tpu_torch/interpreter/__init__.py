"""Resource interpreter: pluggable semantics for arbitrary resource kinds.

The port's own copy of ``karmada_tpu/interpreter``: the facade and the
native interpreters. Ref: pkg/resourceinterpreter/interpreter.go:39-143 —
the interpreter operations, registered as Python callables per (kind,
operation). The embedded third-party corpus, the declarative
customizations and the interpreter webhooks, the tiers that the JAX
package resolves ahead of the native one, are not ported yet.
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


def default_interpreter() -> ResourceInterpreter:
    interp = ResourceInterpreter()
    register_native_interpreters(interp)
    return interp
