"""Host references of the division semantics: constants and the numpy divider."""

from .divider import (  # noqa: F401
    AGGREGATED,
    DUPLICATED,
    DYNAMIC_WEIGHT,
    MAX_INT32,
    STATIC_WEIGHT,
    STRATEGY_NAMES,
)
from .divider_np import assign_batch_np  # noqa: F401
