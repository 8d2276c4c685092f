"""Cluster resource modeling: grade-bucket capacity estimation.

Counterpart of ``karmada_tpu.models``. Ref: pkg/modeling/modeling.go (node
bucketing into resource-model grades) and the model-based estimation path
of pkg/estimator/client/general.go:198-249. The grade boundaries pack into
``[C, G, R]`` arrays (``pack_models``) and the whole fleet estimates in one
launch of the hand-written kernel K7 (``model_overlay``), over the engine's
profile table.
"""

from .modeling import (  # noqa: F401
    ModelPack,
    estimate_by_models,
    estimate_by_models_np,
    model_overlay,
    model_overlay_ref,
    pack_models,
)
