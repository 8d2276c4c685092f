"""karmada_tpu_torch — the PyTorch/CUDA port of karmada_tpu.

The scheduler's Filter/Score/Select/AssignReplicas hot path of
``karmada_tpu`` rebuilt on PyTorch, with hand-written CUDA kernels for
the device programs on its path. The JAX package stays the reference:
every module here sits at the same relative path as its counterpart there
and is held placement-identical to it by the ``tests/test_torch_*.py``
suite. The port imports neither jax nor anything of ``karmada_tpu``; the
jax-free modules it needs are its own copies.

Layer map:

- :mod:`karmada_tpu_torch.api`       — typed data model subset
- :mod:`karmada_tpu_torch.utils`     — quantities, feature gate, builders
- :mod:`karmada_tpu_torch.ops`       — estimate and division: plain torch
                                       functions plus the K1/K2 kernels
                                       (K1 with its table and merge forms)
- :mod:`karmada_tpu_torch.refimpl`   — the numpy host divider
- :mod:`karmada_tpu_torch.scheduler` — snapshot packing, ``TensorScheduler``
                                       (the fleet path and the host general
                                       path) and the fleet table with its
                                       K3-K6 kernels
- :mod:`karmada_tpu_torch.models`    — resource-model grades: packing, the
                                       plain estimate and the K7 kernel
- :mod:`karmada_tpu_torch.estimator` — the node-level accurate estimator,
                                       its registry and the K8 kernel
- :mod:`karmada_tpu_torch.parallel`  — the fused single-device step
- :mod:`karmada_tpu_torch.native`    — nvcc build and ctypes loading of
                                       ``csrc/*.cu``, and the g++-built
                                       host wire runtime (``fold.c``)

Every entry point that touches tensors takes ``device`` and defaults to
``"cuda"``; on CPU tensors the kernels' plain versions run instead.
"""

__version__ = "0.1.0"
