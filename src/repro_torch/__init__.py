"""PyTorch/CUDA port of the ``repro`` package (the JAX reference beside it).

Sub-package and module names mirror ``repro`` so a reader finds each
counterpart (``repro_torch/core/ring.py`` <-> ``repro/core/ring.py``). This
package imports ``torch`` and numpy only: never ``jax`` and nothing of
``repro``. Entry points run on the GPU unless the caller asks for
``device="cpu"``; nothing carries on on the CPU by itself.
"""
