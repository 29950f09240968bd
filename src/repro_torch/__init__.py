"""PyTorch/CUDA port of the DropPEFT reproduction (``src/repro`` is the JAX
reference).  Its first slice is multi-tenant LoRA serving: ``api.serve``.

The package imports ``torch`` and numpy only, never JAX or the JAX package.
"""
