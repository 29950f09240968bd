"""PyTorch/CUDA port of the DropPEFT reproduction (``src/repro`` is the JAX
reference): multi-tenant LoRA serving (``api.serve``), and federated
fine-tuning with DropPEFT and its baselines (``api.build``,
``api.experiment``, ``api.replicate``).

The package imports ``torch`` and numpy only, never JAX or the JAX package.
"""
