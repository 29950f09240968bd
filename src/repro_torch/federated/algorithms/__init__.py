"""Registered federated algorithms (one subclass per paper method), as
``repro.federated.algorithms``.

Importing this package populates the registry, in the reference's order,
so ``repro_torch.api.list_methods()`` equals ``repro.api.list_methods()``.
"""
from repro_torch.federated.algorithms.base import (
    FederatedAlgorithm,
    get_algorithm,
    register,
    registered_methods,
)
from repro_torch.federated.algorithms.baselines import FedAdapter, FedAdaOPT, FedHetLoRA, FedLoRA
from repro_torch.federated.algorithms.droppeft import (
    DropPEFT,
    DropPEFTFixedRate,
    DropPEFTNoPTLS,
    DropPEFTNoSTLD,
)

__all__ = [
    "FederatedAlgorithm",
    "register",
    "get_algorithm",
    "registered_methods",
    "FedLoRA",
    "FedAdapter",
    "FedHetLoRA",
    "FedAdaOPT",
    "DropPEFT",
    "DropPEFTNoSTLD",
    "DropPEFTFixedRate",
    "DropPEFTNoPTLS",
]
