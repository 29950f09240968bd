"""Partition specs of the port's parameter, PEFT and cache trees, as
``repro.sharding``, and their DTensor placements."""
from repro_torch.sharding.specs import (
    PartitionSpec,
    batch_spec,
    cache_specs,
    param_specs,
    peft_specs,
    to_shardings,
)

__all__ = ["PartitionSpec", "param_specs", "peft_specs", "cache_specs", "batch_spec", "to_shardings"]
