"""Data of the port, numpy only: the synthetic task, the Dirichlet device
partition and the per-device pipeline."""
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.pipeline import DeviceDataset
from repro_torch.data.synthetic import SyntheticTask, make_task

__all__ = ["dirichlet_partition", "SyntheticTask", "make_task", "DeviceDataset"]
