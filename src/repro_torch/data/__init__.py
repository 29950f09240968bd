"""Data of the port, numpy only: the synthetic task, the Dirichlet device
partition and the per-device pipeline."""
