"""Federated fine-tuning of the port: one client's local round, so far."""
