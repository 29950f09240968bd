"""Multi-tenant LoRA serving of the port: adapter pools and the continuous batcher."""
