"""Layers of the port: norms, rotary, linear (LoRA and adapter pools), MLP, attention."""
