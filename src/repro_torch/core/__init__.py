"""PEFT (LoRA) trees of the port."""
