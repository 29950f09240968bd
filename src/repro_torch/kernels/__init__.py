"""Hand-written CUDA kernels of the port (``csrc/``), their build, their
dispatcher (``ops``) and their plain PyTorch twins (``ref``)."""
