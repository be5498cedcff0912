"""Hand-written CUDA kernels for the QAP hot paths and their plain
PyTorch counterparts (``ops`` dispatches between them by device)."""
