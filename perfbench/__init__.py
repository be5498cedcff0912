"""The benchmark of the PyTorch/CUDA port (``repro_torch``): the mapping
service under a backlog of the paper's PSA solves.  ``run.py`` is the
command; ``BENCHMARK.json`` at the root of the checkout names the cells."""
