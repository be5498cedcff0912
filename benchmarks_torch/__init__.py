"""The paper's experiments and the service benchmarks on the PyTorch port
(``repro_torch``), one module per module of ``benchmarks/``."""
