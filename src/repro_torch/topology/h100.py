"""Rates of one NVIDIA H100 SXM5 (700 W), the card the port runs on:
what ``launch.roofline`` divides a lowered cell's counts by."""

# HBM3 bandwidth, bytes/s: NVIDIA's H100 Tensor Core GPU datasheet (SXM5),
# 3.35 TB/s -- the rate PERF.md's kernel bounds use.
HBM_BW = 3.35e12

# Peak FLOP/s by the product's dtype (HLO's names), the same datasheet:
# bf16 and fp16 dense tensor-core 989.4 TFLOP/s (1,979 with sparsity,
# halved); f32 outside the tensor cores 67 TFLOP/s -- the rate PERF.md's
# kernel bounds use.
PEAK_FLOPS = {"bf16": 989.4e12, "f16": 989.4e12, "f32": 67e12}

# NVLink 4 bandwidth, bytes/s each way: the datasheet's 900 GB/s per GPU
# is summed over both directions.
NVLINK_BW = 450e9
