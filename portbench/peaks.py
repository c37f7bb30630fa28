"""Peak rates of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its
700 W limit): the highest published rate at which each kind of arithmetic
can be done at its stated precision, so that no implementation reads over
100% of them.  A run states the card's power limit beside every share."""

# float32: three TF32 tensor-core products stand for one float32 product
# (the split-operand scheme the port's panel tile uses), 495 / 3 TFLOP/s;
# above the 67 TFLOP/s of float32 FMAs outside the tensor cores
FP32_FLOPS = 495e12 / 3
# float64 on the tensor cores (DMMA); 34 TFLOP/s outside them
FP64_FLOPS = 67e12
# HBM3
HBM_BYTES = 3.35e12

PEAK_FLOPS = {"fp32": FP32_FLOPS, "fp64": FP64_FLOPS}
