"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the
full 700 W): device memory at 3.35 TB/s, and f32 outside the tensor cores
at 67 TFLOP/s (also taken for the aligner's integer compares and adds)."""

BYTES_S = 3.35e12
OPS_S = 67e12
