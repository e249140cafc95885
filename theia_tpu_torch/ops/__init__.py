"""Device ops: sketches, the fused detector step, and the CUDA kernel
build (`_build`)."""
