"""K1: the wavefront DP fill kernel (CUDA) with its plain version."""
