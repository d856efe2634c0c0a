"""K2, the Myers bit-vector kernel, with its plain version and wrapper."""
