"""Engine registry, length bucketing, plan cache and batch dispatch of the
port."""
