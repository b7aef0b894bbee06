"""What the benchmark measures with: peaks, FLOP counts, roofline bounds,
trace reduction, kernel names and the comparisons that decide ``correct``."""
