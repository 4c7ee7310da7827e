"""Traffic for the benchmark: seeded TS pools and the paced TS writer."""
