"""Workload profiles (paper Table 2) for trace generation."""
