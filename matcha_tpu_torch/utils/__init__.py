"""Profiling, timing and plotting helpers."""
