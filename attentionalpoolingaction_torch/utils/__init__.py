"""Utilities: metric writers and profiling."""
