"""Utilities: Lie groups, rigid fits and RANSAC, profiling, logging."""
