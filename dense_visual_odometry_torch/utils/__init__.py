"""Utilities: Lie groups."""
