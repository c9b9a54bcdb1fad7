"""Tracking models: the robust frame-to-frame solver and the sessions."""
