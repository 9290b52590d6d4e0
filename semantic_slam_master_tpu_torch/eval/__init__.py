"""Trajectory evaluation (numpy)."""
