"""Synthetic world, TUM trajectory IO and timestamp association (numpy)."""
