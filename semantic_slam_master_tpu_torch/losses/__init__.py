"""Self-supervised training losses."""
