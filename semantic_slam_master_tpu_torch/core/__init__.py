"""Core math: Lie groups, cameras, fixed-shape helpers, precision, devices."""
