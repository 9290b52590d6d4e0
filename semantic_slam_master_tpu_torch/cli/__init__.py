"""Command-line entry points: ``run-slam`` and ``evaluate``.

Invoked as ``python -m semantic_slam_master_tpu_torch <command>``.
"""
