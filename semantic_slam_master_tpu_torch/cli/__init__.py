"""Command-line entry points: ``run-slam``, ``evaluate``, ``run-tests`` and
``associate``.

Invoked as ``python -m semantic_slam_master_tpu_torch <command>``.
"""
