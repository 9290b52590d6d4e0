"""Drives: how a traffic mix hands its world to the port inside the
measured window. A traffic file names its drive; each drive module has
``WITH_SLAM`` (whether its outputs include poses), ``warm(program,
world)`` and ``window(program, world, seconds, tracer, rng)``, which
returns a ``harness.run.WindowResult``."""
