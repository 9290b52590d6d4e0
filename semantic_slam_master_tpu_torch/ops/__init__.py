"""Image, FAST, ORB and matching operators (port of ``ops/``)."""
