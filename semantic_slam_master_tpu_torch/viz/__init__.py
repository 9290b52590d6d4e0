"""Plots of the port (port of ``viz/``): trajectories, the acceptance
suite's dashboard, the saliency dashboard and match plots. Every module
imports ``matplotlib`` inside the function that draws, so importing them
needs none."""

from . import matches, saliency, trajectory

__all__ = ["matches", "saliency", "trajectory"]
