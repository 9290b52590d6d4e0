"""Tracking frontend, PnP, bundle adjustment and the SLAM system."""
