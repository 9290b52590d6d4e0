"""Tracking frontend, PnP, bundle adjustment, the SLAM system and loop
closing (bag of words, pose graph, online chunks)."""
