"""Learned models of the port: the ViT frontend (backbone, selector,
refiner, uncertainty head, offset head) and the semantic segmenter."""
