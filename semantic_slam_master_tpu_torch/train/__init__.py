"""Training-side pieces the port needs for inference: the ``model:``
section of the training configuration and ``build_model``."""
