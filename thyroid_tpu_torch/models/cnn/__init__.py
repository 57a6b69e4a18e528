from . import efficientnet  # noqa: F401  (registers the EfficientNet family)
