from . import densenet, efficientnet, inception, resnet  # noqa: F401  (register the CNN families)
