from . import efficientnet, resnet  # noqa: F401  (register the EfficientNet and ResNet families)
