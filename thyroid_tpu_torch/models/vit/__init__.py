from . import deit, swin, vit  # noqa: F401  (register the ViT, DeiT and Swin families)
