from . import swin  # noqa: F401  (registers the Swin family)
