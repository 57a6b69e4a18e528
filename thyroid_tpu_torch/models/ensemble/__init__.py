from .cnn_ensemble import (  # noqa: F401  (registers cnn_ensemble)
    DEFAULT_MODEL_ACCURACIES, CNNEnsemble, build_cnn_ensemble,
    build_ensemble_from_members,
)
