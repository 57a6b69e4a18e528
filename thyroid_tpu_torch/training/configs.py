"""The repo's training configurations as dict literals (the port reads no
YAML: the card's machine has no PyYAML, and config composition is not
ported). Each is a copy of the file its comment names."""

# configs/training/vit.yaml
TRAINING_VIT = {
    "epochs": 100,
    "batch_size": 32,
    "loss": {"name": "cross_entropy", "label_smoothing": 0.1},
    "optimizer_params": {"name": "adamw", "lr": 1.0e-4, "weight_decay": 1.0e-5},
    "scheduler_params": {"name": "cosine", "eta_min": 1.0e-6,
                         "warmup_epochs": 10},
    "monitor_metric": "val_acc",
    "monitor_mode": "max",
    "early_stopping_patience": 15,
    "save_top_k": 3,
    "save_last": True,
    "layer_decay": 0.9,
    "ema_decay": None,
}

# configs/training/cnn.yaml
TRAINING_CNN = {
    "epochs": 100,
    "batch_size": 32,
    "loss": {"name": "cross_entropy", "label_smoothing": 0.0},
    "optimizer_params": {"name": "adamw", "lr": 1.0e-4, "weight_decay": 1.0e-5},
    "scheduler_params": {"name": "cosine", "eta_min": 0.0, "warmup_epochs": 5},
    "monitor_metric": "val_acc",
    "monitor_mode": "max",
    "early_stopping_patience": 10,
    "save_top_k": 3,
    "save_last": True,
    "layer_decay": None,
    "ema_decay": None,
}

# configs/model/cnn/efficientnet_b0.yaml
MODEL_EFFICIENTNET_B0 = {
    "name": "efficientnet_b0",
    "architecture": "cnn",
    "pretrained": False,
    "num_classes": 2,
    "in_channels": 1,
    "img_size": 224,
    "params": {"width_mult": 1.0, "depth_mult": 1.0, "dropout_rate": 0.2,
               "drop_path_rate": 0.2},
}

# configs/trainer/default.yaml
TRAINER_DEFAULT = {
    "max_epochs": 150,
    "min_epochs": 1,
    "max_steps": -1,
    "precision": "bf16",
    "deterministic": True,
    "gradient_clip_val": 1.0,
    "gradient_clip_algorithm": "norm",
    "accumulate_grad_batches": 1,
    "log_every_n_steps": 50,
    "check_val_every_n_epoch": 1,
    "limit_train_batches": 1.0,
    "limit_val_batches": 1.0,
    "enable_checkpointing": True,
    "enable_progress_bar": True,
    "mesh_shape": None,
    "data_axis": "data",
    "model_axis": None,
    "remat": False,
    "donate_state": True,
}

# configs/vit_optimizer_params.json: the optimizer of a ViT-family model
# whose training config names none
VIT_OPTIMIZER_PARAMS = {"lr": 0.0001, "weight_decay": 1e-05}
