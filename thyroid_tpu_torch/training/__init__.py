"""Training of the port's models (counterpart of thyroid_tpu/training)."""
