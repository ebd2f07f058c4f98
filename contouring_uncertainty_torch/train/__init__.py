"""Training runtime: train and eval steps, the epoch loop, early stopping
and checkpoints (counterpart of contouring_uncertainty_tpu/train)."""

from contouring_uncertainty_torch.train.trainer import Trainer, TrainerConfig
