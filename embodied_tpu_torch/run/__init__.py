"""Run protocols. Only the single-host `train` script so far; train_eval,
eval_only, pretrain and parallel come in later slices."""

from .train import train
