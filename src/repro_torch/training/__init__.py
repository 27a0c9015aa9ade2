"""LM training on one device: optimizers, the train step, checkpoints and
the fault-tolerant loop (a port of the JAX package's ``training/``)."""
from repro_torch.training.optim import make_optimizer  # noqa: F401
from repro_torch.training.train_step import make_train_step, init_train_state  # noqa: F401
from repro_torch.training.checkpoint import CheckpointManager  # noqa: F401
from repro_torch.training.rematctx import use_remat, current_remat  # noqa: F401
