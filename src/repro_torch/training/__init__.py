"""Training: AdamW over the parameter tree, the train step over every
family's ``loss_fn``, the bigram data pipeline and npz checkpoints, with the
JAX package's semantics (``src/repro/training``)."""
from repro_torch.training.optimizer import AdamWState, adamw_init, adamw_update
from repro_torch.training.train_step import make_train_step

__all__ = ["AdamWState", "adamw_init", "adamw_update", "make_train_step"]
