from repro_torch.train.optim import AdamW, AdamState, apply_updates, warmup_cosine  # noqa: F401
from repro_torch.train.step import make_loss_fn, make_train_step, softmax_xent  # noqa: F401
