"""Training substrate on PyTorch: optimizer, loop, data pipeline,
checkpointing. ``data.py`` imports no framework and is a word-for-word
copy of the JAX package's; the loop runs on the card unless the caller
asks for the CPU."""
from .checkpoint import restore_checkpoint, save_checkpoint
from .data import DataConfig, PrefetchLoader, SyntheticTokenStream
from .optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_update,
    global_norm,
    init_adamw,
    lr_schedule,
)
from .train_loop import TrainConfig, make_train_step, train
