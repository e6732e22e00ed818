"""The package's user-facing demos, the JAX package's ``examples/`` on
PyTorch. Each runs on the card unless given ``--device cpu``:

  python -m repro_torch.examples.quickstart
  python -m repro_torch.examples.kv_fetch_serving
  python -m repro_torch.examples.model_switching
  python -m repro_torch.examples.train_small [--steps 150]
"""
