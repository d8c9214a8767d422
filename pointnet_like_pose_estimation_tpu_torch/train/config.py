"""Typed training configuration (counterpart of ``train/config.py`` of the
JAX package, field for field, so that a ``config.json`` written by either
reads into both).

``dtype`` is the compute dtype of the Linear layers, ``"float32"`` or
``"bfloat16"``; parameters, optimizer state and BatchNorm stay float32.
``data_parallel`` trains over every rank of the process group (``train``),
which ``multihost`` forms from the ``torchrun`` environment.
``epoch_chunk`` has no effect in the port: it is the number of steps of one
TPU dispatch in the JAX package (a scan segment), and the port replays one
captured graph a step (``steps.EpochRunner``).
``device_data`` keeps the train split on the device (one upload, batches
gathered there); off, batches come from the host one by one.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TrainConfig:
    model: str = "pointnet_cls"
    num_classes: int = 7
    num_points: int = 1024
    batch_size: int = 24
    epochs: int = 100
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    optimizer: str = "adam"          # 'adam' | 'sgd'
    lr_step_epochs: int = 20         # StepLR step_size
    lr_gamma: float = 0.7            # StepLR gamma
    loss_kind: str = "L2_loss"       # pose heads: 'L2_loss' | 'L1_loss'
    loss_reduction: str = "mean"     # 'mean' | 'sum'
    seed: int = 0
    log_dir: str = "log"
    experiment: str = "default"
    dtype: str = "float32"           # compute dtype: 'float32' | 'bfloat16'
    augment: bool = True
    data_parallel: bool = False
    multihost: bool = False
    device_data: bool = True         # dataset resident on the device
    epoch_chunk: int = 256           # steps of one TPU dispatch; no effect in the port
    ckpt_every: int = 1
    # reference-compat quirk flags
    compat_first3_mean: bool = False  # mean of the first three points
    compat_pm1_bce: bool = False      # +-1 targets straight into BCE
    # transform the regression targets with the augmentation
    augment_consistent_labels: bool = False

    @classmethod
    def for_model(cls, model: str, **overrides) -> "TrainConfig":
        """Reference per-task defaults: pose heads train at lr 1e-4."""
        base = dict(model=model, learning_rate=1e-3 if "cls" in model else 1e-4)
        base.update(overrides)
        return cls(**base)
