from repro_torch.training.train_step import (cross_entropy,  # noqa: F401
                                             make_train_step)
from repro_torch.training.loop import TrainConfig, TrainLoop  # noqa: F401
