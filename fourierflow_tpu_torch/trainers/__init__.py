from .callbacks import (Callback, JSONLogger, ModelCheckpoint, StochasticWeightAveraging,
                        WandbLogger)
from .trainer import Trainer

__all__ = ["Callback", "JSONLogger", "ModelCheckpoint", "StochasticWeightAveraging", "Trainer",
           "WandbLogger"]
