from .callbacks import Callback, JSONLogger, ModelCheckpoint
from .trainer import Trainer

__all__ = ["Callback", "JSONLogger", "ModelCheckpoint", "Trainer"]
