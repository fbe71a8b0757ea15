"""Driver loop of the port: ``Trainer``, ``TrainerConfig``, ``RunResult``."""

from repro_torch.engine.trainer import RunResult, Trainer, TrainerConfig

__all__ = ["RunResult", "Trainer", "TrainerConfig"]
