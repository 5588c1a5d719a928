from .runner import FTConfig, StragglerMonitor, TrainRunner  # noqa: F401
