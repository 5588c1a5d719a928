from .checkpoint import (CheckpointManager, latest_step, restore,  # noqa: F401
                         save)
