"""Training substrate of the port: AdamW with its schedule, and the train
step with microbatching and the planner's gradient-bucket order."""

from .optim import OptConfig, adamw_init, adamw_update, lr_at  # noqa: F401
from .step import (TrainState, build_train_step,  # noqa: F401
                   init_params, init_train_state, loss_for)
