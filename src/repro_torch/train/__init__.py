"""The train step (counterpart of ``repro/train``)."""
from repro_torch.train.train_step import (TrainState, init_train_state,
                                          make_train_step, restore_state,
                                          state_tree)
