from repro_torch.ckpt.checkpoint import (CheckpointManager, FleetCheckpoint,
                                         FleetStateError)
