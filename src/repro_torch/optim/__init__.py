"""AdamW and int8 gradient compression (counterpart of ``repro/optim``)."""
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     clip_by_global_norm, global_norm,
                                     lr_schedule)
from repro_torch.optim.compress import (compress_int8, decompress_int8,
                                        ef_compress, ef_compress_leaf,
                                        init_residuals)
