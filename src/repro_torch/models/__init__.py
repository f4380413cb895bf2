from repro_torch.models.transformer import (Model, decode_step, forward,
                                            init_cache, init_model, prefill)
