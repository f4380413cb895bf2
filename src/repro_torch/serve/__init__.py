from repro_torch.serve.engine import (ServeEngine, make_serve_step,
                                      prefill_to_decode_cache)
