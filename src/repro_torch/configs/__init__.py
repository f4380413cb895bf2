"""Architecture configs of the port. ``get_config(arch_id)`` resolves the
exact public config, ``get_smoke_config(arch_id)`` a reduced variant of
the same family for CPU tests; ``ARCH_IDS`` lists the archs the port
runs."""
from repro_torch.configs.registry import (ARCH_IDS, get_config,
                                          get_smoke_config)
