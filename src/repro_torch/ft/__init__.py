from repro_torch.ft.elastic import (fold_windows, rebucketize_tasks,
                                    remesh_fleet, remesh_plan)
from repro_torch.ft.straggler import (ThroughputTracker, outer_rebalance,
                                      plan_next_segment, rebalance_hook,
                                      rebalance_tasks, replan_handle,
                                      tracker_from_result)
