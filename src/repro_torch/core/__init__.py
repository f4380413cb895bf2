# The decoupled (one-sided) MapReduce engine behind the Job API, with the
# ranks as a leading tensor dim (counterpart of repro.core).
from repro_torch.core.job import (CombineOverflowError, JobConfig, JobHandle,
                                  JobResult, submit)
from repro_torch.core.partition import (HashPartitioner, Partitioner,
                                        SampledPartitioner,
                                        available_partitioners,
                                        resolve_partitioner)
from repro_torch.core.registry import (Backend, JobSpec, UnknownBackendError,
                                       available_backends, get_backend,
                                       register_backend)
from repro_torch.core.scheduler import (AdmissionQueueFull, FairSharePolicy,
                                        FifoPolicy, JobScheduler,
                                        PriorityPolicy, SchedulePolicy,
                                        TenantStats, available_policies,
                                        resolve_policy)
from repro_torch.core.usecase import UseCase, as_map_fn
from repro_torch.core.usecases import (Histogram, InvertedIndex, WordCount,
                                       histogram_oracle,
                                       inverted_index_oracle,
                                       wordcount_oracle)
