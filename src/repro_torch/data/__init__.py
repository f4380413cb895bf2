from repro_torch.data.corpus import (imbalance_repeats, lm_token_stream,
                                     synth_corpus, zipf_skew_repeats,
                                     zipf_tokens)
from repro_torch.data.feed import FeedBudget, FeedStats, Segment, SegmentFeed
from repro_torch.data.source import (ArraySource, ConcatSource, DataSource,
                                     MmapTokenSource, ZipfSource, as_source,
                                     read_all)
