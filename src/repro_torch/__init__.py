"""PyTorch/CUDA port of the decoupled MapReduce engine (``repro``).

The P ranks of the reference's ``shard_map`` mesh are a leading tensor
dimension on one device: every engine tensor is ``(P, ...)``. The Job API
mirrors ``repro.core``::

    from repro_torch.core import JobConfig, WordCount, submit
    res = submit(JobConfig(WordCount(vocab=262_144), task_size=256,
                           push_cap=64, fused_map=True), source).result()

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
