"""Sweep orchestration: class x stage execution with checkpointed resume."""

from beyondff_tpu_torch.orchestration.sweep import (  # noqa: F401
    DEFAULT_SKIP,
    SweepRunner,
    default_class_list,
    host_partition,
    host_suffix,
    merge_host_results,
    resolve_hosts,
)
