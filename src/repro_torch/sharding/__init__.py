from repro_torch.sharding.partition import (
    DEFAULT_RULES,
    Partitioner,
    partition_spec,
)

__all__ = ["DEFAULT_RULES", "Partitioner", "partition_spec"]
