"""Federated substrate: partitioning, vmapped local training, FedAvg (plain,
robust, compressed), runtimes (fused multi-job + unfused baseline +
synthetic)."""

from repro_torch.fl.partition import iid_partition, noniid_partition
from repro_torch.fl.aggregation import (fedavg, fedavg_compressed,
                                        fedavg_compressed_loop)
from repro_torch.fl.runtime import (DEFAULT_B0, FLJobRuntime,
                                    FusedMultiRuntime, MultiRuntime,
                                    SyntheticRuntime, bucket_for,
                                    default_buckets)

__all__ = [
    "iid_partition",
    "noniid_partition",
    "fedavg",
    "fedavg_compressed",
    "fedavg_compressed_loop",
    "DEFAULT_B0",
    "FLJobRuntime",
    "FusedMultiRuntime",
    "MultiRuntime",
    "SyntheticRuntime",
    "bucket_for",
    "default_buckets",
]
