from repro_torch.data.synthetic import (
    DATASET_PRESETS,
    AttributedDataset,
    QueryWorkload,
    make_composite_workload,
    make_dataset,
    make_label_workload,
    make_preset,
    make_range_workload,
)

__all__ = [
    "DATASET_PRESETS",
    "AttributedDataset",
    "QueryWorkload",
    "make_composite_workload",
    "make_dataset",
    "make_label_workload",
    "make_preset",
    "make_range_workload",
]
