from .dataset import Dataset, MASK_TRAIN, MASK_VAL, MASK_TEST, MASK_NONE
from .nts_format import (
    read_edge_binary,
    write_edge_binary,
    read_feature_table,
    read_label_table,
    read_mask_table,
    load_nts_dataset,
    load_from_config,
)
from .ogb import export_nts_format, load_ogb, load_ogb_dir
from .synthetic import (
    random_graph_dataset,
    powerlaw_graph_dataset,
    planted_community_dataset,
    reddit_like_dataset,
    calibrated_reddit_like_dataset,
)

__all__ = [
    "Dataset",
    "MASK_TRAIN",
    "MASK_VAL",
    "MASK_TEST",
    "MASK_NONE",
    "read_edge_binary",
    "write_edge_binary",
    "read_feature_table",
    "read_label_table",
    "read_mask_table",
    "load_nts_dataset",
    "load_from_config",
    "load_ogb",
    "load_ogb_dir",
    "export_nts_format",
    "random_graph_dataset",
    "powerlaw_graph_dataset",
    "planted_community_dataset",
    "reddit_like_dataset",
    "calibrated_reddit_like_dataset",
]
