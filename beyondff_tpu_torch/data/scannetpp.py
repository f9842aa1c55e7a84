"""ScanNet++ benchmark metadata (reference: evaluation/dataset/scannetpp.py)."""

from beyondff_tpu_torch.data._tables import load_split, load_table

_T = load_table("scannetpp")

SEMANTIC_CAT_SCANNET_PP = tuple(_T["SEMANTIC_CAT_SCANNET_PP"])
INSTANCE_CAT_SCANNET_PP = tuple(_T["INSTANCE_CAT_SCANNET_PP"])


def val_scenes() -> tuple:
    return load_split("scannetpp_val")


def train_scenes() -> tuple:
    return load_split("scannetpp_train")
