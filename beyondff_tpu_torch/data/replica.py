"""Replica benchmark metadata (reference: evaluation/dataset/replica.py)."""

from beyondff_tpu_torch.data._tables import load_split, load_table

INSTANCE_CAT_REPLICA = tuple(load_table("replica")["INSTANCE_CAT_REPLICA"])


def scenes() -> tuple:
    return load_split("replica_8scenes")
