"""S3DIS benchmark metadata (reference: evaluation/dataset/s3dis.py)."""

from beyondff_tpu_torch.data._tables import load_split, load_table

INSTANCE_CAT_S3DIS = tuple(load_table("s3dis")["INSTANCE_CAT_S3DIS"])


def split() -> tuple:
    return load_split("s3dis_split")


def full_split() -> tuple:
    return load_split("s3dis_full_split")
