"""Convert per-scene .ply point clouds to the (N, 6) xyz+rgb .npy layout the
pipeline consumes (reference: tools/utils/ply2npy.py; required preprocessing
per README.md:27). Pure numpy PLY parsing, no Open3D.

    python -m beyondff_tpu_torch.tools.ply2npy <ply_dir> <npy_dir>
"""

import argparse
import os

import numpy as np

from beyondff_tpu_torch.utils.ply import read_point_cloud_with_colors


def main(argv=None):
    ap = argparse.ArgumentParser(description="PLY point clouds -> (N, 6) .npy")
    ap.add_argument("ply_dir")
    ap.add_argument("npy_dir")
    args = ap.parse_args(argv)
    os.makedirs(args.npy_dir, exist_ok=True)
    files = sorted(f for f in os.listdir(args.ply_dir) if f.endswith(".ply"))
    for name in files:
        xyz, rgb = read_point_cloud_with_colors(os.path.join(args.ply_dir, name))
        out = np.concatenate([xyz, rgb], axis=1).astype(np.float64)
        np.save(os.path.join(args.npy_dir, name[:-4] + ".npy"), out)
        print(f"{name}: {out.shape}")
    print(f"converted {len(files)} scenes")


if __name__ == "__main__":
    main()
