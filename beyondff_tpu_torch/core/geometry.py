"""Point-cloud <-> image geometry: projection, visibility, 2D->3D mask lifting.

The port's copy of beyondff_tpu/core/geometry.py. Frames are a batch
dimension of plain tensor ops (the JAX package's ``vmap``); the
world->camera transform and the pinhole intrinsics are pre-fused into one
(3, 4) matrix per frame in float64 on the host, and the per-point work
(project, round, depth test, mask lookup) runs on the frames' device.
``lift_frames*`` emit ``masked_counts`` and ``viewed_counts`` in the same
pass, as in the JAX package.

Semantics parity notes (reference: tools/projection_2d_to_3d.py:37-92):
  * pixel coords use round-half-to-even exactly like ``np.round``;
  * visibility = in-bounds AND depth!=0 AND |z_cam - depth| < thresh, with
    no explicit z>0 test, matching the reference;
  * the 4x4 pose inverse and intrinsic product are computed in float64 on the
    host; per-point math is float32.

Float32 rounding follows the JAX package on XLA:CPU, so pixel ids and the
depth test agree with it point for point: the (3, 4) x (4, N) projection is
a chain of fused multiply-adds over k = 0..3 (each product exact, one
rounding per step, as XLA's batched f32 dot rounds on the CPU), written as
float64 products and sums rounded to float32 at each step so that CPU and
CUDA give the same bits; no matmul is used, so TF32 cannot enter. The depth
resize takes ``jax.image.resize(..., "linear")``'s taps in one fixed
summation order (see :func:`prepare_depth`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from beyondff_tpu_torch.core import resize as _resize


def fuse_projection(cam_intr: np.ndarray, cam_pose: np.ndarray) -> np.ndarray:
    """Fuse intrinsics and world->camera extrinsics into one (3,4) matrix.

    ``P = K @ inv(pose)[:3]`` so that ``P @ [x,y,z,1]^T = [u*z, v*z, z]``.
    Row 2 of P recovers the camera-space depth z used by the visibility test.
    Computed in float64 (the reference keeps the whole pipeline in numpy
    doubles; only the 4x4 algebra is precision-critical).
    """
    cam_intr = np.asarray(cam_intr, dtype=np.float64)[:3, :3]
    cam_pose = np.asarray(cam_pose, dtype=np.float64)
    world2cam = np.linalg.inv(cam_pose)
    return (cam_intr @ world2cam[:3]).astype(np.float64)


def homogenize(points: np.ndarray) -> np.ndarray:
    """(N,3) xyz -> (4,N) homogeneous float32 (reference: projection_2d_to_3d.py:385-390)."""
    pts = np.asarray(points, dtype=np.float32)[:, :3]
    return np.concatenate([pts.T, np.ones((1, pts.shape[0]), np.float32)], axis=0)


# --------------------------------------------------------------------------
# device-side tensor code (frames batched along dim 0)
# --------------------------------------------------------------------------


def project_points(pcd_h: torch.Tensor, projs: torch.Tensor) -> torch.Tensor:
    """(4, N) f32 points, (F, 3, 4) f32 matrices -> (F, 3, N) f32 ``[u*z, v*z, z]``:
    acc = p0*x0, then acc = fma(p_k, x_k, acc) for k = 1, 2, 3."""
    x = pcd_h.double()
    p = projs.double()
    acc = (p[:, :, 0:1] * x[0]).float()
    for k in range(1, 4):
        acc = (acc.double() + p[:, :, k:k + 1] * x[k]).float()
    return acc


def project_and_test(
    pcd_h: torch.Tensor,  # (4, N) float32 homogeneous world points
    projs: torch.Tensor,  # (F, 3, 4) float32 fused projections
    depths: torch.Tensor,  # (F, H, W) float32 metric depth, 0 = invalid
    depth_thresh: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project points into F frames; return (pixel_id, visible).

    pixel_id: (F, N) int64 flattened v*W+u for visible points, -1 otherwise.
    visible:  (F, N) bool visibility mask.
    """
    f, h, w = depths.shape
    cam = project_points(pcd_h, projs)
    z = cam[:, 2]
    nz = z != 0
    inv_z = torch.where(nz, 1.0 / z, torch.zeros_like(z))
    u_f = cam[:, 0] * inv_z
    v_f = cam[:, 1] * inv_z
    finite = torch.isfinite(u_f) & torch.isfinite(v_f) & nz
    # round half to even, then clamp far-off values to just outside the frame
    # before the integer cast (in-bounds decisions are unchanged)
    u = torch.where(finite, torch.round(u_f).clamp(-2, w + 1), -2.0).long()
    v = torch.where(finite, torch.round(v_f).clamp(-2, h + 1), -2.0).long()
    inb = finite & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    flat = v.clamp(0, h - 1) * w + u.clamp(0, w - 1)
    d = torch.gather(depths.reshape(f, h * w), 1, flat)
    thresh = torch.tensor(depth_thresh, dtype=torch.float32, device=depths.device)
    visible = inb & (d != 0) & (torch.abs(z - d) < thresh)
    return torch.where(visible, flat, -1), visible


def prepare_depth(depth_u16: torch.Tensor, out_hw: Tuple[int, int],
                  depth_scale: float = 1000.0) -> torch.Tensor:
    """(F, h0, w0) raw uint16 depth -> (F, H, W) metric float32 on its device.

    Raw depth arrives as int16 or int32 bit patterns of uint16 (torch's
    uint16 support is thin). The bilinear resize (half-pixel convention)
    has ``jax.image.resize(..., "linear")``'s taps and weights, summed in
    the order XLA:CPU takes inside one GEMM block at ScanNet's 480x640 ->
    968x1296: the scale multiplies by the float32 reciprocal of
    ``depth_scale``, the width axis contracts first with fused
    multiply-adds, then the height axis with rounded products. XLA:CPU's
    own rounding changes with the shape (where its GEMM splits a
    contraction, and whether it fuses), so the two can differ by a few
    float32 ulps; the result is the same on every device here."""
    raw = depth_u16.to(torch.int32) & 0xFFFF
    metric = raw.float() * float(np.float32(1) / np.float32(depth_scale))
    f, h0, w0 = metric.shape
    h, w = out_hw
    if w != w0:
        metric = _resize.linear_axis(metric, w, 2, fused=True)
    if h != h0:
        metric = _resize.linear_axis(metric, h, 1, fused=False)
    return metric


def pack_masks(masks: np.ndarray) -> np.ndarray:
    """(M<=32, HW) bool -> (HW,) uint32 bitfield (bit m = mask m), on the host."""
    m = masks.shape[0]
    if m > 32:
        raise ValueError(f"pack_masks supports up to 32 masks, got {m}")
    out = np.zeros(masks.shape[1], np.uint32)
    for i in range(m):
        out |= masks[i].astype(np.uint32) << np.uint32(i)
    return out


def _counts(membership: torch.Tensor, vis: torch.Tensor):
    return membership.sum(dim=(0, 1)), vis.sum(dim=0)


def lift_frames_packed(
    pcd_h: torch.Tensor,  # (4, N)
    projs: torch.Tensor,  # (F, 3, 4)
    depths: torch.Tensor,  # (F, H, W)
    masks_packed: torch.Tensor,  # (F, H*W) int64 bitfields (bit m = mask m)
    depth_thresh: float = 0.08,
    n_masks: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bit-packed lift: one word gather per point recovers membership in up
    to 32 masks. Returns (membership (F, n_masks, N), masked_counts,
    viewed_counts)."""
    pid, vis = project_and_test(pcd_h, projs, depths, depth_thresh)
    words = torch.gather(masks_packed, 1, pid.clamp(min=0))
    words = torch.where(pid >= 0, words, torch.zeros_like(words))
    membership = torch.empty((pid.shape[0], n_masks, pid.shape[1]), dtype=torch.bool,
                             device=pid.device)
    for m in range(n_masks):
        membership[:, m] = ((words >> m) & 1) != 0
    return (membership, *_counts(membership, vis))


def rle_runs_to_packed(run_starts: torch.Tensor, run_ends: torch.Tensor, hw: int) -> torch.Tensor:
    """(F, M<=32, R) RLE run bounds -> (F, HW) int64 packed masks, on device.

    Interval decode as scatter + cumsum: +1 at each run start, -1 at each
    (half-open) end, prefix-sum along pixels; runs within a mask are
    disjoint, so the running value stays in {0, 1}. Pad runs use
    start = HW+1 (their end is rewritten to land with the start, so they
    cancel outside the pixel range). One mask at a time bounds the scratch
    to (F, HW+2)."""
    f, m, _ = run_starts.shape
    en = torch.where(run_starts > hw, hw + 1, run_ends).long()
    st = run_starts.clamp(0, hw + 1).long()
    packed = torch.zeros((f, hw), dtype=torch.int64, device=run_starts.device)
    ones = torch.ones(st.shape[0], st.shape[2], dtype=torch.int32, device=st.device)
    for j in range(m):
        delta = torch.zeros((f, hw + 2), dtype=torch.int32, device=st.device)
        delta.scatter_add_(1, st[:, j], ones)
        delta.scatter_add_(1, en[:, j], -ones)
        dense = torch.cumsum(delta, dim=1, dtype=torch.int32)[:, :hw] > 0
        packed |= dense.long() << j
    return packed


def lift_frames_rle(
    pcd_h: torch.Tensor,  # (4, N)
    projs: torch.Tensor,  # (F, 3, 4)
    depths: torch.Tensor,  # (F, H, W)
    run_starts: torch.Tensor,  # (F, M, R) int, 0-based, ascending; pad = HW+1
    run_ends: torch.Tensor,  # (F, M, R) int, half-open ends; pad = 0
    depth_thresh: float = 0.08,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Membership straight from RLE runs, never from an uploaded bitmap.

    Up to 32 masks per frame decode on device into packed words
    (:func:`rle_runs_to_packed`) and take one word gather per point. More
    masks binary-search every visible point's pixel id against each mask's
    runs: runs are disjoint and ascending, so a point is inside mask m iff
    ``starts[i] <= pid < ends[i]`` for ``i = searchsorted(starts, pid) - 1``;
    pad runs (start HW+1) are unreachable. Returns (membership (F, M, N),
    masked_counts, viewed_counts)."""
    f, m, _ = run_starts.shape
    hw = depths.shape[1] * depths.shape[2]
    if m <= 32:
        packed = rle_runs_to_packed(run_starts, run_ends, hw)
        return lift_frames_packed(pcd_h, projs, depths, packed, depth_thresh, n_masks=m)
    pid, vis = project_and_test(pcd_h, projs, depths, depth_thresh)
    pidc = pid.clamp(min=0)
    st = run_starts.long()
    en = run_ends.long()
    membership = torch.empty((f, m, pid.shape[1]), dtype=torch.bool, device=pid.device)
    for j in range(m):
        idx = torch.searchsorted(st[:, j].contiguous(), pidc, right=True) - 1
        end = torch.gather(en[:, j], 1, idx.clamp(min=0))
        membership[:, j] = (idx >= 0) & (pidc < end) & (pid >= 0)
    return (membership, *_counts(membership, vis))


def lift_frames(
    pcd_h: torch.Tensor,  # (4, N)
    projs: torch.Tensor,  # (F, 3, 4)
    depths: torch.Tensor,  # (F, H, W)
    masks: torch.Tensor,  # (F, M, H*W) bool, padded along M
    mask_valid: torch.Tensor,  # (F, M) bool padding flags
    depth_thresh: float = 0.08,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lift a chunk of frames' dense 2D masks onto the shared point cloud.

    Returns:
      membership: (F, M, N) bool point membership per (frame, mask)
      masked_counts: (N,) — number of (frame, mask) pairs covering each
        point (reference: projection_2d_to_3d.py:459-461)
      viewed_counts: (N,) — number of frames in which each point is
        visible (reference: projection_2d_to_3d.py:537-567)
    """
    pid, vis = project_and_test(pcd_h, projs, depths, depth_thresh)
    pidc = pid.clamp(min=0)
    f, m = mask_valid.shape
    membership = torch.empty((f, m, pid.shape[1]), dtype=torch.bool, device=pid.device)
    for j in range(m):
        member = torch.gather(masks[:, j], 1, pidc)
        membership[:, j] = member & (pid >= 0) & mask_valid[:, j:j + 1]
    return (membership, *_counts(membership, vis))


def view_counts(
    pcd_h: torch.Tensor,  # (4, N)
    projs: torch.Tensor,  # (F, 3, 4)
    depths: torch.Tensor,  # (F, H, W)
    depth_thresh: float = 0.08,
) -> torch.Tensor:
    """(N,) visibility counts for frames that carry no detections."""
    _, vis = project_and_test(pcd_h, projs, depths, depth_thresh)
    return vis.sum(dim=0)


# --------------------------------------------------------------------------
# host-side numpy oracle (float64) — used by tests and fixtures
# --------------------------------------------------------------------------


def lift_frame_np(
    pcd_h: np.ndarray,  # (4, N) float64
    cam_intr: np.ndarray,
    cam_pose: np.ndarray,
    depth: np.ndarray,  # (H, W) float
    masks: np.ndarray,  # (M, H, W) bool
    depth_thresh: float = 0.08,
) -> Tuple[np.ndarray, np.ndarray]:
    """Float64 reference semantics of one frame's lift. Returns (membership, visible)."""
    h, w = depth.shape
    pts_cam = (np.linalg.inv(np.asarray(cam_pose, np.float64)) @ np.asarray(pcd_h, np.float64)).T[:, :3]
    proj = np.asarray(cam_intr, np.float64)[:3, :3] @ pts_cam.T
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = np.round(proj[:2] / pts_cam[:, 2]).T
    finite = np.isfinite(uv).all(axis=1)
    uv_i = np.where(finite[:, None], uv, -1).astype(np.int64)
    inb = finite & (uv_i[:, 0] >= 0) & (uv_i[:, 0] < w) & (uv_i[:, 1] >= 0) & (uv_i[:, 1] < h)
    u = np.clip(uv_i[:, 0], 0, w - 1)
    v = np.clip(uv_i[:, 1], 0, h - 1)
    d = depth[v, u]
    visible = inb & (d != 0) & (np.abs(pts_cam[:, 2] - d) < depth_thresh)
    member = np.asarray(masks).astype(bool)[:, v, u] & visible[None, :]
    return member, visible
