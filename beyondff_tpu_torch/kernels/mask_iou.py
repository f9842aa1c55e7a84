"""Pairwise IoU of boolean masks: the hand-written Hopper kernels and their
plain version.

Port of beyondff_tpu/kernels/mask_iou.py (``pairwise_iou_pallas`` and
``pad_and_iou``). (Ia, N) x (Ib, N) ``torch.bool`` masks -> (Ia, Ib) float32
``inter / (area_a + area_b - inter)``, 0/0 = nan. The masks may be views
whose rows lie further apart than N bytes (last dimension contiguous), as
:func:`aligned_rows` makes them. Rows on 16-byte boundaries (strides and
bases multiples of 16; :func:`wgmma_route`) are counted on int8 wgmma fed by
TMA (``csrc/mask_iou_wgmma.cu``, counted as ``mask_iou_wgmma``); every other
call on the int8 mma.sync kernel of ``csrc/mask_iou.cu`` (``mask_iou``),
which cuts rows at any address out of 16-byte loads, from the bool bytes as
they are. Counts are exact integers, so both kernels, the
plain version and the JAX package agree bit for bit. The wrapper launches a
kernel for CUDA tensors and raises on what they do not take; CPU tensors
take :func:`pairwise_iou_plain`.
"""

from __future__ import annotations

from typing import Optional

import torch

from beyondff_tpu_torch.kernels import dispatch

# bytes the main path rounds its row strides to. The wgmma kernel's tensor
# maps need only multiples of 16, but a row's 128-byte TMA boxes then fall
# on whole L2 lines (a stride of 16 mod 32 touches 5 sectors a box row
# instead of 4: 1.4x the time at 600 x 250 000, tools/kernel_variants.py on
# an H100 80GB HBM3 at 700 W)
ROW_PAD = 128


def aligned_rows(rows: int, n: int, device) -> torch.Tensor:
    """An uninitialised (rows, n) bool view of (rows, n rounded up to 128)
    storage: rows 128 bytes apart from an allocation's base (on the card a
    128-byte boundary), so the mask-IoU call takes the wgmma kernel."""
    stride = -(-max(n, 1) // ROW_PAD) * ROW_PAD
    return torch.empty(rows, stride, dtype=torch.bool, device=device)[:, :n]


def is_aligned(t: torch.Tensor) -> bool:
    """Whether a 2-D tensor is laid out as :func:`aligned_rows` lays masks
    out: contiguous rows a multiple of 128 bytes and at least N bytes apart,
    from a base on a 16-byte boundary (a one-row tensor needs only the
    base)."""
    return (t.dim() == 2 and (t.shape[1] <= 1 or t.stride(1) == 1)
            and (t.shape[0] <= 1 or (t.stride(0) % ROW_PAD == 0
                                     and t.stride(0) >= t.shape[1]))
            and t.data_ptr() % 16 == 0)


def wgmma_route(ia: int, ib: int, n: int, lda: int, ldb: int, a_ptr: int,
                b_ptr: Optional[int]) -> bool:
    """The mirror of ``bff_mask_iou_wgmma_takes``: whether ``bff_mask_iou``
    counts on the wgmma kernel. ``lda``, ``ldb``: row strides in bytes;
    ``b_ptr`` None is a self-IoU (``ldb`` then ignored)."""
    if b_ptr is None:
        ldb = lda
    return (ia >= 1 and ib >= 1 and 1 <= n < 2 ** 31 and lda >= n and ldb >= n
            and lda % 16 == 0 and ldb % 16 == 0 and lda < 2 ** 39 and ldb < 2 ** 39
            and a_ptr % 16 == 0 and (b_ptr is None or b_ptr % 16 == 0))


# csrc/mask_iou_wgmma.cu's kTile (output rows and columns of a block), kChunk
# (points of a stage) and kCluster (blocks sharing A)
WGMMA_TILE, WGMMA_CHUNK, WGMMA_CLUSTER = 128, 128, 2


def wgmma_schedule(ia: int, ib: int, n: int, self_iou: bool, sms: int = 132):
    """The wgmma kernel's grid as ``bff_mask_iou_wgmma_count`` lays it out:
    one entry per block, (tile row, tile column, cluster rank, past the last
    tile column, first point, end point) of its slice of N, and the TMA
    boxes it loads as (kind, point, row): ``"a"`` its share of A's rows
    (multicast to the cluster), ``"b"`` B's 128 rows, one of each per
    128-point chunk."""
    tile, chunk, cl = WGMMA_TILE, WGMMA_CHUNK, WGMMA_CLUSTER
    tiles_i, tiles_j = -(-ia // tile), -(-ib // tile)
    groups = ([(i, i + m * cl) for i in range(tiles_i) for m in range(-(-(tiles_j - i) // cl))]
              if self_iou else
              [(i, m * cl) for i in range(tiles_i) for m in range(-(-tiles_j // cl))])
    chunks = -(-n // chunk)
    splits = max(1, sms // (len(groups) * cl))
    splits = max(1, min(splits, chunks // 4, 65535))
    split_len = -(-chunks // splits) * chunk
    splits = -(-n // split_len)
    share = tile // cl
    blocks = []
    for y in range(splits):
        k0, k1 = y * split_len, min(n, (y + 1) * split_len)
        for ti, tj0 in groups:
            for r in range(cl):
                tj = tj0 + r
                past = tj >= tiles_j
                boxes = []
                for k in range(k0, k1, chunk):
                    if ti * tile + r * share < ia:
                        boxes.append(("a", k, ti * tile + r * share))
                    if not past:
                        boxes.append(("b", k, tj * tile))
                blocks.append((ti, tj, r, past, k0, k1, boxes))
    return blocks


def _row_stride(t: torch.Tensor) -> int:
    """Bytes between rows as the kernels read them: N for a single row."""
    return t.stride(0) if t.shape[0] > 1 else max(t.shape[1], t.stride(0))


def pairwise_iou_plain(a: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same function in plain PyTorch: a float32 product over N and f32
    row sums (exact below 2^24 points)."""
    af = a.float()
    bf = af if b is None else b.float()
    inter = af @ bf.T
    union = af.sum(1)[:, None] + bf.sum(1)[None, :] - inter
    return inter / union


def pairwise_iou(a: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Ia, N) x (Ib, N) bool -> (Ia, Ib) float32 IoU; ``b`` None is a vs a."""
    if not dispatch.kernel_device(*((a,) if b is None else (a, b))):
        return pairwise_iou_plain(a, b)
    dispatch.refuse_autograd("mask_iou", a, b)
    for t in (a,) if b is None else (a, b):
        if (t.dtype != torch.bool or t.dim() != 2
                or (t.shape[1] > 1 and t.stride(1) != 1)
                or (t.shape[0] > 1 and t.stride(0) < t.shape[1])):
            raise ValueError(f"pairwise_iou takes 2-D bool masks with contiguous rows, got "
                             f"{t.dtype} {tuple(t.shape)} strides {t.stride()}")
    if b is not None and (b.shape[1] != a.shape[1] or b.device != a.device):
        raise ValueError(f"masks disagree: {tuple(a.shape)} on {a.device} vs "
                         f"{tuple(b.shape)} on {b.device}")
    ia, n = a.shape
    ib = ia if b is None else b.shape[0]
    out = torch.empty(ia, ib, dtype=torch.float32, device=a.device)
    if ia == 0 or ib == 0:
        return out
    from beyondff_tpu_torch.kernels import _build

    lda = _row_stride(a)
    ldb = lda if b is None else _row_stride(b)
    b_ptr = None if b is None else b.data_ptr()
    wgmma = wgmma_route(ia, ib, n, lda, ldb, a.data_ptr(), b_ptr)
    workspace = torch.empty(ia * ib + ia + ib, dtype=torch.int32, device=a.device)
    rc = _build.library().bff_mask_iou(
        a.data_ptr(), b_ptr, ia, ib, n, lda, ldb,
        workspace.data_ptr(), out.data_ptr(), torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mask_iou kernel launch failed (code {rc})")
    dispatch.launch_counts["mask_iou_wgmma" if wgmma else "mask_iou"] += 1
    return out
